// Farthest-point sampling for Hopper (sm_90a): a frame spread over a cluster
// of blocks, the whole chain of k - 1 dependent selections in one launch for
// a batch.
//
// Replaces no TPU kernel: hgsfusion_tpu/ops/pointnet2.py::farthest_point_sample
// is XLA's lax.fori_loop. PV-RCNN and PV-RCNN++ pick their 1,024 keypoints of
// 8,192 points with it; the port's plain version (ops/pointnet2.py::
// farthest_point_sample_plain) is that loop in PyTorch, about 7 launches a
// step, so some 7,000 launches a frame. Its rules, each kept here:
//
//   out[0] = 0, even where point 0 is not valid;
//   dist = valid ? 1e10 : -1;
//   for s in 1 .. k-1:
//     last = xyz[out[s-1]]
//     dist = min(dist, valid ? ((dx*dx + dy*dy) + dz*dz) : -1)   (f32)
//     out[s] = argmax(dist), ties to the lowest index
//
// so k may exceed the valid points (then the argmax finds a valid point at
// distance 0, or index 0 where none is valid).
//
// FPS is chaotic: one rounding difference picks another point, and every
// keypoint after it moves. So the kernel equals the plain version's indices
// exactly: the difference and the products and sums are each rounded on their
// own (__fsub_rn / __fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA) in the plain version's order, and every reduction keeps the largest
// distance, then the lowest index. An invalid point keeps -1, as min(-1, d)
// with d >= 0.
//
// Bound on an H100: the chain of k - 1 dependent frame-wide argmax steps, not
// bytes (xyz read once, 8 B an index written) nor operations (10 f32 operations
// a point a step). Design: a frame's points are cut into contiguous slices of
// THREADS * PTS points, one block each, and the blocks of a frame form one
// thread-block cluster (launched with cudaLaunchAttributeClusterDimension;
// ops/library.py::fps_plan picks the cluster size and PTS from the frame's
// size: 8,192 points on 4 blocks of 16 points a thread), so that each step's
// distance updates are spread over that many SMs. Warp w of a block owns the
// points slice + w * 32 * PTS + lane + 32 q, their xyz and running minima in
// registers. A step:
//   1. each thread updates its minima and keeps its best (ascending q, a strict
//      > keeps the first);
//   2. the warp's argmax is two single-instruction reductions on 32-bit keys
//      (redux.sync): a non-negative f32 orders like its bits as uint32, so a
//      valid distance d maps to bits(d) + 1 and anything else (-1, or -inf past
//      the frame's end) to 0; the max key, then the lowest index holding it;
//   3. lanes 0 .. C-1 send the warp's record (key; index, x, y, z from the
//      block's shared copy of its slice) into slot rank * WARPS + warp of block
//      `lane` of the cluster by st.async, which counts its bytes on that
//      block's mbarrier of the step's parity when it lands;
//   4. every thread waits on its own block's mbarrier until all C * WARPS
//      records have landed (thread 0 arrived on it at the step's start,
//      expecting their bytes): no barrier across the cluster or the block;
//   5. every warp of every block reduces the records itself: slots run in
//      index order, so the largest key, then the lowest slot, is the frame's
//      argmax, and the winner's xyz comes with its record.
// Slots and mbarriers of parity p are used again at step s + 2, whose records
// no block sends before it has every block's records of step s + 1, which each
// warp sends after reading those of step s; so warps stay within a step of
// each other and two parities suffice. tune_fps.py measured the choices on
// the card (PERF.md): a cluster barrier a step (barrier.cluster arrive.release
// / wait.acquire) cost about 1 us, twice this exchange; one record a block,
// 64 or 256 threads a block and 4,096 points a block were slower, 1,024 a
// block as fast at 8,192 points and slower at 16,384 (a cluster of 16).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // blocks a frame (above 8: a non-portable cluster size)
constexpr int MAX_RECORDS = MAX_CLUSTER * WARPS;
constexpr int MAX_DEVICES = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no index
constexpr int RECORD_BYTES = 20;          // a record's key and (index, x, y, z)

// a distance's key: bits + 1 for d >= 0 (a valid point), 0 for -1 or -inf
__device__ __forceinline__ unsigned key_of(float d) {
  return d >= 0.0f ? __float_as_uint(d) + 1u : 0u;
}

// the shared-memory address of `p` in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// the warp's record (key; index, x, y, z) into `slot` of block `rank`, each
// store counting its bytes on that block's barrier `bar` when it lands
__device__ __forceinline__ void publish(unsigned* s_key, uint4* s_rec, uint64_t* bar, int slot,
                                        unsigned rank, unsigned key, unsigned idx, float4 p) {
  const unsigned b = cluster_addr(bar, rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
          cluster_addr(&s_key[slot], rank)),
      "r"(key), "r"(b)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(cluster_addr(&s_rec[slot], rank)),
      "r"(idx), "r"(__float_as_uint(p.x)), "r"(__float_as_uint(p.y)), "r"(__float_as_uint(p.z)),
      "r"(b)
      : "memory");
}

// this thread's arrival at `bar`'s phase, which then waits for `bytes` more
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

// until `bar`'s phase of this parity has completed
__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}

template <int PTS>
constexpr int smem_bytes() {
  return THREADS * PTS * static_cast<int>(sizeof(float4));
}

// PTS points a thread; gridDim.x = frames x cluster size
template <int PTS>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid, int n, int k,
           int64_t* __restrict__ out) {
  extern __shared__ float4 s_pt[];  // this block's slice: x, y, z
  __shared__ unsigned s_key[2][MAX_RECORDS];
  __shared__ uint4 s_rec[2][MAX_RECORDS];  // index, x, y, z
  __shared__ uint64_t s_bar[2];            // the records of a parity landed
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int c = static_cast<int>(cluster.num_blocks());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int frame = blockIdx.x / c;
  const float* p = xyz + static_cast<int64_t>(frame) * n * 3;
  const uint8_t* v = valid + static_cast<int64_t>(frame) * n;
  int64_t* o = out + static_cast<int64_t>(frame) * k;
  const int base = static_cast<int>(rank) * THREADS * PTS;  // the slice's first point
  const int wbase = base + warp * 32 * PTS;                 // the warp's first point
  float x[PTS], y[PTS], z[PTS], d[PTS];
#pragma unroll
  for (int q = 0; q < PTS; ++q) {
    const int j = wbase + lane + 32 * q;
    x[q] = y[q] = z[q] = 0.0f;
    d[q] = -INFINITY;  // past the frame's end: never taken
    if (j < n) {
      x[q] = p[3 * j];
      y[q] = p[3 * j + 1];
      z[q] = p[3 * j + 2];
      d[q] = v[j] ? 1e10f : -1.0f;
    }
    s_pt[j - base] = make_float4(x[q], y[q], z[q], 0.0f);
  }
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(&s_bar[0])))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(&s_bar[1])))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && t == 0) o[0] = 0;
  const int records = c * WARPS;
  cluster.sync();  // every block of the cluster running, its barriers and slice in place
  for (int s = 1; s < k; ++s) {
    const int par = s & 1;
    if (t == 0) expect_bytes(&s_bar[par], records * RECORD_BYTES);
    float bv = -INFINITY;
    unsigned bi = kNone;
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
      const float dx = __fsub_rn(x[q], lx), dy = __fsub_rn(y[q], ly), dz = __fsub_rn(z[q], lz);
      const float dd =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      d[q] = fminf(d[q], dd);  // an invalid point's -1 stays
      if (d[q] > bv) {
        bv = d[q];
        bi = wbase + lane + 32 * q;
      }
    }
    const unsigned key = key_of(bv);
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const unsigned widx = __reduce_min_sync(kFull, key == wkey ? bi : kNone);
    if (lane < c)
      publish(s_key[par], s_rec[par], &s_bar[par], static_cast<int>(rank) * WARPS + warp, lane,
              wkey, widx, s_pt[widx != kNone ? widx - base : 0]);
    wait_parity(&s_bar[par], ((s - 1) >> 1) & 1);
    // the largest key, then the lowest slot: the frame's argmax
    unsigned best = 0, slot = kNone;
#pragma unroll
    for (int i = 0; i < MAX_RECORDS / 32; ++i) {
      const int r = lane + 32 * i;
      if (r < records) {
        const unsigned kr = s_key[par][r];
        if (slot == kNone || kr > best) {
          best = kr;
          slot = r;
        }
      }
    }
    const unsigned top = __reduce_max_sync(kFull, best);
    const uint4 rec = s_rec[par][__reduce_min_sync(kFull, best == top ? slot : kNone)];
    lx = __uint_as_float(rec.y);
    ly = __uint_as_float(rec.z);
    lz = __uint_as_float(rec.w);
    // not thread 0: its arrival on the mbarrier is a release, ordered after
    // this store
    if (rank == 0 && t == THREADS - 1) o[s] = rec.x;
  }
}

// the dynamic shared memory above 48 KB and cluster sizes above 8 are granted
// once per device and instantiation (so that a call inside a CUDA graph
// capture makes no attribute call)
template <int PTS>
cudaError_t prepare() {
  static int done[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < MAX_DEVICES && done[device])) return err;
  err = cudaFuncSetAttribute(fps_kernel<PTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<PTS>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_kernel<PTS>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device < MAX_DEVICES) done[device] = 1;
  return err;
}

template <int PTS>
int launch(const void* xyz, const void* valid, int b, int n, int k, int cluster, void* out,
           void* stream) {
  cudaError_t err = prepare<PTS>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<PTS>();
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel<PTS>, static_cast<const float*>(xyz),
                           static_cast<const uint8_t*>(valid), n, k, static_cast<int64_t*>(out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// xyz: (b, n, 3) float32, contiguous; valid: (b, n) bool (one byte each).
// out: (b, k) int64, every element written: each frame's k indices in
// selection order. Each frame runs on `cluster` blocks of THREADS threads,
// `pts` points a thread (1, 2, 4, 8, 16 or 32; their xyz and minima in
// registers): cluster * THREADS * pts >= n, cluster <= MAX_CLUSTER, b *
// cluster at most 2^31 - 1. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments out of those ranges).
extern "C" int fps(const void* xyz, const void* valid, int b, int n, int k, int cluster,
                   int pts, void* out, void* stream) {
  if (b == 0 || k == 0) return cudaSuccess;
  if (b < 0 || k < 0 || n < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      static_cast<int64_t>(cluster) * THREADS * pts < n ||
      static_cast<int64_t>(b) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  switch (pts) {
    case 1: return launch<1>(xyz, valid, b, n, k, cluster, out, stream);
    case 2: return launch<2>(xyz, valid, b, n, k, cluster, out, stream);
    case 4: return launch<4>(xyz, valid, b, n, k, cluster, out, stream);
    case 8: return launch<8>(xyz, valid, b, n, k, cluster, out, stream);
    case 16: return launch<16>(xyz, valid, b, n, k, cluster, out, stream);
    case 32: return launch<32>(xyz, valid, b, n, k, cluster, out, stream);
    default: return cudaErrorInvalidValue;
  }
}
