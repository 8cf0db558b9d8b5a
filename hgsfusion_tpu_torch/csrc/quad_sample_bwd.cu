// Quad bilinear sampler backward for Hopper (sm_90a): pixel-binned and
// tile-owned, with no global atomics.
//
// Replaces the TPU kernels hgsfusion_tpu/ops/pallas_sample.py::_scatter_outer
// (rows layout) and ::_scatter_outer_planes (planes layout), together with the
// routing of their quad-table cotangent back onto the map (_unshift). Both
// layouts compute one function, the adjoint of quad_sample_fwd's four tap
// reads:
//
//   out[p_tap(j), :] += w4[j, tap] * ct[j, :]   for every query j and tap,
//
// where the taps of query j are the 2x2 patch of the zero-padded NHWC map
// (B, H+2, W+2, c) whose top-left pixel is idx[j]: p, p + 1, p + W + 2,
// p + W + 3. The result is cropped to (B, H, W, c) and rounded once to the
// cotangent's dtype.
//
// Contention. The queries of a frame are voxels in (Y, X, Z) order, and many
// land on the same pixels. On the flagship frustum geometry (3,174,400
// queries, 82% of them with a nonzero weight) the 10.4 M tap adds of a call
// fall on 61,898 pixels of map A (64 ch) and 15,730 of map B (192 ch): 168
// and 660 adds per receiving pixel on average, 1,600 and 6,079 at most. A
// block of 256 consecutive queries touches 217 (A) and 93 (B) distinct
// pixels on average and up to 1,024, so pre-reducing consecutive queries
// before global atomics still leaves millions of them.
//
// Design: invert the scatter. The glue (ops/quad_sample.py::quad_bins) sorts
// the queries with any nonzero weight by their top-left pixel, stable in
// query order (`order`), and gives each pixel's run in `order` as CSR
// offsets (`start`, length B*(H+2)*(W+2) + 1). Output pixel (y, x) sits at
// padded (y+1, x+1) and receives only from the queries whose top-left pixel
// is (y+1, x+1), (y+1, x), (y, x+1) or (y, x). So the queries of an output
// tile of TILE x TILE pixels are the runs of its (TILE+1)^2 top-left pixels:
// TILE+1 contiguous ranges of `order`, one per top-left row, here called the
// tile's list.
//
// One cluster of CLUSTER blocks owns one tile and one slice of 64 channels
// (32 for an odd c). The tile's list is cut into equal contiguous chunks,
// one per warp of the cluster; each lane owns two channels (one for an odd
// c). A warp walks its chunk in batches of UNROLL queries of one run, the
// next batch's entries of `order` loading while the current batch's rows
// are in flight, and keeps the four tap sums of the current top-left pixel
// in registers. When the run ends it writes them into its block's
// shared-memory tile, one f32 array per tap, so that no two writers meet. A
// run that spans several warps' chunks is summed by the warp where it
// starts, which adds the later warps' pieces in warp order after a barrier.
// Then each block sums its four tap arrays, and each block of the cluster
// sums a quarter of the tile's pixels over the cluster's blocks, in block
// order, through distributed shared memory, rounds once and writes straight
// into the cropped output. Every output element is written once; nothing is
// zeroed in global memory and no atomic is used anywhere, so the result is
// the same bit for bit from run to run. Splitting every tile's list over the
// blocks of a cluster (on different SMs) bounds a block's work where a tile
// is hot: the flagship's heaviest 8x8 tile of B holds 85,716 queries
// against a mean of 11,626.
//
// Bound on an H100: bytes. The inputs must be read once: `order` and w4 of
// every query (20 B; the glue reads idx once to build `order`), the
// cotangent rows of the queries with a nonzero weight, and the output is
// written once in the cotangent's dtype. Halo queries (top-left pixels on a
// tile's edge) are read by up to four tiles, 1.27x (A) and 1.25x (B) of the
// queries at TILE = 8 on the flagship geometry, and the list entries and
// weights once per channel slice (three for B). Each warp keeps UNROLL
// rows in flight; shared memory (74 KB a block at 64 channels) allows 3
// blocks, 24 warps, per SM.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 8;             // output pixels per tile side
constexpr int TL = TILE + 1;        // top-left pixels per tile side
constexpr int SEGS = TL * TL;       // top-left pixels (runs) of a tile
constexpr int TILE_PX = TILE * TILE;
constexpr int THREADS = 256;        // 8 warps, one worker each
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;       // resident blocks per SM (shared memory allows 3)
constexpr int CLUSTER = 4;          // blocks sharing one tile and slice; divides TILE_PX
constexpr int UNROLL = 8;           // cotangent rows in flight per warp

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// V consecutive channels of one row, loaded or stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct Params {
  const void* ct;          // (n, c) cotangent
  const int32_t* order;    // (n,) queries sorted by top-left pixel, nonzero-weight ones first
  const int32_t* start;    // (B*(H+2)*(W+2) + 1,) each top-left pixel's run in order
  const float4* w4;        // (n,) tap weights
  void* out;               // (B, H, W, c) map gradient
  int h, w, c;
  int slice;               // channels of one slice, 32 * V
  int slices, tiles_y, tiles_x;
};

// Shared memory of a block with `cs` channels per slice, in bytes.
constexpr size_t smem_bytes(int cs) {
  return sizeof(float) * (4 * TILE_PX + WARPS * 4) * static_cast<size_t>(cs)  // taps, pieces
         + sizeof(int) * (TL * (TL + 1) + SEGS + 1 + TL);
}

template <int V>
__device__ __forceinline__ void zero(float (&acc)[4][V]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
}

// Store the sums of one chunk's piece of run `seg` (tile-local top-left
// pixel, row-major over TL x TL): into the warp's slot `piece` when the run
// began in an earlier chunk, else into the per-tap tile arrays of `cs`
// channels, for the taps inside the tile.
template <int V>
__device__ __forceinline__ void store_run(float* part, float* piece, bool to_piece, int cs,
                                          int seg, int lane, const float (&acc)[4][V]) {
  if (to_piece) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) piece[t * cs + lane * V + v] = acc[t][v];
    return;
  }
  const int lr = seg / TL, lc = seg % TL;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int oy = lr + (t >> 1) - 1, ox = lc + (t & 1) - 1;
    if (oy < 0 || oy >= TILE || ox < 0 || ox >= TILE) continue;
    float* dst = part + ((t * TILE_PX + oy * TILE + ox) * cs + lane * V);
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = acc[t][v];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) quad_sample_bwd_kernel(const Params p) {
  extern __shared__ float4 smem[];
  const int cs = p.slice;
  float* part = reinterpret_cast<float*>(smem);             // [4][TILE_PX][cs]
  float* head = part + 4 * TILE_PX * cs;                    // [WARPS][4][cs]
  int* srow = reinterpret_cast<int*>(head + WARPS * 4 * cs);  // [TL][TL + 1] start values
  int* off = srow + TL * (TL + 1);                          // [SEGS + 1] runs in the tile's list
  int* rdelta = off + SEGS + 1;                             // [TL] list position -> order index

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int item = blockIdx.x / CLUSTER;
  const int slice = item % p.slices;
  const int tile = item / p.slices;
  const int tx = tile % p.tiles_x;
  const int ty = (tile / p.tiles_x) % p.tiles_y;
  const int b = tile / (p.tiles_x * p.tiles_y);
  const int y0 = ty * TILE, x0 = tx * TILE;
  const int64_t wp2 = p.w + 2;
  const int64_t map_base = static_cast<int64_t>(b) * (p.h + 2) * wp2;

  // 1. The start of each top-left pixel's run, rows y0..y0+TILE and columns
  // x0..x0+TILE+1 (a top-left pixel lies in rows 0..H and columns 0..W of the
  // padded map; further columns clamp to W+1, whose run is empty, and
  // further rows are empty). Zero the tap arrays meanwhile.
  for (int i = threadIdx.x; i < TL * (TL + 1); i += THREADS) {
    const int r = i / (TL + 1), col = i % (TL + 1);
    const int row = y0 + r;
    srow[i] = row <= p.h ? p.start[map_base + row * wp2 + min(x0 + col, p.w + 1)] : 0;
  }
  float4* part4 = reinterpret_cast<float4*>(part);
  for (int i = threadIdx.x; i < TILE_PX * cs; i += THREADS)
    part4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // 2. The tile's list is its rows' ranges of `order`, one after another.
  for (int i = threadIdx.x; i <= SEGS; i += THREADS) {
    const int r = i / TL, col = i % TL;
    int row_off = 0;
    for (int rr = 0; rr < r; ++rr) row_off += srow[rr * (TL + 1) + TL] - srow[rr * (TL + 1)];
    if (i == SEGS) {
      off[SEGS] = row_off;
    } else {
      off[i] = row_off + srow[r * (TL + 1) + col] - srow[r * (TL + 1)];
      if (col == 0) rdelta[r] = srow[r * (TL + 1)] - row_off;
    }
  }
  __syncthreads();

  // 3. This block's share of the list, cut into one chunk per warp.
  const int m = off[SEGS];
  const int k_lo = static_cast<int>(static_cast<int64_t>(m) * rank / CLUSTER);
  const int k_hi = static_cast<int>(static_cast<int64_t>(m) * (rank + 1) / CLUSTER);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = slice * cs + lane * V;
  const bool live = ch < p.c;
  const int ch_ld = live ? ch : 0;  // lanes past the last channel load channel 0 and write nothing
  auto chunk_start = [&](int w) {
    return k_lo + static_cast<int>(static_cast<int64_t>(k_hi - k_lo) * w / WARPS);
  };
  const int k0 = chunk_start(warp), k1 = chunk_start(warp + 1);
  const T* ct = static_cast<const T*>(p.ct);
  float* piece = head + warp * 4 * cs;

  float acc[4][V];
  zero(acc);
  int s = 0;
  bool tail = false;  // acc holds the start of a run that continues in later chunks
  if (k0 < k1) {
    // the run that holds position k0: the last s with off[s] <= k0
    int lo = 0, hi = SEGS - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= k0) lo = mid; else hi = mid - 1;
    }
    s = lo;
    bool first = max(off[s], k_lo) < k0;  // the run began in an earlier chunk
    int k = k0;
    int end = min(off[s + 1], k1);
    int s_next = s, end_next = end;
    const int32_t* ord_next = p.order + rdelta[s / TL];
    // batches of UNROLL positions of one run (a short last batch repeats
    // its last position and adds nothing for it); the next batch's entries
    // of `order`, in this run or the next, load while this batch's rows are
    // in flight
    int q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(ord_next + min(k + u, end - 1));
    while (true) {
      const int n = min(UNROLL, end - k);
      float4 wt[UNROLL];
      Pack<T, V> g[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        wt[u] = __ldg(p.w4 + q[u]);
        g[u] = *reinterpret_cast<const Pack<T, V>*>(ct + static_cast<int64_t>(q[u]) * p.c + ch_ld);
      }
      k += n;
      if (k < k1) {
        if (k == end) {  // the next run: skip the empty ones
          do { ++s_next; } while (off[s_next + 1] <= k);
          end_next = min(off[s_next + 1], k1);
          ord_next = p.order + rdelta[s_next / TL];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(ord_next + min(k + u, end_next - 1));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (u < n) {
          const float wv[4] = {wt[u].x, wt[u].y, wt[u].z, wt[u].w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[t][v] = fmaf(wv[t], to_f32(g[u].v[v]), acc[t][v]);
        }
      }
      if (k < end) continue;
      // this chunk's piece of run s is summed
      if (!first && min(off[s + 1], k_hi) > k1) {
        tail = true;
        break;
      }
      if (live) store_run(part, piece, first, cs, s, lane, acc);
      if (k >= k1) break;
      first = false;
      zero(acc);
      s = s_next;
      end = end_next;
    }
  }
  __syncthreads();
  // 4. A run that crosses chunks: its first warp adds the later pieces in
  // warp order.
  if (tail) {
    const int end = min(off[s + 1], k_hi);
    for (int w = warp + 1; w < WARPS; ++w) {
      const int a = chunk_start(w);
      if (a >= end) break;
      if (chunk_start(w + 1) > a && live) {
        const float* src = head + w * 4 * cs + lane * V;
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[t][v] += src[t * cs + v];
      }
    }
    if (live) store_run(part, piece, false, cs, s, lane, acc);
  }
  __syncthreads();
  // 5. This block's tile sum, taps in order.
  const int plane = TILE_PX * cs / 4;
  for (int i = threadIdx.x; i < plane; i += THREADS) {
    const float4 a = part4[i], b1 = part4[i + plane], b2 = part4[i + 2 * plane],
                 b3 = part4[i + 3 * plane];
    part4[i] = make_float4(((a.x + b1.x) + b2.x) + b3.x, ((a.y + b1.y) + b2.y) + b3.y,
                           ((a.z + b1.z) + b2.z) + b3.z, ((a.w + b1.w) + b2.w) + b3.w);
  }
  cluster.sync();
  // 6. This block's pixels of the tile: the cluster's sums in block order,
  // rounded once, written into the cropped output.
  constexpr int PER = TILE_PX / CLUSTER;
  const int vecs = cs / V;
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < PER * vecs; i += THREADS) {
    const int px = rank * PER + i / vecs;
    const int cv = (i % vecs) * V;
    const int y = y0 + px / TILE, x = x0 + px % TILE, c0 = slice * cs + cv;
    if (y >= p.h || x >= p.w || c0 >= p.c) continue;
    float got[CLUSTER][V];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float* src = cluster.map_shared_rank(part, r) + px * cs + cv;
#pragma unroll
      for (int v = 0; v < V; ++v) got[r][v] = src[v];
    }
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) sum += got[r][v];
      o.v[v] = from_f32<T>(sum);
    }
    T* dst = out + ((static_cast<int64_t>(b) * p.h + y) * p.w + x) * p.c + c0;
    *reinterpret_cast<Pack<T, V>*>(dst) = o;
  }
  // no block leaves while another reads its shared memory
  cluster.sync();
}

template <typename T, int V>
cudaError_t launch(Params p, int b, cudaStream_t stream) {
  p.slice = 32 * V;
  p.slices = (p.c + p.slice - 1) / p.slice;
  p.tiles_y = (p.h + TILE - 1) / TILE;
  p.tiles_x = (p.w + TILE - 1) / TILE;
  const int64_t blocks = static_cast<int64_t>(b) * p.tiles_y * p.tiles_x * p.slices * CLUSTER;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(p.slice);
  auto kernel = quad_sample_bwd_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Two channels per thread (64 per slice), or one for an odd c (32 per slice).
template <typename T>
cudaError_t dispatch(const Params& p, int b, cudaStream_t stream) {
  if (p.c % 2 == 0) return launch<T, 2>(p, b, stream);
  return launch<T, 1>(p, b, stream);
}

}  // namespace

// ct: (n, c) cotangent, contiguous, 16-byte aligned. order: (n,) int32 and
// start: (b*(h+2)*(w+2) + 1,) int32, the bins of ops/quad_sample.py::quad_bins.
// w4: (n, 4) f32 tap weights, 16-byte aligned. out: (b, h, w, c) in ct's
// dtype, 16-byte aligned; every element is written. dtype of ct and out:
// 0 float32, 1 bfloat16, 2 float16. Returns the launch's cudaError_t.
extern "C" int quad_sample_bwd(const void* ct, const void* order, const void* start,
                               const void* w4, void* out, int b, int h, int w, int c,
                               int dtype, void* stream) {
  Params p = {};
  p.ct = ct;
  p.order = static_cast<const int32_t*>(order);
  p.start = static_cast<const int32_t*>(start);
  p.w4 = static_cast<const float4*>(w4);
  p.out = out;
  p.h = h;
  p.w = w;
  p.c = c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, b, s);
    case 1: return dispatch<__nv_bfloat16>(p, b, s);
    case 2: return dispatch<__half>(p, b, s);
    default: return cudaErrorInvalidValue;
  }
}
