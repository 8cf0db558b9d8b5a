// Rotated greedy NMS for Hopper (sm_90a): one block per frame, the whole
// sweep in one launch, nothing read back to the host.
//
// Computes what hgsfusion_tpu/ops/nms.py::greedy_nms_lazy computes (XLA's
// lax.while_loop there; no TPU kernel): over score-sorted candidates,
//
//   i = the first valid candidate
//   while i < K and kept < max_keep:
//     keep i; suppress every later j with IoU_bev(box i, box j) > thresh
//     i = the next candidate neither invalid nor suppressed
//
// The port's plain version (ops/nms.py::greedy_nms_lazy_plain) reads the
// candidate count back to the host and launches a few kernels per kept box;
// at 500 kept boxes that loop is the served frame's longest stage.
//
// Design: the block holds every candidate's BEV corners (32 B) and its
// centre, circumradius and area (16 B) in shared memory (192 KB for the
// configs' 4,096 candidates, past the 48 KB default: the launch raises the
// block's limit), and a bitmask of the live candidates, one 32-bit word per
// 32 of them. Each step keeps the first live candidate i; each warp takes
// whole words of the bitmask from i's word on, its 32 lanes test the live
// candidates of the word (one each) against box i, and the warp clears the
// bits of those suppressed (and i's own) with one ballot and one store: no
// word has two writers, so no atomics. A candidate whose circumcircle lies
// clear of box i's (by a margin far above the corners' rounding) cannot
// overlap it, so its IoU is 0 and it is not suppressed (at a threshold of 0
// or more): only the lanes near box i evaluate the IoU, and a warp whose 32
// candidates are all far from it skips the evaluation. Each warp also finds the first bit left set in
// its words; one barrier later every thread reduces the warps' results to
// the next i, so a step costs one __syncthreads (the warps' minima are
// double-buffered, so a step's writes never meet the last step's reads).
//
// The IoU is the port's sort-free boundary integral (ops/rotated_iou.py:
// boxes_to_corners_bev, _pairwise_intersection_from_corners, _half_boundary)
// in f32, each product and sum rounded on its own as PyTorch's elementwise
// ops round them (__fmul_rn / __fadd_rn never contract into an FMA) and the
// four-term sums and means taken in index order. Only the order of those
// small sums may differ from PyTorch's reductions, so a keep decision can
// differ from the plain version's only where an IoU lies within rounding of
// the threshold.
//
// Bound on an H100: operations. Each step evaluates one IoU (about 700 f32
// operations, 33 of them divisions) for every live candidate after i near
// box i, and a circle test for the others, on the one SM that holds the
// frame; a B-frame batch runs B blocks side by side.
// The boxes are read once and the keep mask written once.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-8f;       // IoU denominator floor (ops/rotated_iou.py _EPS)
constexpr float EPS_PAR = 1e-6f;   // parallel edges (_EPS_PAR)
constexpr float EPS_COLL = 1e-5f;  // collinear edges (_EPS_COLL)
// the C entry's return when the candidates' corners do not fit in shared memory
constexpr int TOO_MANY_CANDIDATES = -1;
constexpr int MAX_DEVICES = 64;
// circumcircles this far apart (relative to 1 + their radii) leave their
// boxes disjoint whatever the corners' f32 rounding
constexpr float DISC_MARGIN = 1e-3f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Quad {
  float x[4], y[4];  // counter-clockwise BEV corners
};

// boxes_to_corners_bev: the template (+-0.5 dx, +-0.5 dy), rotated, shifted
__device__ Quad corners(const float* box) {
  const float tx[4] = {0.5f, -0.5f, -0.5f, 0.5f}, ty[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  const float c = cosf(box[6]), s = sinf(box[6]);
  Quad q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float px = mul(box[3], tx[k]), py = mul(box[4], ty[k]);
    q.x[k] = add(sub(mul(px, c), mul(py, s)), box[0]);
    q.y[k] = add(add(mul(px, s), mul(py, c)), box[1]);
  }
  return q;
}

__device__ __forceinline__ float sum4(const float (&v)[4]) {
  return add(add(add(v[0], v[1]), v[2]), v[3]);
}

// _half_boundary: the shoelace contribution of P's edges clipped to inside
// Q; a P-edge on a Q-edge line counts only in the first pass and only if the
// two point the same way.
__device__ float half_boundary(const Quad& p, const Quad& q, bool first_pass) {
  float contrib[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dx = sub(p.x[(i + 1) & 3], p.x[i]), dy = sub(p.y[(i + 1) & 3], p.y[i]);
    float t_lo = 0.f, t_hi = 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ex = sub(q.x[(j + 1) & 3], q.x[j]), ey = sub(q.y[(j + 1) & 3], q.y[j]);
      const float rx = sub(p.x[i], q.x[j]), ry = sub(p.y[i], q.y[j]);
      const float a = sub(mul(ex, ry), mul(ey, rx));
      const float b = sub(mul(ex, dy), mul(ey, dx));
      const bool parallel = fabsf(b) <= EPS_PAR;
      const float tc = __fdiv_rn(-a, parallel ? 1.f : b);
      float lo = (!parallel && b > 0.f) ? tc : 0.f;
      float hi = (!parallel && b < 0.f) ? tc : 1.f;
      const bool collinear = parallel && fabsf(a) <= EPS_COLL;
      bool parallel_ok;
      if (first_pass) {
        const bool same_dir = add(mul(dx, ex), mul(dy, ey)) > 0.f;
        parallel_ok = collinear ? same_dir : a > 0.f;
      } else {
        parallel_ok = !collinear && a > 0.f;
      }
      if (parallel && !parallel_ok) hi = -1.f;
      t_lo = fmaxf(t_lo, lo);
      t_hi = fminf(t_hi, hi);
    }
    const float ax = add(p.x[i], mul(t_lo, dx)), ay = add(p.y[i], mul(t_lo, dy));
    const float bx = add(p.x[i], mul(t_hi, dx)), by = add(p.y[i], mul(t_hi, dy));
    contrib[i] = t_hi > t_lo ? sub(mul(ax, by), mul(ay, bx)) : 0.f;
  }
  return mul(0.5f, sum4(contrib));
}

// boxes_iou_bev of one pair: the intersection about the pair's joint
// centroid, over the union
__device__ float iou(const Quad& a, float area_a, const Quad& b, float area_b) {
  const float cx = mul(0.5f, add(mul(sum4(a.x), 0.25f), mul(sum4(b.x), 0.25f)));
  const float cy = mul(0.5f, add(mul(sum4(a.y), 0.25f), mul(sum4(b.y), 0.25f)));
  Quad p, q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p.x[k] = sub(a.x[k], cx), p.y[k] = sub(a.y[k], cy);
    q.x[k] = sub(b.x[k], cx), q.y[k] = sub(b.y[k], cy);
  }
  const float inter = fmaxf(add(half_boundary(p, q, true), half_boundary(q, p, false)), 0.f);
  return __fdiv_rn(inter, fmaxf(sub(add(area_a, area_b), inter), EPS));
}

// the candidate of word w's lowest set bit, or INT_MAX
__device__ __forceinline__ int first_bit(uint32_t bits, int w) {
  return bits ? 32 * w + __ffs(bits) - 1 : INT_MAX;
}

__device__ __forceinline__ int block_min(const int* warp_first) {
  int v = INT_MAX;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v = min(v, warp_first[w]);
  return v;
}

__global__ void __launch_bounds__(THREADS)
nms_lazy_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, int k,
                float thresh, int max_keep, uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem_f4[];
  const int words = (k + 31) / 32;
  Quad* quad = reinterpret_cast<Quad*>(smem_f4);
  float4* disc = reinterpret_cast<float4*>(quad + k);  // centre x, y, circumradius, area
  uint32_t* live = reinterpret_cast<uint32_t*>(disc + k);
  uint32_t* kept = live + words;
  __shared__ int warp_first[2][WARPS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bx = boxes + static_cast<int64_t>(blockIdx.x) * k * 7;
  const uint8_t* vd = valid + static_cast<int64_t>(blockIdx.x) * k;
  uint8_t* out = keep + static_cast<int64_t>(blockIdx.x) * k;

  for (int j = threadIdx.x; j < k; j += THREADS) {
    float box[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) box[c] = bx[static_cast<int64_t>(j) * 7 + c];
    quad[j] = corners(box);
    disc[j] = make_float4(box[0], box[1], 0.5f * sqrtf(box[3] * box[3] + box[4] * box[4]),
                          mul(box[3], box[4]));
  }
  // the bitmask, 32 candidates a word, one warp a word; each warp's first
  // valid candidate
  int first = INT_MAX;
  for (int w = warp; w < words; w += WARPS) {
    const int j = 32 * w + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, j < k && vd[j] != 0);
    if (lane == 0) live[w] = bits, kept[w] = 0u;
    first = min(first, first_bit(bits, w));
  }
  if (lane == 0) warp_first[0][warp] = first;
  __syncthreads();

  int buf = 0;
  int i = block_min(warp_first[buf]);
  for (int n = 0; i < k && n < max_keep; ++n) {
    if (threadIdx.x == 0) kept[i / 32] |= 1u << (i % 32);
    const Quad qi = quad[i];
    const float4 di = disc[i];
    buf ^= 1;
    first = INT_MAX;
    // words before i's hold no live bit: i is the first
    for (int w = i / 32 + warp; w < words; w += WARPS) {
      const uint32_t bits = live[w];
      const int j = 32 * w + lane;
      bool doomed = false;
      if (((bits >> lane) & 1u) && j > i) {
        const float4 dj = disc[j];
        const float gap = di.z + dj.z + DISC_MARGIN * (1.f + di.z + dj.z);
        const float ex = di.x - dj.x, ey = di.y - dj.y;
        doomed = ex * ex + ey * ey > gap * gap ? 0.f > thresh
                                               : iou(qi, di.w, quad[j], dj.w) > thresh;
      }
      doomed = doomed || j == i;
      const uint32_t left = bits & ~__ballot_sync(0xffffffffu, doomed);
      if (lane == 0) live[w] = left;
      first = min(first, first_bit(left, w));
    }
    if (lane == 0) warp_first[buf][warp] = first;
    __syncthreads();
    i = block_min(warp_first[buf]);
  }
  __syncthreads();  // thread 0's last kept bit
  for (int j = threadIdx.x; j < k; j += THREADS) out[j] = (kept[j / 32] >> (j % 32)) & 1u;
}

size_t smem_bytes(int k) {
  const size_t words = (static_cast<size_t>(k) + 31) / 32;
  return static_cast<size_t>(k) * (sizeof(Quad) + sizeof(float4)) +
         2 * words * sizeof(uint32_t);
}

}  // namespace

// boxes: (b, k, 7) float32 [x, y, z, dx, dy, dz, heading], score-sorted per
// frame, contiguous. valid: (b, k) bool (one byte each). keep: (b, k) bool,
// every element written: the greedy keep set of each frame, at most
// max_keep entries. Returns the launch's cudaError_t, or -1 when k
// candidates' corners exceed a block's shared memory.
extern "C" int nms_lazy(const void* boxes, const void* valid, int b, int k, float thresh,
                        int max_keep, void* keep, void* stream) {
  if (b == 0 || k == 0) return cudaSuccess;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes(k);
  if (bytes + sizeof(int) * 2 * WARPS > static_cast<size_t>(optin)) return TOO_MANY_CANDIDATES;
  // raise the block's limit once per device (to the most it can take), so
  // that a call inside a CUDA graph capture makes no attribute call
  static int raised[MAX_DEVICES] = {};
  if (device >= MAX_DEVICES || !raised[device]) {
    err = cudaFuncSetAttribute(nms_lazy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(sizeof(int) * 2 * WARPS));
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) raised[device] = 1;
  }
  nms_lazy_kernel<<<b, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), k, thresh,
      max_keep, static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
