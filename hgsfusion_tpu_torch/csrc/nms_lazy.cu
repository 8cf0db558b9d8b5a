// Rotated greedy NMS for Hopper (sm_90a) in two launches, nothing read back
// to the host: nms_mask builds every frame's suppression mask on all SMs,
// nms_sweep walks the greedy rule over it, one block a frame.
//
// Computes what hgsfusion_tpu/ops/nms.py::greedy_nms_lazy computes (XLA's
// lax.while_loop there; no TPU kernel): over score-sorted candidates,
//
//   i = the first valid candidate
//   while i < K and kept < max_keep:
//     keep i; suppress every later j with IoU_bev(box i, box j) > thresh
//     i = the next candidate neither invalid nor suppressed
//
// The port's plain versions (ops/nms.py) are greedy_nms_lazy_plain, which
// reads the candidate count back to the host and launches a few kernels per
// kept box, and the two-phase nms_mask_plain + nms_sweep_plain, which the
// mask's bits are held to.
//
// nms_mask. mask[b, i, w] is a 64-bit word: bit j % 64 of word w = j / 64
// is set where candidates i < j are both valid and box i suppresses box j,
// the same decision for that pair as a sweep keeping i makes. The grid is
// (row tile r <= column tile c of 64 candidates each, frame): 2,080 blocks a
// frame at K = 4,096. A block whose 64 rows hold no valid candidate writes
// nothing and exits (its words are never read). Otherwise it loads its rows'
// and columns' BEV corners (32 B) and centre, circumradius and area (16 B)
// into shared memory, and each of its 64 threads tests one row candidate i
// against the valid columns j > i: a pair whose circumcircles lie clear of
// each other (by a margin far above the corners' rounding) cannot overlap,
// so its IoU is 0 and the bit is 0 > thresh; the other pairs go to a list in
// shared memory, whose IoUs all 64 threads then evaluate side by side (the
// few near pairs of a row would serialise a warp lane by lane), setting the
// bits with shared atomics. Thread i writes its row's word: every word of a
// row tile with a valid row and a column tile at or after it is written
// (rows of invalid candidates as 0).
//
// nms_sweep. One block a frame walks the row tiles in order, keeping the
// frame's valid bits, the bits suppressed so far and the kept bits in
// shared memory. In tile t, warp 0 resolves the 64 candidates one after the
// other: each live one is kept (up to max_keep) and its word of tile t (the
// diagonal word, fetched into the warp's registers a tile ahead, handed out
// by a shuffle) clears the later live ones. Its next words (tile t + 1),
// fetched with them, give tile t + 1's suppressed bits at once, reduced over
// the kept rows by the warp; meanwhile the other 15 warps OR the words of
// the rows kept in tile t - 1 for tiles t + 1 on into the suppressed bits
// (coalesced reads of consecutive words of a row), so a tile costs one
// barrier and the resolution never waits for those reads. The walk stops after the last tile
// holding a valid candidate, or at max_keep; keep is written once.
//
// The IoU is the port's sort-free boundary integral (ops/rotated_iou.py:
// boxes_to_corners_bev, _pairwise_intersection_from_corners, _half_boundary)
// in f32, each product and sum rounded on its own as PyTorch's elementwise
// ops round them (__fmul_rn / __fadd_rn never contract into an FMA) and the
// four-term sums and means taken in index order. Only the order of those
// small sums may differ from PyTorch's reductions, so a keep decision can
// differ from the plain versions' only where an IoU lies within rounding of
// the threshold.
//
// Bound on an H100: operations. The greedy rule needs, for each kept box,
// an IoU (about 700 f32 operations, 33 of them divisions) with each live
// later candidate near it and a circle test with the others; nms_mask makes
// the circle test for every valid pair and the IoU for every near pair,
// spread over all SMs. nms_sweep moves the kept rows' words (bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int TILE = 64;             // candidates a row or column tile: one 64-bit word
constexpr int SWEEP_THREADS = 512;   // nms_sweep: warp 0 resolves, 15 warps OR words
constexpr int HELPERS = SWEEP_THREADS - 32;
constexpr int UNROLL = 4;            // words a helper thread has in flight
constexpr float EPS = 1e-8f;         // IoU denominator floor (ops/rotated_iou.py _EPS)
constexpr float EPS_PAR = 1e-6f;     // parallel edges (_EPS_PAR)
constexpr float EPS_COLL = 1e-5f;    // collinear edges (_EPS_COLL)
constexpr int MAX_DEVICES = 64;
constexpr unsigned kFull = 0xffffffffu;
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

// candidate j's corners and its centre x, y, circumradius and area
__device__ __forceinline__ void load_candidate(const float* bx, int j, Quad& q, float4& disc) {
  float box[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) box[c] = bx[static_cast<int64_t>(j) * 7 + c];
  q = corners(box);
  disc = make_float4(box[0], box[1], 0.5f * sqrtf(box[3] * box[3] + box[4] * box[4]),
                     mul(box[3], box[4]));
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

// whether the circumcircles of di and dj lie clear of each other
__device__ __forceinline__ bool clear(const float4& di, const float4& dj) {
  const float gap = di.z + dj.z + DISC_MARGIN * (1.f + di.z + dj.z);
  const float ex = di.x - dj.x, ey = di.y - dj.y;
  return ex * ex + ey * ey > gap * gap;
}

// the first word of row tile r in the upper triangle of t x t tiles
__device__ __forceinline__ int64_t row_start(int64_t r, int64_t t) {
  return r * t - r * (r - 1) / 2;
}

__global__ void __launch_bounds__(TILE)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, int k,
                int tiles, float thresh, u64* __restrict__ mask) {
  __shared__ Quad quad[2][TILE];     // the row tile's candidates, the column tile's
  __shared__ float4 disc[2][TILE];
  __shared__ u64 word[TILE];
  __shared__ uint16_t pairs[TILE * TILE];  // near pairs: row << 6 | column
  __shared__ unsigned col_bits[2];
  __shared__ int n_pairs;

  // this block's tile pair r <= c from its index in the upper triangle
  const int64_t idx = blockIdx.x, nt = tiles;
  const double b2 = 2.0 * nt + 1.0;
  int64_t r = static_cast<int64_t>((b2 - sqrt(b2 * b2 - 8.0 * static_cast<double>(idx))) / 2.0);
  r = r < 0 ? 0 : r >= nt ? nt - 1 : r;
  while (r > 0 && row_start(r, nt) > idx) --r;
  while (r + 1 < nt && row_start(r + 1, nt) <= idx) ++r;
  const int64_t c = r + (idx - row_start(r, nt));

  const int t = threadIdx.x;
  const int i = static_cast<int>(r) * TILE + t, j = static_cast<int>(c) * TILE + t;
  const int64_t frame = blockIdx.y;
  const uint8_t* vd = valid + frame * k;
  const float* bx = boxes + frame * k * 7;
  const bool row_valid = i < k && vd[i] != 0;
  if (!__syncthreads_or(row_valid)) return;
  const bool col_valid = j < k && vd[j] != 0;
  const unsigned ballot = __ballot_sync(kFull, col_valid);
  if ((t & 31) == 0) col_bits[t >> 5] = ballot;
  if (t == 0) n_pairs = 0;
  if (row_valid) load_candidate(bx, i, quad[0][t], disc[0][t]);
  if (col_valid) load_candidate(bx, j, quad[1][t], disc[1][t]);
  __syncthreads();

  // row i against the valid columns after it: the clear pairs decided here,
  // the near ones listed
  u64 bits = 0;
  if (row_valid) {
    u64 cols = static_cast<u64>(col_bits[1]) << 32 | col_bits[0];
    if (r == c) cols &= t == TILE - 1 ? 0ull : ~0ull << (t + 1);
    const float4 di = disc[0][t];
    while (cols) {
      const int u = __ffsll(static_cast<long long>(cols)) - 1;
      cols &= cols - 1;
      if (clear(di, disc[1][u])) {
        if (0.f > thresh) bits |= 1ull << u;
      } else {
        pairs[atomicAdd(&n_pairs, 1)] = static_cast<uint16_t>(t << 6 | u);
      }
    }
  }
  word[t] = bits;
  __syncthreads();
  const int n = n_pairs;
  for (int p = t; p < n; p += TILE) {
    const int a = pairs[p] >> 6, u = pairs[p] & 63;
    if (iou(quad[0][a], disc[0][a].w, quad[1][u], disc[1][u].w) > thresh)
      atomicOr(&word[a], 1ull << u);
  }
  __syncthreads();
  if (i < k) mask[(frame * k + i) * tiles + c] = word[t];
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return static_cast<u64>(hi) << 32 | lo;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid, int k,
                 int tiles, int max_keep, uint8_t* __restrict__ keep) {
  extern __shared__ u64 sm[];
  u64* live = sm;                   // the valid bits, a word a tile
  u64* removed = live + tiles;      // bits suppressed by tiles before the last one resolved
  u64* kept = removed + tiles;      // the kept bits
  __shared__ int kept_rows[2][TILE];  // the rows kept in a tile, double-buffered
  __shared__ int n_kept_rows[2];
  __shared__ int stop[2];  // whether max_keep was reached, double-buffered like them
  __shared__ int last;

  const int64_t frame = blockIdx.x;
  const u64* fm = mask + frame * k * tiles;
  const uint8_t* vd = valid + frame * k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) last = -1;
  for (int w = threadIdx.x; w < tiles; w += SWEEP_THREADS) removed[w] = 0, kept[w] = 0;
  __syncthreads();
  for (int h = warp; h < 2 * tiles; h += SWEEP_THREADS / 32) {  // 32 candidates a warp
    const int j = 32 * h + lane;
    const unsigned bits = __ballot_sync(kFull, j < k && vd[j] != 0);
    if (lane == 0) {
      reinterpret_cast<unsigned*>(live)[h] = bits;  // the low half of word h / 2 first
      if (bits) atomicMax(&last, h / 2);
    }
  }
  __syncthreads();
  const int last_tile = last;

  // warp 0: lane l holds rows 64 t + l and 64 t + 32 + l of tile t, their
  // words of tile t (d) and tile t + 1 (nx), and tile t + 1's (pd, pn)
  u64 d[2] = {0, 0}, nx[2] = {0, 0}, pd[2] = {0, 0}, pn[2] = {0, 0};
  auto fetch = [&](int t, u64 (&dw)[2], u64 (&nw)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = TILE * t + 32 * h + lane;
      const u64* words = fm + static_cast<int64_t>(row) * tiles;
      dw[h] = row < k ? __ldg(words + t) : 0ull;
      nw[h] = row < k && t + 1 < tiles ? __ldg(words + t + 1) : 0ull;
    }
  };
  u64 fast = 0;  // warp 0: the bits of tile t suppressed by tile t - 1's kept rows
  int n_kept = 0;
  if (warp == 0 && last_tile >= 0) fetch(0, d, nx);

  for (int t = 0; t <= last_tile; ++t) {
    const int buf = t & 1;
    if (warp == 0) {
      if (t < last_tile) fetch(t + 1, pd, pn);
      u64 open = live[t] & ~(removed[t] | fast);
      u64 taken = 0;
      while (open && n_kept < max_keep) {
        const int i = __ffsll(static_cast<long long>(open)) - 1;
        taken |= 1ull << i;
        ++n_kept;
        const u64 di = __shfl_sync(kFull, i < 32 ? d[0] : d[1], i & 31);
        open &= ~(di | 1ull << i);
      }
      fast = warp_or(((taken >> lane) & 1 ? nx[0] : 0ull) |
                     ((taken >> (32 + lane)) & 1 ? nx[1] : 0ull));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 32 * h + lane;
        if ((taken >> b) & 1)
          kept_rows[buf][__popcll(taken & ((1ull << b) - 1))] = TILE * t + b;
      }
      if (lane == 0) {
        kept[t] = taken;
        n_kept_rows[buf] = __popcll(taken);
        stop[buf] = n_kept >= max_keep;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) d[h] = pd[h], nx[h] = pn[h];
    } else if (t > 0) {
      // tile t - 1's kept rows: their words of tiles t + 1 .. last_tile
      const int nr = n_kept_rows[buf ^ 1], nw = last_tile - t;
      const int total = nr * nw;
      for (int p0 = threadIdx.x - 32; p0 < total; p0 += UNROLL * HELPERS) {
        u64 v[UNROLL];
        int w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int p = p0 + u * HELPERS;
          v[u] = 0;
          w[u] = 0;
          if (p < total) {
            const int row = kept_rows[buf ^ 1][p / nw];
            w[u] = t + 1 + p % nw;
            v[u] = __ldg(fm + static_cast<int64_t>(row) * tiles + w[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (v[u]) atomicOr(&removed[w[u]], v[u]);
      }
    }
    __syncthreads();
    if (stop[buf]) break;
  }
  uint8_t* out = keep + frame * k;
  for (int j = threadIdx.x; j < k; j += SWEEP_THREADS) out[j] = (kept[j >> 6] >> (j & 63)) & 1;
}

// the shared memory nms_sweep needs beyond 48 KB is granted once per device
// (so that a call inside a CUDA graph capture makes no attribute call)
cudaError_t raise_sweep_smem() {
  static int raised[MAX_DEVICES] = {};
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < MAX_DEVICES && raised[device])) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  if ((err = cudaFuncGetAttributes(&attr, nms_sweep_kernel)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && device < MAX_DEVICES) raised[device] = 1;
  return err;
}

}  // namespace

// boxes: (b, k, 7) float32 [x, y, z, dx, dy, dz, heading], score-sorted per
// frame, contiguous. valid: (b, k) bool (one byte each). mask: (b, k, tiles)
// 64-bit words, tiles = ceil(k / 64): the words of every row tile holding a
// valid candidate, at and after its own tile, are written (see the notes
// above). b at most 65,535, k * tiles under 2^31. Returns the launch's
// cudaError_t.
extern "C" int nms_mask(const void* boxes, const void* valid, int b, int k, float thresh,
                        void* mask, void* stream) {
  if (b == 0 || k == 0) return cudaSuccess;
  const int64_t tiles = (static_cast<int64_t>(k) + TILE - 1) / TILE;
  if (b < 0 || k < 0 || b > 65535 || k * tiles >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles * (tiles + 1) / 2), static_cast<unsigned>(b));
  nms_mask_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), k,
      static_cast<int>(tiles), thresh, static_cast<u64*>(mask));
  return cudaGetLastError();
}

// mask: nms_mask's words for (b, k) candidates; valid: (b, k) bool. keep:
// (b, k) bool, every element written: the greedy keep set of each frame, at
// most max_keep entries. Returns the launch's cudaError_t.
extern "C" int nms_sweep(const void* mask, const void* valid, int b, int k, int max_keep,
                         void* keep, void* stream) {
  if (b == 0 || k == 0) return cudaSuccess;
  const int64_t tiles = (static_cast<int64_t>(k) + TILE - 1) / TILE;
  if (b < 0 || k < 0 || max_keep < 0 || k * tiles >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const size_t smem = 3 * tiles * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_sweep_smem();
    if (err != cudaSuccess) return err;
  }
  nms_sweep_kernel<<<b, SWEEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid), k,
      static_cast<int>(tiles), max_keep, static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
