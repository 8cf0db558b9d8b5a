// Depth-weighted frustum sampler for Hopper (sm_90a): the forward and the
// depth distribution's gradient.
//
// Replaces no TPU kernel: the JAX package computes this function with XLA,
// hgsfusion_tpu/models/frustum.py::FrustumToVoxelMultiScale._sample_with_depth
// (USE_DEPTH), the reference's trilinear grid_sample of the frustum volume
// F[c, d, h, w] = probs[d, h, w] * feat[c, h, w] with align_corners=True and
// zeros padding, without building the volume. It is the gather view's
// heaviest operation on that path, so it runs on kernels like every other
// sampler of the view. For query j with grid row (u, v, z) (normalized) on an
// NHWC map (B, H, W, C) and its depth distribution (B, H, W, D):
//
//   dc = (z + 1) / 2 (D - 1), d0 = floor(dc), td = dc - d0 (rounded to T),
//   a0 = (1 - td) [d0 in 0..D-1], a1 = td [d0 + 1 in 0..D-1],
//   pd_t = a0 probs[p_t, d0] + a1 probs[p_t, d0 + 1],
//   out[j, :] = sum_t w_t pd_t feat[p_t, :],
//
// where p_t and w_t are the bilinear taps and weights of (u, v), computed as
// quad_sample.cu computes them (quad_tap, quad_taps.cuh). The products are
// summed in f32 and rounded once to T. JAX gathers all D bins of every tap;
// here a tap with a nonzero weight reads the two bins d0 and d0 + 1 and, if
// w_t pd_t is not 0, its feature row.
//
// quad_sample_depth_fwd: one warp per tile of 32 queries, as quad_sample.cu's
// forward: each lane computes one query's taps, depth lerp and four
// effective weights w_t pd_t (reading the bins itself), and the warp walks
// the tile's (query, 16-byte vector) pairs with K1's combine_tile
// (quad_taps.cuh). Under a gradient the same launch writes, per query, the
// effective weights (what quad_sample_bwd.cu, K2, takes for the features'
// gradient, unchanged) and the key its bins sort by: the flat top-left pixel
// in the zero-padded map, or B (H + 2) (W + 2) for a query that reaches no
// bin.
//
// quad_sample_depth_bwd: the gradient of probs,
//
//   g_probs[p_t, d0] += a0 s_t,  g_probs[p_t, d0 + 1] += a1 s_t,
//   s_t = w_t <g[j, :], feat[p_t, :]>,
//
// deterministic and without atomics. Phase 1 (query order) computes every
// query's four s_t: a warp per 32 queries, four queries in flight, each lane
// two channels of the cotangent row and of the taps' rows, the dot products
// summed over the warp by shuffles; it writes s_t and (a0, a1, d0), 32 B a
// query (on 16-byte vectors: eight lanes a query, three shuffle rounds;
// a query that reaches no bin is skipped). Phase 2 owns the output. An output pixel's entries are the queries
// whose taps include it: in the bins' order (ops/quad_sample.py::csr_bins
// of the keys) two runs, the top-left pixels one row up (taps 3 and 2) and
// the pixel's own row (taps 1 and 0), up to 5,983 entries on a VoD map
// while most pixels have tens. So the work is cut into chunks of CH entry
// visits: a plan (two passes over the pixels: per-block sums, then each
// block's scan after the earlier blocks' sums) reads the bins' starts,
// gives each pixel max(1, ceil(visits / CH)) chunks, numbers them in pixel
// order and lists the pixels of more than one. A warp takes one chunk, its lanes
// 32 visits at a time; the lanes whose bins are equal (__match_any_sync on
// d0) are summed in lane order by the group's first lane, which adds the
// sum to the bin in the warp's shared-memory row of D bins, for d0 and
// then, apart, for d0 + 1 (so no two groups of one step share a bin). A
// pixel of one chunk writes its row; a heavier pixel's chunks write rows of
// a scratch buffer, which a last pass sums per pixel in chunk order. Every
// bin is summed in one fixed order and written once, so two runs agree bit
// for bit.
//
// Bound on an H100: bytes. The forward must read each query's grid row
// (12 B), the map and the probabilities once and write the output (plus
// 20 B a query under a gradient); at the VoD gather maps (3,174,400 queries,
// bf16) the output dominates: 406 MB (64 channels) and 1.22 GB (192). The
// backward must read the cotangent (the same sizes), the grid, the map and
// the bins and write the f32 gradient (20 MB and 5 MB at D = 80); the
// 32 B-a-query scratch between the phases (102 MB) is its own cost.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_taps.cuh"

namespace {

constexpr int THREADS = 128;  // forward and phase 1: 4 warps, one tile each
constexpr int UNROLL = 2;     // forward: pairs a lane reads before it stores
constexpr int QU = 4;         // phase 1: queries in flight a warp
constexpr int CH = 256;           // phase 2: entry visits a chunk
constexpr int PLAN_THREADS = 256;  // phase 2's plan: pixels a block
constexpr int BIN_THREADS = 256;  // phase 2: 8 warps, one chunk (or heavy pixel) each
constexpr int MAX_BINS = 128;     // phase 2's row of bins in shared memory
constexpr unsigned kFull = 0xffffffffu;

// The depth lerp of one query as frustum.py::_sample_with_depth computes it:
// the unnormalisation in f32 without contraction, td rounded to T, 1 - td
// rounded to T; d0 clamped to -1 .. D (only read where a0 or a1 is not 0).
struct DepthLerp {
  int d0;
  float a0, a1;
};

template <typename T>
__device__ __forceinline__ DepthLerp depth_lerp(float cz, int d) {
  const float top = static_cast<float>(d - 1);
  const float dc = __fmul_rn(__fmul_rn(__fadd_rn(cz, 1.0f), 0.5f), top);
  const float f0 = floorf(dc), f1 = __fadd_rn(f0, 1.0f);
  const float td = round_t<T>(__fsub_rn(dc, f0));
  DepthLerp r;
  r.a0 = f0 >= 0.0f && f0 <= top ? round_t<T>(__fsub_rn(1.0f, td)) : 0.0f;
  r.a1 = f1 >= 0.0f && f1 <= top ? td : 0.0f;
  r.d0 = static_cast<int>(fminf(fmaxf(f0, -1.0f), static_cast<float>(d)));
  return r;
}

struct Params {
  const float* grid;  // query j's (u, v, z) at grid[j * stride + 0..2]
  int64_t stride;
  int64_t n;
  int64_t per_frame;  // queries of one frame
  const void* map;    // (B, h, w, c)
  const void* probs;  // (B, h, w, d)
  int h, w, c, d;
  void* out;          // forward: (n, c); backward: (B, h, w, d) f32
  int32_t* key;       // forward: (n,) or null
  float4* w4;         // forward: (n,) effective weights, or null
  const void* ct;     // backward: (n, c) cotangent
  const int32_t* order;  // backward: the bins of the keys
  const int32_t* start;
  float4* rec;        // backward scratch: (n, 2) float4
  int lanes;          // forward: c / V
  int64_t tiles;      // tiles of 32 queries
  int32_t pixels;     // B (h + 2) (w + 2): the key of a query that reaches no bin
};

__device__ __forceinline__ int64_t frame_of(const Params& p, int64_t q) {
  return p.per_frame == p.n ? 0 : q / p.per_frame;
}

// query q's taps: the flat unpadded top-left pixel (frame included), the raw
// weights, the padded top-left pixel and the depth lerp
template <typename T>
__device__ __forceinline__ void query_geometry(const Params& p, int64_t q, int& pix,
                                               float (&w)[4], int32_t& padded, DepthLerp& dl) {
  const float* g = p.grid + q * p.stride;
  const QuadTap qt = quad_tap<T>(__ldg(g), __ldg(g + 1), p.h, p.w);
  dl = depth_lerp<T>(__ldg(g + 2), p.d);
  const int64_t frame = frame_of(p, q);
  pix = static_cast<int>((frame * p.h + qt.yp - 1) * p.w + qt.xp - 1);
  padded = static_cast<int32_t>((frame * (p.h + 2) + qt.yp) * (p.w + 2) + qt.xp);
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = qt.w[t];
}

// the forward's effective weights w_t pd_t of query q, its key and (under a
// gradient) both written out
template <typename T>
__device__ __forceinline__ void depth_weights(const Params& p, int64_t q, int& pix,
                                              float (&we)[4]) {
  float w[4];
  int32_t padded;
  DepthLerp dl;
  query_geometry<T>(p, q, pix, w, padded, dl);
  const T* probs = static_cast<const T*>(p.probs);
  const int offs[4] = {0, 1, p.w, p.w + 1};
  bool any = false;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float pd = 0.0f;
    if (w[t] != 0.0f) {
      any = true;
      const T* row = probs + static_cast<int64_t>(pix + offs[t]) * p.d;
      const float p0 = dl.a0 != 0.0f ? to_f32(row[dl.d0]) : 0.0f;
      const float p1 = dl.a1 != 0.0f ? to_f32(row[dl.d0 + 1]) : 0.0f;
      pd = fmaf(dl.a1, p1, dl.a0 * p0);
    }
    we[t] = w[t] * pd;
  }
  if (p.key != nullptr) {
    p.key[q] = any && (dl.a0 != 0.0f || dl.a1 != 0.0f) ? padded : p.pixels;
    p.w4[q] = make_float4(we[0], we[1], we[2], we[3]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) depth_fwd_kernel(const Params prm) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (tile >= prm.tiles) return;
  const int64_t q0 = tile * 32;
  int my_pix = 0;
  float my_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q0 + lane < prm.n) depth_weights<T>(prm, q0 + lane, my_pix, my_w);
  combine_tile<T, V, UNROLL>(static_cast<const T*>(prm.map), static_cast<T*>(prm.out), prm.n,
                             q0, lane, prm.lanes, prm.w, my_pix, my_w);
}

// Phase 1: s_t = w_t <ct[q], map[p_t]> of every query, and its depth lerp.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) depth_dot_kernel(const Params prm) {
  using P = Pack<T, V>;
  const int lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (tile >= prm.tiles) return;
  const int64_t q0 = tile * 32;
  const T* __restrict__ map = static_cast<const T*>(prm.map);
  const T* __restrict__ ct = static_cast<const T*>(prm.ct);
  const int c = prm.c;

  int my_pix = 0;
  float my_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q0 + lane < prm.n) {
    int32_t padded;
    DepthLerp dl;
    query_geometry<T>(prm, q0 + lane, my_pix, my_w, padded, dl);
    prm.rec[2 * (q0 + lane) + 1] = make_float4(dl.a0, dl.a1, __int_as_float(dl.d0), 0.0f);
  }
  const int offs[4] = {0, 1, prm.w, prm.w + 1};
#pragma unroll 1
  for (int i = 0; i < 32; i += QU) {
    float dot[QU][4];
    float wq[QU][4];
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int64_t q = q0 + i + u;
      const int pix = __shfl_sync(kFull, my_pix, i + u);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wq[u][t] = __shfl_sync(kFull, my_w[t], i + u);
        dot[u][t] = 0.0f;
      }
      if (q >= prm.n) continue;
      for (int ch = lane * V; ch < c; ch += 32 * V) {
        const P g = *reinterpret_cast<const P*>(ct + q * c + ch);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const P f = load_if<T, V>(map + static_cast<int64_t>(pix + offs[t]) * c + ch,
                                    wq[u][t] != 0.0f);
#pragma unroll
          for (int k = 0; k < V; ++k) dot[u][t] = fmaf(to_f32(g.v[k]), to_f32(f.v[k]), dot[u][t]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < QU; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) dot[u][t] += __shfl_xor_sync(kFull, dot[u][t], off);
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int64_t q = q0 + i + u;
      if (lane == i + u && q < prm.n)
        prm.rec[2 * q] = make_float4(wq[u][0] * dot[u][0], wq[u][1] * dot[u][1],
                                     wq[u][2] * dot[u][2], wq[u][3] * dot[u][3]);
    }
  }
}

// Phase 1 on 16-byte vectors (c a multiple of 16 / sizeof(T), the rows
// 16-byte aligned): eight lanes a query, each lane V channels of the
// cotangent row and of the taps' rows a step, four queries a warp at a
// time and two such steps in flight; the dot products summed over the
// eight lanes in three shuffle rounds. A query that reaches no bin (no tap
// weight, or both depth weights 0) is skipped: phase 2 never reads it.
template <typename T>
__global__ void __launch_bounds__(THREADS) depth_dot_vec_kernel(const Params prm) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int lane = threadIdx.x & 31, grp = lane >> 3, sub = lane & 7;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (tile >= prm.tiles) return;
  const int64_t q0 = tile * 32;
  const T* __restrict__ map = static_cast<const T*>(prm.map);
  const T* __restrict__ ct = static_cast<const T*>(prm.ct);
  const int c = prm.c;

  int my_pix = 0;
  float my_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool my_live = false;
  if (q0 + lane < prm.n) {
    int32_t padded;
    DepthLerp dl;
    query_geometry<T>(prm, q0 + lane, my_pix, my_w, padded, dl);
    prm.rec[2 * (q0 + lane) + 1] = make_float4(dl.a0, dl.a1, __int_as_float(dl.d0), 0.0f);
    my_live = (my_w[0] != 0.0f || my_w[1] != 0.0f || my_w[2] != 0.0f || my_w[3] != 0.0f) &&
              (dl.a0 != 0.0f || dl.a1 != 0.0f);
  }
  const int offs[4] = {0, 1, prm.w, prm.w + 1};
#pragma unroll 1
  for (int i = 0; i < 32; i += 8) {
    int pix[2];
    float wq[2][4], dot[2][4];
    bool live[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int src = i + 4 * u + grp;
      pix[u] = __shfl_sync(kFull, my_pix, src);
      live[u] = __shfl_sync(kFull, my_live, src);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wq[u][t] = __shfl_sync(kFull, my_w[t], src);
        dot[u][t] = 0.0f;
      }
    }
    for (int ch = sub * V; ch < c; ch += 8 * V) {
      P g[2], f[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        g[u] = load_if<T, V>(ct + (q0 + i + 4 * u + grp) * c + ch, live[u]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          f[u][t] = load_if<T, V>(map + static_cast<int64_t>(pix[u] + offs[t]) * c + ch,
                                  live[u] && wq[u][t] != 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int k = 0; k < V; ++k)
            dot[u][t] = fmaf(to_f32(g[u].v[k]), to_f32(f[u][t].v[k]), dot[u][t]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) dot[u][t] += __shfl_xor_sync(kFull, dot[u][t], off);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t q = q0 + i + 4 * u + grp;
      if (sub == 0 && live[u])
        prm.rec[2 * q] = make_float4(wq[u][0] * dot[u][0], wq[u][1] * dot[u][1],
                                     wq[u][2] * dot[u][2], wq[u][3] * dot[u][3]);
    }
  }
}

// Phase 2's work list (see the header), in int32 scratch: off (P + 1: a
// pixel's first chunk, off[P] the chunks), chunk_pixel (a chunk's pixel),
// heavy (the pixels of more than one chunk, in order), meta (chunks, heavy
// pixels); and the heavy pixels' chunk rows in f32 scratch.
struct Plan {
  int32_t* off;
  int32_t* chunk_pixel;
  int32_t* heavy;
  int32_t* meta;
  int32_t* sums;  // (2 blocks of the plan): each block's chunks and heavy pixels
  float* rows;    // (chunks, d)
};

// output pixel o's two runs of entries in the bins' order: [a0, a1) the
// top-left pixels one row up (tap 3 before amid, tap 2 from it), [b0, b1)
// its own row (tap 1 before bmid, tap 0 from it)
struct Runs {
  int a0, amid, a1, b0, bmid, b1;
};

__device__ __forceinline__ Runs pixel_runs(const Params& p, int64_t o) {
  const int64_t hw = static_cast<int64_t>(p.h) * p.w;
  const int64_t b = o / hw;
  const int y = static_cast<int>((o % hw) / p.w), x = static_cast<int>(o % p.w);
  const int64_t wp2 = p.w + 2;
  const int64_t pad = (b * (p.h + 2) + y + 1) * wp2 + x + 1;
  Runs r;
  r.a0 = __ldg(p.start + pad - wp2 - 1);
  r.amid = __ldg(p.start + pad - wp2);
  r.a1 = __ldg(p.start + pad - wp2 + 1);
  r.b0 = __ldg(p.start + pad - 1);
  r.bmid = __ldg(p.start + pad);
  r.b1 = __ldg(p.start + pad + 1);
  return r;
}

__device__ __forceinline__ int chunks_of(const Runs& r) {
  const int visits = (r.a1 - r.a0) + (r.b1 - r.b0);
  return visits > CH ? (visits + CH - 1) / CH : 1;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Phase 2's plan, first pass: each block of PLAN_THREADS pixels its
// chunks and heavy pixels, summed (sums[2 block], sums[2 block + 1]).
__global__ void __launch_bounds__(PLAN_THREADS) depth_count_kernel(const Params prm,
                                                                   int64_t outputs, Plan plan) {
  __shared__ int part[2][PLAN_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * PLAN_THREADS + threadIdx.x;
  int c = o < outputs ? chunks_of(pixel_runs(prm, o)) : 0, h = c > 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(kFull, c, off);
    h += __shfl_xor_sync(kFull, h, off);
  }
  if (lane == 0) {
    part[0][warp] = c;
    part[1][warp] = h;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int sum = 0;
    for (int j = 0; j < PLAN_THREADS / 32; ++j) sum += part[threadIdx.x][j];
    plan.sums[2 * blockIdx.x + threadIdx.x] = sum;
  }
}

// Phase 2's plan, second pass: each block adds up the earlier blocks'
// sums, numbers its pixels' chunks and heavy pixels in pixel order and
// writes off, chunk_pixel and heavy; the last block writes off[P] and meta.
__global__ void __launch_bounds__(PLAN_THREADS) depth_plan_kernel(const Params prm,
                                                                  int64_t outputs, Plan plan) {
  __shared__ int part[2][PLAN_THREADS / 32];
  __shared__ int base[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {
    int c = 0, h = 0;
    for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x); j += PLAN_THREADS) {
      c += plan.sums[2 * j];
      h += plan.sums[2 * j + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(kFull, c, off);
      h += __shfl_xor_sync(kFull, h, off);
    }
    if (lane == 0) {
      part[0][warp] = c;
      part[1][warp] = h;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      int sum = 0;
      for (int j = 0; j < PLAN_THREADS / 32; ++j) sum += part[threadIdx.x][j];
      base[threadIdx.x] = sum;
    }
    __syncthreads();
  }
  const int64_t o = static_cast<int64_t>(blockIdx.x) * PLAN_THREADS + threadIdx.x;
  const int c = o < outputs ? chunks_of(pixel_runs(prm, o)) : 0, h = c > 1;
  const int ci = warp_inclusive_sum(c, lane), hi = warp_inclusive_sum(h, lane);
  if (lane == 31) {
    part[0][warp] = ci;
    part[1][warp] = hi;
  }
  __syncthreads();
  int cw = base[0], hw = base[1];  // the chunks and heavy pixels before this warp
  for (int j = 0; j < warp; ++j) {
    cw += part[0][j];
    hw += part[1][j];
  }
  if (o < outputs) {
    const int first = cw + ci - c;
    plan.off[o] = first;
    for (int i = 0; i < c; ++i) plan.chunk_pixel[first + i] = static_cast<int32_t>(o);
    if (h) plan.heavy[hw + hi - 1] = static_cast<int32_t>(o);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == PLAN_THREADS - 1) {
    // the last thread's running totals include every pixel
    plan.off[outputs] = cw + ci;
    plan.meta[0] = cw + ci;
    plan.meta[1] = hw + hi;
  }
}

// the lanes' values `x` for bin `bin` (live lanes with 0 <= bin < d): each
// group of lanes with one bin summed in lane order by its first lane, which
// adds the sum to the warp's row
__device__ __forceinline__ void add_to_bins(float* row, float* vals, bool live, int bin, float x,
                                            int d, int lane) {
  const bool ok = live && bin >= 0 && bin < d;
  const unsigned group = __match_any_sync(kFull, ok ? bin : -1);
  vals[lane] = x;
  __syncwarp();
  if (ok && __ffs(group) - 1 == lane) {
    float sum = 0.0f;
    for (unsigned g = group; g != 0; g &= g - 1) sum += vals[__ffs(g) - 1];
    row[bin] += sum;
  }
  __syncwarp();
}

// Phase 2: one warp per chunk of CH visits of one pixel.
__global__ void __launch_bounds__(BIN_THREADS) depth_bins_kernel(const Params prm, Plan plan) {
  __shared__ float rows[BIN_THREADS / 32][MAX_BINS];
  __shared__ float vals[BIN_THREADS / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (BIN_THREADS / 32) + warp;
  if (c >= __ldg(plan.meta)) return;
  const int o = __ldg(plan.chunk_pixel + c);
  const int first = __ldg(plan.off + o), count = __ldg(plan.off + o + 1) - first;
  const Runs r = pixel_runs(prm, o);
  const int na = r.a1 - r.a0;
  const int v0 = static_cast<int>(c - first) * CH;
  const int v1 = na + r.b1 - r.b0 < v0 + CH ? na + r.b1 - r.b0 : v0 + CH;
  float* row = rows[warp];
  for (int j = lane; j < prm.d; j += 32) row[j] = 0.0f;
  __syncwarp();
  const float* rec = reinterpret_cast<const float*>(prm.rec);
  for (int v = v0; v < v1; v += 32) {
    const int vl = v + lane;
    const bool live = vl < v1;
    int d0 = -1;
    float x0 = 0.0f, x1 = 0.0f;
    if (live) {
      int k, t;
      if (vl < na) {
        k = r.a0 + vl;
        t = k < r.amid ? 3 : 2;
      } else {
        k = r.b0 + (vl - na);
        t = k < r.bmid ? 1 : 0;
      }
      const int64_t q = __ldg(prm.order + k);
      const float st = rec[8 * q + t];
      const float4 z = prm.rec[2 * q + 1];
      x0 = st * z.x;
      x1 = st * z.y;
      d0 = __float_as_int(z.z);
    }
    add_to_bins(row, vals[warp], live, d0, x0, prm.d, lane);
    add_to_bins(row, vals[warp], live, d0 + 1, x1, prm.d, lane);
  }
  float* dst = count == 1 ? static_cast<float*>(prm.out) + static_cast<int64_t>(o) * prm.d
                          : plan.rows + c * prm.d;
  for (int j = lane; j < prm.d; j += 32) dst[j] = row[j];
}

// Phase 2's last pass: a heavy pixel's chunk rows summed in chunk order.
__global__ void __launch_bounds__(BIN_THREADS) depth_merge_kernel(const Params prm, Plan plan) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * (BIN_THREADS / 32) + warp;
  if (h >= __ldg(plan.meta + 1)) return;
  const int o = __ldg(plan.heavy + h);
  const int c0 = __ldg(plan.off + o), c1 = __ldg(plan.off + o + 1);
  float* out = static_cast<float*>(prm.out) + static_cast<int64_t>(o) * prm.d;
  for (int j = lane; j < prm.d; j += 32) {
    float sum = 0.0f;
    for (int c = c0; c < c1; ++c) sum += plan.rows[static_cast<int64_t>(c) * prm.d + j];
    out[j] = sum;
  }
}

template <typename T, int V>
cudaError_t launch_fwd(Params& prm, cudaStream_t stream) {
  prm.lanes = prm.c / V;
  const int64_t blocks = (prm.tiles + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  depth_fwd_kernel<T, V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(Params& prm, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = prm.c % kVec == 0 && reinterpret_cast<uintptr_t>(prm.map) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(prm.out) % 16 == 0;
  return vec ? launch_fwd<T, kVec>(prm, stream) : launch_fwd<T, 1>(prm, stream);
}

// phase 2's work list for n queries over `outputs` pixels: at most outputs
// + 4 n / CH chunks (every pixel one, and one for each further CH of the
// 4 n visits), and 4 n / CH + 1 heavy pixels
int64_t max_chunks(int64_t n, int64_t outputs) { return outputs + (4 * n + CH - 1) / CH; }
int64_t max_heavy(int64_t n) { return (4 * n + CH - 1) / CH + 1; }
int64_t plan_blocks_of(int64_t outputs) { return (outputs + PLAN_THREADS - 1) / PLAN_THREADS; }
// the int32 work list: off, chunk_pixel, heavy, meta, the plan's block sums
int64_t work_entries(int64_t n, int64_t outputs) {
  return outputs + 1 + max_chunks(n, outputs) + max_heavy(n) + 2 + 2 * plan_blocks_of(outputs);
}

template <typename T>
cudaError_t dispatch_bwd(Params& prm, int b, const Plan& plan, cudaStream_t stream) {
  const int64_t blocks = (prm.tiles + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const bool pair = prm.c % 2 == 0 && reinterpret_cast<uintptr_t>(prm.map) % (2 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(prm.ct) % (2 * sizeof(T)) == 0;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = prm.c % kVec == 0 && reinterpret_cast<uintptr_t>(prm.map) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(prm.ct) % 16 == 0;
  if (prm.n > 0) {
    if (vec)
      depth_dot_vec_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
    else if (pair)
      depth_dot_kernel<T, 2><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
    else
      depth_dot_kernel<T, 1><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t outputs = static_cast<int64_t>(b) * prm.h * prm.w;
  constexpr int kWarps = BIN_THREADS / 32;
  const int64_t chunk_blocks = (max_chunks(prm.n, outputs) + kWarps - 1) / kWarps;
  const int64_t merge_blocks = (max_heavy(prm.n) + kWarps - 1) / kWarps;
  if (chunk_blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const unsigned plan_blocks = static_cast<unsigned>(plan_blocks_of(outputs));
  depth_count_kernel<<<plan_blocks, PLAN_THREADS, 0, stream>>>(prm, outputs, plan);
  depth_plan_kernel<<<plan_blocks, PLAN_THREADS, 0, stream>>>(prm, outputs, plan);
  depth_bins_kernel<<<static_cast<unsigned>(chunk_blocks), BIN_THREADS, 0, stream>>>(prm, plan);
  depth_merge_kernel<<<static_cast<unsigned>(merge_blocks), BIN_THREADS, 0, stream>>>(prm, plan);
  return cudaGetLastError();
}

bool bad_shape(int64_t stride, int64_t n, int64_t per_frame, int b, int h, int w, int c, int d) {
  return n < 0 || per_frame < 1 || b < 1 || h < 1 || w < 1 || c < 1 || d < 1 ||
         d > MAX_BINS || stride < 3 || n > b * per_frame ||
         static_cast<int64_t>(b) * (h + 2) * (w + 2) >= (int64_t{1} << 31);
}

}  // namespace

// grid: query j's (u, v, z) at grid[j * stride + 0..2], f32; n queries,
// per_frame of them a frame. map: (b, h, w, c) and probs: (b, h, w, d),
// contiguous, in the data type; d <= 128. out: (n, c) in the data type.
// key_out, w4_out: both null, or (n,) int32 and (n, 4) f32 (16-byte aligned):
// the bins' keys and the effective tap weights for the backward. dtype:
// 0 float32, 1 bfloat16, 2 float16. Returns the launch's cudaError_t.
extern "C" int quad_sample_depth_fwd(const void* grid, int64_t stride, int64_t n,
                                     int64_t per_frame, const void* map, const void* probs, int b,
                                     int h, int w, int c, int d, void* out, void* key_out,
                                     void* w4_out, int dtype, void* stream) {
  if (bad_shape(stride, n, per_frame, b, h, w, c, d) ||
      (key_out == nullptr) != (w4_out == nullptr) ||
      reinterpret_cast<uintptr_t>(w4_out) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params prm{};
  prm.grid = static_cast<const float*>(grid);
  prm.stride = stride;
  prm.n = n;
  prm.per_frame = per_frame;
  prm.map = map;
  prm.probs = probs;
  prm.h = h;
  prm.w = w;
  prm.c = c;
  prm.d = d;
  prm.out = out;
  prm.key = static_cast<int32_t*>(key_out);
  prm.w4 = static_cast<float4*>(w4_out);
  prm.tiles = (n + 31) / 32;
  prm.pixels = static_cast<int32_t>(static_cast<int64_t>(b) * (h + 2) * (w + 2));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_fwd<float>(prm, s);
    case 1: return dispatch_fwd<__nv_bfloat16>(prm, s);
    case 2: return dispatch_fwd<__half>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}

// grid, n, per_frame, map: as for quad_sample_depth_fwd. ct: (n, c)
// cotangent of its output, contiguous, in the data type. order: (n,) and
// start: (b (h + 2) (w + 2) + 1,) int32, the bins of the forward's keys
// (ops/quad_sample.py::csr_bins). rec: scratch of n x 32 bytes, 16-byte
// aligned. work: int32 scratch of work_len >= quad_sample_depth_bwd_work(n,
// b, h, w) entries; rows: f32 scratch of rows_len >= that entry's `chunks`
// times d. out: (b, h, w, d) f32, every element written. Returns the
// launches' cudaError_t.
extern "C" int quad_sample_depth_bwd(const void* grid, int64_t stride, int64_t n,
                                     int64_t per_frame, const void* map, const void* ct,
                                     const void* order, const void* start, void* rec, void* work,
                                     int64_t work_len, void* rows, int64_t rows_len, int b,
                                     int h, int w, int c, int d, void* out, int dtype,
                                     void* stream) {
  const int64_t outputs = static_cast<int64_t>(b) * h * w;
  if (bad_shape(stride, n, per_frame, b, h, w, c, d) ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0 ||
      work_len < work_entries(n, outputs) || plan_blocks_of(outputs) > 2147483647LL ||
      rows_len < max_chunks(n, outputs) * d || max_chunks(n, outputs) >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  Plan plan;
  plan.off = static_cast<int32_t*>(work);
  plan.chunk_pixel = plan.off + outputs + 1;
  plan.heavy = plan.chunk_pixel + max_chunks(n, outputs);
  plan.meta = plan.heavy + max_heavy(n);
  plan.sums = plan.meta + 2;
  plan.rows = static_cast<float*>(rows);
  Params prm{};
  prm.grid = static_cast<const float*>(grid);
  prm.stride = stride;
  prm.n = n;
  prm.per_frame = per_frame;
  prm.map = map;
  prm.h = h;
  prm.w = w;
  prm.c = c;
  prm.d = d;
  prm.out = out;
  prm.ct = ct;
  prm.order = static_cast<const int32_t*>(order);
  prm.start = static_cast<const int32_t*>(start);
  prm.rec = static_cast<float4*>(rec);
  prm.tiles = (n + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_bwd<float>(prm, b, plan, s);
    case 1: return dispatch_bwd<__nv_bfloat16>(prm, b, plan, s);
    case 2: return dispatch_bwd<__half>(prm, b, plan, s);
    default: return cudaErrorInvalidValue;
  }
}

// The int32 entries of quad_sample_depth_bwd's work list for n queries over
// a (b, h, w) map; `chunks`: its chunk rows, each of d floats.
extern "C" int64_t quad_sample_depth_bwd_work(int64_t n, int b, int h, int w, int64_t* chunks) {
  const int64_t outputs = static_cast<int64_t>(b) * h * w;
  *chunks = max_chunks(n, outputs);
  return work_entries(n, outputs);
}
