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
// query. Phase 2 owns the output: one warp per pixel, each lane ceil(D / 32)
// bins in registers. It walks the queries that reach the pixel in the bins'
// order (ops/quad_sample.py::csr_bins of the keys: the runs of the four
// top-left pixels whose taps include it), 32 entries loaded at a time and
// handed out by shuffles, each adding to its two bins. Every bin is summed in
// one fixed order and written once, so two runs agree bit for bit.
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
constexpr int BIN_THREADS = 256;  // phase 2: 8 warps, one pixel each
constexpr int MAX_BINS = 128;     // phase 2 keeps ceil(D / 32) <= 4 bins a lane
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

// Phase 2: one warp per output pixel, NB bins a lane.
template <int NB>
__global__ void __launch_bounds__(BIN_THREADS) depth_bins_kernel(const Params prm,
                                                                  int64_t outputs) {
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * (BIN_THREADS / 32) + (threadIdx.x >> 5);
  if (o >= outputs) return;
  const int64_t hw = static_cast<int64_t>(prm.h) * prm.w;
  const int64_t b = o / hw;
  const int y = static_cast<int>((o % hw) / prm.w), x = static_cast<int>(o % prm.w);
  const int64_t wp2 = prm.w + 2;
  const int64_t padded = (b * (prm.h + 2) + y + 1) * wp2 + x + 1;
  const int64_t tl[4] = {padded, padded - 1, padded - wp2, padded - wp2 - 1};
  const float* rec = reinterpret_cast<const float*>(prm.rec);
  float acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int k1 = __ldg(prm.start + tl[t] + 1);
    for (int k = __ldg(prm.start + tl[t]); k < k1; k += 32) {
      int d0 = -2;
      float v0 = 0.0f, v1 = 0.0f;
      if (k + lane < k1) {
        const int64_t q = __ldg(prm.order + k + lane);
        const float s = rec[8 * q + t];
        const float4 z = prm.rec[2 * q + 1];
        v0 = s * z.x;
        v1 = s * z.y;
        d0 = __float_as_int(z.z);
      }
      const int cnt = min(32, k1 - k);
      for (int i = 0; i < cnt; ++i) {
        const int di = __shfl_sync(kFull, d0, i);
        const float x0 = __shfl_sync(kFull, v0, i), x1 = __shfl_sync(kFull, v1, i);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int bin = lane + 32 * j;
          if (bin == di) acc[j] += x0;
          if (bin == di + 1) acc[j] += x1;
        }
      }
    }
  }
  float* out = static_cast<float*>(prm.out) + o * prm.d;
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (lane + 32 * j < prm.d) out[lane + 32 * j] = acc[j];
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

template <int NB>
cudaError_t launch_bins(const Params& prm, int64_t outputs, cudaStream_t stream) {
  const int64_t blocks = (outputs + BIN_THREADS / 32 - 1) / (BIN_THREADS / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  depth_bins_kernel<NB><<<static_cast<unsigned>(blocks), BIN_THREADS, 0, stream>>>(prm, outputs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(Params& prm, int b, cudaStream_t stream) {
  const int64_t blocks = (prm.tiles + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const bool pair = prm.c % 2 == 0 && reinterpret_cast<uintptr_t>(prm.map) % (2 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(prm.ct) % (2 * sizeof(T)) == 0;
  if (prm.n > 0) {
    if (pair)
      depth_dot_kernel<T, 2><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
    else
      depth_dot_kernel<T, 1><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t outputs = static_cast<int64_t>(b) * prm.h * prm.w;
  switch ((prm.d + 31) / 32) {
    case 1: return launch_bins<1>(prm, outputs, stream);
    case 2: return launch_bins<2>(prm, outputs, stream);
    case 3: return launch_bins<3>(prm, outputs, stream);
    default: return launch_bins<4>(prm, outputs, stream);
  }
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
// aligned. out: (b, h, w, d) f32, every element written. Returns the
// launches' cudaError_t.
extern "C" int quad_sample_depth_bwd(const void* grid, int64_t stride, int64_t n,
                                     int64_t per_frame, const void* map, const void* ct,
                                     const void* order, const void* start, void* rec, int b,
                                     int h, int w, int c, int d, void* out, int dtype,
                                     void* stream) {
  if (bad_shape(stride, n, per_frame, b, h, w, c, d) ||
      reinterpret_cast<uintptr_t>(rec) % 16 != 0)
    return cudaErrorInvalidValue;
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
    case 0: return dispatch_bwd<float>(prm, b, s);
    case 1: return dispatch_bwd<__nv_bfloat16>(prm, b, s);
    case 2: return dispatch_bwd<__half>(prm, b, s);
    default: return cudaErrorInvalidValue;
  }
}
