// Quad bilinear sampler forward for Hopper (sm_90a).
//
// Replaces the TPU kernels hgsfusion_tpu/ops/pallas_sample.py::_gather_combine
// (rows layout) and ::_gather_combine_planes (planes layout), whose function
// the prototypes _bench_gather_pallas.py::pallas_gather_combine,
// ::pallas_gather_combine_planes and ::pallas_gather_combine_windowed share.
// For n queries with sampling coordinates uv (normalized (x, y), read in
// place at one row stride) on an unpadded NHWC map (B, H, W, c) it computes
//
//   out[j, :] = sum_tap w_tap(j) * tap_row(j, tap)
//
// where the taps of query j are the 2x2 pixel patch around uv[j] in frame
// j / per_frame and their weights the bilinear weights with the zeros
// padding folded in (grid_sample.py::grid_sample_2d_quad, _quad_pass). The
// taps are computed here from uv, bit for bit as ops/quad_sample.py::
// quad_indices computes them (quad_tap, quad_taps.cuh); a tap outside the map
// has weight 0, so no padded map is needed. The TPU kernels gather from a 4x
// quad table kept in VMEM; here a tap row is read straight from the map, and
// only where its weight is not 0: a query whose four weights are 0 reads
// nothing and writes zeros. The four taps are summed in f32 in the order
// w00 t00, w01 t01, w10 t10, w11 t11 with fused multiply-adds and rounded once
// to the data type. When idx_out and w4_out are given, the same launch also
// writes what the backward kernel takes (quad_indices' result: the flat
// top-left pixel in the zero-padded (B, H + 2, W + 2) map, int32, and the four
// weights, f32).
//
// Bound on an H100: bytes. The function must read each query's (x, y) (8 B)
// and the map once, and write the output (plus 20 B a query of idx and w4
// when a gradient is taken). At the VoD gather maps (3,174,400 queries; maps
// of 8.0 and 6.0 MB in bf16, all resident in the 50 MB L2) the output
// dominates: 406 MB (64 ch) and 1.22 GB (192 ch). The polar view's calls are
// short: 198,400 or 96,000 queries, 25-51 MB written, and only about 4% of
// the near field's queries carry a weight.
//
// Design. A warp owns a tile of 32 consecutive queries. Each lane computes
// the taps of one query of the tile and the warp hands them out by shuffles;
// the tile's 32 x (c / V) (query, 16-byte vector) pairs are then walked 32 at
// a time, neighbouring lanes on neighbouring vectors of one query's rows, so
// every access is a full 16-byte vector and the lanes of a query read whole
// rows. A lane reads UNROLL pairs' taps (predicated loads through the
// read-only path, one after another) before it combines and stores them;
// stores are streaming (st.global.cs) so the output does not evict the map
// from L2. Channels that are not a multiple of 16 bytes, or a map or output
// that is not 16-byte aligned, take the same walk with one element a pair.
//
// Measured on an H100 (tune_quad_fwd.py, bf16; PERF.md): one pair in
// flight a lane (UNROLL = 1) took 1.01-1.11x as long, four 1.05-1.16x; 256
// threads a block 1.02-1.06x at the gather maps. Two designs were tried and
// dropped: every lane of a query computing its taps instead of the shuffles
// took 1.36-1.50x as long, and splitting a tile's steps over more warps for
// the short polar calls (each warp computing the tile's taps again) made them
// 5-31% slower: with 3,000-6,200 tiles a call the card already holds enough
// loads in flight.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_taps.cuh"

namespace {

// tuning constants (tune_quad_fwd.py rebuilds the kernel with others)
constexpr int THREADS = 128;  // threads a block
constexpr int UNROLL = 2;     // pairs a lane reads before it stores

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = THREADS / 32;

struct Params {
  const float* uv;  // query j's (x, y) at uv[j * uv_stride], uv[j * uv_stride + 1]
  int64_t uv_stride;
  int64_t n;
  int64_t per_frame;  // queries of one frame: query j samples frame j / per_frame
  const void* map;    // (B, h, w, c), contiguous
  int h, w, c;
  void* out;      // (n, c)
  int32_t* idx;   // (n,) or null
  float4* w4;     // (n,) or null
  int lanes;      // c / V: the pairs of one query
  int64_t tiles;  // tiles of 32 queries, one a warp
};

// V consecutive channels of one pixel, moved as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the V channels at p where pred, zeros elsewhere; a 16-byte pack is one
// predicated load through the read-only path, so no branch splits a batch
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_if(const T* p, bool pred) {
  Pack<T, V> r;
  if constexpr (sizeof(Pack<T, V>) == 16) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
        "@p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "+r"(u.x), "+r"(u.y), "+r"(u.z), "+r"(u.w)
        : "l"(p), "r"(static_cast<int>(pred)));
    r = *reinterpret_cast<const Pack<T, V>*>(&u);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = pred ? p[k] : from_f32<T>(0.0f);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_streaming(Pack<T, V>* dst, const Pack<T, V>& val) {
  if constexpr (sizeof(Pack<T, V>) == 16) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(&val));
  } else {
    *dst = val;
  }
}

// query q's taps: the flat unpadded pixel of its top-left tap (frame
// included; outside the map where that tap's weight is 0) and the four
// weights; its idx and w4 written where the caller asks for them
template <typename T>
__device__ __forceinline__ void query_taps(const Params& prm, int64_t q, int& pix,
                                           float (&w)[4]) {
  const float* p = prm.uv + q * prm.uv_stride;
  const QuadTap qt = quad_tap<T>(__ldg(p), __ldg(p + 1), prm.h, prm.w);
  const int64_t frame = prm.per_frame == prm.n ? 0 : q / prm.per_frame;
  pix = static_cast<int>((frame * prm.h + qt.yp - 1) * prm.w + qt.xp - 1);
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = qt.w[t];
  if (prm.idx != nullptr) {
    prm.idx[q] = static_cast<int32_t>((frame * (prm.h + 2) + qt.yp) * (prm.w + 2) + qt.xp);
    prm.w4[q] = make_float4(qt.w[0], qt.w[1], qt.w[2], qt.w[3]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) quad_sample_fwd_kernel(const Params prm) {
  using P = Pack<T, V>;
  const int lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (tile >= prm.tiles) return;
  const int64_t q0 = tile * 32;
  const T* __restrict__ map = static_cast<const T*>(prm.map);
  T* __restrict__ out = static_cast<T*>(prm.out);
  const int L = prm.lanes, c = prm.c;
  const int64_t row = static_cast<int64_t>(prm.w) * c;

  // this lane's query of the tile
  int my_pix = 0;
  float my_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q0 + lane < prm.n) query_taps<T>(prm, q0 + lane, my_pix, my_w);

  // steps 0 .. L - 1; pair s * 32 + lane is vector v of the tile's query ql
  int ql = lane / L, v = lane - ql * L;
  const int dq = 32 / L, dv = 32 - dq * L;

#pragma unroll 1
  for (int s = 0; s < L; s += UNROLL) {
    P t[UNROLL][4];
    float wt[UNROLL][4];
    int64_t dst[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t q = q0 + ql;
      ok[u] = s + u < L && q < prm.n;
      const int pix = __shfl_sync(kFull, my_pix, ql);
#pragma unroll
      for (int k = 0; k < 4; ++k) wt[u][k] = __shfl_sync(kFull, my_w[k], ql);
      const int64_t at = static_cast<int64_t>(pix) * c + static_cast<int64_t>(v) * V;
      t[u][0] = load_if<T, V>(map + at, ok[u] && wt[u][0] != 0.0f);
      t[u][1] = load_if<T, V>(map + at + c, ok[u] && wt[u][1] != 0.0f);
      t[u][2] = load_if<T, V>(map + at + row, ok[u] && wt[u][2] != 0.0f);
      t[u][3] = load_if<T, V>(map + at + row + c, ok[u] && wt[u][3] != 0.0f);
      dst[u] = q * c + static_cast<int64_t>(v) * V;
      ql += dq;
      v += dv;
      if (v >= L) {
        v -= L;
        ++ql;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      P r;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float acc = wt[u][0] * to_f32(t[u][0].v[k]);
        acc = fmaf(wt[u][1], to_f32(t[u][1].v[k]), acc);
        acc = fmaf(wt[u][2], to_f32(t[u][2].v[k]), acc);
        acc = fmaf(wt[u][3], to_f32(t[u][3].v[k]), acc);
        r.v[k] = from_f32<T>(acc);
      }
      store_streaming(reinterpret_cast<P*>(out + dst[u]), r);
    }
  }
}

template <typename T, int V>
cudaError_t launch(Params& prm, cudaStream_t stream) {
  prm.lanes = prm.c / V;
  prm.tiles = (prm.n + 31) / 32;
  const int64_t blocks = (prm.tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  quad_sample_fwd_kernel<T, V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Params& prm, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = prm.c % kVec == 0 && reinterpret_cast<uintptr_t>(prm.map) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(prm.out) % 16 == 0;
  return vec ? launch<T, kVec>(prm, stream) : launch<T, 1>(prm, stream);
}

}  // namespace

// uv: query j's (x, y) at uv[j * uv_stride] and uv[j * uv_stride + 1], f32;
// n queries, per_frame of them a frame (n = b * per_frame). map: (b, h, w, c)
// unpadded, contiguous, in the data type. out: (n, c) in the data type.
// idx_out, w4_out: both null, or (n,) int32 and (n, 4) f32 (16-byte
// aligned) for quad_indices' result. dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns the launch's cudaError_t.
extern "C" int quad_sample_fwd(const void* uv, int64_t uv_stride, int64_t n, int64_t per_frame,
                               const void* map, int b, int h, int w, int c, void* out,
                               void* idx_out, void* w4_out, int dtype, void* stream) {
  if (n < 0 || per_frame < 1 || b < 1 || h < 1 || w < 1 || c < 1 || uv_stride < 2 ||
      n > b * per_frame || (idx_out == nullptr) != (w4_out == nullptr) ||
      reinterpret_cast<uintptr_t>(w4_out) % 16 != 0 ||
      static_cast<int64_t>(b) * (h + 2) * (w + 2) >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params prm{};
  prm.uv = static_cast<const float*>(uv);
  prm.uv_stride = uv_stride;
  prm.n = n;
  prm.per_frame = per_frame;
  prm.map = map;
  prm.h = h;
  prm.w = w;
  prm.c = c;
  prm.out = out;
  prm.idx = static_cast<int32_t*>(idx_out);
  prm.w4 = static_cast<float4*>(w4_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(prm, s);
    case 1: return dispatch<__nv_bfloat16>(prm, s);
    case 2: return dispatch<__half>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}
