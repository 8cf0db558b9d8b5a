// The sampler's tap computation, shared by quad_sample.cu (K1),
// quad_sample_reduce.cu (P3) and quad_sample_depth.cu: the conversions
// between the data types and f32, and each query's top-left tap and four
// weights computed from its sampling coordinates bit for bit as
// ops/grid_sample.py::quad_taps and ops/quad_sample.py::quad_indices compute
// them; and the tile walk that K1 and the depth forward share
// (combine_tile), which gathers and combines a warp's 32 queries' taps,
// from a map in the data type or, for F2V QUANT int8, in int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
// (only ever given 0: the zero an int8 map reads outside its taps)
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

// x rounded to T (to nearest, ties to even) and back
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f32<T>(from_f32<T>(x));
}
// One query's taps on a map of h x w pixels: the top-left tap (yp, xp) in
// the zero-padded (h + 2) x (w + 2) map and the weights (w00, w01, w10, w11),
// each operation of ops/grid_sample.py::quad_taps in its own rounding: the
// unnormalisation in f32 without contraction, tx and ty rounded to T, every
// weight operation rounded to T (the 0/1 masks multiply exactly).
struct QuadTap {
  int yp, xp;
  float w[4];
};

template <typename T>
__device__ __forceinline__ QuadTap quad_tap(float cx, float cy, int h, int w) {
  const float ix = __fmul_rn(__fmul_rn(__fadd_rn(cx, 1.0f), 0.5f), static_cast<float>(w - 1));
  const float iy = __fmul_rn(__fmul_rn(__fadd_rn(cy, 1.0f), 0.5f), static_cast<float>(h - 1));
  const float ix0 = floorf(ix), iy0 = floorf(iy);
  const float ix1 = __fadd_rn(ix0, 1.0f), iy1 = __fadd_rn(iy0, 1.0f);
  const float tx = round_t<T>(__fsub_rn(ix, ix0)), ty = round_t<T>(__fsub_rn(iy, iy0));
  const float sx = round_t<T>(__fsub_rn(1.0f, tx)), sy = round_t<T>(__fsub_rn(1.0f, ty));
  const float wm = static_cast<float>(w - 1), hm = static_cast<float>(h - 1);
  const bool mx0 = ix0 >= 0.0f && ix0 <= wm, mx1 = ix1 >= 0.0f && ix1 <= wm;
  const bool my0 = iy0 >= 0.0f && iy0 <= hm, my1 = iy1 >= 0.0f && iy1 <= hm;
  QuadTap q;
  q.xp = static_cast<int>(fminf(fmaxf(ix1, 0.0f), static_cast<float>(w)));
  q.yp = static_cast<int>(fminf(fmaxf(iy1, 0.0f), static_cast<float>(h)));
  q.w[0] = mx0 && my0 ? round_t<T>(__fmul_rn(sx, sy)) : 0.0f;
  q.w[1] = mx1 && my0 ? round_t<T>(__fmul_rn(tx, sy)) : 0.0f;
  q.w[2] = mx0 && my1 ? round_t<T>(__fmul_rn(sx, ty)) : 0.0f;
  q.w[3] = mx1 && my1 ? round_t<T>(__fmul_rn(tx, ty)) : 0.0f;
  return q;
}

// V consecutive channels of one pixel, moved as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the V channels at p where pred, zeros elsewhere; a 16-byte pack (and an
// int8 pack of 8 or 4 bytes) is one predicated load through the read-only
// path, so no branch splits a batch
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
  } else if constexpr (std::is_same_v<T, int8_t> && sizeof(Pack<T, V>) == 8) {
    uint2 u = make_uint2(0u, 0u);
    asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
        "@p ld.global.nc.v2.u32 {%0, %1}, [%2];\n\t}"
        : "+r"(u.x), "+r"(u.y)
        : "l"(p), "r"(static_cast<int>(pred)));
    r = *reinterpret_cast<const Pack<T, V>*>(&u);
  } else if constexpr (std::is_same_v<T, int8_t> && sizeof(Pack<T, V>) == 4) {
    uint32_t u = 0u;
    asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "@p ld.global.nc.u32 %0, [%1];\n\t}"
        : "+r"(u)
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

// One warp's tile of 32 consecutive queries from q0 (n in all), each lane
// holding one query's flat unpadded top-left pixel and four weights (a tap
// with weight 0 is not read): out[q, :] = sum_t w_t map[tap_t(q), :] over
// an (h, w, c) map (c = L V) of type M (T, or int8 for an unscaled int8
// payload), summed in f32 in the order w00 t00, w01 t01, w10 t10, w11 t11
// with fused multiply-adds and rounded once to T. The warp hands
// the taps out by shuffles and walks the tile's 32 x L (query, vector)
// pairs 32 at a time, neighbouring lanes on neighbouring vectors, each lane
// reading UNROLL pairs' taps before it combines and stores them (streaming
// stores, so the output does not evict the map from L2).
template <typename T, int V, int UNROLL, typename M = T>
__device__ __forceinline__ void combine_tile(const M* __restrict__ map, T* __restrict__ out,
                                             int64_t n, int64_t q0, int lane, int L, int w,
                                             int my_pix, const float (&my_w)[4]) {
  using P = Pack<T, V>;
  using PM = Pack<M, V>;
  constexpr unsigned kAll = 0xffffffffu;
  const int c = L * V;
  const int64_t row = static_cast<int64_t>(w) * c;
  // steps 0 .. L - 1; pair s * 32 + lane is vector v of the tile's query ql
  int ql = lane / L, v = lane - ql * L;
  const int dq = 32 / L, dv = 32 - dq * L;

#pragma unroll 1
  for (int s = 0; s < L; s += UNROLL) {
    PM t[UNROLL][4];
    float wt[UNROLL][4];
    int64_t dst[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t q = q0 + ql;
      ok[u] = s + u < L && q < n;
      const int pix = __shfl_sync(kAll, my_pix, ql);
#pragma unroll
      for (int k = 0; k < 4; ++k) wt[u][k] = __shfl_sync(kAll, my_w[k], ql);
      const int64_t at = static_cast<int64_t>(pix) * c + static_cast<int64_t>(v) * V;
      t[u][0] = load_if<M, V>(map + at, ok[u] && wt[u][0] != 0.0f);
      t[u][1] = load_if<M, V>(map + at + c, ok[u] && wt[u][1] != 0.0f);
      t[u][2] = load_if<M, V>(map + at + row, ok[u] && wt[u][2] != 0.0f);
      t[u][3] = load_if<M, V>(map + at + row + c, ok[u] && wt[u][3] != 0.0f);
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
}  // namespace
