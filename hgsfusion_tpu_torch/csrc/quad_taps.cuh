// The sampler's tap computation, shared by quad_sample.cu (K1) and
// quad_sample_reduce.cu (P3): the conversions between the data types and
// f32, and each query's top-left tap and four weights computed from its
// sampling coordinates bit for bit as ops/grid_sample.py::quad_taps and
// ops/quad_sample.py::quad_indices compute them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

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
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

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
}  // namespace
