// Quad bilinear sampler backward for Hopper (sm_90a).
//
// Replaces the TPU kernels hgsfusion_tpu/ops/pallas_sample.py::_scatter_outer
// (rows layout) and ::_scatter_outer_planes (planes layout), together with the
// routing of their quad-table cotangent back onto the map (_unshift). Both
// layouts compute one function, the adjoint of quad_sample_fwd's four tap
// reads:
//
//   acc[p_tap(j), :] += w4[j, tap] * ct[j, :]   for every query j and tap,
//
// where the taps of query j are the 2x2 patch of the zero-padded NHWC map whose
// top-left pixel is idx[j]: p, p + 1, p + W + 2, p + W + 3. The TPU kernels
// accumulate into a 4x quad table kept in VMEM, in the cotangent's dtype, and
// _unshift then adds its four tap blocks onto the map. Here every query adds
// straight onto an f32 accumulator shaped like the padded map,
// (B, H+2, W+2, c); the caller zeroes it, then crops the ring and rounds once
// to the feature dtype. At the flagship shapes it is 16.3 MB (64 ch, map
// 131x486) and 12.6 MB (192 ch, 67x244), so it stays in the 50 MB L2 cache.
//
// Bound on an H100: bytes. Each of the 3,174,400 queries reads c cotangent
// elements, 4 B of index and 16 B of weights; the accumulator is written once.
// That is 406 MB + 63.5 MB + 16.3 MB (64 ch) and 1219 MB + 63.5 MB + 12.6 MB
// (192 ch): 0.145 ms and 0.387 ms at 3.35 TB/s. The f32 adds (N * 4 * c:
// 0.81 G and 2.44 G) are far below the card's rate.
//
// Design: a group of c/V threads serves one query; each thread loads V
// cotangent channels as one access and issues one vector atomicAdd (float4 or
// float2, which compute capability 9.x has for global memory) per tap; a
// width that is not a multiple of 2 falls to the scalar atomicAdd. A tap whose
// weight is 0 (out of the image) adds nothing and is skipped.
//
// Caveat, contention: neighbouring queries in (Y, X, Z) voxel order land on the
// same pixels (about 50 queries per pixel at 64 ch and 200 at 192 ch), and
// atomics on one address serialize in L2, so this kernel is expected to run
// far from its byte bound. The order of the f32 adds changes from run to run:
// results agree within rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

// V consecutive channels of one query, loaded as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// dst[0:V] += w * g[0:V], as one vector atomic where V allows.
template <int V>
__device__ __forceinline__ void atomic_add_scaled(float* dst, const float* g, float w);

template <>
__device__ __forceinline__ void atomic_add_scaled<4>(float* dst, const float* g, float w) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
}
template <>
__device__ __forceinline__ void atomic_add_scaled<2>(float* dst, const float* g, float w) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(w * g[0], w * g[1]));
}
template <>
__device__ __forceinline__ void atomic_add_scaled<1>(float* dst, const float* g, float w) {
  atomicAdd(dst, w * g[0]);
}

// blockDim.x = c / V threads per query, blockDim.y queries per block.
template <typename T, int V>
__global__ void quad_sample_bwd_kernel(const T* __restrict__ ct, const int32_t* __restrict__ idx,
                                       const float4* __restrict__ w4, float* __restrict__ acc,
                                       int64_t n, int c, int64_t row_pixels) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (q >= n) return;
  const int64_t ch = static_cast<int64_t>(threadIdx.x) * V;
  const int64_t p = idx[q];
  const float4 w = w4[q];
  const Pack<T, V> raw = *reinterpret_cast<const Pack<T, V>*>(ct + q * c + ch);
  float g[V];
#pragma unroll
  for (int k = 0; k < V; ++k) g[k] = to_f32(raw.v[k]);
  const int64_t taps[4] = {p, p + 1, p + row_pixels, p + row_pixels + 1};
  const float wt[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (wt[t] != 0.f) atomic_add_scaled<V>(acc + taps[t] * c + ch, g, wt[t]);
  }
}

template <typename T, int V>
cudaError_t launch(const void* ct, const void* idx, const void* w4, void* acc, int64_t n, int c,
                   int64_t row_pixels, cudaStream_t stream) {
  const int lanes = c / V;
  if (lanes > 1024) return cudaErrorInvalidConfiguration;
  const int per_block = lanes >= 256 ? 1 : 256 / lanes;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  dim3 block(lanes, per_block);
  quad_sample_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), block, 0, stream>>>(
      static_cast<const T*>(ct), static_cast<const int32_t*>(idx),
      static_cast<const float4*>(w4), static_cast<float*>(acc), n, c, row_pixels);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* ct, const void* idx, const void* w4, void* acc, int64_t n, int c,
                     int64_t row_pixels, cudaStream_t stream) {
  if (c % 4 == 0) return launch<T, 4>(ct, idx, w4, acc, n, c, row_pixels, stream);
  if (c % 2 == 0) return launch<T, 2>(ct, idx, w4, acc, n, c, row_pixels, stream);
  return launch<T, 1>(ct, idx, w4, acc, n, c, row_pixels, stream);
}

}  // namespace

// ct: (n, c) cotangent, contiguous, 16-byte aligned. idx: (n,) int32 flat pixel
// index of each query's top-left tap in the padded map. w4: (n, 4) f32 tap
// weights. acc: (B, H+2, W+2, c) f32, zeroed by the caller, 16-byte aligned.
// row_pixels = W + 2. dtype of ct: 0 float32, 1 bfloat16, 2 float16. Returns
// the launch's cudaError_t.
extern "C" int quad_sample_bwd(const void* ct, const void* idx, const void* w4, void* acc,
                               int64_t n, int c, int64_t row_pixels, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(ct, idx, w4, acc, n, c, row_pixels, s);
    case 1: return dispatch<__nv_bfloat16>(ct, idx, w4, acc, n, c, row_pixels, s);
    case 2: return dispatch<__half>(ct, idx, w4, acc, n, c, row_pixels, s);
    default: return cudaErrorInvalidValue;
  }
}
