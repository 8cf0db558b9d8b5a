// Row scatter-add for Hopper (sm_90a): destination-binned, one warp per
// destination row and channel chunk, with no atomics.
//
// Replaces the TPU prototype _bench_scatter_pallas.py::pallas_scatter
// (pallas_call :86), which adds every update row into a zeroed table:
//
//   out[idx[j], :] += rows[j, :]    for j = 0 .. n-1,
//
// holding the whole table in VMEM and adding one row at a time. That cannot
// be carried over: a table of the benchmark's g8 case (16,048 x 768) is
// 49 MB in f32, and its rows are hot (about 198 updates land on each, 50 in
// the g4 case), so atomics onto the table serialize where they meet.
//
// Design: invert the scatter. The glue (ops/row_scatter.py::row_scatter_bins)
// sorts the update indices, stable in j (`order`), and gives each
// destination row its run in `order` as CSR offsets (`start`, num_rows + 1
// entries); indices outside the table sort last, past start[num_rows], and
// are never read. One warp owns one destination row and one chunk of
// 32 * V channels; each lane owns V consecutive channels, loaded as one
// access of up to 16 bytes. The warp walks the row's run in batches of
// UNROLL updates, the next batch's entries of `order` loading while the
// current batch's rows are in flight, sums them in f32 in j order, rounds
// once and writes the row once. Rows with no update are written as zeros,
// so nothing is zeroed beforehand and the result is the same bit for bit
// from run to run.
//
// Bound on an H100: bytes. Every update row and index is read once and
// every table row written once; each update row is read by exactly one warp
// (its destination's, one per channel chunk it spans), `order` once per
// chunk. A destination that receives most updates serializes on its warp;
// the benchmark's windowed indices spread them over every row of a window.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one destination row and chunk each
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;     // update rows in flight per warp

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
  const void* rows;        // (n, c) update rows
  const int32_t* order;    // (n,) updates sorted by destination, in-range ones first
  const int32_t* start;    // (num_rows + 1,) each destination's run in order
  void* out;               // (num_rows, c) table
  int num_rows, c, chunks; // chunks of 32 * V channels per row
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) row_scatter_add_kernel(const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  if (item >= static_cast<int64_t>(p.num_rows) * p.chunks) return;
  const int r = static_cast<int>(item / p.chunks);
  const int ch = static_cast<int>(item % p.chunks) * 32 * V + lane * V;
  const bool live = ch < p.c;
  const int ch_ld = live ? ch : 0;  // lanes past the last channel load channel 0, write nothing
  const T* rows = static_cast<const T*>(p.rows);
  const int k0 = __ldg(p.start + r), k1 = __ldg(p.start + r + 1);

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  int q[UNROLL];
  if (k0 < k1) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(p.order + min(k0 + u, k1 - 1));
  }
  // batches of UNROLL updates (a short last batch repeats its last update
  // and adds nothing for it)
  for (int k = k0; k < k1; k += UNROLL) {
    Pack<T, V> g[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      g[u] = *reinterpret_cast<const Pack<T, V>*>(rows + static_cast<int64_t>(q[u]) * p.c + ch_ld);
    const int n = min(UNROLL, k1 - k);
    if (k + UNROLL < k1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(p.order + min(k + UNROLL + u, k1 - 1));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += to_f32(g[u].v[v]);
      }
    }
  }
  if (!live) return;
  Pack<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(acc[v]);
  *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(p.out) + static_cast<int64_t>(r) * p.c + ch) = o;
}

template <typename T, int V>
cudaError_t launch(Params p, cudaStream_t stream) {
  p.chunks = (p.c + 32 * V - 1) / (32 * V);
  const int64_t blocks = (static_cast<int64_t>(p.num_rows) * p.chunks + WARPS - 1) / WARPS;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  row_scatter_add_kernel<T, V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The widest access (up to 16 bytes) whose channel count divides c.
template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  if (p.c % W == 0) return launch<T, W>(p, stream);
  if (p.c % (W / 2) == 0) return launch<T, W / 2>(p, stream);
  if constexpr (W >= 4) {
    if (p.c % (W / 4) == 0) return launch<T, W / 4>(p, stream);
  }
  return launch<T, 1>(p, stream);
}

}  // namespace

// rows: (n, c) update rows, contiguous, 16-byte aligned. order: (n,) int32
// and start: (num_rows + 1,) int32, the bins of
// ops/row_scatter.py::row_scatter_bins. out: (num_rows, c) in rows' dtype,
// 16-byte aligned; every element is written. dtype: 0 float32, 1 bfloat16,
// 2 float16. Returns the launch's cudaError_t.
extern "C" int row_scatter_add(const void* rows, const void* order, const void* start,
                               void* out, int num_rows, int c, int dtype, void* stream) {
  Params p = {};
  p.rows = rows;
  p.order = static_cast<const int32_t*>(order);
  p.start = static_cast<const int32_t*>(start);
  p.out = out;
  p.num_rows = num_rows;
  p.c = c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, s);
    case 1: return dispatch<__nv_bfloat16>(p, s);
    case 2: return dispatch<__half>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
