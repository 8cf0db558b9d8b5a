// Quad bilinear sampler fused with the view transform's reduce product, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _bench_gather_pallas.py::pallas_gather_combine_matmul
// (:162), the Pallas prototype of the gather view's forward reduce
// (hgsfusion_tpu/models/frustum.py: quad-sample each gather group, then
// einsum with the group's rows of the 1x1x1 conv kernel into an f32
// accumulator). For G gather groups (1 <= G <= 4), each a zero-padded NHWC
// map fp_g (B, H_g+2, W_g+2, c_g) with its per-query top-left pixel idx_g and
// tap weights w4_g (ops/quad_sample.py::quad_indices), it computes
//
//   out[j, :] = bias + sum_g round_T( sum_tap w4_g[j, tap] * fp_g[tap(idx_g[j])] )
//                            @ K[off_g : off_g + c_g, :]
//
// with the four taps summed in f32 and rounded once to the map's type T, as
// quad_sample_fwd does (csrc/quad_sample.cu), and every product of the
// reduce exact in f32 and summed in f32, as models/layers.py::matmul_f32
// does. The sampled (N, c_g) tensors never reach device memory.
//
// Bound on an H100: bytes. Each query reads 4 B of index and 16 B of weights
// per group and writes O f32 outputs once; the maps (14 MB at the flagship
// shapes) are read once from device memory and then from L2. At the flagship
// shapes (N = 3,174,400 queries, c = 64 and 192, O = 128) that is 127 MB +
// 14 MB + 1.625 GB, about 0.53 ms at 3.35 TB/s, against 208 GFLOP of bf16
// products (0.21 ms at 989 TFLOP/s).
//
// Design (simple first): a block of 256 threads owns BM = 64 queries and
// BN = 128 outputs (grid.y walks a wider O), three blocks to an SM. For each
// group and each chunk of KC channels its threads start every load of the
// chunk first (the taps and K's rows, 16 bytes each), then combine the taps
// into a shared tile (BM x KC, type T) and stage the matching KC x BN rows
// of K beside it; bf16 and f16 then take the tensor cores (wmma 16x16x16
// fragments, f32 accumulators held in registers across every group and
// chunk), f32 an FMA loop in f32 (tensor cores would mean TF32). Channels
// past c_g and outputs past O are zeros in shared memory, and rows past N
// and outputs past O are masked on the store. The output goes out once,
// bias added, with streaming stores so it does not evict the maps from L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 4;
constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64;         // queries per block
constexpr int BN = 128;        // outputs per block
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM the registers are capped for (80 each)

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

// V consecutive channels, moved as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Shared tiles per type: KC channels per chunk, leading dimensions (the
// 16-bit tiles padded by 8 elements against bank conflicts; wmma needs
// multiples of 8 and 32-byte aligned fragment starts, which these keep).
template <typename T> struct Tile {
  static constexpr bool kMma = true;
  static constexpr int KC = 64, LDA = KC + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int kBytesAB = (BM * LDA + KC * LDB) * static_cast<int>(sizeof(T));
  static constexpr int kBytesC = BM * LDC * 4;
  static constexpr int kBytes = kBytesAB > kBytesC ? kBytesAB : kBytesC;
};
template <> struct Tile<float> {
  static constexpr bool kMma = false;
  static constexpr int KC = 32, LDA = KC, LDB = BN;
  static constexpr int kBytes = (BM * LDA + KC * LDB) * 4;
};

struct Group {
  const void* fp;
  const int32_t* idx;
  const float4* w4;
  int64_t row_pixels;  // W + 2
  int c;
  int k_off;
  int vec;  // 16-byte tap loads (c a multiple of the vector, fp aligned)
};

struct Params {
  Group g[kMaxGroups];
  int groups;
  const void* k;  // (sum c, o), row-major
  const float* bias;
  float* out;  // (n, o)
  int64_t n;
  int o;
  int k_vec;    // 16-byte loads of K's rows
  int out_vec;  // float4 stores
};

// A thread's share of the block's (BM x KC) tile of sampled channels
// [kc, kc + KC) of group gr: every load is started first, at a clamped
// position where the query or channel is past the end (its result is
// zeroed), so the loads of a chunk are in flight together.
template <typename T, int V>
struct TapTile {
  static constexpr int KC = Tile<T>::KC, LDA = Tile<T>::LDA, kPerRow = KC / V;
  static constexpr int kItems = BM * kPerRow / kThreads;
  using P = Pack<T, V>;
  P t[kItems][4];
  float4 w[kItems];
  bool live[kItems];

  __device__ __forceinline__ void load(const Group& gr, int kc, int rows, const int32_t* s_idx,
                                       const float4* s_w4) {
    const T* fp = static_cast<const T*>(gr.fp);
    const int64_t c = gr.c, rp = gr.row_pixels;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = threadIdx.x + it * kThreads;
      const int q = item / kPerRow;
      const int ch = kc + (item % kPerRow) * V;
      live[it] = q < rows && ch < c;
      const int64_t p = live[it] ? s_idx[q] : 0;
      const T* base = fp + p * c + (live[it] ? ch : 0);
      w[it] = s_w4[q];
      t[it][0] = *reinterpret_cast<const P*>(base);
      t[it][1] = *reinterpret_cast<const P*>(base + c);
      t[it][2] = *reinterpret_cast<const P*>(base + rp * c);
      t[it][3] = *reinterpret_cast<const P*>(base + (rp + 1) * c);
    }
  }

  // the four taps summed in f32 and rounded once, into the shared tile
  __device__ __forceinline__ void store(T* as) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = threadIdx.x + it * kThreads;
      const int q = item / kPerRow, col = (item % kPerRow) * V;
      P r;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float acc = w[it].x * to_f32(t[it][0].v[k]);
        acc = fmaf(w[it].y, to_f32(t[it][1].v[k]), acc);
        acc = fmaf(w[it].z, to_f32(t[it][2].v[k]), acc);
        acc = fmaf(w[it].w, to_f32(t[it][3].v[k]), acc);
        r.v[k] = from_f32<T>(live[it] ? acc : 0.0f);
      }
      *reinterpret_cast<P*>(as + q * LDA + col) = r;
    }
  }
};

// A thread's share of rows [off + kc, off + kc + KC) and columns
// [o0, o0 + BN) of K, zeros past the group's channels and past O; loads
// first, as TapTile.
template <typename T, int V>
struct KTile {
  static constexpr int KC = Tile<T>::KC, LDB = Tile<T>::LDB, kPerRow = BN / V;
  static constexpr int kItems = KC * kPerRow / kThreads;
  using P = Pack<T, V>;
  P v[kItems];
  bool live[kItems];

  __device__ __forceinline__ void load(const Params& prm, const Group& gr, int kc, int o0) {
    const T* k = static_cast<const T*>(prm.k);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = threadIdx.x + it * kThreads;
      const int r = item / kPerRow, col = (item % kPerRow) * V;
      live[it] = kc + r < gr.c && o0 + col < prm.o;
      const int64_t at = live[it] ? static_cast<int64_t>(gr.k_off + kc + r) * prm.o + o0 + col : 0;
      v[it] = *reinterpret_cast<const P*>(k + at);
    }
  }

  __device__ __forceinline__ void store(T* bs) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = threadIdx.x + it * kThreads;
      const int r = item / kPerRow, col = (item % kPerRow) * V;
      P z = v[it];
      if (!live[it]) {
#pragma unroll
        for (int e = 0; e < V; ++e) z.v[e] = from_f32<T>(0.0f);
      }
      *reinterpret_cast<P*>(bs + r * LDB + col) = z;
    }
  }
};

// The ragged paths (channels or outputs not a multiple of the vector): one
// element per item, loaded and stored in turn, so their registers stay few.
template <typename T>
__device__ __forceinline__ void gather_chunk_ragged(const Group& gr, int kc, int rows,
                                                    const int32_t* s_idx, const float4* s_w4,
                                                    T* as) {
  constexpr int KC = Tile<T>::KC, LDA = Tile<T>::LDA;
  const T* fp = static_cast<const T*>(gr.fp);
  const int64_t c = gr.c, rp = gr.row_pixels;
  for (int item = threadIdx.x; item < BM * KC; item += kThreads) {
    const int q = item / KC, col = item % KC;
    float acc = 0.0f;
    if (q < rows && kc + col < c) {
      const T* base = fp + s_idx[q] * c + kc + col;
      const float4 w = s_w4[q];
      acc = w.x * to_f32(base[0]);
      acc = fmaf(w.y, to_f32(base[c]), acc);
      acc = fmaf(w.z, to_f32(base[rp * c]), acc);
      acc = fmaf(w.w, to_f32(base[(rp + 1) * c]), acc);
    }
    as[q * LDA + col] = from_f32<T>(acc);
  }
}

template <typename T>
__device__ __forceinline__ void load_k_chunk_ragged(const Params& prm, const Group& gr, int kc,
                                                    int o0, T* bs) {
  constexpr int KC = Tile<T>::KC, LDB = Tile<T>::LDB;
  const T* k = static_cast<const T*>(prm.k);
  for (int item = threadIdx.x; item < KC * BN; item += kThreads) {
    const int r = item / BN, col = item % BN;
    const bool live = kc + r < gr.c && o0 + col < prm.o;
    bs[r * LDB + col] =
        live ? k[static_cast<int64_t>(gr.k_off + kc + r) * prm.o + o0 + col] : from_f32<T>(0.0f);
  }
}

// Stages chunk kc of group gr: its sampled tile into as, K's rows into bs.
// The 16-byte paths start all their loads first (TapTile, KTile).
template <typename T>
__device__ __forceinline__ void stage_chunk(const Params& prm, const Group& gr, int kc, int o0,
                                            int rows, const int32_t* s_idx, const float4* s_w4,
                                            T* as, T* bs) {
  constexpr int V = 16 / sizeof(T);
  if (gr.vec && prm.k_vec) {
    KTile<T, V> kt;
    TapTile<T, V> tt;
    kt.load(prm, gr, kc, o0);
    tt.load(gr, kc, rows, s_idx, s_w4);
    tt.store(as);
    kt.store(bs);
    return;
  }
  if (gr.vec) {
    TapTile<T, V> tt;
    tt.load(gr, kc, rows, s_idx, s_w4);
    tt.store(as);
  } else {
    gather_chunk_ragged<T>(gr, kc, rows, s_idx, s_w4, as);
  }
  if (prm.k_vec) {
    KTile<T, V> kt;
    kt.load(prm, gr, kc, o0);
    kt.store(bs);
  } else {
    load_k_chunk_ragged<T>(prm, gr, kc, o0, bs);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
quad_sample_reduce_kernel(const Params prm) {
  using Tl = Tile<T>;
  constexpr int KC = Tl::KC, LDA = Tl::LDA, LDB = Tl::LDB;
  __shared__ __align__(128) unsigned char smem[Tl::kBytes];
  __shared__ int32_t s_idx[BM];
  __shared__ float4 s_w4[BM];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + BM * LDA;

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int o0 = blockIdx.y * BN;
  const int rows = static_cast<int>(prm.n - q0 < BM ? prm.n - q0 : BM);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // accumulators: the MMA path keeps 2x2 16x16 fragments per warp (a 2x4
  // grid of 32x32 warp tiles); the FMA path 8 rows x 4 columns per thread
  // (rows warp + 8 i, columns lane + 32 j)
  using namespace nvcuda;
  using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  AccFrag acc[2][2];
  float facc[8][4];
  if constexpr (Tl::kMma) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
  }
  const int wr = warp / 4, wc = warp % 4;

  for (int g = 0; g < prm.groups; ++g) {
    const Group& gr = prm.g[g];
    __syncthreads();  // the previous chunk's reads of the tiles and indices are done
    if (tid < BM) {
      const bool live = tid < rows;
      s_idx[tid] = live ? gr.idx[q0 + tid] : 0;
      s_w4[tid] = live ? gr.w4[q0 + tid] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int kc = 0; kc < gr.c; kc += KC) {
      stage_chunk<T>(prm, gr, kc, o0, rows, s_idx, s_w4, as, bs);
      __syncthreads();
      if constexpr (Tl::kMma) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], as + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], bs + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = to_f32(as[(warp + 8 * i) * LDA + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = to_f32(bs[k * LDB + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  float* out = prm.out;
  const int64_t o = prm.o;
  if constexpr (Tl::kMma) {
    // the fragments go through shared memory (over the A and B tiles) so
    // the store is row by row, bias added, masked at the edges
    constexpr int LDC = Tl::LDC;
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j], LDC,
                                wmma::mem_row_major);
    __syncthreads();
    if (prm.out_vec) {
      constexpr int kPerRow = BN / 4;
      for (int e = tid; e < BM * kPerRow; e += kThreads) {
        const int r = e / kPerRow, col = (e % kPerRow) * 4;
        if (r < rows && o0 + col < o) {
          float4 v = *reinterpret_cast<const float4*>(cs + r * LDC + col);
          const float4 bv = *reinterpret_cast<const float4*>(prm.bias + o0 + col);
          v.x += bv.x;
          v.y += bv.y;
          v.z += bv.z;
          v.w += bv.w;
          __stcs(reinterpret_cast<float4*>(out + (q0 + r) * o + o0 + col), v);
        }
      }
    } else {
      for (int e = tid; e < BM * BN; e += kThreads) {
        const int r = e / BN, col = e % BN;
        if (r < rows && o0 + col < o)
          __stcs(out + (q0 + r) * o + o0 + col, cs[r * LDC + col] + prm.bias[o0 + col]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = o0 + lane + 32 * j;
        if (r < rows && col < o) __stcs(out + (q0 + r) * o + col, facc[i][j] + prm.bias[col]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(Params& prm, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  for (int g = 0; g < prm.groups; ++g) {
    Group& gr = prm.g[g];
    gr.vec = gr.c % V == 0 && reinterpret_cast<uintptr_t>(gr.fp) % 16 == 0;
  }
  prm.k_vec = prm.o % V == 0 && reinterpret_cast<uintptr_t>(prm.k) % 16 == 0;
  prm.out_vec = prm.o % 4 == 0 && reinterpret_cast<uintptr_t>(prm.out) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(prm.bias) % 16 == 0;
  const int64_t blocks = (prm.n + BM - 1) / BM;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((prm.o + BN - 1) / BN));
  quad_sample_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// groups: G in [1, 4]. For group g: fps[g] its zero-padded map
// (B, H+2, W+2, cs[g]) in the compute type, contiguous, 16-byte aligned;
// idxs[g] (n,) int32 flat top-left pixel of each query in it; w4s[g] (n, 4)
// f32 tap weights; row_pixels[g] = W + 2; k_offs[g] its first row of kmat.
// kmat: (sum of cs, o) in the compute type, contiguous. bias: (o,) f32.
// out: (n, o) f32. dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns the launch's cudaError_t.
extern "C" int quad_sample_reduce_fwd(const void* const* fps, const void* const* idxs,
                                      const void* const* w4s, const int64_t* row_pixels,
                                      const int* cs, const int* k_offs, int groups,
                                      const void* kmat, const void* bias, void* out, int64_t n,
                                      int o, int dtype, void* stream) {
  if (groups < 1 || groups > kMaxGroups || o < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params prm{};
  prm.groups = groups;
  for (int g = 0; g < groups; ++g) {
    if (cs[g] < 1 || k_offs[g] < 0) return cudaErrorInvalidValue;
    prm.g[g] = Group{fps[g], static_cast<const int32_t*>(idxs[g]),
                     static_cast<const float4*>(w4s[g]), row_pixels[g], cs[g], k_offs[g], 0};
  }
  prm.k = kmat;
  prm.bias = static_cast<const float*>(bias);
  prm.out = static_cast<float*>(out);
  prm.n = n;
  prm.o = o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(prm, s);
    case 1: return launch<__nv_bfloat16>(prm, s);
    case 2: return launch<__half>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}
