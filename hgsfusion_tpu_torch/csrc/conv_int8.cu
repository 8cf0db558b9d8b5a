// int8 x int8 -> int32 implicit-GEMM convolution with a per-output-channel
// rescale, for Hopper (sm_90a).
//
// The convolution of DDN QUANT w8a8 (the JAX package's
// hgsfusion_tpu/models/resnet.py::QConv8, :75-86: lax.conv_general_dilated
// on int8 operands with an int32 result). It replaces no TPU kernel: XLA
// compiles that convolution. For an NHWC int8 input x (B, H, W, C), int8
// weights w (O, Kp) whose row o holds the kernel's (ky, kx, c) values in
// that order (K = kh kw C of them, zeros up to Kp, a multiple of 32), the
// per-tensor activation scale ax and the per-output-channel weight scales
// wk, it computes
//
//   out[b, oy, ox, o] = round_T( f32(sum_{ky, kx, c} x[b, iy, ix, c] w[o, ky, kx, c])
//                                * (ax * wk[o]) )
//
// with iy = oy sh - ph + ky dh and ix = ox sw - pw + kx dw (zero outside the
// map): the sum exact in int32 (|sum| <= 127^2 K < 2^31 for K <= 133,144),
// its conversion to f32 and the two products rounded to nearest as the
// JAX package's `out.astype(f32) * (ax * wk)`, the result rounded once to T.
// So the output is bit for bit JAX's.
//
// Bound on an H100: at the VoD backbone's shapes most convolutions are
// bound by operations (2 M N K int8 operations at 1,979 TOP/s), the 1x1
// convolutions of the wide stages by bytes; chip_smoke.py computes both for
// each shape.
//
// Design (a first kernel: mma.sync, not wgmma). The GEMM is M = B Ho Wo
// output pixels by N = O channels by K, walked 32 bytes of K at a time. A
// block of 256 threads (8 warps, 2 x 4) computes a 128 x 128 tile, each warp
// 64 x 32 with mma.sync m16n8k32 s8 into int32 registers. A 4-stage cp.async
// ring in shared memory holds the A tile (the im2col rows of 128 output
// pixels: each thread copies one 16-byte piece of one row, the piece's
// position in the input computed from its tap, zero-filled in the padding
// and past M) and the B tile (128 weight rows); the two 16-byte pieces of a
// 32-byte row are swapped on rows 4-7 of every 8, so ldmatrix (which loads
// the int8 fragments as 8 x 16-byte rows) meets no bank conflict. Channels
// that are not a multiple of 16 (the stem's 3) take byte loads into the
// same stages, each byte's tap computed on its own. The epilogue converts,
// rescales and stores two outputs a thread and row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output pixels a block
constexpr int BN = 128;     // output channels a block
constexpr int BK = 32;      // bytes of K a stage
constexpr int kStages = 4;  // stages of the ring
constexpr int kThreads = 256;
constexpr int kTileBytes = BM * BK;  // one operand's tile in a stage: 4 KB

struct Params {
  const int8_t* x;   // (b, h, w, c), contiguous
  const int8_t* wt;  // (o, kp), contiguous
  const float* ax;   // (1,): the activation's scale
  const float* wk;   // (o,): the weights' scales
  void* out;         // (b, ho, wo, o) in T
  int b, h, w, c, o;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int ho, wo;
  int k, kp;  // K = kh kw c, and K rounded up to a multiple of BK
  int64_t m;  // b ho wo
};

template <typename T> __device__ __forceinline__ T to_out(float x);
template <> __device__ __forceinline__ float to_out<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half to_out<__half>(float x) { return __float2half_rn(x); }

// byte offset of 16-byte piece `half` of row r in a tile of 32-byte rows
__device__ __forceinline__ int tile_offset(int r, int half) {
  return r * BK + ((half ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  // src-size 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this thread's A row: its output pixel's frame row base and top-left input
// position, or m past the end
struct Row {
  int64_t frame_row;  // n * h
  int iy0, ix0;
  bool live;
};

// VEC: c a multiple of 16 and x 16-byte aligned, so a 16-byte piece of K
// lies inside one tap
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) conv2d_w8a8_kernel(const __grid_constant__ Params prm) {
  __shared__ __align__(128) unsigned char a_tile[kStages][kTileBytes];
  __shared__ __align__(128) unsigned char b_tile[kStages][kTileBytes];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // the row and piece this thread copies into each stage
  const int lrow = tid >> 1, lhalf = tid & 1;
  Row ar;
  {
    const int64_t m = m0 + lrow;
    ar.live = m < prm.m;
    const int64_t mm = ar.live ? m : 0;
    const int ox = static_cast<int>(mm % prm.wo);
    const int64_t t = mm / prm.wo;
    const int oy = static_cast<int>(t % prm.ho);
    const int64_t n = t / prm.ho;
    ar.frame_row = n * prm.h;
    ar.iy0 = oy * prm.sh - prm.ph;
    ar.ix0 = ox * prm.sw - prm.pw;
  }
  const int brow_n = n0 + lrow;
  const int8_t* b_src = prm.wt + static_cast<int64_t>(brow_n < prm.o ? brow_n : 0) * prm.kp;
  const int taps = prm.kh * prm.kw;
  const int kb_count = prm.kp / BK;

  auto load = [&](int stage, int kb) {
    const int k = kb * BK + lhalf * 16;
    const uint32_t dst = smem_addr(&a_tile[stage][tile_offset(lrow, lhalf)]);
    if constexpr (VEC) {
      const int tap = k / prm.c, c0 = k - tap * prm.c;
      const int ky = tap / prm.kw, kx = tap - ky * prm.kw;
      const int iy = ar.iy0 + ky * prm.dh, ix = ar.ix0 + kx * prm.dw;
      const bool ok = ar.live && tap < taps && iy >= 0 && iy < prm.h && ix >= 0 && ix < prm.w;
      const int8_t* src = ok ? prm.x + ((ar.frame_row + iy) * prm.w + ix) * prm.c + c0 : prm.x;
      cp_async16(dst, src, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const int ke = k + e;
        if (!ar.live || ke >= prm.k) continue;
        const int tap = ke / prm.c, ch = ke - tap * prm.c;
        const int ky = tap / prm.kw, kx = tap - ky * prm.kw;
        const int iy = ar.iy0 + ky * prm.dh, ix = ar.ix0 + kx * prm.dw;
        if (iy < 0 || iy >= prm.h || ix < 0 || ix >= prm.w) continue;
        const uint32_t byte =
            static_cast<uint8_t>(prm.x[((ar.frame_row + iy) * prm.w + ix) * prm.c + ch]);
        v[e >> 2] |= byte << (8 * (e & 3));
      }
      *reinterpret_cast<uint4*>(&a_tile[stage][tile_offset(lrow, lhalf)]) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    cp_async16(smem_addr(&b_tile[stage][tile_offset(lrow, lhalf)]), b_src + k, brow_n < prm.o);
  };

  // warp (wm, wn): rows 64 wm.., columns 32 wn..
  const int wm = warp & 1, wn = warp >> 1;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kb_count) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kb = 0; kb < kb_count; ++kb) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kb % kStages is in; every warp is done with kb - 1's
    {
      const int next = kb + kStages - 1;
      if (next < kb_count) load(next % kStages, next);
      cp_async_commit();
    }
    const int st = kb % kStages;
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      // matrices: rows 0-7 / 8-15 of the m16 tile, bytes 0-15 / 16-31
      const int r = wm * 64 + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldmatrix_x4(a[mt], smem_addr(&a_tile[st][tile_offset(r, lane >> 4)]));
    }
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // matrices: n 0-7 bytes 0-15 / 16-31, n 8-15 bytes 0-15 / 16-31
      const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
      uint32_t q[4];
      ldmatrix_x4(q, smem_addr(&b_tile[st][tile_offset(r, (lane >> 3) & 1)]));
      b[2 * np][0] = q[0];
      b[2 * np][1] = q[1];
      b[2 * np + 1][0] = q[2];
      b[2 * np + 1][1] = q[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
  cp_async_wait<0>();

  // epilogue: f32(acc) * (ax * wk[o]), rounded once to T
  const float ax = *prm.ax;
  const int g = lane >> 2, tig = lane & 3;
  T* out = static_cast<T*>(prm.out);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + tig * 2;
    const float s0 = col < prm.o ? __fmul_rn(ax, prm.wk[col]) : 0.0f;
    const float s1 = col + 1 < prm.o ? __fmul_rn(ax, prm.wk[col + 1]) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (r >= prm.m) continue;
        T* dst = out + r * prm.o + col;
        if (col < prm.o) dst[0] = to_out<T>(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), s0));
        if (col + 1 < prm.o)
          dst[1] = to_out<T>(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), s1));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const int64_t mb = (prm.m + BM - 1) / BM;
  if (mb > 2147483647LL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(mb), static_cast<unsigned>((prm.o + BN - 1) / BN));
  const bool vec = prm.c % 16 == 0 && reinterpret_cast<uintptr_t>(prm.x) % 16 == 0;
  if (vec)
    conv2d_w8a8_kernel<T, true><<<grid, kThreads, 0, stream>>>(prm);
  else
    conv2d_w8a8_kernel<T, false><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w, c) int8, contiguous. wt: (o, kp) int8, contiguous and 16-byte
// aligned, row o the kernel's values in (ky, kx, c) order, zeros past
// k = kh kw c; kp a multiple of 32. ax: (1,) f32; wk: (o,) f32 (device
// pointers). out: (b, ho, wo, o) in the output type, contiguous; ho and wo
// the convolution's output size for the strides (sh, sw), paddings (ph, pw)
// and dilations (dh, dw). dtype: 0 float32, 1 bfloat16, 2 float16. Returns
// the launch's cudaError_t.
extern "C" int conv2d_w8a8(const void* x, const void* wt, const void* ax, const void* wk,
                           void* out, int b, int h, int w, int c, int o, int kh, int kw, int sh,
                           int sw, int ph, int pw, int dh, int dw, int ho, int wo, int kp,
                           int dtype, void* stream) {
  const int64_t k = static_cast<int64_t>(kh) * kw * c;
  if (b < 1 || h < 1 || w < 1 || c < 1 || o < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ph < 0 || pw < 0 || dh < 1 || dw < 1 || ho < 1 || wo < 1 || kp % BK != 0 || kp < k ||
      k > 133144 || reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      static_cast<int64_t>(b) * h * w * c >= (int64_t{1} << 62))
    return cudaErrorInvalidValue;
  Params prm{};
  prm.x = static_cast<const int8_t*>(x);
  prm.wt = static_cast<const int8_t*>(wt);
  prm.ax = static_cast<const float*>(ax);
  prm.wk = static_cast<const float*>(wk);
  prm.out = out;
  prm.b = b;
  prm.h = h;
  prm.w = w;
  prm.c = c;
  prm.o = o;
  prm.kh = kh;
  prm.kw = kw;
  prm.sh = sh;
  prm.sw = sw;
  prm.ph = ph;
  prm.pw = pw;
  prm.dh = dh;
  prm.dw = dw;
  prm.ho = ho;
  prm.wo = wo;
  prm.k = static_cast<int>(k);
  prm.kp = kp;
  prm.m = static_cast<int64_t>(b) * ho * wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(prm, s);
    case 1: return launch<__nv_bfloat16>(prm, s);
    case 2: return launch<__half>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}
