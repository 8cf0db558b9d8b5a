// int8 x int8 -> int32 implicit-GEMM convolution that quantizes its own
// input, with a per-output-channel rescale, for Hopper (sm_90a).
//
// The convolution of DDN QUANT w8a8 (the JAX package's
// hgsfusion_tpu/models/resnet.py::QConv8, :73-86: the activation quantized
// per tensor, lax.conv_general_dilated on int8 operands with an int32
// result, the rescale). It replaces no TPU kernel: XLA compiles that
// convolution. For an NHWC input x (B, H, W, C) in T (f32, bf16 or f16),
// the per-tensor activation scale ax, int8 weights w (O, Kp) whose row o
// holds the kernel's (ky, kx, c) values in that order (K = kh kw C of them,
// zeros up to Kp, a multiple of 32) and the per-output-channel weight
// scales wk, it computes
//
//   q[b, iy, ix, c] = clip(rint(f32(x[b, iy, ix, c]) / ax), -127, 127)
//   out[b, oy, ox, o] = round_T( f32(sum_{ky, kx, c} q[b, iy, ix, c] w[o, ky, kx, c])
//                                * (ax * wk[o]) )
//
// with iy = oy sh - ph + ky dh and ix = ox sw - pw + kx dw (zero outside the
// map): the quotient correctly rounded and rounded to the nearest integer,
// ties to even, as the JAX package's `round(x.astype(f32) / ax)`; the sum
// exact in int32 (|sum| <= 127^2 K < 2^31 for K <= 133,144), its
// conversion to f32 and the two products rounded to nearest as
// `out.astype(f32) * (ax * wk)`, the result rounded once to T (or kept in
// f32). So the output is bit for bit JAX's, and
// ops/conv_int8.py::conv2d_w8a8_plain's.
//
// Bound on an H100: 2 M N K int8 operations at 1,979 TOP/s, or the bytes
// of x (in T), the weights and the output; at the VoD backbone's shapes the
// 3x3 convolutions are bound by operations, the 1x1 ones by bytes
// (chip_smoke.py computes both for each shape).
//
// Design. The GEMM is M = B Ho Wo output pixels by N = O channels by K,
// walked 128 bytes of K a stage. The op first quantizes x once to int8
// (quantize_kernel; for channels that are not a multiple of 16, the stem's
// 3, im2col_kernel writes the int8 im2col rows instead, over which the
// convolution is a 1x1 one of Kp channels). A persistent block of three
// warpgroups then walks output tiles of 128 pixels by BN channels (BN =
// 64, 128 or 256, chosen by the caller), N tile fastest so that the tiles
// in flight share their input rows in L2:
// - the producer warpgroup fills a ring of stages (4, 6 or 8 of them),
//   each an A tile (the tile's 128 im2col rows, 128 x 128 int8) and a B
//   tile (BN weight rows, BN x 128 int8), both K-major with the 128-byte
//   swizzle. One thread asks the TMA for B (a 2-D tensor map over (O, Kp),
//   zeros past either edge), and for A where the A tile is a plain block
//   of the int8 rows (kTma: a 1x1 convolution at stride 1 without padding,
//   and the im2col rows), or, for c a multiple of 128 at stride 1 along x
//   with a 16-bit output, a block of 128 pixels of one input row at the
//   stage's tap and channels (kTap: the tiles are then 128 pixels of one
//   output row, and the map's zero fill is the padding). Otherwise (kInt8)
//   each producer thread owns one 16-byte piece of eight rows: it computes
//   the rows' input positions once per tile and its piece's tap (ky, kx, c)
//   once per stage (advanced by 128 from the last), and copies the piece
//   by cp.async (zeros outside the map, past K and past M); a stage is
//   handed over once its copies land, the copies of the stages between in
//   flight.
// - the first pass takes x / ax as x (1 / ax) rounded once to an integer
//   by one fma with 1.5 * 2^23 (round to nearest, ties to even);
//   that is rint(x / ax) unless the product lies within 2^-15 of a
//   half-integer, or outside +-127, and a piece with such a value is
//   quantized again with the exact division, rint and the clip.
// - two consumer warpgroups each multiply 64 rows of the A tile by the B
//   tile with wgmma m64nBNk32 s8 x s8 -> s32 from shared memory, four a
//   stage, keeping the previous stage's group in flight
//   (wgmma.wait_group 1) before giving its stage back.
// - full / empty mbarriers carry the ring between them (a waiting thread
//   is suspended, not spinning); the consumers' epilogue (f32(acc) * (ax *
//   wk[o]), rounded once to T) stages the tile in shared memory, slab by
//   slab: a 16-bit output (O a multiple of 8) in 64 x 64 slabs with the
//   128-byte swizzle that one thread hands to the TMA (a tensor map over
//   the output), the warpgroup going on while the stores drain; an f32
//   output in 64 x 32 slabs written in coalesced 16-byte stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;            // output pixels a tile: two consumer warpgroups of 64
constexpr int BK = 128;            // bytes of K a stage: one swizzled 128-byte row
constexpr int kConsumers = 256;    // warps 0-7: two consumer warpgroups
constexpr int kProducers = 128;    // warps 8-11: the producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kATile = BM * BK;    // 16 KB
constexpr int kSlabCols = 32;            // store_tile's slab: 64 rows of 32 outputs
constexpr int kStgPitch = kSlabCols * 4 + 16;  // a staged row of at most 4-byte outputs, + 16
// a consumer warpgroup's staging: one store_tile slab, or one 64 x 64 slab
// of 16-bit outputs for the TMA (8 KB); a multiple of 1024 bytes
constexpr int kStgBytes = 64 * kStgPitch;
constexpr float kMagic = 12582912.0f;    // 1.5 * 2^23: x + kMagic rounds x to an integer
constexpr float kNearHalf = 0.5f - 1.0f / 32768.0f;

template <int BN> __host__ __device__ constexpr int stages() {
  return BN == 256 ? 4 : BN == 128 ? 6 : 8;
}
template <int BN> __host__ __device__ constexpr int ring_bytes() {
  return stages<BN>() * (kATile + BN * BK);
}
template <int BN> __host__ __device__ constexpr int smem_bytes() {
  return 1024 + ring_bytes<BN>() + 2 * kStgBytes + 2 * stages<BN>() * 8;
}
static_assert(smem_bytes<256>() <= 232448 && smem_bytes<128>() <= 232448 &&
                  smem_bytes<64>() <= 232448 && kStgBytes % 1024 == 0 && kStgBytes >= 8192,
              "shared memory");

struct Params {
  const void* x;     // (b, h, w, c) in T, contiguous
  const void* xq;    // x's int8 levels, or the im2col rows of them
  const float* ax;   // (1,): the activation's scale
  const float* wk;   // (o,): the weights' scales
  void* out;         // (b, ho, wo, o) in T or f32
  int h, w, c, o;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int ho, wo;
  int k;             // kh kw c
  int kb_count;      // stages a tile: Kp / BK rounded up
  int n_tiles;       // N tiles
  int out_f32;       // the output in f32 (else in T)
  int out_vec;       // 16-byte output stores: o a multiple of the vector, out aligned
  int tma_out;       // 16-bit output through the TMA (o a multiple of 8, out aligned)
  int xtiles;        // kTap: tiles of 128 pixels an output row
  int64_t m;         // b ho wo
  int64_t m_in;      // b h w c: x's values
  int64_t tiles;     // M tiles x N tiles
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

// two outputs rounded to T, stored together
template <typename T> __device__ __forceinline__ void store2(void* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(void* p, float a, float b) {
  *static_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(void* p, float a, float b) {
  *static_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<__half>(void* p, float a, float b) {
  *static_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// the 16 values of a 16-byte-aligned piece in f32, from its raw vectors
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 (&raw)[sizeof(T)], float (&v)[16]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[4 * i] = __uint_as_float(raw[i].x);
      v[4 * i + 1] = __uint_as_float(raw[i].y);
      v[4 * i + 2] = __uint_as_float(raw[i].z);
      v[4 * i + 3] = __uint_as_float(raw[i].w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (std::is_same_v<T, __nv_bfloat16>) {
          v[8 * i + 2 * e] = __uint_as_float(u[e] << 16);
          v[8 * i + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
        } else {
          const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[e]));
          v[8 * i + 2 * e] = f.x;
          v[8 * i + 2 * e + 1] = f.y;
        }
      }
    }
  }
}

// x (1 / ax) + kMagic rounded once: its low byte is the int8 level when
// `ok` stays true (see the header)
__device__ __forceinline__ float level(float v, float r, bool& ok) {
  const float m = __fmaf_rn(v, r, kMagic);
  const float q = __fsub_rn(m, kMagic);
  const float d = __fmaf_rn(v, r, -q);
  ok &= (fabsf(d) <= kNearHalf) & (fabsf(q) <= 127.0f);
  return m;
}
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  const uint32_t lo = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}
// the exact quantization of one value, as a byte
__device__ __forceinline__ uint32_t exact_level(float v, float ax) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, ax)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}
__device__ __forceinline__ uint4 quantize16(const float (&v)[16], float r, float ax) {
  bool ok = true;
  float m[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) m[e] = level(v[e], r, ok);
  uint4 q;
  if (ok) {
    q.x = pack4(m[0], m[1], m[2], m[3]);
    q.y = pack4(m[4], m[5], m[6], m[7]);
    q.z = pack4(m[8], m[9], m[10], m[11]);
    q.w = pack4(m[12], m[13], m[14], m[15]);
  } else {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = exact_level(v[4 * i], ax) | exact_level(v[4 * i + 1], ax) << 8 |
             exact_level(v[4 * i + 2], ax) << 16 | exact_level(v[4 * i + 3], ax) << 24;
    q = make_uint4(b[0], b[1], b[2], b[3]);
  }
  return q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// waits for the phase of `parity` to complete; a waiting thread is suspended
// (up to the hint, in ns, a try) rather than spinning, so that the waiting
// consumers leave the producer its issue slots
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, %2;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity), "r"(1000000)
      : "memory");
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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// the box at (k0, r0) of a 2-D tensor map (k innermost) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k0, int r0,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0), "r"(bar)
      : "memory");
}
// the box at (c0, x0, y, b) of a 4-D tensor map over (b, h, w, c) int8
// into shared memory, completing on `bar`; coordinates outside the map
// (the padding) read zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int x0,
                                            int y, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(x0), "r"(y), "r"(b), "r"(bar)
      : "memory");
}
// a 64 x 64 slab of 16-bit outputs at (column n0, pixel x0, output row y)
// of a 3-D tensor map over (rows, wo, o); the pixels past wo are not written
__device__ __forceinline__ void tma_store_out3(const CUtensorMap* map, uint32_t src, int n0,
                                               int x0, int y) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(n0), "r"(x0), "r"(y), "r"(src)
      : "memory");
}
// a 64 x 64 slab of 16-bit outputs (64 rows of 128 bytes, 128-byte
// swizzle) at (column n0, row m0) of the output's tensor map; the rows and
// columns past its edges are not written
__device__ __forceinline__ void tma_store_out(const CUtensorMap* map, uint32_t src, int n0,
                                              int64_t m0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(n0), "r"(static_cast<int>(m0)), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the producer's generic stores become visible to the products' async reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a K-major operand with the 128-byte swizzle: rows of 128 bytes, 8-row
// atoms of 1024 bytes one after another (SBO 1024); `addr` the k32 step's
// start in its atom, the atom 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | uint64_t{1} << 16 |
         uint64_t{1024 >> 4} << 32 | uint64_t{1} << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R> __device__ __forceinline__ void fence_acc(int (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// the accumulator operands d[i .. i + 15] of a wgmma
#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
// wgmma m64nNk32 s8 x s8 -> s32, A and B from shared memory (descriptors),
// the accumulator in mma.sync's C layout n-tile by n-tile; `acc` 0 zeroes it
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : D16(0), D16(16)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : D16(0), D16(16), D16(32), D16(48), D16(64), D16(80), D16(96), D16(112)
      : "l"(da), "l"(db), "r"(acc));
}

#undef D16
#undef D4

// Where the A tiles come from: x's int8 levels (quantize_kernel, or
// im2col_kernel's rows as a 1x1 convolution), copied by cp.async in 16-byte
// pieces (kInt8), or by the TMA: where the A tile is a plain block of the
// int8 rows (kTma: a 1x1 convolution at stride 1 without padding), or, tap
// by tap, a block of one input row (kTap: tiles of 128 pixels of one output
// row, c a multiple of 128, stride 1 along x).
enum Src { kInt8, kTma, kTap };

// The producer warpgroup (thread p of 128): the A tiles of every tile this
// block walks, and the B tiles through the TMA.
template <int BN, Src SRC>
__device__ __forceinline__ void produce(const Params& prm, const CUtensorMap* wmap,
                                        const CUtensorMap* amap, unsigned char* a_ring,
                                        uint32_t b_ring, uint32_t full, uint32_t empty) {
  constexpr int S = stages<BN>();
  constexpr int kLag = S - 2;  // kInt8: stages whose copies are in flight
  const int p = threadIdx.x - kConsumers;
  const int piece = p & 7, rs = p >> 3;  // the 16-byte piece, rows rs + 16 i
  const int8_t* xq = static_cast<const int8_t*>(prm.xq);
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < prm.tiles; tile += gridDim.x) {
    const int64_t m0 = tile / prm.n_tiles * BM;
    const int n0 = static_cast<int>(tile % prm.n_tiles) * BN;
    // kTap: the tile's output row (frame and y) and first pixel
    const int64_t orow = tile / prm.n_tiles / (SRC == kTap ? prm.xtiles : 1);
    const int ox0 = static_cast<int>(tile / prm.n_tiles % (SRC == kTap ? prm.xtiles : 1)) * BM;
    // the tile's rows: frame row, top-left input position, live
    int frame_row[8], iy0[8], ix0[8];
    bool live[8];
#pragma unroll
    for (int i = 0; i < (SRC == kTma || SRC == kTap ? 0 : 8); ++i) {
      const int64_t mr = m0 + rs + 16 * i;
      live[i] = mr < prm.m;
      const int64_t mm = live[i] ? mr : 0;
      const int ox = static_cast<int>(mm % prm.wo);
      const int64_t t = mm / prm.wo;
      const int oy = static_cast<int>(t % prm.ho);
      frame_row[i] = static_cast<int>(t / prm.ho) * prm.h;
      iy0[i] = oy * prm.sh - prm.ph;
      ix0[i] = ox * prm.sw - prm.pw;
    }
    // this thread's piece's tap at the tile's first stage
    int kt = piece * 16;  // k of the piece
    int tap = kt / prm.c, c0 = kt - tap * prm.c;
    int ky = tap / prm.kw, kx = tap - ky * prm.kw;
    for (int kb = 0; kb < prm.kb_count; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
      unsigned char* a = a_ring + s * kATile;
      if (p == 0) {
        mbar_arrive_tx(full + 8 * s, BN * BK + (SRC == kTma || SRC == kTap ? kATile : 0));
        if constexpr (SRC == kTma)
          tma_load_2d(smem_addr(a), amap, kb * BK, static_cast<int>(m0), full + 8 * s);
        if constexpr (SRC == kTap) {
          // the stage's 128 channels lie in one tap: a box of 128 input
          // pixels of one row, read zeros where it leaves the map
          const int y = static_cast<int>(orow % prm.ho), b = static_cast<int>(orow / prm.ho);
          tma_load_4d(smem_addr(a), amap, c0, ox0 - prm.pw + kx * prm.dw,
                      y * prm.sh - prm.ph + ky * prm.dh, b, full + 8 * s);
        }
        tma_load_2d(b_ring + s * (BN * BK), wmap, kb * BK, n0, full + 8 * s);
      }
      if constexpr (SRC == kTma || SRC == kTap) {
        mbar_arrive(full + 8 * s);
        if constexpr (SRC == kTap) {
          c0 += BK;
          if (c0 == prm.c) {
            c0 = 0;
            if (++kx == prm.kw) {
              kx = 0;
              ++ky;
            }
          }
        }
        continue;
      }
      // kInt8: the 16 int8 levels of each row's piece, zeros outside the
      // map; a stage is given to the consumers once its copies (and the
      // fence) are done, kLag stages later, the copies between in flight
      const bool tap_ok = kt < prm.k;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int iy = iy0[i] + ky * prm.dh, ix = ix0[i] + kx * prm.dw;
        const bool ok = live[i] && tap_ok &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(prm.h) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(prm.w);
        const int row = rs + 16 * i;
        cp_async16(smem_addr(a + row * BK + ((piece ^ (row & 7)) << 4)),
                   ok ? xq + ((static_cast<int64_t>(frame_row[i]) + iy) * prm.w + ix) * prm.c + c0
                      : xq,
                   ok);
      }
      cp_async_commit();
      if (it >= kLag) {
        cp_async_wait<kLag>();
        fence_async_smem();
        mbar_arrive(full + 8 * ((it - kLag) % S));
      }
      // the next stage's tap: 128 k on
      kt += BK;
      c0 += BK;
      while (c0 >= prm.c) {
        c0 -= prm.c;
        if (++kx == prm.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
  }
  if constexpr (SRC == kInt8) {
    cp_async_wait<0>();
    fence_async_smem();
    for (int j = it > kLag ? it - kLag : 0; j < it; ++j) mbar_arrive(full + 8 * (j % S));
  }
}

// x in T -> its int8 levels clip(rint(x / ax), -127, 127) (n values, q
// 16-byte aligned): 16 values a thread and step while x is 16-byte aligned
// (n16 steps), the rest one by one (the rounding: see the header).
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* x, const float* ax_ptr,
                                                       int8_t* q, int64_t n, int64_t n16) {
  const float ax = __ldg(ax_ptr);
  const float r = __frcp_rn(ax);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = start; i < n16; i += step) {
    uint4 raw[sizeof(T)];
    const uint4* src = reinterpret_cast<const uint4*>(x + 16 * i);
#pragma unroll
    for (int v = 0; v < static_cast<int>(sizeof(T)); ++v) raw[v] = __ldg(src + v);
    float v[16];
    unpack16<T>(raw, v);
    reinterpret_cast<uint4*>(q)[i] = quantize16(v, r, ax);
  }
  for (int64_t i = 16 * n16 + start; i < n; i += step)
    q[i] = static_cast<int8_t>(exact_level(to_f32<T>(x[i]), ax));
}

template <typename T>
cudaError_t launch_quantize(const void* x, const float* ax, int8_t* q, int64_t n, int sms,
                            cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int64_t n16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 ? n / 16 : 0;
  const int64_t need = ((n16 > 0 ? n16 : n) + 255) / 256;
  const int64_t blocks = need < 8 * sms ? need : 8 * sms;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(static_cast<const T*>(x),
                                                                         ax, q, n, n16);
  return cudaGetLastError();
}

// The im2col rows of the convolution in int8 levels, for channels that are
// not a multiple of 16 (the stem's 3): q (m, kp), row m the levels of
// output pixel m's taps in (ky, kx, c) order, zeros outside the map and
// past k; a thread a 16-byte piece, its 16 values read one by one with
// the tap advanced by one element. The convolution is then a 1x1 one over
// these rows (kp channels, kp a multiple of 32).
template <typename T>
__global__ void __launch_bounds__(256) im2col_kernel(const Params prm, int kp, int8_t* q) {
  const float ax = __ldg(prm.ax);
  const float r = __frcp_rn(ax);
  const T* x = static_cast<const T*>(prm.x);
  const int m_rows = static_cast<int>(prm.m);  // < 2^31: the caller checks
  const int64_t total = prm.m * (kp / 16);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    // neighbouring threads on neighbouring pixels, so that a warp's loads of
    // one tap value are a few cache lines; 32-bit index arithmetic
    const int piece = static_cast<int>(i / m_rows);
    const int m = static_cast<int>(i - static_cast<int64_t>(piece) * m_rows);
    const int k0 = piece * 16;
    const int ox = m % prm.wo, t = m / prm.wo;
    const int oy = t % prm.ho;
    const int64_t frame_row = static_cast<int64_t>(t / prm.ho) * prm.h;
    const int iy0 = oy * prm.sh - prm.ph, ix0 = ox * prm.sw - prm.pw;
    int ey = 0, ex = 0, ec = 0;
    if (k0 < prm.k) {
      const int t0 = k0 / prm.c;
      ec = k0 - t0 * prm.c;
      ey = t0 / prm.kw;
      ex = t0 - ey * prm.kw;
    }
    float v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int iy = iy0 + ey * prm.dh, ix = ix0 + ex * prm.dw;
      const bool ok = k0 + e < prm.k && static_cast<unsigned>(iy) < static_cast<unsigned>(prm.h) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(prm.w);
      v[e] = ok ? to_f32<T>(x[((frame_row + iy) * prm.w + ix) * prm.c + ec]) : 0.0f;
      if (++ec == prm.c) {
        ec = 0;
        if (++ex == prm.kw) {
          ex = 0;
          ++ey;
        }
      }
    }
    *reinterpret_cast<uint4*>(q + static_cast<int64_t>(m) * kp + k0) = quantize16(v, r, ax);
  }
}

template <typename T>
cudaError_t launch_im2col(const Params& prm, int kp, int8_t* q, int sms, cudaStream_t stream) {
  if (prm.m >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int64_t need = (prm.m * (kp / 16) + 255) / 256;
  im2col_kernel<T><<<static_cast<unsigned>(need < 8 * sms ? need : 8 * sms), 256, 0, stream>>>(
      prm, kp, q);
  return cudaGetLastError();
}

template <typename TO, int BN>
__device__ __forceinline__ void store_tile(const Params& prm, const int (&acc)[BN / 2],
                                           unsigned char* stg, int64_t m0, int n0) {
  const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const float ax = __ldg(prm.ax);
  TO* out = static_cast<TO*>(prm.out);
  constexpr int E = 16 / sizeof(TO);  // outputs a 16-byte store
  constexpr int kPitch = kSlabCols * static_cast<int>(sizeof(TO)) + 16;
  constexpr int kPieces = kSlabCols / E;  // 16-byte pieces a staged row
#pragma unroll
  for (int slab = 0; slab < BN / kSlabCols; ++slab) {
#pragma unroll
    for (int jj = 0; jj < kSlabCols / 8; ++jj) {
      const int j = slab * (kSlabCols / 8) + jj;
      const int colt = 8 * jj + 2 * (lane & 3), col = n0 + slab * kSlabCols + colt;
      const float s0 = col < prm.o ? __fmul_rn(ax, __ldg(prm.wk + col)) : 0.0f;
      const float s1 = col + 1 < prm.o ? __fmul_rn(ax, __ldg(prm.wk + col + 1)) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rowt = wq * 16 + (lane >> 2) + 8 * h;
        store2<TO>(stg + rowt * kPitch + colt * static_cast<int>(sizeof(TO)),
                   __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0),
                   __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1));
      }
    }
    named_sync(1 + g);
    for (int idx = tid; idx < 64 * kPieces; idx += 128) {
      const int row = idx / kPieces, pc = idx - row * kPieces;
      const int64_t grow = m0 + g * 64 + row;
      const int col0 = n0 + slab * kSlabCols + pc * E;
      if (grow >= prm.m || col0 >= prm.o) continue;
      const unsigned char* src = stg + row * kPitch + pc * 16;
      TO* dst = out + grow * prm.o + col0;
      if (prm.out_vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const TO* sv = reinterpret_cast<const TO*>(src);
        for (int e = 0; e < E && col0 + e < prm.o; ++e) dst[e] = sv[e];
      }
    }
    named_sync(1 + g);
  }
}

// A consumer warpgroup's epilogue of one tile in a 16-bit TO through the
// TMA: each 64 x 64 slab rounded into shared memory (the 128-byte swizzle),
// then one thread hands it to the TMA; the next slab (or tile) waits only
// until the TMA has read the last one, and the warpgroup goes on to its
// next tile while the stores drain.
template <typename TO, int BN, bool ROWS>
__device__ __forceinline__ void store_tile_tma(const Params& prm, const CUtensorMap* omap,
                                               const int (&acc)[BN / 2], unsigned char* stg,
                                               int64_t m0, int n0, int64_t orow, int ox0) {
  const int g = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const float ax = __ldg(prm.ax);
#pragma unroll
  for (int slab = 0; slab < BN / 64; ++slab) {
    if (tid == 0) bulk_wait_read();
    named_sync(1 + g);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = slab * 8 + jj;
      const int col = n0 + slab * 64 + 8 * jj + 2 * (lane & 3);
      const float s0 = col < prm.o ? __fmul_rn(ax, __ldg(prm.wk + col)) : 0.0f;
      const float s1 = col + 1 < prm.o ? __fmul_rn(ax, __ldg(prm.wk + col + 1)) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wq * 16 + (lane >> 2) + 8 * h;
        store2<TO>(stg + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * (lane & 3),
                   __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0),
                   __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1));
      }
    }
    fence_async_smem();
    named_sync(1 + g);
    if (tid == 0) {
      if constexpr (ROWS)  // kTap: the tile's pixels in one output row
        tma_store_out3(omap, smem_addr(stg), n0 + slab * 64, ox0 + g * 64,
                       static_cast<int>(orow));
      else
        tma_store_out(omap, smem_addr(stg), n0 + slab * 64, m0 + g * 64);
      bulk_commit();
    }
  }
}

// A consumer warpgroup (g = 0, 1): rows 64 g .. 64 g + 63 of each tile.
template <typename T, int BN, Src SRC>
__device__ __forceinline__ void consume(const Params& prm, const CUtensorMap* omap,
                                        uint32_t a_ring, uint32_t b_ring, unsigned char* stg,
                                        uint32_t full, uint32_t empty) {
  constexpr int S = stages<BN>();
  const int g = threadIdx.x >> 7, lane = threadIdx.x & 31;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < prm.tiles; tile += gridDim.x) {
    const int64_t m0 = tile / prm.n_tiles * BM;
    const int n0 = static_cast<int>(tile % prm.n_tiles) * BN;
    const int64_t orow = tile / prm.n_tiles / (SRC == kTap ? prm.xtiles : 1);
    const int ox0 = static_cast<int>(tile / prm.n_tiles % (SRC == kTap ? prm.xtiles : 1)) * BM;
    for (int kb = 0; kb < prm.kb_count; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      const uint32_t a = a_ring + s * kATile + g * (64 * BK);
      const uint32_t b = b_ring + s * (BN * BK);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), kb | kk);
      wgmma_commit();
      // the previous stage's products are done: give it back
      wgmma_wait<1>();
      fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    if constexpr (sizeof(T) == 2) {
      if (prm.tma_out) {
        store_tile_tma<T, BN, SRC == kTap>(prm, omap, acc, stg, m0, n0, orow, ox0);
        continue;
      }
    }
    if (prm.out_f32)
      store_tile<float, BN>(prm, acc, stg, m0, n0);
    else
      store_tile<T, BN>(prm, acc, stg, m0, n0);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

template <typename T, int BN, Src SRC>
__global__ void __launch_bounds__(kThreads, 1)
    conv2d_w8a8_kernel(const __grid_constant__ Params prm, const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap omap) {
  constexpr int S = stages<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* a_ring = base;
  unsigned char* b_ring = base + S * kATile;
  unsigned char* stg = base + ring_bytes<BN>();
  const uint32_t bars = smem_addr(stg + 2 * kStgBytes);
  const uint32_t full = bars, empty = bars + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, kProducers + 1);  // every producer thread, and the TMA's bytes
      mbar_init(empty + 8 * s, kConsumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers)
    produce<BN, SRC>(prm, &wmap, &amap, a_ring, smem_addr(b_ring), full, empty);
  else
    consume<T, BN, SRC>(prm, &omap, smem_addr(a_ring), smem_addr(b_ring),
                   stg + (threadIdx.x >> 7) * kStgBytes, full, empty);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no link to it)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, int BN, Src SRC>
cudaError_t launch(Params& prm, const void* wt, int kp, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(prm.o)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  prm.n_tiles = (prm.o + BN - 1) / BN;
  prm.xtiles = (prm.wo + BM - 1) / BM;
  prm.tiles = (SRC == kTap ? prm.m / prm.wo * prm.xtiles : (prm.m + BM - 1) / BM) * prm.n_tiles;
  prm.out_vec = prm.o % (16 / (prm.out_f32 ? 4 : sizeof(T))) == 0 &&
                reinterpret_cast<uintptr_t>(prm.out) % 16 == 0;
  CUtensorMap omap{};
  prm.tma_out = sizeof(T) == 2 && !prm.out_f32 && prm.o % 8 == 0 &&
                reinterpret_cast<uintptr_t>(prm.out) % 16 == 0 && prm.m < (int64_t{1} << 31);
  if (SRC == kTap && !prm.tma_out) return cudaErrorInvalidValue;
  if (prm.tma_out) {
    // the output as (m, o), or for kTap as (output rows, wo, o)
    const cuuint64_t odims[3] = {static_cast<cuuint64_t>(prm.o),
                                 static_cast<cuuint64_t>(SRC == kTap ? prm.wo : prm.m),
                                 static_cast<cuuint64_t>(prm.m / prm.wo)};
    const cuuint64_t ostrides[2] = {static_cast<cuuint64_t>(prm.o) * 2,
                                    static_cast<cuuint64_t>(prm.o) * 2 * prm.wo};
    const cuuint32_t obox[3] = {64, 64, 1};
    const cuuint32_t ostep[3] = {1, 1, 1};
    if (encode(&omap,
               std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               SRC == kTap ? 3 : 2, prm.out, odims, ostrides, obox, ostep,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  CUtensorMap amap{};
  if (SRC == kTap) {
    // the int8 levels as (b, h, w, c): the A tile of a stage is the box of
    // 128 pixels of one input row and the stage's 128 channels
    const int64_t frames = prm.m_in / (static_cast<int64_t>(prm.h) * prm.w * prm.c);
    const cuuint64_t adims[4] = {static_cast<cuuint64_t>(prm.c), static_cast<cuuint64_t>(prm.w),
                                 static_cast<cuuint64_t>(prm.h), static_cast<cuuint64_t>(frames)};
    const cuuint64_t astrides[3] = {static_cast<cuuint64_t>(prm.c),
                                    static_cast<cuuint64_t>(prm.c) * prm.w,
                                    static_cast<cuuint64_t>(prm.c) * prm.w * prm.h};
    const cuuint32_t abox[4] = {BK, BM, 1, 1};
    const cuuint32_t astep[4] = {1, 1, 1, 1};
    if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(prm.xq), adims,
               astrides, abox, astep, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  if (SRC == kTma) {
    // the int8 rows (a pixel's channels, or its im2col values) as a (m, c)
    // matrix: the A tile is the box of 128 rows at m0
    const cuuint64_t adims[2] = {static_cast<cuuint64_t>(prm.c), static_cast<cuuint64_t>(prm.m)};
    const cuuint64_t astrides[1] = {static_cast<cuuint64_t>(prm.c)};
    const cuuint32_t abox[2] = {BK, BM};
    if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(prm.xq), adims,
               astrides, abox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(conv2d_w8a8_kernel<T, BN, SRC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t blocks = prm.tiles < sms ? prm.tiles : sms;
  conv2d_w8a8_kernel<T, BN, SRC><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      prm, map, amap, omap);
  return cudaGetLastError();
}

template <typename T, Src SRC>
cudaError_t launch_bn(Params& prm, const void* wt, int kp, int bn, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<T, 64, SRC>(prm, wt, kp, stream);
    case 128: return launch<T, 128, SRC>(prm, wt, kp, stream);
    case 256: return launch<T, 256, SRC>(prm, wt, kp, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T>
cudaError_t dispatch(Params& prm, const void* wt, int kp, int bn, cudaStream_t stream) {
  if (bn != 64 && bn != 128 && bn != 256) return cudaErrorInvalidValue;
  if (prm.xq == nullptr || reinterpret_cast<uintptr_t>(prm.xq) % 16 != 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err;
  if ((err = sm_count(sms)) != cudaSuccess) return err;
  int8_t* xq = static_cast<int8_t*>(const_cast<void*>(prm.xq));
  if (prm.c % 16 != 0) {
    // the im2col rows in int8, then a 1x1 convolution over them
    if ((err = launch_im2col<T>(prm, kp, xq, sms, stream)) != cudaSuccess) return err;
    prm.h = prm.ho;
    prm.w = prm.wo;
    prm.c = prm.k = kp;
    prm.kh = prm.kw = prm.sh = prm.sw = prm.dh = prm.dw = 1;
    prm.ph = prm.pw = 0;
  } else if ((err = launch_quantize<T>(prm.x, prm.ax, xq, prm.m_in, sms, stream)) !=
             cudaSuccess) {
    return err;
  }
  const bool rows = prm.kh == 1 && prm.kw == 1 && prm.sh == 1 && prm.sw == 1 && prm.ph == 0 &&
                    prm.pw == 0 && prm.m < (int64_t{1} << 31);
  // kTap stores through the TMA's 3-D output map (16-bit outputs only)
  const bool taps = prm.c % BK == 0 && prm.sw == 1 && sizeof(T) == 2 && !prm.out_f32 &&
                    prm.o % 8 == 0 && reinterpret_cast<uintptr_t>(prm.out) % 16 == 0 &&
                    prm.m < (int64_t{1} << 31);
  if (rows) return launch_bn<T, kTma>(prm, wt, kp, bn, stream);
  if (taps) return launch_bn<T, kTap>(prm, wt, kp, bn, stream);
  return launch_bn<T, kInt8>(prm, wt, kp, bn, stream);
}

// The convolution's Params, its scratch and output left to the caller;
// false for sizes out of the kernels' range.
bool conv_params(Params& prm, const void* x, const void* ax, int b, int h, int w, int c, int o,
                 int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw, int ho, int wo,
                 int kp) {
  const int64_t k = static_cast<int64_t>(kh) * kw * c;
  if (b < 1 || h < 1 || w < 1 || c < 1 || o < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ph < 0 || pw < 0 || dh < 1 || dw < 1 || ho < 1 || wo < 1 || kp % 32 != 0 || kp < k ||
      k > 133144 || static_cast<int64_t>(b) * h >= (int64_t{1} << 31) ||
      static_cast<int64_t>(b) * h * w * c >= (int64_t{1} << 62))
    return false;
  prm = Params{};
  prm.x = x;
  prm.ax = static_cast<const float*>(ax);
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
  prm.kb_count = (kp + BK - 1) / BK;
  prm.m = static_cast<int64_t>(b) * ho * wo;
  prm.m_in = static_cast<int64_t>(b) * h * w * c;
  return true;
}

}  // namespace

// x: (b, h, w, c) contiguous in its type. wt: (o, kp) int8, contiguous
// and 16-byte aligned, row o the kernel's values in (ky, kx, c) order,
// zeros past k = kh kw c; kp a multiple of 32. ax: (1,) f32; wk: (o,) f32
// (device pointers). out: (b, ho, wo, o), contiguous; ho
// and wo the convolution's output size for the strides (sh, sw), paddings
// (ph, pw) and dilations (dh, dw). dtype: x's, 0 float32, 1 bfloat16, 2
// float16; out_f32: out in float32 (else in x's type). bn: the tile's
// output channels, 64, 128 or 256. xq: int8 scratch (16-byte aligned) into
// which a first launch quantizes x once for the A tiles to copy: x's size
// where c is a multiple of 16, else b ho wo kp (the im2col rows, as
// im2col_int8 writes them). Returns the launches' cudaError_t.
extern "C" int conv2d_w8a8(const void* x, const void* wt, const void* ax, const void* wk,
                           void* out, int b, int h, int w, int c, int o, int kh, int kw, int sh,
                           int sw, int ph, int pw, int dh, int dw, int ho, int wo, int kp,
                           int dtype, int out_f32, int bn, void* xq, void* stream) {
  Params prm;
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      !conv_params(prm, x, ax, b, h, w, c, o, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo, kp))
    return cudaErrorInvalidValue;
  prm.xq = xq;
  prm.wk = static_cast<const float*>(wk);
  prm.out = out;
  prm.out_f32 = out_f32 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(prm, wt, kp, bn, s);
    case 1: return dispatch<__nv_bfloat16>(prm, wt, kp, bn, s);
    case 2: return dispatch<__half>(prm, wt, kp, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: n values in its type (dtype as conv2d_w8a8's), q 16-byte aligned; ax:
// (1,) f32 -> q: n int8 levels clip(rint(x / ax), -127, 127), as
// conv2d_w8a8's first launch writes them for c a multiple of 16. Returns
// the launch's cudaError_t.
extern "C" int quantize_int8(const void* x, const void* ax, void* q, int64_t n, int dtype,
                             void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err;
  if ((err = sm_count(sms)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(ax);
  int8_t* out = static_cast<int8_t*>(q);
  switch (dtype) {
    case 0: return launch_quantize<float>(x, a, out, n, sms, s);
    case 1: return launch_quantize<__nv_bfloat16>(x, a, out, n, sms, s);
    case 2: return launch_quantize<__half>(x, a, out, n, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, ax, the convolution's sizes and kp as conv2d_w8a8's; q: (b ho wo, kp)
// int8, 16-byte aligned -> the int8 im2col rows, row m output pixel m's
// taps' levels clip(rint(x / ax), -127, 127) in (ky, kx, c) order, zeros
// outside the map and past kh kw c, as conv2d_w8a8's first launch writes
// them for c not a multiple of 16. Returns the launch's cudaError_t.
extern "C" int im2col_int8(const void* x, const void* ax, void* q, int b, int h, int w, int c,
                           int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw, int ho,
                           int wo, int kp, int dtype, void* stream) {
  Params prm;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      !conv_params(prm, x, ax, b, h, w, c, 1, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo, kp))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err;
  if ((err = sm_count(sms)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* out = static_cast<int8_t*>(q);
  switch (dtype) {
    case 0: return launch_im2col<float>(prm, kp, out, sms, s);
    case 1: return launch_im2col<__nv_bfloat16>(prm, kp, out, sms, s);
    case 2: return launch_im2col<__half>(prm, kp, out, sms, s);
    default: return cudaErrorInvalidValue;
  }
}
