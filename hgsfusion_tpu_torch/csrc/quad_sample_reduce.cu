// Quad bilinear sampler fused with the view transform's reduce product, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _bench_gather_pallas.py::pallas_gather_combine_matmul
// (:162), the Pallas prototype of the gather view's forward reduce
// (hgsfusion_tpu/models/frustum.py: quad-sample each gather group, einsum with
// the group's rows of the 1x1x1 conv kernel into an f32 accumulator, cast to
// the compute type). For G gather groups (1 <= G <= 4), each an unpadded NHWC
// map f_g (B, H_g, W_g, c_g) in the compute type T, the sampling coordinates
// uv (n queries, read in place with their stride) and the rows K_g =
// K[off_g : off_g + c_g] of the reduce kernel, it computes
//
//   out[j, :] = round_T( bias + sum_g round_T( sum_tap w_tap * f_g[tap] ) @ K_g )
//
// The taps of query j are computed here from uv[j], bit for bit as
// ops/grid_sample.py::quad_taps and ops/quad_sample.py::quad_indices compute
// them (quad_tap, in quad_taps.cuh); a tap outside the map is selected as
// zero, which is what the zero-padded map of the plain route holds there. The four taps
// are summed in f32 and rounded once to T; the reduce's products are exact in
// f32 and summed in f32 with the bias; the output is rounded once to T, as
// the reference's vox.astype(cdt).
//
// Bound on an H100: bytes. Each query reads 8 B of uv and writes O outputs in
// T; the maps and K are read once. At the flagship shapes (n = 3,174,400,
// c = 64 and 192, O = 128, bf16) that is 25 MB + 14 MB + 64 KB + 813 MB,
// about 0.254 ms at 3.35 TB/s, against 208 GFLOP of products (0.210 ms at
// 989 TFLOP/s). The taps themselves pass through L2: 4 x 256 x 2 B a query,
// 6.5 GB, which sets the pace of the gathers.
//
// Design (bf16, f16). Persistent blocks of 12 warps (three warpgroups), one
// block per SM; each block holds its (sum c) x 128 slice of K in shared
// memory for its life, K-major with the 128-byte swizzle (grid.y walks a
// wider O). Each warpgroup walks 64-query tiles, each warp 16 of the
// queries, and owns a 64 x 128 f32 accumulator in registers. A tile is a
// sequence of chunks of KC = 32 channels of one group. Each warp computes its
// queries' taps from uv (lanes 0-15, once a group, or once for groups of one
// size) and gathers the four tap rows of the chunk's 16 queries by 16-byte
// cp.async into a ring of kStages stages of its own shared memory, zero-filled
// where the tap is outside the map or the channel past c, kStages - 1 chunks
// ahead of the one being multiplied. Four lanes read one 64-byte row chunk,
// so each copy instruction asks L2 for 8 whole row chunks: with one 32-byte
// sector a lane pair the same bytes took 1.7x as long (PERF.md). The warp
// combines a chunk straight into the product's A fragments (ldmatrix of the
// four taps, f32 sum, one rounding to T), and the warpgroup multiplies them
// by K's slice with wgmma (A from registers, B from shared memory). The
// epilogue rounds once to T, gathers each lane's 8 consecutive outputs by
// shuffles inside its quad and stores them with 16-byte streaming stores.
// Warps synchronise only with themselves and their warpgroup's products; the
// block synchronises once, after loading K. Each warp waits for its
// warpgroup's product before the next chunk's combine rewrites A's
// registers; ptxas serialises the products anyway (C7518), so they are not
// yet under the next chunk's gathers (PERF.md). Channels not a multiple of 8 or a map not
// 16-byte aligned take synchronous element loads into the same stages.
//
// f32 takes a plain kernel: 32 queries x 128 outputs a block, the taps
// combined into a shared tile, K's chunk beside it, an FMA loop in f32
// (tensor cores would mean TF32).
//
// quad_sample_taps runs quad_tap alone and writes what quad_indices builds
// (the flat top-left pixel in the zero-padded map, the four weights), so the
// taps can be held against it bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quad_taps.cuh"

namespace {

constexpr int kMaxGroups = 4;
constexpr int kMaxChunks = 64;
// quad_sample_reduce_fwd's return when the groups' rows of K (each group's
// rounded up to whole chunks) exceed the slice a block's shared memory holds
constexpr int kKSliceTooLarge = -1;
constexpr unsigned kFull = 0xffffffffu;

// two f32 values rounded to T, packed low first
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

struct Group {
  const void* map;  // (B, h, w, c), contiguous
  int h, w, c;
  int k_off;  // its first row of K
  int vec;  // 16-byte gathers: c a multiple of 16 / sizeof(T), map 16-byte aligned
};

// one chunk of a tile: KC channels from kc of group `group`, whose K rows sit
// at row krow of the shared slice; new_taps when its taps differ from the
// previous chunk's (a group's first chunk, unless the previous group has the
// same height and width)
struct Chunk {
  int group, kc, krow, new_taps;
};

struct Params {
  const float* uv;  // query j's (x, y) at uv[j * uv_stride], uv[j * uv_stride + 1]
  int64_t uv_stride;
  int64_t n;
  int64_t per_frame;  // queries of one frame: query j samples frame j / per_frame
  Group g[kMaxGroups];
  int groups;
  Chunk chunk[kMaxChunks];
  int chunks;
  int k_rows;     // rows of the shared slice of K (each group's padded to KC)
  const void* k;  // (sum c, o), row-major
  const float* bias;  // (o,)
  void* out;          // (n, o) in T
  int o;
  int out_vec;  // 16-byte stores: o a multiple of 8, out 16-byte aligned
};

// ---------------------------------------------------------------------------
// bf16 / f16: persistent warpgroups, cp.async ring, wgmma

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int RM = 16;   // queries per warp tile
constexpr int BN = 128;  // outputs per block
constexpr int KC = 32;   // channels per chunk (64 B of a 16-bit tap row)
constexpr int kStages = 2;  // chunks a warp has in flight: 1 gathering, 1 multiplied
constexpr int kTapBytes = RM * KC * 2;           // one tap's 16 rows: 1 KB
constexpr int kStageBytes = 4 * kTapBytes;       // four taps
constexpr int kMetaBytes = RM * 16;              // the 16 queries' weights (float4)
constexpr int kWarpBytes = kStages * (kStageBytes + kMetaBytes);
constexpr int kRingBytes = kWarps * kWarpBytes;
constexpr int kMaxSmem = 232448;                 // a block's shared memory on sm_90
// K's slice: rows rounded up to whole 64-row swizzle atoms, 1024-byte aligned
constexpr int kMaxKRows = (kMaxSmem - kRingBytes - 1024) / (BN * 2) / 64 * 64;
static_assert(kWarps % 4 == 0, "whole warpgroups");

// byte offset of 16-byte piece p (0..3) of row r in a tap's 16 x 64 B tile:
// XOR-swizzled so the eight rows of an ldmatrix sit on distinct banks
__device__ __forceinline__ int tap_offset(int r, int p) { return r * 64 + ((p ^ ((r >> 1) & 3)) << 4); }

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

// Two wgmma m64n128k16, one chunk of KC = 32 channels: A (64 x 16 each, every
// warp of the warpgroup its 16 rows) in registers in mma.sync's A layout, B
// (16 x 128 each) K-major in shared memory (kmajor_sw128_desc), D 64 f32 a
// thread in mma.sync's C layout, n-tile by n-tile. One asm statement for the
// chunk's two k16 steps.
using BF = __nv_bfloat16;
using HF = __half;
// the 64 accumulator operands, and the chunk's two products with TY the
// PTX type of A and B (bf16 or f16)
#define WGMMA_D \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_CHUNK(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" WGMMA_D "}, " \
      "{%64, %65, %66, %67}, %72, p, 1, 1, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" WGMMA_D "}, " \
      "{%68, %69, %70, %71}, %73, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(a[1][0]), "r"(a[1][1]), \
        "r"(a[1][2]), "r"(a[1][3]), "l"(desc0), "l"(desc1), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_chunk(float (&d)[BN / 8][4], const uint32_t (&a)[2][4],
                                            uint64_t desc0, uint64_t desc1) {
  static_assert(std::is_same_v<T, BF> || std::is_same_v<T, HF>, "bf16 or f16");
  if constexpr (std::is_same_v<T, BF>)
    WGMMA_CHUNK("bf16");
  else
    WGMMA_CHUNK("f16");
}
#undef WGMMA_CHUNK
#undef WGMMA_D

// B's descriptor: K-major, 128-byte swizzle (8 rows of 64 k, 1024-byte
// atoms, 16-byte chunk c of row r at c ^ r), SBO 1024 between the atoms of
// consecutive 8-row groups along N; `addr` the k16 step's start in its atom
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | uint64_t{1} << 16 |
         uint64_t{1024 >> 4} << 32 | uint64_t{1} << 62;
}
// element (n, k) of K's slice: 64-k blocks of 16 atoms (BN / 8 row groups)
__device__ __forceinline__ int kslice_index(int n, int k) {
  return (k >> 6) * (BN * 64) + (n >> 3) * 512 + (n & 7) * 64 +
         ((((k >> 3) & 7) ^ (n & 7)) << 3) + (k & 7);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous product
__device__ __forceinline__ void fence_acc(float (&acc)[BN / 8][4]) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(acc[i][k])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t bits(__half x) { return __half_as_ushort(x); }
template <typename T> __device__ __forceinline__ T from_bits(uint32_t b);
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint32_t b) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(b & 0xffffu));
}
template <> __device__ __forceinline__ __half from_bits<__half>(uint32_t b) {
  return __ushort_as_half(static_cast<unsigned short>(b & 0xffffu));
}

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// One lane's tap rows in the current group: for rows lane / 4 and
// lane / 4 + 8 of the tile (h = 0, 1), the element offset of each tap's
// pixel row in the map (0 when the tap is outside the map) and which taps
// are inside it (bit 4 h + t).
struct TapRows {
  int off[2][4];
  uint32_t live;
};

// A warp's gather of one chunk into a stage (`stage`, its shared address).
// Lanes 0-15 hold the weights of the tile's queries (tw); lane l copies
// 16-byte piece l % 4 of rows l / 4 and l / 4 + 8 for each tap, so that each
// copy instruction reads 8 whole 64-byte row chunks; zero-filled outside the
// map and past c.
template <typename T>
__device__ __forceinline__ void gather_chunk(const Group& gr, int kc, const TapRows& tr,
                                             const float (&tw)[4], uint32_t stage,
                                             unsigned char* stage_ptr, float4* meta, int lane) {
  constexpr int V = 16 / sizeof(T);
  if (lane < RM) meta[lane] = make_float4(tw[0], tw[1], tw[2], tw[3]);
  const int piece = lane & 3, ch = kc + piece * V;
  const T* base = static_cast<const T*>(gr.map);
  if (gr.vec) {
    const bool in = ch < gr.c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = tap_offset((lane >> 2) + 8 * h, piece);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool live = (tr.live >> (4 * h + t)) & 1;
        cp_async16(stage + t * kTapBytes + off, in ? base + tr.off[h][t] + ch : base, live && in);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = tap_offset((lane >> 2) + 8 * h, piece);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool live = (tr.live >> (4 * h + t)) & 1;
        const T* src = base + tr.off[h][t];
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < V; e += 2) {
          uint32_t lo = 0, hi = 0;
          if (live && ch + e < gr.c) lo = bits(src[ch + e]);
          if (live && ch + e + 1 < gr.c) hi = bits(src[ch + e + 1]);
          v[e / 2] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(stage_ptr + t * kTapBytes + off) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) quad_sample_reduce_mma(const __grid_constant__ Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * kWarpBytes;
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t ring_end = smem_addr(smem + kRingBytes);
  T* ks = reinterpret_cast<T*>(smem + kRingBytes + (((ring_end + 1023) & ~1023u) - ring_end));
  const uint32_t ks_addr = smem_addr(ks);
  const int o0 = blockIdx.y * BN;

  // K's slice, K-major and swizzled (kslice_index): each group's rows
  // padded to a multiple of KC with zeros, and zeros past O
  {
    const T* k = static_cast<const T*>(prm.k);
    int krow = 0;
    for (int g = 0; g < prm.groups; ++g) {
      const int c = prm.g[g].c, rows = (c + KC - 1) / KC * KC;
      for (int e = threadIdx.x; e < rows * BN; e += kThreads) {
        const int r = e / BN, col = e % BN, kr = krow + r;
        ks[kslice_index(col, kr)] =
            r < c && o0 + col < prm.o ? k[static_cast<int64_t>(prm.g[g].k_off + r) * prm.o + o0 + col]
                                      : from_f32<T>(0.0f);
      }
      krow += rows;
    }
  }
  // the products read K through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warpgroups walk 64-query tiles, each warp its 16 rows of them
  constexpr int kGroups = kWarps / 4;
  const int wi = warp & 3;
  const int64_t n_tiles = (prm.n + 4 * RM - 1) / (4 * RM);
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kGroups + (warp >> 2);
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * kGroups;
  if (gw >= n_tiles) return;
  const int cpt = prm.chunks;
  const int64_t steps = ((n_tiles - 1 - gw) / n_groups + 1) * cpt;
  const bool one_frame = prm.per_frame == prm.n;

  // the issue side's taps: lanes 0-15 one query each, my_pix the pixels of
  // rows lane / 4 and lane / 4 + 8 for the copies and tr their rows in the
  // current group's map; its position: tile, chunk, stage, steps
  int pix[4] = {-1, -1, -1, -1}, my_pix[2][4] = {{-1, -1, -1, -1}, {-1, -1, -1, -1}};
  float tw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  TapRows tr{{{0, 0, 0, 0}, {0, 0, 0, 0}}, 0u};
  int64_t i_tile = gw, issued = 0;
  int i_j = 0, i_st = 0;

  auto issue = [&]() {
    if (issued < steps) {
      const Chunk ch = prm.chunk[i_j];
      const Group& gr = prm.g[ch.group];
      if (ch.new_taps) {
        const int64_t q = (i_tile * 4 + wi) * RM + lane;
        if (lane < RM && q < prm.n) {
          const float* p = prm.uv + q * prm.uv_stride;
          const QuadTap qt = quad_tap<T>(p[0], p[1], gr.h, gr.w);
          const int64_t frame = one_frame ? 0 : q / prm.per_frame;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int y = qt.yp - 1 + (t >> 1), x = qt.xp - 1 + (t & 1);
            const bool in = y >= 0 && y < gr.h && x >= 0 && x < gr.w;
            pix[t] = in ? static_cast<int>((frame * gr.h + y) * gr.w + x) : -1;
            tw[t] = qt.w[t];
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            pix[t] = -1;
            tw[t] = 0.0f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < 4; ++t) my_pix[h][t] = __shfl_sync(kFull, pix[t], (lane >> 2) + 8 * h);
      }
      if (ch.kc == 0) {
        tr.live = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            tr.off[h][t] = my_pix[h][t] >= 0 ? my_pix[h][t] * gr.c : 0;
            tr.live |= my_pix[h][t] >= 0 ? 1u << (4 * h + t) : 0u;
          }
      }
      gather_chunk<T>(gr, ch.kc, tr, tw, ring_addr + i_st * kStageBytes, ring + i_st * kStageBytes,
                      reinterpret_cast<float4*>(ring + kStages * kStageBytes + i_st * kMetaBytes),
                      lane);
      if (++i_j == cpt) {
        i_j = 0;
        i_tile += n_groups;
      }
      i_st = i_st + 1 == kStages ? 0 : i_st + 1;
      ++issued;
    }
    cp_async_commit();
  };

  float acc[BN / 8][4];
  const int quad = lane >> 2, ql = lane & 3;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue();

  int64_t tile = gw;
  int j = 0, st = 0;
#pragma unroll 1
  for (int64_t s = 0; s < steps; ++s) {
    issue();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    if (j == 0) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = o0 + nt * 8 + ql * 2;
        const float b0 = col < prm.o ? prm.bias[col] : 0.0f;
        const float b1 = col + 1 < prm.o ? prm.bias[col + 1] : 0.0f;
        acc[nt][0] = b0;
        acc[nt][1] = b1;
        acc[nt][2] = b0;
        acc[nt][3] = b1;
      }
    }
    const unsigned char* stage = ring + st * kStageBytes;
    const float4* meta = reinterpret_cast<const float4*>(ring + kStages * kStageBytes + st * kMetaBytes);
    const float4 wlo = meta[quad], whi = meta[quad + 8];
    const int krow = prm.chunk[j].krow;
    uint32_t a[KC / 16][4];
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // the four taps' 16 x 16 A fragments, combined in f32, rounded once
      uint32_t tap[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ldmatrix_x4(tap[t], smem_addr(stage + t * kTapBytes +
                                      tap_offset(lane & 15, kk * 2 + (lane >> 4))));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w = (i & 1) ? whi : wlo;  // a1, a3: rows 8-15
        const float2 t0 = unpack2<T>(tap[0][i]), t1 = unpack2<T>(tap[1][i]);
        const float2 t2 = unpack2<T>(tap[2][i]), t3 = unpack2<T>(tap[3][i]);
        float lo = w.x * t0.x, hi = w.x * t0.y;
        lo = fmaf(w.y, t1.x, lo);
        hi = fmaf(w.y, t1.y, hi);
        lo = fmaf(w.z, t2.x, lo);
        hi = fmaf(w.z, t2.y, hi);
        lo = fmaf(w.w, t3.x, lo);
        hi = fmaf(w.w, t3.y, hi);
        a[kk][i] = pack2<T>(lo, hi);
      }
    }
    // the warpgroup's 64 x 128 product of this chunk on the tensor cores
    fence_acc(acc);
    wgmma_fence();
    static_assert(KC == 32, "two k16 products a chunk");
    wgmma_chunk<T>(acc, a, kmajor_sw128_desc(ks_addr + (krow >> 6) * (BN * 128) + (krow & 63) * 2),
                  kmajor_sw128_desc(ks_addr + (krow >> 6) * (BN * 128) + ((krow + 16) & 63) * 2));
    wgmma_commit();
    // the product reads A from registers: done before the next chunk's
    // combine rewrites them, and before the epilogue reads the accumulator
    wgmma_wait0();
    fence_acc(acc);
    __syncwarp();  // every lane's reads of the stage are done before it is refilled

    if (j == cpt - 1) {
      // rows quad and quad + 8 of the tile; lane ql of a quad gathers the 8
      // outputs of n-tile 4 G + ql from its quad's four lanes
      const int64_t r0 = (tile * 4 + wi) * RM + quad;
      T* out = static_cast<T*>(prm.out);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t r = r0 + half * 8;
#pragma unroll
        for (int G = 0; G < BN / 32; ++G) {
          uint32_t p[4], got[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            p[u] = pack2<T>(acc[4 * G + u][2 * half], acc[4 * G + u][2 * half + 1]);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            // send n-tile (ql + rr) & 3; receive from lane (ql - rr) & 3 of the quad
            const uint32_t v = sel4(p[0], p[1], p[2], p[3], (ql + rr) & 3);
            got[rr] = __shfl_sync(kFull, v, (lane & ~3) | ((ql - rr) & 3));
          }
          // got[rr] holds columns 2 src, 2 src + 1 with src = (ql - rr) & 3
          uint32_t v4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v4[k] = sel4(got[0], got[1], got[2], got[3], (ql - k) & 3);
          const int col = o0 + (4 * G + ql) * 8;
          if (r < prm.n) {
            T* dst = out + r * prm.o + col;
            if (prm.out_vec && col + 8 <= prm.o) {
              __stcs(reinterpret_cast<uint4*>(dst), make_uint4(v4[0], v4[1], v4[2], v4[3]));
            } else {
#pragma unroll
              for (int k = 0; k < 8; ++k)
                if (col + k < prm.o) dst[k] = from_bits<T>(v4[k >> 1] >> (16 * (k & 1)));
            }
          }
        }
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
    if (++j == cpt) {
      j = 0;
      tile += n_groups;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// f32: a plain kernel

constexpr int FM = 32;   // queries per block
constexpr int FKC = 32;  // channels per chunk
constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;

__global__ void __launch_bounds__(kFThreads) quad_sample_reduce_f32(const __grid_constant__ Params prm) {
  __shared__ float as[FM][FKC + 1];
  __shared__ float bs[FKC][BN];
  __shared__ int s_pix[FM][4];
  __shared__ float s_w[FM][4];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * FM;
  const int o0 = blockIdx.y * BN;
  const float* k = static_cast<const float*>(prm.k);
  float acc[FM / kFWarps][BN / 32];
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    const int col = o0 + lane + 32 * j;
    const float b = col < prm.o ? prm.bias[col] : 0.0f;
#pragma unroll
    for (int i = 0; i < FM / kFWarps; ++i) acc[i][j] = b;
  }
  for (int g = 0; g < prm.groups; ++g) {
    const Group& gr = prm.g[g];
    const float* map = static_cast<const float*>(gr.map);
    const int64_t c = gr.c;
    __syncthreads();
    if (tid < FM) {
      const int64_t q = q0 + tid;
      if (q < prm.n) {
        const float* p = prm.uv + q * prm.uv_stride;
        const QuadTap qt = quad_tap<float>(p[0], p[1], gr.h, gr.w);
        const int64_t frame = q / prm.per_frame;
        for (int t = 0; t < 4; ++t) {
          const int y = qt.yp - 1 + (t >> 1), x = qt.xp - 1 + (t & 1);
          const bool in = y >= 0 && y < gr.h && x >= 0 && x < gr.w;
          s_pix[tid][t] = in ? static_cast<int>((frame * gr.h + y) * gr.w + x) : -1;
          s_w[tid][t] = qt.w[t];
        }
      } else {
        for (int t = 0; t < 4; ++t) {
          s_pix[tid][t] = -1;
          s_w[tid][t] = 0.0f;
        }
      }
    }
    for (int kc = 0; kc < gr.c; kc += FKC) {
      __syncthreads();
      for (int e = tid; e < FM * FKC; e += kFThreads) {
        const int q = e / FKC, ch = kc + e % FKC;
        float v = 0.0f;
        if (ch < gr.c) {
          float t[4];
          for (int u = 0; u < 4; ++u) t[u] = s_pix[q][u] >= 0 ? map[s_pix[q][u] * c + ch] : 0.0f;
          v = s_w[q][0] * t[0];
          v = fmaf(s_w[q][1], t[1], v);
          v = fmaf(s_w[q][2], t[2], v);
          v = fmaf(s_w[q][3], t[3], v);
        }
        as[q][e % FKC] = v;
      }
      for (int e = tid; e < FKC * BN; e += kFThreads) {
        const int r = e / BN, col = e % BN;
        bs[r][col] = kc + r < gr.c && o0 + col < prm.o
                         ? k[static_cast<int64_t>(gr.k_off + kc + r) * prm.o + o0 + col]
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < FKC; ++kk) {
        float b[BN / 32];
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) b[j] = bs[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < FM / kFWarps; ++i) {
          const float a = as[warp + kFWarps * i][kk];
#pragma unroll
          for (int j = 0; j < BN / 32; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }
  float* out = static_cast<float*>(prm.out);
#pragma unroll
  for (int i = 0; i < FM / kFWarps; ++i) {
    const int64_t r = q0 + warp + kFWarps * i;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = o0 + lane + 32 * j;
      if (r < prm.n && col < prm.o) __stcs(out + r * prm.o + col, acc[i][j]);
    }
  }
}

template <typename T>
__global__ void quad_sample_taps_kernel(const float* uv, int64_t uv_stride, int64_t n,
                                        int64_t per_frame, int h, int w, int32_t* idx,
                                        float4* w4) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const QuadTap qt = quad_tap<T>(uv[q * uv_stride], uv[q * uv_stride + 1], h, w);
  idx[q] = static_cast<int32_t>(((q / per_frame) * (h + 2) + qt.yp) * (w + 2) + qt.xp);
  w4[q] = make_float4(qt.w[0], qt.w[1], qt.w[2], qt.w[3]);
}

// a cudaError_t, or kKSliceTooLarge
template <typename T>
int launch_mma(Params& prm, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int k_rows = 0, chunks = 0;
  for (int g = 0; g < prm.groups; ++g) {
    Group& gr = prm.g[g];
    // tap rows are addressed by int32 element offsets
    if (prm.n / prm.per_frame * gr.h * static_cast<int64_t>(gr.w) * gr.c >= (int64_t{1} << 31))
      return cudaErrorInvalidValue;
    gr.vec = gr.c % V == 0 && reinterpret_cast<uintptr_t>(gr.map) % 16 == 0;
    const bool same = g > 0 && prm.g[g - 1].h == gr.h && prm.g[g - 1].w == gr.w;
    for (int kc = 0; kc < gr.c; kc += KC) {
      if (chunks == kMaxChunks) return kKSliceTooLarge;
      prm.chunk[chunks++] = Chunk{g, kc, k_rows + kc, kc == 0 && !same};
    }
    k_rows += (gr.c + KC - 1) / KC * KC;
  }
  if ((k_rows + 63) / 64 * 64 > kMaxKRows) return kKSliceTooLarge;
  prm.chunks = chunks;
  prm.k_rows = k_rows;
  prm.out_vec = prm.o % 8 == 0 && reinterpret_cast<uintptr_t>(prm.out) % 16 == 0;
  const int smem = kRingBytes + 1024 + (k_rows + 63) / 64 * 64 * BN * 2;
  cudaError_t err = cudaFuncSetAttribute(quad_sample_reduce_mma<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quad_sample_reduce_mma<T>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int o_tiles = (prm.o + BN - 1) / BN;
  const int64_t n_tiles = (prm.n + 4 * RM - 1) / (4 * RM);
  int64_t blocks = sms * per_sm / o_tiles;
  if (blocks < 1) blocks = 1;
  const int64_t needed = (n_tiles + kWarps / 4 - 1) / (kWarps / 4);
  if (blocks > needed) blocks = needed;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(o_tiles));
  quad_sample_reduce_mma<T><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

cudaError_t launch_f32(Params& prm, cudaStream_t stream) {
  const int64_t blocks = (prm.n + FM - 1) / FM;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((prm.o + BN - 1) / BN));
  quad_sample_reduce_f32<<<grid, kFThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// uv: query j's (x, y) at uv[j * uv_stride] and uv[j * uv_stride + 1], f32;
// n queries, per_frame of them a frame (n a multiple). For each of the
// `groups` groups (1 to 4): maps[g] its unpadded map (B, hs[g], ws[g],
// cs[g]) in the compute type, contiguous; k_offs[g] its first row of kmat.
// kmat: (sum of cs, o) in the compute type, contiguous. bias: (o,) f32.
// out: (n, o) in the compute type. dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns the launch's cudaError_t, or -1 (nothing launched) when bf16 / f16
// K's rows do not fit in a block's shared memory.
extern "C" int quad_sample_reduce_fwd(const void* uv, int64_t uv_stride, int64_t n,
                                      int64_t per_frame, const void* const* maps, const int* hs,
                                      const int* ws, const int* cs, const int* k_offs,
                                      int groups, const void* kmat, const void* bias, void* out,
                                      int o, int dtype, void* stream) {
  if (groups < 1 || groups > kMaxGroups || o < 1 || n < 0 || per_frame < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params prm{};
  prm.uv = static_cast<const float*>(uv);
  prm.uv_stride = uv_stride;
  prm.n = n;
  prm.per_frame = per_frame;
  prm.groups = groups;
  for (int g = 0; g < groups; ++g) {
    if (cs[g] < 1 || hs[g] < 1 || ws[g] < 1 || k_offs[g] < 0) return cudaErrorInvalidValue;
    prm.g[g] = Group{maps[g], hs[g], ws[g], cs[g], k_offs[g], 0};
  }
  prm.k = kmat;
  prm.bias = static_cast<const float*>(bias);
  prm.out = out;
  prm.o = o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(prm, s);
    case 1: return launch_mma<__nv_bfloat16>(prm, s);
    case 2: return launch_mma<__half>(prm, s);
    default: return cudaErrorInvalidValue;
  }
}

// The fused kernel's taps alone, for one map of h x w pixels: idx (n,) int32
// the top-left tap's flat pixel in the zero-padded (B, h + 2, w + 2) map,
// w4 (n, 4) f32 the weights, as ops/quad_sample.py::quad_indices builds them.
// uv, uv_stride, per_frame and dtype as quad_sample_reduce_fwd's.
extern "C" int quad_sample_taps(const void* uv, int64_t uv_stride, int64_t n, int64_t per_frame,
                                int h, int w, void* idx, void* w4, int dtype, void* stream) {
  if (n < 0 || per_frame < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + 255) / 256;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(uv);
  int32_t* i = static_cast<int32_t*>(idx);
  float4* wv = static_cast<float4*>(w4);
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0: quad_sample_taps_kernel<float><<<nb, 256, 0, s>>>(u, uv_stride, n, per_frame, h, w, i, wv); break;
    case 1: quad_sample_taps_kernel<__nv_bfloat16><<<nb, 256, 0, s>>>(u, uv_stride, n, per_frame, h, w, i, wv); break;
    case 2: quad_sample_taps_kernel<__half><<<nb, 256, 0, s>>>(u, uv_stride, n, per_frame, h, w, i, wv); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
