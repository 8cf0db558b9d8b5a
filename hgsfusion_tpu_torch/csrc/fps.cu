// Farthest-point sampling for Hopper (sm_90a): one block a frame, the whole
// chain of k - 1 dependent selections in one launch for a batch.
//
// Replaces no TPU kernel: hgsfusion_tpu/ops/pointnet2.py::farthest_point_sample
// is XLA's lax.fori_loop. PV-RCNN and PV-RCNN++ pick their 1,024 keypoints of
// 8,192 points with it; the port's plain version (ops/pointnet2.py::
// farthest_point_sample_plain) is that loop in PyTorch, about 7 launches a
// step, so some 7,000 launches a frame. Its rules, each kept here:
//
//   out[0] = 0, even where point 0 is not valid;
//   dist = valid ? 1e10 : -1;
//   for s in 1 .. k-1:
//     last = xyz[out[s-1]]
//     dist = min(dist, valid ? ((dx*dx + dy*dy) + dz*dz) : -1)   (f32)
//     out[s] = argmax(dist), ties to the lowest index
//
// so k may exceed the valid points (then the argmax finds a valid point at
// distance 0, or index 0 where none is valid).
//
// FPS is chaotic: one rounding difference picks another point, and every
// keypoint after it moves. So the kernel equals the plain version's indices
// exactly: the difference and the products and sums are each rounded on their
// own (__fsub_rn / __fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA) in the plain version's order, and both reductions break ties to the
// lower index. An invalid point keeps -1, as min(-1, d) with d >= 0.
//
// Design. Each of the block's 1,024 threads keeps its points' running minima
// (j = t, t + 1024, ...: at most 16, so N <= 16,384) in registers, and the
// frame's xyz sits in shared memory (192 KB at 16,384) to read the last
// selected point. Up to 8,192 points a thread keeps their xyz in registers
// too; above, it reads them from shared memory each step (stride-3 words
// across a warp: no bank conflict). A step: each thread updates its minima
// and takes its best (ascending j, a strict > keeps the first), a
// warp-shuffle argmax, one value a warp into a shared slot of the step's
// parity, one barrier, then every warp reduces the 32 slots itself (so the
// next step may write the other parity's slots without a second barrier)
// and reads the winner's xyz.
//
// Bound on an H100: the chain of k - 1 dependent block-wide argmax steps, not
// bytes (xyz read once, 8 B an index written). Each step is a barrier and two
// five-round shuffle reductions after 8 (16) distance updates a thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int REG_PTS = 8;   // points a thread keeps with their xyz in registers
constexpr int MAX_PTS = 16;  // points a thread keeps (their minima in registers)
constexpr int MAX_POINTS = THREADS * MAX_PTS;
constexpr int MAX_DEVICES = 64;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) takes (v2, i2) where v2 is larger, or equal at a lower index
__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// every lane ends with the warp's (max, lowest index of the max)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, v2, i2);
  }
}

// PTS points a thread; kRegXYZ: their xyz in registers, else read from the
// shared copy each step
template <int PTS, bool kRegXYZ>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid, int n, int k,
           int64_t* __restrict__ out) {
  extern __shared__ float s_xyz[];  // the frame's (n, 3) points
  __shared__ float s_val[2][WARPS];
  __shared__ int s_idx[2][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* p = xyz + static_cast<int64_t>(blockIdx.x) * n * 3;
  const uint8_t* v = valid + static_cast<int64_t>(blockIdx.x) * n;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * k;
  for (int j = t; j < n * 3; j += THREADS) s_xyz[j] = p[j];
  constexpr int XYZ = kRegXYZ ? PTS : 1;
  float x[XYZ], y[XYZ], z[XYZ], d[PTS];
#pragma unroll
  for (int q = 0; q < PTS; ++q) {
    const int j = t + q * THREADS;
    d[q] = (j < n && v[j]) ? 1e10f : -1.0f;
    if constexpr (kRegXYZ) {
      x[q] = y[q] = z[q] = 0.0f;
      if (j < n) {
        x[q] = p[3 * j];
        y[q] = p[3 * j + 1];
        z[q] = p[3 * j + 2];
      }
    }
  }
  __syncthreads();
  if (t == 0) o[0] = 0;
  float lx = s_xyz[0], ly = s_xyz[1], lz = s_xyz[2];
  for (int s = 1; s < k; ++s) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
      const int j = t + q * THREADS;
      if (j < n) {
        float px, py, pz;
        if constexpr (kRegXYZ) {
          px = x[q];
          py = y[q];
          pz = z[q];
        } else {
          px = s_xyz[3 * j];
          py = s_xyz[3 * j + 1];
          pz = s_xyz[3 * j + 2];
        }
        const float dx = __fsub_rn(px, lx), dy = __fsub_rn(py, ly), dz = __fsub_rn(pz, lz);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        d[q] = fminf(d[q], dd);  // an invalid point's -1 stays
        if (d[q] > bv) {
          bv = d[q];
          bi = j;
        }
      }
    }
    warp_argmax(bv, bi);
    const int buf = s & 1;
    if (lane == 0) {
      s_val[buf][warp] = bv;
      s_idx[buf][warp] = bi;
    }
    __syncthreads();
    bv = s_val[buf][lane];
    bi = s_idx[buf][lane];
    warp_argmax(bv, bi);
    if (t == 0) o[s] = bi;
    lx = s_xyz[3 * bi];
    ly = s_xyz[3 * bi + 1];
    lz = s_xyz[3 * bi + 2];
  }
}

// the dynamic shared memory above 48 KB is granted once per device and
// instantiation (so that a call inside a CUDA graph capture makes no
// attribute call)
template <int PTS, bool kRegXYZ>
cudaError_t raise_smem() {
  static int raised[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < MAX_DEVICES && raised[device])) return err;
  err = cudaFuncSetAttribute(fps_kernel<PTS, kRegXYZ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             THREADS * PTS * 3 * static_cast<int>(sizeof(float)));
  if (err == cudaSuccess && device < MAX_DEVICES) raised[device] = 1;
  return err;
}

template <int PTS, bool kRegXYZ>
int launch(const void* xyz, const void* valid, int b, int n, int k, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem<PTS, kRegXYZ>();
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PTS, kRegXYZ><<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(valid), n, k,
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// The most points a frame may hold (what the registers of a block keep).
extern "C" int fps_max_points() { return MAX_POINTS; }

// xyz: (b, n, 3) float32, contiguous; valid: (b, n) bool (one byte each).
// out: (b, k) int64, every element written: each frame's k indices in
// selection order. 1 <= n <= fps_max_points() (16,384), b at most 2^31 - 1.
// Returns the launch's cudaError_t.
extern "C" int fps(const void* xyz, const void* valid, int b, int n, int k, void* out,
                   void* stream) {
  if (b == 0 || k == 0) return cudaSuccess;
  if (b < 0 || k < 0 || n < 1 || n > MAX_POINTS) return cudaErrorInvalidValue;
  if (n <= THREADS * REG_PTS) return launch<REG_PTS, true>(xyz, valid, b, n, k, out, stream);
  return launch<MAX_PTS, false>(xyz, valid, b, n, k, out, stream);
}
