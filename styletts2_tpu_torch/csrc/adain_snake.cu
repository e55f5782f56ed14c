// Fused AdaIN + snake for Hopper (sm_90a), NCW layout.
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `fused_adain_snake` (styletts2_tpu/ops/pallas_kernels.py:38-105). For each
// (b, c) row of x (B, C, T):
//     y   = (1 + gamma[b,c]) * (x - mean_T) * rsqrt(var_T + 1e-5) + beta[b,c]
//     out = y + sin^2(alpha[c] * y) / alpha[c]
// with f32 math and the output in x's dtype (f32 or bf16). The variance is the
// centred one (Welford), not E[x^2] - mean^2, which cancels on rows whose
// mean is large against their spread.
//
// What bounds it: bytes. Each element costs ~20 flops against 8 bytes moved
// (f32 read + write), far below the card's flop/byte balance. A full-width
// stage-1 call, x (1, 128, 48001) f32, is one 192 KB row per channel and moves
// at least 2 * 24.6 MB = 49 MB: one read and one write. The statistics need a
// second read of the row; at 192 KB a row fits L2 (50 MB) many times over, so
// that read is mostly served from L2 rather than HBM.
//
// Design: one thread block per (b, c) row, which NCW makes contiguous in T,
// so every load is coalesced and the reduction never leaves the block (no
// second kernel, no atomics, no ragged-edge tiling: any T >= 1, any C). Pass
// 1 reads the row once and accumulates Welford (count, mean, M2) per thread,
// merged across the warp with shuffles and across warps in shared memory.
// Pass 2 re-reads the row (from L2), normalises, applies the affine and the
// snake, and writes. Long rows get 1024 threads so enough loads are in flight
// to cover the ~130 blocks that the main path's channel counts give.
// Vectorised loads, TMA and a persistent grid are for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Welford {
  float n, mean, m2;
};

__device__ __forceinline__ Welford merge(Welford a, Welford b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  float n = a.n + b.n;
  float delta = b.mean - a.mean;
  float wb = b.n / n;
  Welford r;
  r.n = n;
  r.mean = a.mean + delta * wb;
  r.m2 = a.m2 + b.m2 + delta * delta * a.n * wb;
  return r;
}

__device__ __forceinline__ Welford warp_merge(Welford w) {
  for (int off = 16; off > 0; off >>= 1) {
    Welford o;
    o.n = __shfl_xor_sync(0xffffffffu, w.n, off);
    o.mean = __shfl_xor_sync(0xffffffffu, w.mean, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, w.m2, off);
    w = merge(w, o);
  }
  return w;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void adain_snake_kernel(const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ alpha,
                                   T* __restrict__ out, int C, int64_t len,
                                   float eps) {
  __shared__ Welford partial[32];
  __shared__ float stats[2];
  const int64_t row = blockIdx.x;  // b * C + c
  const int c = static_cast<int>(row % C);
  const T* xr = x + row * len;
  T* yr = out + row * len;

  // pass 1: Welford over this thread's strided elements
  Welford w = {0.f, 0.f, 0.f};
  for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
    float v = load_f32(xr + t);
    w.n += 1.f;
    float d = v - w.mean;
    w.mean += d / w.n;
    w.m2 += d * (v - w.mean);
  }
  w = warp_merge(w);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = w;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    w = lane < nwarps ? partial[lane] : Welford{0.f, 0.f, 0.f};
    w = warp_merge(w);
    if (lane == 0) {
      stats[0] = w.mean;
      stats[1] = rsqrtf(w.m2 / w.n + eps);
    }
  }
  __syncthreads();

  // pass 2: normalise, style affine, snake
  const float mean = stats[0];
  const float rstd = stats[1];
  const float g = 1.f + gamma[row];
  const float b = beta[row];
  const float a = alpha[c];
  for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
    float y = g * ((load_f32(xr + t) - mean) * rstd) + b;
    float s = sinf(a * y);
    store(yr + t, y + (s * s) / a);
  }
}

}  // namespace

// Plain C entry point for ctypes. x/out: (B, C, T) contiguous, f32 when
// is_bf16 == 0 else bf16; gamma/beta: (B, C) f32; alpha: (C,) f32. threads is
// a multiple of 32 in [32, 1024]. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported.
extern "C" int adain_snake_forward(const void* x, const void* gamma,
                                   const void* beta, const void* alpha,
                                   void* out, int B, int C, int64_t T,
                                   int is_bf16, int threads, void* stream) {
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* a = static_cast<const float*>(alpha);
  if (is_bf16) {
    adain_snake_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, a,
        static_cast<__nv_bfloat16*>(out), C, T, 1e-5f);
  } else {
    adain_snake_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), g, b, a, static_cast<float*>(out), C,
        T, 1e-5f);
  }
  return static_cast<int>(cudaGetLastError());
}
