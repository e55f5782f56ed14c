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
//
// The backward (K2, `adain_snake_backward` below) replaces the analytic VJP
// `_bwd` of the custom VJP `_adain_snake_pallas`
// (styletts2_tpu/ops/pallas_kernels.py:108-164). With x^ = (x - mean) * rstd,
// g = 1 + gamma, z = g * x^ + beta:
//     dz     = dy * (1 + sin 2az)
//     dalpha = sum_{B,T} dy * (z sin(2az) / a - sin^2(az) / a^2)
//     dgamma = sum_T dz * x^,   dbeta = sum_T dz
//     dx     = rstd * (g dz - g mean_T(dz) - x^ g mean_T(dz x^))
// all in f32, the statistics recomputed (the forward saves only its inputs).
// One block per (b, c) row again, three passes over the row: Welford
// statistics (x), the row sums and this row's dalpha term (x, dy), then dx
// (x, dy). dgamma and dbeta are whole per row; dalpha needs a sum over B, so
// the kernel writes a (B, C) partial and the wrapper reduces it over B in a
// fixed order (no atomics: the result is the same from run to run).
// What bounds it: bytes again, ~5 row reads and 1 write per element (5 * 4 +
// 4 bytes in f32 against ~40 flops), the re-reads mostly from L2 at the
// training rows (<= 96 KB each). A later design could keep the row in shared
// memory or registers between passes (one HBM read of x and dy) or fuse the
// statistics into the forward's saved state.

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

// mean and rstd of one row, Welford, written to stats[0..1] for the block
__device__ __forceinline__ void row_stats(Welford w, float eps, float* stats) {
  __shared__ Welford partial[32];
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
}

struct Sums {
  float dz, dz_xhat, dalpha;
};

__device__ __forceinline__ Sums warp_sum(Sums s) {
  for (int off = 16; off > 0; off >>= 1) {
    s.dz += __shfl_xor_sync(0xffffffffu, s.dz, off);
    s.dz_xhat += __shfl_xor_sync(0xffffffffu, s.dz_xhat, off);
    s.dalpha += __shfl_xor_sync(0xffffffffu, s.dalpha, off);
  }
  return s;
}

template <typename T>
__global__ void adain_snake_bwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ dy,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ alpha,
                                       T* __restrict__ dx,
                                       float* __restrict__ dgamma,
                                       float* __restrict__ dbeta,
                                       float* __restrict__ dalpha_rows, int C,
                                       int64_t len, float eps) {
  __shared__ float stats[2];
  __shared__ Sums partial[32];
  __shared__ float sums[2];
  const int64_t row = blockIdx.x;  // b * C + c
  const int c = static_cast<int>(row % C);
  const T* xr = x + row * len;
  const T* dyr = dy + row * len;
  T* dxr = dx + row * len;

  // pass 1: statistics, as the forward computes them
  Welford w = {0.f, 0.f, 0.f};
  for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
    float v = load_f32(xr + t);
    w.n += 1.f;
    float d = v - w.mean;
    w.mean += d / w.n;
    w.m2 += d * (v - w.mean);
  }
  row_stats(w, eps, stats);
  const float mean = stats[0];
  const float rstd = stats[1];
  const float g = 1.f + gamma[row];
  const float b = beta[row];
  const float a = alpha[c];
  const float inv_a = 1.f / a;

  // pass 2: sum dz, sum dz * x^ and this row's dalpha term
  Sums s = {0.f, 0.f, 0.f};
  for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
    const float xhat = (load_f32(xr + t) - mean) * rstd;
    const float z = g * xhat + b;
    const float d = load_f32(dyr + t);
    const float sn = sinf(a * z);
    const float s2 = sinf(2.f * a * z);
    const float dz = d * (1.f + s2);
    s.dz += dz;
    s.dz_xhat += dz * xhat;
    s.dalpha += d * (z * s2 * inv_a - sn * sn * inv_a * inv_a);
  }
  s = warp_sum(s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? partial[lane] : Sums{0.f, 0.f, 0.f};
    s = warp_sum(s);
    if (lane == 0) {
      dgamma[row] = s.dz_xhat;
      dbeta[row] = s.dz;
      dalpha_rows[row] = s.dalpha;
      sums[0] = g * s.dz / static_cast<float>(len);       // mean_T(g dz)
      sums[1] = g * s.dz_xhat / static_cast<float>(len);  // mean_T(g dz x^)
    }
  }
  __syncthreads();

  // pass 3: dx
  const float m_dz = sums[0];
  const float m_dzx = sums[1];
  for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
    const float xhat = (load_f32(xr + t) - mean) * rstd;
    const float z = g * xhat + b;
    const float dz = load_f32(dyr + t) * (1.f + sinf(2.f * a * z));
    store(dxr + t, rstd * (g * dz - m_dz - xhat * m_dzx));
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

// Backward entry point. x/dy/dx: (B, C, T) contiguous in the same dtype (f32
// or bf16, as is_bf16 says); gamma/beta: (B, C) f32; alpha: (C,) f32;
// dgamma/dbeta/dalpha_rows: (B, C) f32 outputs (dalpha_rows is the per-row
// partial of dalpha, summed over B by the caller). Same launch contract as
// the forward.
extern "C" int adain_snake_backward(const void* x, const void* dy,
                                    const void* gamma, const void* beta,
                                    const void* alpha, void* dx, void* dgamma,
                                    void* dbeta, void* dalpha_rows, int B,
                                    int C, int64_t T, int is_bf16, int threads,
                                    void* stream) {
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* a = static_cast<const float*>(alpha);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* da = static_cast<float*>(dalpha_rows);
  if (is_bf16) {
    adain_snake_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), g, b, a,
        static_cast<__nv_bfloat16*>(dx), dg, db, da, C, T, 1e-5f);
  } else {
    adain_snake_bwd_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), g, b, a,
        static_cast<float*>(dx), dg, db, da, C, T, 1e-5f);
  }
  return static_cast<int>(cudaGetLastError());
}
