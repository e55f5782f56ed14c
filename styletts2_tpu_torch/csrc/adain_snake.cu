// Fused AdaIN + snake for Hopper (sm_90a), NCW layout: the forward (K1) and
// its analytic backward (K2).
//
// K1 replaces the Pallas TPU kernel `_kernel` reached through
// `fused_adain_snake` (styletts2_tpu/ops/pallas_kernels.py:38-105). For each
// (b, c) row of x (B, C, T):
//     y   = (1 + gamma[b,c]) * (x - mean_T) * rsqrt(var_T + 1e-5) + beta[b,c]
//     out = y + sin^2(alpha[c] * y) / alpha[c]
// with f32 math and the output in x's dtype (f32 or bf16). var_T is the
// centred variance, not E[x^2] - mean^2, which cancels on rows whose mean is
// large against their spread.
//
// K2 replaces the analytic VJP `_bwd` of the custom VJP `_adain_snake_pallas`
// (pallas_kernels.py:108-164). With x^ = (x - mean) * rstd, g = 1 + gamma,
// z = g * x^ + beta:
//     dz     = dy * (1 + sin 2az)
//     dalpha = sum_{B,T} dy * (z sin(2az) / a - sin^2(az) / a^2)
//     dgamma = sum_T dz * x^,   dbeta = sum_T dz
//     dx     = rstd * (g dz - g mean_T(dz) - x^ g mean_T(dz x^))
// all in f32, the statistics recomputed (the forward saves only its inputs).
//
// What bounds them: bytes. K1 does ~25 flops per element against 8 bytes
// (f32 in and out), K2 ~60 against 12 (x and dy in, dx out), far below the
// card's flop/byte balance. The least traffic reads each input once and
// writes each output once: K1 moves B*C*T*2*sizeof(T) bytes (49 MB, 14.7 us
// at 3.35 TB/s, for (1, 32, 192000) f32), K2 B*C*T*3*sizeof(T) (590 MB,
// 176 us, for (16, 128, 24001) f32), beside (B, C) vectors.
//
// Design. The output needs the row's statistics, a reduction over all of T,
// so a kernel that streams each row from HBM reads it twice (K2: three
// times), and one block per row leaves most SMs idle at B = 1 (32 rows for
// 132 SMs at C = 32). Here each row is split over a thread-block cluster of
// k blocks, k in {1, 2, 4, 8}, which the wrapper's `_plan` chooses so that
// B*C*k blocks fill the SMs. Each block copies its slice of x (K2: and of
// dy) into shared memory with TMA bulk copies (cp.async.bulk completing on
// mbarriers, in kChunks pieces so that the first pass starts while the rest
// lands) and then reads HBM no more: every later pass reads shared memory,
// and the output leaves in 16-byte stores. Each block reduces its slice
// (the sum, then the centred M2 about the slice's own mean; K2 also the sums
// of dz, dz*x^ and the dalpha term), writes the partial to its shared
// memory, and after a cluster barrier every block reads the k partials
// through distributed shared memory and merges them in rank order 0..k-1
// (Chan's parallel variance): every block of a row holds bit-identical
// statistics, and every run gives the same bits. A last cluster barrier
// keeps each block's shared memory alive until its peers have read it. dgamma
// and dbeta are whole per row and written by rank 0; dalpha is written per
// row and summed over B by the wrapper in a fixed order (no atomics).
//
// Alignment. TMA bulk copies and 16-byte vectors need 16-byte-aligned
// addresses and sizes, and a row starts at x + row*T, unaligned for odd T.
// So the slices' boundaries fall on aligned elements: rank 0 takes the
// row's unaligned head (< 16 bytes) and then S elements, rank j > 0 starts
// at head + j*S (S is a multiple of 16 bytes), and the last rank ends at T
// with an unaligned tail (< 16 bytes). Head and tail are read from global
// memory with scalar loads in each pass; a rank past the end of a short row
// has an empty slice and still takes part in the cluster's barriers.
//
// Rows whose slice does not fit a block's shared memory (f32 T > ~460k for
// K1 at k = 8) keep the cluster split but stream: each pass re-reads the
// slice from global memory (L2 or HBM) with the same 16-byte loads.
//
// Arithmetic. At B = 1 the grid is one wave: every block loads, then every
// block computes and stores, so the output pass's instructions show in the
// time. The sines are taken on the special function unit (__sinf,
// __sincosf) after a two-constant reduction of the argument to [-pi, pi],
// where their absolute error is at most 2^-21.4 (3.6e-7), against ~1 ulp for
// sinf; the outputs stay within a few f32 ulps of the plain version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunks = 4;         // TMA copies, and mbarriers, per array and block
constexpr int kMaxThreads = 512;   // two blocks of 512 threads share an SM

// 16 bytes of f32 or bf16 as floats; single elements
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int V = 8;
  // a bf16 is the high half of an f32: widening is a shift
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
              << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

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

// Sums each of v[0..N) over the block; every thread gets the same bits
// (the butterfly adds the same two operands in both lanes, and every thread
// adds the warps' sums in the same order). red holds 16 * N floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * N + i];
    v[i] = s;
  }
  __syncthreads();
}

// This block's part of a row of len elements: [lo, hi), of which the aligned
// middle [a0, a0 + nvec * V) is 16-byte vectors; the rest (at most V - 1
// elements before a0 and V - 1 after the middle) are the edges.
struct Slice {
  int64_t lo, hi, a0;
  int nvec;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <int V>
__device__ __forceinline__ Slice slice_of(int64_t row, int64_t len, int rank, int k,
                                          int64_t S) {
  const int64_t head = min64(len, (V - (row * len) % V) % V);
  Slice s;
  s.lo = rank == 0 ? 0 : min64(len, head + rank * S);
  s.hi = rank == k - 1 ? len : min64(len, head + (rank + 1) * S);
  s.a0 = rank == 0 ? head : s.lo;
  s.nvec = static_cast<int>((s.hi - s.a0) / V);
  return s;
}

template <int V>
__device__ __forceinline__ int edge_count(const Slice& s) {
  return static_cast<int>((s.a0 - s.lo) + (s.hi - s.a0 - static_cast<int64_t>(s.nvec) * V));
}

// the element index of edge element j of the slice
template <int V>
__device__ __forceinline__ int64_t edge(const Slice& s, int j) {
  const int nh = static_cast<int>(s.a0 - s.lo);
  return j < nh ? s.lo + j : s.a0 + static_cast<int64_t>(s.nvec) * V + (j - nh);
}

__device__ __forceinline__ void chunk(int nvec, int ch, int& v0, int& v1) {
  const int per = (nvec + kChunks - 1) / kChunks;
  v0 = min(nvec, ch * per);
  v1 = min(nvec, (ch + 1) * per);
}

// x - 2 pi * rint(x / 2 pi), with 2 pi as the f32 6.2831855 minus 1.7484555e-7
__device__ __forceinline__ float reduce_2pi(float x) {
  const float j = rintf(x * 0.159154943091895336f);
  return fmaf(j, 1.74845553e-7f, fmaf(-j, 6.28318548202514648f, x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Starts the TMA bulk copies of the slice's aligned middle of xr (and of dyr
// when ds is not null) into xs (ds): chunk ch completes on bars[ch]. Every
// thread of the block calls it.
template <typename T>
__device__ void load_slice(uint64_t* bars, const Slice& s, const T* xr, T* xs, const T* dyr,
                           T* ds) {
  constexpr int V = Io<T>::V;
  if (threadIdx.x == 0) {
    for (int ch = 0; ch < kChunks; ++ch) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[ch]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int ch = 0; ch < kChunks; ++ch) {
      int v0, v1;
      chunk(s.nvec, ch, v0, v1);
      const uint32_t bytes = static_cast<uint32_t>(v1 - v0) * 16u;
      const uint32_t bar = smem_addr(&bars[ch]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(ds ? 2u * bytes : bytes)
                   : "memory");
      if (bytes == 0) continue;
      const int64_t off = s.a0 + static_cast<int64_t>(v0) * V;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(xs + v0 * V)),
          "l"(xr + off), "r"(bytes), "r"(bar)
          : "memory");
      if (ds) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_addr(ds + v0 * V)),
            "l"(dyr + off), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
  }
}

// The row's mean and rstd into stats[0..1] for every thread of every block
// of the cluster: each block's partial `part`, merged in rank order. Lane r
// of warp 0 reads rank r's partial, so the k remote reads overlap.
__device__ __forceinline__ void row_stats(Welford& part, int k, float eps, float* stats) {
  cg::cluster_group cluster = cg::this_cluster();
  if (k > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    Welford p = {0.f, 0.f, 0.f};
    if (threadIdx.x < k) p = k > 1 ? *cluster.map_shared_rank(&part, threadIdx.x) : part;
    Welford w = {0.f, 0.f, 0.f};
    for (int r = 0; r < k; ++r) {
      const Welford o = {__shfl_sync(0xffffffffu, p.n, r), __shfl_sync(0xffffffffu, p.mean, r),
                         __shfl_sync(0xffffffffu, p.m2, r)};
      w = merge(w, o);
    }
    if (threadIdx.x == 0) {
      stats[0] = w.mean;
      stats[1] = rsqrtf(w.m2 / w.n + eps);
    }
  }
  __syncthreads();
}

// This block's (count, mean, M2) of x over its slice, into part (thread 0).
// src is the slice's aligned middle (shared memory when resident, else
// global memory); the first pass waits for each TMA chunk as it lands.
template <typename T>
__device__ __forceinline__ void slice_moments(const Slice& s, const T* src, const T* xr,
                                              bool resident, uint64_t* bars, float* red,
                                              Welford& part) {
  constexpr int V = Io<T>::V;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nedge = edge_count<V>(s);
  float sum[1] = {0.f};
  for (int ch = 0; ch < kChunks; ++ch) {
    int v0, v1;
    chunk(s.nvec, ch, v0, v1);
    if (resident) mbar_wait(&bars[ch], 0);
    for (int i = v0 + tid; i < v1; i += nt) {
      float v[V];
      Io<T>::load(src + i * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) sum[0] += v[e];
    }
  }
  for (int j = tid; j < nedge; j += nt) sum[0] += Io<T>::get(xr + edge<V>(s, j));
  block_sum(sum, red);
  const float n = static_cast<float>(s.hi - s.lo);
  const float m = n > 0.f ? sum[0] / n : 0.f;
  float m2[1] = {0.f};
  for (int i = tid; i < s.nvec; i += nt) {
    float v[V];
    Io<T>::load(src + i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - m;
      m2[0] += d * d;
    }
  }
  for (int j = tid; j < nedge; j += nt) {
    const float d = Io<T>::get(xr + edge<V>(s, j)) - m;
    m2[0] += d * d;
  }
  block_sum(m2, red);
  if (tid == 0) part = Welford{n, m, m2[0]};
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    adain_snake_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ alpha,
                       T* __restrict__ out, int C, int64_t len, int k, int64_t S, bool resident,
                       float eps) {
  constexpr int V = Io<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kChunks];
  __shared__ float red[kMaxThreads / 32];
  __shared__ Welford part;
  __shared__ float stats[2];
  const int rank = static_cast<int>(blockIdx.x % k);
  const int64_t row = blockIdx.x / k;  // b * C + c
  const int c = static_cast<int>(row % C);
  const Slice s = slice_of<V>(row, len, rank, k, S);
  const T* xr = x + row * len;
  T* yr = out + row * len;
  T* xs = reinterpret_cast<T*>(smem);
  if (resident) load_slice<T>(bars, s, xr, xs, nullptr, nullptr);
  const T* src = resident ? xs : xr + s.a0;

  // passes 1-2: the slice's moments; then the row's, from the cluster
  slice_moments<T>(s, src, xr, resident, bars, red, part);
  row_stats(part, k, eps, stats);

  // pass 3: normalise, style affine, snake
  const float mean = stats[0];
  const float rstd = stats[1];
  const float g = 1.f + gamma[row];
  const float b = beta[row];
  const float a = alpha[c];
  const float inv_a = 1.f / a;
  T* dst = yr + s.a0;
  for (int i = threadIdx.x; i < s.nvec; i += blockDim.x) {
    float v[V];
    Io<T>::load(src + i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float y = g * ((v[e] - mean) * rstd) + b;
      const float sn = __sinf(reduce_2pi(a * y));
      v[e] = y + sn * sn * inv_a;
    }
    Io<T>::store(dst + i * V, v);
  }
  const int nedge = edge_count<V>(s);
  for (int j = threadIdx.x; j < nedge; j += blockDim.x) {
    const int64_t t = edge<V>(s, j);
    const float y = g * ((Io<T>::get(xr + t) - mean) * rstd) + b;
    const float sn = __sinf(reduce_2pi(a * y));
    Io<T>::put(yr + t, y + sn * sn * inv_a);
  }
  if (k > 1) cg::this_cluster().sync();  // peers may still read `part`
}

struct Grad {
  float xhat, dz, dalpha;
};

__device__ __forceinline__ Grad grad_at(float x, float d, float mean, float rstd, float g,
                                        float b, float a, float inv_a) {
  Grad r;
  r.xhat = (x - mean) * rstd;
  const float z = g * r.xhat + b;
  float sn, cs;
  __sincosf(reduce_2pi(a * z), &sn, &cs);
  const float s2 = 2.f * sn * cs;  // sin 2az
  r.dz = d * (1.f + s2);
  r.dalpha = d * (z * s2 * inv_a - sn * sn * inv_a * inv_a);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    adain_snake_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ alpha, T* __restrict__ dx,
                           float* __restrict__ dgamma, float* __restrict__ dbeta,
                           float* __restrict__ dalpha_rows, int C, int64_t len, int k, int64_t S,
                           bool resident, float eps) {
  constexpr int V = Io<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kChunks];
  __shared__ float red[kMaxThreads / 32 * 3];
  __shared__ Welford part;
  __shared__ float sums_part[3];
  __shared__ float stats[2];
  __shared__ float sums[2];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rank = static_cast<int>(blockIdx.x % k);
  const int64_t row = blockIdx.x / k;  // b * C + c
  const int c = static_cast<int>(row % C);
  const Slice s = slice_of<V>(row, len, rank, k, S);
  const T* xr = x + row * len;
  const T* dyr = dy + row * len;
  T* dxr = dx + row * len;
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + S;
  if (resident) load_slice<T>(bars, s, xr, xs, dyr, ds);
  const T* xsrc = resident ? xs : xr + s.a0;
  const T* dsrc = resident ? ds : dyr + s.a0;

  // passes 1-2: statistics, as the forward computes them
  slice_moments<T>(s, xsrc, xr, resident, bars, red, part);
  row_stats(part, k, eps, stats);
  const float mean = stats[0];
  const float rstd = stats[1];
  const float g = 1.f + gamma[row];
  const float b = beta[row];
  const float a = alpha[c];
  const float inv_a = 1.f / a;

  // pass 3: sum dz, sum dz * x^ and the dalpha term over the slice
  float acc[3] = {0.f, 0.f, 0.f};
  for (int i = tid; i < s.nvec; i += nt) {
    float xv[V], dv[V];
    Io<T>::load(xsrc + i * V, xv);
    Io<T>::load(dsrc + i * V, dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const Grad r = grad_at(xv[e], dv[e], mean, rstd, g, b, a, inv_a);
      acc[0] += r.dz;
      acc[1] += r.dz * r.xhat;
      acc[2] += r.dalpha;
    }
  }
  const int nedge = edge_count<V>(s);
  for (int j = tid; j < nedge; j += nt) {
    const int64_t t = edge<V>(s, j);
    const Grad r = grad_at(Io<T>::get(xr + t), Io<T>::get(dyr + t), mean, rstd, g, b, a, inv_a);
    acc[0] += r.dz;
    acc[1] += r.dz * r.xhat;
    acc[2] += r.dalpha;
  }
  block_sum(acc, red);
  if (tid == 0) {
    sums_part[0] = acc[0];
    sums_part[1] = acc[1];
    sums_part[2] = acc[2];
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (k > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (tid < 32) {  // the row's sums, in rank order (lane r reads rank r's)
    float p[3] = {0.f, 0.f, 0.f};
    if (tid < k) {
      const float* q = k > 1 ? cluster.map_shared_rank(sums_part, tid) : sums_part;
      p[0] = q[0];
      p[1] = q[1];
      p[2] = q[2];
    }
    float tot[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < k; ++r) {
#pragma unroll
      for (int i = 0; i < 3; ++i) tot[i] += __shfl_sync(0xffffffffu, p[i], r);
    }
    if (tid == 0) {
      if (rank == 0) {
        dgamma[row] = tot[1];
        dbeta[row] = tot[0];
        dalpha_rows[row] = tot[2];
      }
      sums[0] = g * tot[0] / static_cast<float>(len);  // mean_T(g dz)
      sums[1] = g * tot[1] / static_cast<float>(len);  // mean_T(g dz x^)
    }
  }
  __syncthreads();

  // pass 4: dx, dz recomputed
  const float m_dz = sums[0];
  const float m_dzx = sums[1];
  T* dst = dxr + s.a0;
  for (int i = tid; i < s.nvec; i += nt) {
    float xv[V], dv[V];
    Io<T>::load(xsrc + i * V, xv);
    Io<T>::load(dsrc + i * V, dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const Grad r = grad_at(xv[e], dv[e], mean, rstd, g, b, a, inv_a);
      xv[e] = rstd * (g * r.dz - m_dz - r.xhat * m_dzx);
    }
    Io<T>::store(dst + i * V, xv);
  }
  for (int j = tid; j < nedge; j += nt) {
    const int64_t t = edge<V>(s, j);
    const Grad r = grad_at(Io<T>::get(xr + t), Io<T>::get(dyr + t), mean, rstd, g, b, a, inv_a);
    Io<T>::put(dxr + t, rstd * (g * r.dz - m_dz - r.xhat * m_dzx));
  }
  if (k > 1) cluster.sync();  // peers may still read `part` and `sums_part`
}

// Lets the kernel take all the dynamic shared memory the current device
// allows a block beside the kernel's static shared memory, once per device.
// A launch that asks for more is refused.
template <auto Kernel>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, Kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
  }
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The plan's invariants (see `_plan` in ops/adain_snake.py); cudaSuccess or
// cudaErrorInvalidValue.
template <typename T>
cudaError_t check_plan(int B, int C, int64_t len, int k, int64_t S, int threads, int smem,
                       int arrays) {
  constexpr int V = Io<T>::V;
  const bool ok =
      B >= 1 && C >= 1 && len >= 1 && (k == 1 || k == 2 || k == 4 || k == 8) &&
      threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 && S >= V && S % V == 0 &&
      S * k >= len && S / V <= INT_MAX && static_cast<int64_t>(B) * C * k <= INT_MAX &&
      smem >= 0 &&
      (smem == 0 || static_cast<int64_t>(smem) >= arrays * S * static_cast<int64_t>(sizeof(T)));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of B*C*k blocks in clusters of k; returns the launch's error or,
// failing that, cudaGetLastError().
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, int k, int threads, int smem, cudaStream_t st,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T>
int forward(const void* x, const void* gamma, const void* beta, const void* alpha, void* out,
            int B, int C, int64_t len, int k, int64_t S, int threads, int smem,
            cudaStream_t st) {
  cudaError_t err = check_plan<T>(B, C, len, k, S, threads, smem, 1);
  if (err == cudaSuccess) err = allow_smem<adain_snake_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(adain_snake_kernel<T>, B * C * k, k, threads, smem, st,
                static_cast<const T*>(x), static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<const float*>(alpha),
                static_cast<T*>(out), C, len, k, S, smem > 0, 1e-5f);
}

template <typename T>
int backward(const void* x, const void* dy, const void* gamma, const void* beta,
             const void* alpha, void* dx, void* dgamma, void* dbeta, void* dalpha_rows, int B,
             int C, int64_t len, int k, int64_t S, int threads, int smem, cudaStream_t st) {
  cudaError_t err = check_plan<T>(B, C, len, k, S, threads, smem, 2);
  if (err == cudaSuccess) err = allow_smem<adain_snake_bwd_kernel<T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(adain_snake_bwd_kernel<T>, B * C * k, k, threads, smem, st,
                static_cast<const T*>(x), static_cast<const T*>(dy),
                static_cast<const float*>(gamma), static_cast<const float*>(beta),
                static_cast<const float*>(alpha), static_cast<T*>(dx),
                static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                static_cast<float*>(dalpha_rows), C, len, k, S, smem > 0, 1e-5f);
}

}  // namespace

// The current device's room for a plan, into out[0..2]: its SMs; the
// dynamic shared memory one block of any of the kernels may take; and that
// of each of two blocks sharing an SM. Returns a cudaError_t.
extern "C" int adain_snake_limits(int* out) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  const void* kernels[] = {reinterpret_cast<const void*>(adain_snake_kernel<float>),
                           reinterpret_cast<const void*>(adain_snake_kernel<__nv_bfloat16>),
                           reinterpret_cast<const void*>(adain_snake_bwd_kernel<float>),
                           reinterpret_cast<const void*>(adain_snake_bwd_kernel<__nv_bfloat16>)};
  int stat = 0;  // the most static shared memory of any of them
  for (const void* kernel : kernels) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && static_cast<int>(attr.sharedSizeBytes) > stat) {
      stat = static_cast<int>(attr.sharedSizeBytes);
    }
  }
  out[1] = optin - stat;
  out[2] = per_sm / 2 - reserved - stat;
  return static_cast<int>(err);
}

// Plain C entry points for ctypes. x/out: (B, C, T) contiguous and 16-byte
// aligned, f32 when is_bf16 == 0 else bf16; gamma/beta: (B, C) f32; alpha:
// (C,) f32. The plan (`_plan` in ops/adain_snake.py): cluster size k in {1,
// 2, 4, 8}, slice elements per block (a multiple of 16 bytes, k * slice >=
// T), threads (a multiple of 32, <= 512), smem bytes of dynamic shared
// memory (the slice, or 0 to stream it from global memory). Launches on
// `stream`, does not synchronise, and returns a cudaError_t: an invalid
// plan, or the launch's error, so a refused launch is reported.
extern "C" int adain_snake_forward(const void* x, const void* gamma, const void* beta,
                                   const void* alpha, void* out, int B, int C, int64_t T,
                                   int is_bf16, int k, int64_t slice, int threads, int smem,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return forward<__nv_bfloat16>(x, gamma, beta, alpha, out, B, C, T, k, slice, threads, smem,
                                  st);
  }
  return forward<float>(x, gamma, beta, alpha, out, B, C, T, k, slice, threads, smem, st);
}

// Backward entry point. x/dy/dx: (B, C, T) contiguous, 16-byte aligned, in
// the same dtype (f32 or bf16, as is_bf16 says); gamma/beta: (B, C) f32;
// alpha: (C,) f32; dgamma/dbeta/dalpha_rows: (B, C) f32 outputs (dalpha_rows
// is the per-row partial of dalpha, summed over B by the caller). The plan
// as for the forward, smem holding the slices of x and dy.
extern "C" int adain_snake_backward(const void* x, const void* dy, const void* gamma,
                                    const void* beta, const void* alpha, void* dx, void* dgamma,
                                    void* dbeta, void* dalpha_rows, int B, int C, int64_t T,
                                    int is_bf16, int k, int64_t slice, int threads, int smem,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return backward<__nv_bfloat16>(x, dy, gamma, beta, alpha, dx, dgamma, dbeta, dalpha_rows,
                                   B, C, T, k, slice, threads, smem, st);
  }
  return backward<float>(x, dy, gamma, beta, alpha, dx, dgamma, dbeta, dalpha_rows, B, C, T, k,
                         slice, threads, smem, st);
}
