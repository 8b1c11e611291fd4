// RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_fwd` in
// src/repro/kernels/rmsnorm/kernel.py (and the jnp `layers.rms_norm` the
// reference model actually runs).
//
// Bound: bytes. Each row is read and written once and does about four
// operations per element, far below the card's ~295 operations per byte
// of bf16 ridge. Design for that: 16-byte vector loads and stores
// (8 bf16 or 4 f32 values per thread), neighbouring threads on
// neighbouring addresses, the sum of squares reduced in f32 with warp
// shuffles, no shared-memory staging of the row. One warp per row for
// D <= 1024 (four rows per 128-thread block), one block per row above.
// The second pass re-reads the row, which the first pass left in L1/L2.
//
// Rounding order: y = x * rsqrt(mean(x^2) + eps) is computed in f32 and
// rounded to the input dtype, and only then multiplied by `scale` (and
// rounded again). That is `layers.rms_norm` and `rmsnorm/ref.py`, the
// function the JAX serving path computes. The Pallas kernel instead
// multiplies by `scale` in f32 before a single cast; in f32 the two are
// identical, in bf16 they differ by one rounding.
//
// Backward (no TPU kernel: the JAX package differentiates
// `layers.rms_norm` with XLA). With r = rsqrt(mean(x^2) + eps), n = x * r
// in f32, x^ = n rounded to x's dtype (what the forward multiplied by
// `scale`) and g^ = g * scale rounded to x's dtype (the product's
// gradient in the input dtype, as JAX forms it):
//     dx     = r * (g^ - n * mean(g^ * n))
//     dscale = sum over rows of g * x^
// Bound: bytes, like the forward (x and g read, dx written, three passes
// over a row that stays in L1/L2). The same row mapping as the forward:
// one warp per row for D <= 1024, one block per row above (at most 256
// threads: each holds 32 f32 dscale accumulators, and 1024 such threads
// would not fit the SM's registers). Each warp (or
// block) walks a grid-stride set of rows and keeps its share of dscale
// in f32 registers (it owns the same columns in every row); at the end
// it writes them to one row of an f32 (groups, D) scratch, and a second
// small launch sums that scratch over groups per column. No atomics, so
// dscale is the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte vector of VEC elements of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// One row, reduced by a group of `width` threads starting at `lane0`
// within the block. `width` is 32 (warp per row) or blockDim.x (block per
// row); `red` is block shared scratch for the block-per-row case.
template <typename T, bool VEC>
__device__ void norm_row(const T* __restrict__ x, const T* __restrict__ scale,
                         T* __restrict__ out, int dim, float eps, int lane,
                         int width, bool block_row, float* red) {
  float ss = 0.f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    for (int c = lane; c < dim / N; c += width) {
      Vec<T> a = xv[c];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float f = to_f(a.v[i]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < dim; c += width) {
      float f = to_f(x[c]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (block_row) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    if (threadIdx.x < 32) {
      const int n_warps = (blockDim.x + 31) >> 5;
      float t = threadIdx.x < n_warps ? red[threadIdx.x] : 0.f;
      t = warp_sum(t);
      if (threadIdx.x == 0) red[0] = t;
    }
    __syncthreads();
    ss = red[0];
  }
  const float r = rsqrtf(ss / (float)dim + eps);
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* sv = reinterpret_cast<const Vec<T>*>(scale);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
    for (int c = lane; c < dim / N; c += width) {
      Vec<T> a = xv[c];
      Vec<T> s = sv[c];
      Vec<T> y;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float yn = to_f(from_f<T>(to_f(a.v[i]) * r));   // round, then scale
        y.v[i] = from_f<T>(yn * to_f(s.v[i]));
      }
      ov[c] = y;
    }
  } else {
    for (int c = lane; c < dim; c += width) {
      const float yn = to_f(from_f<T>(to_f(x[c]) * r));
      out[c] = from_f<T>(yn * to_f(scale[c]));
    }
  }
}

template <typename T, bool VEC>
__global__ void rmsnorm_warp_rows(const T* __restrict__ x, const T* __restrict__ scale,
                                  T* __restrict__ out, int rows, int dim, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp exits together: no block barrier used
  const size_t off = (size_t)row * dim;
  norm_row<T, VEC>(x + off, scale, out + off, dim, eps, threadIdx.x & 31, 32,
                   false, nullptr);
}

template <typename T, bool VEC>
__global__ void rmsnorm_block_rows(const T* __restrict__ x, const T* __restrict__ scale,
                                   T* __restrict__ out, int rows, int dim, float eps) {
  __shared__ float red[32];
  const size_t off = (size_t)blockIdx.x * dim;
  norm_row<T, VEC>(x + off, scale, out + off, dim, eps, threadIdx.x, blockDim.x,
                   true, red);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int dim, float eps,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  constexpr int N = Vec<T>::N;
  const bool vec = dim % N == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(scale) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  if (dim <= 1024) {
    const int threads = 128;
    const int rows_per_block = threads / 32;
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (vec)
      rmsnorm_warp_rows<T, true><<<blocks, threads, 0, stream>>>(xp, sp, op, rows, dim, eps);
    else
      rmsnorm_warp_rows<T, false><<<blocks, threads, 0, stream>>>(xp, sp, op, rows, dim, eps);
  } else {
    const int units = vec ? dim / N : dim;
    int threads = ((units + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (vec)
      rmsnorm_block_rows<T, true><<<rows, threads, 0, stream>>>(xp, sp, op, rows, dim, eps);
    else
      rmsnorm_block_rows<T, false><<<rows, threads, 0, stream>>>(xp, sp, op, rows, dim, eps);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kMaxAcc = 32;        // dscale accumulators (f32) per thread
constexpr int kBwdThreads = 256;   // threads per row in block mode (register budget)
constexpr int kMaxBwdGroups = 1024;

// N consecutive elements (one 16-byte vector, or one element) as floats.
template <typename T, bool VEC>
__device__ __forceinline__ void load_unit(const T* __restrict__ p, int u, float* out) {
  if constexpr (VEC) {
    const Vec<T> a = reinterpret_cast<const Vec<T>*>(p)[u];
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(a.v[i]);
  } else {
    out[0] = to_f(p[u]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_unit(T* __restrict__ p, int u, const float* in) {
  if constexpr (VEC) {
    Vec<T> a;
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) a.v[i] = from_f<T>(in[i]);
    reinterpret_cast<Vec<T>*>(p)[u] = a;
  } else {
    p[u] = from_f<T>(in[0]);
  }
}

// Sum over the row's group: a warp, or (BLOCK) the whole block.
template <bool BLOCK>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if (!BLOCK) return v;
  __syncthreads();                       // red may still hold the last sum
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float t = threadIdx.x < n_warps ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool VEC, bool BLOCK>
__global__ void __launch_bounds__(kBwdThreads) rmsnorm_bwd_rows(const T* __restrict__ g, const T* __restrict__ x,
                                 const T* __restrict__ scale, T* __restrict__ dx,
                                 float* __restrict__ part, int rows, int dim, float eps) {
  constexpr int N = VEC ? Vec<T>::N : 1;
  constexpr int J = kMaxAcc / N;         // units per thread, upper bound
  __shared__ float red[32];
  const int width = BLOCK ? blockDim.x : 32;
  const int lane = BLOCK ? threadIdx.x : (threadIdx.x & 31);
  const int group = BLOCK ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int n_groups = BLOCK ? gridDim.x : gridDim.x * (blockDim.x >> 5);
  const int units = dim / N;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int row = group; row < rows; row += n_groups) {
    const size_t off = (size_t)row * dim;
    const T* xr = x + off;
    const T* gr = g + off;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = lane + j * width;
      if (u < units) {
        float xv[N];
        load_unit<T, VEC>(xr, u, xv);
#pragma unroll
        for (int e = 0; e < N; ++e) ss = fmaf(xv[e], xv[e], ss);
      }
    }
    ss = group_sum<BLOCK>(ss, red);
    const float r = rsqrtf(ss / (float)dim + eps);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = lane + j * width;
      if (u < units) {
        float xv[N], gv[N], sv[N];
        load_unit<T, VEC>(xr, u, xv);
        load_unit<T, VEC>(gr, u, gv);
        load_unit<T, VEC>(scale, u, sv);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float n = xv[e] * r;
          const float gh = to_f(from_f<T>(gv[e] * sv[e]));
          dot = fmaf(gh, n, dot);
          acc[j * N + e] = fmaf(gv[e], to_f(from_f<T>(n)), acc[j * N + e]);
        }
      }
    }
    const float mean = group_sum<BLOCK>(dot, red) / (float)dim;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = lane + j * width;
      if (u < units) {
        float xv[N], gv[N], sv[N], out[N];
        load_unit<T, VEC>(xr, u, xv);
        load_unit<T, VEC>(gr, u, gv);
        load_unit<T, VEC>(scale, u, sv);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float n = xv[e] * r;
          const float gh = to_f(from_f<T>(gv[e] * sv[e]));
          out[e] = r * (gh - n * mean);
        }
        store_unit<T, VEC>(dx + off, u, out);
      }
    }
  }
  float* pr = part + (size_t)group * dim;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = lane + j * width;
    if (u < units) {
#pragma unroll
      for (int e = 0; e < N; ++e) pr[u * N + e] = acc[j * N + e];
    }
  }
}

template <typename T>
__global__ void rmsnorm_bwd_reduce(const float* __restrict__ part, int n_groups, int dim,
                                   T* __restrict__ dscale) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  float s = 0.f;
  for (int i = 0; i < n_groups; ++i) s += part[(size_t)i * dim + c];
  dscale[c] = from_f<T>(s);
}

// Row groups (warps or blocks) the backward uses for (rows, dim); the
// caller allocates an f32 (groups, dim) scratch of this many rows.
int bwd_groups(int rows, int dim) {
  if (dim <= 1024) {
    const int blocks = std::min((rows + 3) / 4, kMaxBwdGroups / 4);
    return 4 * std::max(blocks, 1);
  }
  return std::max(std::min(rows, kMaxBwdGroups / 2), 1);
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* scale, void* dx, void* dscale,
               void* part, int rows, int dim, float eps, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  constexpr int N = Vec<T>::N;
  const bool vec = dim % N == 0 && (reinterpret_cast<uintptr_t>(g) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(scale) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(dx) % 16) == 0;
  const int groups = bwd_groups(rows, dim);
  if (dim <= 1024) {
    if (vec)
      rmsnorm_bwd_rows<T, true, false><<<groups / 4, 128, 0, stream>>>(gp, xp, sp, dxp, pp, rows, dim, eps);
    else
      rmsnorm_bwd_rows<T, false, false><<<groups / 4, 128, 0, stream>>>(gp, xp, sp, dxp, pp, rows, dim, eps);
  } else {
    const int units = vec ? dim / N : dim;
    int threads = ((units + 31) / 32) * 32;
    if (threads > kBwdThreads) threads = kBwdThreads;
    if (vec)
      rmsnorm_bwd_rows<T, true, true><<<groups, threads, 0, stream>>>(gp, xp, sp, dxp, pp, rows, dim, eps);
    else
      rmsnorm_bwd_rows<T, false, true><<<groups, threads, 0, stream>>>(gp, xp, sp, dxp, pp, rows, dim, eps);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_reduce<T><<<(dim + 255) / 256, 256, 0, stream>>>(pp, groups, dim,
                                                               static_cast<T*>(dscale));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                                 int dim, float eps, int dtype, void* stream) {
  if (rows <= 0 || dim <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, dim, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, rows, dim, eps, s);
  return -1;
}

extern "C" int repro_rmsnorm_bwd_groups(int rows, int dim) { return bwd_groups(rows, dim); }

// Backward: dx (rows, dim) and dscale (dim,) from the output gradient g.
// `part` is f32 scratch of repro_rmsnorm_bwd_groups(rows, dim) x dim.
// dim must be at most 32 * 256 (32 dscale accumulators per thread, at
// most 256 threads per row).
extern "C" int repro_rmsnorm_bwd(const void* g, const void* x, const void* scale, void* dx,
                                 void* dscale, void* part, int rows, int dim, float eps,
                                 int dtype, void* stream) {
  if (rows <= 0 || dim <= 0 || dim > kMaxAcc * kBwdThreads) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(g, x, scale, dx, dscale, part, rows, dim, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, scale, dx, dscale, part, rows, dim, eps, s);
  return -1;
}
