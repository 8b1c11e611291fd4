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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
