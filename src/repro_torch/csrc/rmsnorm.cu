// RMSNorm over the last dimension, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_fwd` in
// src/repro/kernels/rmsnorm/kernel.py (and the jnp `layers.rms_norm` the
// reference model actually runs). The backward has no TPU kernel: the JAX
// package differentiates `layers.rms_norm` with XLA.
//
// Rounding order: y = x * rsqrt(mean(x^2) + eps) is computed in f32 and
// rounded to the input dtype, and only then multiplied by `scale` (and
// rounded again). That is `layers.rms_norm` and `rmsnorm/ref.py`, the
// function the JAX serving path computes. The Pallas kernel instead
// multiplies by `scale` in f32 before a single cast; in f32 the two are
// identical, in bf16 they differ by one rounding.
//
// Backward. With r = rsqrt(mean(x^2) + eps), n = x * r in f32, x^ = n
// rounded to x's dtype (what the forward multiplied by `scale`) and
// g^ = g * scale rounded to x's dtype (the product's gradient in the
// input dtype, as JAX forms it):
//     dx     = r * (g^ - n * mean(g^ * n))
//     dscale = sum over rows of g * x^
// Since n = x * r and g^ does not depend on r, mean(g^ * n) =
// r * sum(g^ * x) / D: the row's two sums, sum(x^2) and sum(g^ * x), are
// reduced together as one pair.
//
// What bounds it: bytes. A row is read once and written once (forward:
// x in, y out; backward: x and g in, dx out) with a few operations per
// element, far below the card's ~295 operations per byte of bf16 ridge.
// What the design does about that:
//   * Each row is read from device memory once, in 16-byte vectors
//     (8 bf16 or 4 f32 values; single elements where D or a pointer does
//     not allow them), neighbouring threads on neighbouring addresses, and
//     held in registers: the reduction and the outputs are formed from the
//     registers, never from a second read. A group of `tpr` threads owns a
//     row (a warp when tpr is 32, else the whole block); each thread holds
//     J vectors, units lane, lane + tpr, ..., lane + (J-1) tpr.
//   * `scale` is loaded once per group, at entry together with its first
//     row: a thread's columns are the same in every row.
//   * A persistent grid: a few groups per SM walk the rows in a
//     grid-stride loop, and each starts the loads of its next row before it
//     reduces the current one, so a row's trip to memory overlaps the
//     previous row's reduction and stores (where the registers allow:
//     `kInstances`; the other instances load the next row after the stores).
//     The backward's plan asks 512 resident threads an SM, which keeps the
//     dscale scratch small; the forward's asks 2048, more than its
//     registers keep resident, so its grid runs in a few waves (the
//     fastest in tools/rmsnorm_tiles.py's sweep).
//   * One reduction per row: warp shuffles, then (block groups) one
//     barrier, with the warps' partial sums in one of two shared slots by
//     row parity so that the next row's writes cannot race this row's
//     reads. Every thread sums the warps' partials in warp order, so all
//     threads of a group hold the same bits.
//   * dscale: each group keeps its columns' share in f32 registers over all
//     its rows and writes it to one row of an f32 (groups, D) scratch; a
//     second launch, `rmsnorm_bwd_reduce`, sums the scratch over groups:
//     a block takes 16 columns, each of its 64 slices (16 without 16-byte
//     vectors) sums groups s, s + 64, ... in order, then a halving tree
//     adds the slices. No atomics: for a given shape and plan, a second
//     launch gives the same bits for dx and dscale.
// The launch plan (threads per row, vectors per thread, blocks) is the
// caller's: `launch_plan` in src/repro_torch/kernels/rmsnorm.py, which
// reads the table of instances below (`kInstances`). The entry points
// refuse a plan that no instance takes, that does not cover the row or
// that asks more threads than the instance was built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector of N elements of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// A thread's unit of a row: one 16-byte vector (VEC) or one element.
template <typename T, bool VEC>
struct Unit {
  static constexpr int N = VEC ? Vec<T>::N : 1;
  using Raw = typename std::conditional<VEC, Vec<T>, T>::type;
};

template <typename T>
__device__ __forceinline__ float elem(const Vec<T>& a, int e) { return to_f(a.v[e]); }
template <typename T>
__device__ __forceinline__ float elem(const T& a, int) { return to_f(a); }
template <typename T>
__device__ __forceinline__ void set_elem(Vec<T>& a, int e, T v) { a.v[e] = v; }
template <typename T>
__device__ __forceinline__ void set_elem(T& a, int, T v) { a = v; }

// The instances built, one line each: kernel (0 forward, 1 backward),
// element bytes, 16-byte vectors (1) or single elements (0), units per
// thread J -> the most threads a block of it may have (the registers that
// __launch_bounds__ allows a thread: 64 at 1024, 128 at 512, 255 at 256)
// and whether it prefetches the next row (holds it in registers too).
// Chosen from ptxas's register counts so that no instance spills; the
// main paths' instances (bf16 vectors, J 1 to 4) prefetch. Rows of single
// elements (D not a multiple of 16 bytes, or a pointer not aligned to
// them) reach D 8192 in the forward and D 4096 in the backward. `launch_plan`
// in kernels/rmsnorm.py reads the same table (`INSTANCES`).
struct Instance {
  int bwd, elem, vec, j, threads, prefetch;
};
constexpr Instance kInstances[] = {
    // forward, bf16 and f32 vectors
    {0, 2, 1, 1, 1024, 1}, {0, 2, 1, 2, 512, 1}, {0, 2, 1, 4, 512, 1}, {0, 2, 1, 8, 256, 0},
    {0, 4, 1, 1, 1024, 1}, {0, 4, 1, 2, 512, 1}, {0, 4, 1, 4, 512, 1}, {0, 4, 1, 8, 512, 0},
    // forward, single elements
    {0, 2, 0, 1, 1024, 1}, {0, 2, 0, 2, 1024, 1}, {0, 2, 0, 4, 1024, 1}, {0, 2, 0, 8, 512, 1},
    {0, 2, 0, 16, 512, 1},
    {0, 4, 0, 1, 1024, 1}, {0, 4, 0, 2, 1024, 1}, {0, 4, 0, 4, 1024, 1}, {0, 4, 0, 8, 512, 1},
    {0, 4, 0, 16, 512, 1},
    // backward, bf16 and f32 vectors
    {1, 2, 1, 1, 512, 1}, {1, 2, 1, 2, 512, 1}, {1, 2, 1, 4, 256, 0},
    {1, 4, 1, 1, 1024, 1}, {1, 4, 1, 4, 512, 0},
    // backward, single elements
    {1, 2, 0, 1, 1024, 1}, {1, 2, 0, 2, 1024, 1}, {1, 2, 0, 4, 512, 1}, {1, 2, 0, 8, 512, 1},
    {1, 4, 0, 1, 1024, 1}, {1, 4, 0, 2, 1024, 1}, {1, 4, 0, 4, 512, 1}, {1, 4, 0, 8, 512, 1},
};

__host__ __device__ constexpr Instance instance(int bwd, int elem, int vec, int j) {
  for (const Instance& i : kInstances)
    if (i.bwd == bwd && i.elem == elem && i.vec == vec && i.j == j) return i;
  return Instance{bwd, elem, vec, j, 0, 0};
}

// Sum of K values over the row's group, the same bits in every thread:
// xor shuffles within the warp (each step adds two equal pairs in either
// order, so every lane ends with the same value), then, for a block group,
// the warps' partials in warp order from `red` (one barrier).
template <int K>
__device__ __forceinline__ void group_sum(float (&v)[K], bool block, float (*red)[32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  if (!block) return;
  const int n_warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = red[k][0];
#pragma unroll
    for (int w = 1; w < 32; ++w)
      if (w < n_warps) t += red[k][w];
    v[k] = t;
  }
}

// The row's group: a warp (tpr == 32; a block holds blockDim.x / 32 of
// them) or the whole block.
struct Group {
  bool block;
  int lane, id, count;
  __device__ __forceinline__ explicit Group(int tpr) {
    block = tpr != 32;
    lane = block ? threadIdx.x : (threadIdx.x & 31);
    id = block ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    count = block ? gridDim.x : gridDim.x * (blockDim.x >> 5);
  }
};

template <typename T, bool VEC, int J>
__device__ __forceinline__ void load_row(typename Unit<T, VEC>::Raw (&a)[J],
                                         const T* __restrict__ p, int lane, int tpr,
                                         int units) {
  using Raw = typename Unit<T, VEC>::Raw;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = lane + j * tpr;
    if (u < units) a[j] = reinterpret_cast<const Raw*>(p)[u];
  }
}

template <typename T, bool VEC, int J, bool PF, int MAXT>
__global__ void __launch_bounds__(MAXT)
rmsnorm_fwd_rows(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                 int rows, int dim, float eps, int tpr) {
  using Raw = typename Unit<T, VEC>::Raw;
  constexpr int N = Unit<T, VEC>::N;
  __shared__ __align__(16) float red[2][1][32];
  const Group grp(tpr);
  const int units = dim / N;
  Raw s[J], a[J], b[PF ? J : 1];
  int row = grp.id;
  load_row<T, VEC, J>(s, scale, grp.lane, tpr, units);
  if (row < rows) load_row<T, VEC, J>(a, x + (size_t)row * dim, grp.lane, tpr, units);
  for (int it = 0; row < rows; ++it) {
    const int next = row + grp.count;
    if constexpr (PF) {
      if (next < rows) load_row<T, VEC, J>(b, x + (size_t)next * dim, grp.lane, tpr, units);
    }
    float ss[1] = {0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (grp.lane + j * tpr < units) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = elem(a[j], e);
          ss[0] = fmaf(f, f, ss[0]);
        }
      }
    }
    group_sum<1>(ss, grp.block, red[it & 1]);
    const float r = rsqrtf(ss[0] / (float)dim + eps);
    Raw* o = reinterpret_cast<Raw*>(out + (size_t)row * dim);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = grp.lane + j * tpr;
      if (u < units) {
        Raw y;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float yn = to_f(from_f<T>(elem(a[j], e) * r));   // round, then scale
          set_elem(y, e, from_f<T>(yn * elem(s[j], e)));
        }
        o[u] = y;
      }
    }
    if constexpr (PF) {
#pragma unroll
      for (int j = 0; j < J; ++j) a[j] = b[j];
    } else if (next < rows) {
      load_row<T, VEC, J>(a, x + (size_t)next * dim, grp.lane, tpr, units);
    }
    row = next;
  }
}

template <typename T, bool VEC, int J, bool PF, int MAXT>
__global__ void __launch_bounds__(MAXT)
rmsnorm_bwd_rows(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ scale,
                 T* __restrict__ dx, float* __restrict__ part, int rows, int dim, float eps,
                 int tpr) {
  using Raw = typename Unit<T, VEC>::Raw;
  constexpr int N = Unit<T, VEC>::N;
  __shared__ __align__(16) float red[2][2][32];
  const Group grp(tpr);
  const int units = dim / N;
  Raw s[J], xa[J], ga[J], xb[PF ? J : 1], gb[PF ? J : 1];
  float acc[J * N];
#pragma unroll
  for (int i = 0; i < J * N; ++i) acc[i] = 0.f;
  int row = grp.id;
  load_row<T, VEC, J>(s, scale, grp.lane, tpr, units);
  if (row < rows) {
    load_row<T, VEC, J>(xa, x + (size_t)row * dim, grp.lane, tpr, units);
    load_row<T, VEC, J>(ga, g + (size_t)row * dim, grp.lane, tpr, units);
  }
  for (int it = 0; row < rows; ++it) {
    const int next = row + grp.count;
    if constexpr (PF) {
      if (next < rows) {
        load_row<T, VEC, J>(xb, x + (size_t)next * dim, grp.lane, tpr, units);
        load_row<T, VEC, J>(gb, g + (size_t)next * dim, grp.lane, tpr, units);
      }
    }
    // The pair (sum x^2, sum g^ x), reduced together.
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (grp.lane + j * tpr < units) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xf = elem(xa[j], e);
          const float gh = to_f(from_f<T>(elem(ga[j], e) * elem(s[j], e)));
          v[0] = fmaf(xf, xf, v[0]);
          v[1] = fmaf(gh, xf, v[1]);
        }
      }
    }
    group_sum<2>(v, grp.block, red[it & 1]);
    const float r = rsqrtf(v[0] / (float)dim + eps);
    const float mean = r * (v[1] / (float)dim);       // mean(g^ * n)
    Raw* o = reinterpret_cast<Raw*>(dx + (size_t)row * dim);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = grp.lane + j * tpr;
      if (u < units) {
        Raw d;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xf = elem(xa[j], e), gf = elem(ga[j], e);
          const float n = xf * r;
          const float gh = to_f(from_f<T>(gf * elem(s[j], e)));
          set_elem(d, e, from_f<T>(r * fmaf(-n, mean, gh)));
          acc[j * N + e] = fmaf(gf, to_f(from_f<T>(n)), acc[j * N + e]);
        }
        o[u] = d;
      }
    }
    if constexpr (PF) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        xa[j] = xb[j];
        ga[j] = gb[j];
      }
    } else if (next < rows) {
      load_row<T, VEC, J>(xa, x + (size_t)next * dim, grp.lane, tpr, units);
      load_row<T, VEC, J>(ga, g + (size_t)next * dim, grp.lane, tpr, units);
    }
    row = next;
  }
  // This group's dscale share: one row of the (groups, dim) scratch.
  float* pr = part + (size_t)grp.id * dim;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int u = grp.lane + j * tpr;
    if (u < units) {
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
          reinterpret_cast<float4*>(pr + u * N)[q] =
              make_float4(acc[j * N + 4 * q], acc[j * N + 4 * q + 1], acc[j * N + 4 * q + 2],
                          acc[j * N + 4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) pr[u * N + e] = acc[j * N + e];
      }
    }
  }
}

// dscale[c] = sum over groups of part[group][c], in a fixed order: a block
// takes kReduceCols columns; its threads are CT column lanes (4 columns
// each with float4, else 1) by S slices; slice s sums groups s, s + S, ...
// in order, then a halving tree over the slices (s += s + h for h = S/2,
// ..., 1).
constexpr int kReduceThreads = 256;
constexpr int kReduceCols = 16;

template <typename T, bool V4>
__global__ void __launch_bounds__(kReduceThreads)
rmsnorm_bwd_reduce(const float* __restrict__ part, int groups, int dim, T* __restrict__ dscale) {
  constexpr int W = V4 ? 4 : 1;                 // columns per thread
  constexpr int CT = kReduceCols / W;           // column lanes
  constexpr int S = kReduceThreads / CT;        // group slices
  __shared__ float sm[S][kReduceCols];
  const int c = threadIdx.x % CT, s = threadIdx.x / CT;
  const int col = blockIdx.x * kReduceCols + c * W;
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (col < dim) {
#pragma unroll 4
    for (int gi = s; gi < groups; gi += S) {
      const float* p = part + (size_t)gi * dim + col;
      if constexpr (V4) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        acc[0] += f.x;
        acc[1] += f.y;
        acc[2] += f.z;
        acc[3] += f.w;
      } else {
        acc[0] += *p;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) sm[s][c * W + i] = acc[i];
  __syncthreads();
#pragma unroll
  for (int h = S / 2; h > 0; h >>= 1) {
    if (s < h) {
#pragma unroll
      for (int i = 0; i < W; ++i) sm[s][c * W + i] += sm[s + h][c * W + i];
    }
    __syncthreads();
  }
  if (s == 0) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (col + i < dim) dscale[col + i] = from_f<T>(sm[0][c * W + i]);
  }
}

// A launch plan, as `launch_plan` in kernels/rmsnorm.py makes it.
struct Plan {
  int vec;         // 16-byte vectors (1) or single elements (0)
  int tpr;         // threads per row: 32 (a warp) or the block's threads
  int j;           // units per thread
  int rpb;         // rows (warps) per block when tpr == 32
  int blocks;      // grid size
  int groups() const { return tpr == 32 ? blocks * rpb : blocks; }
  int threads() const { return tpr == 32 ? 32 * rpb : tpr; }
};

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the plan covers a row of `dim` with an instance of up to
// `max_t` threads a block.
template <typename T, bool VEC, int J>
bool plan_ok(const Plan& p, int dim, int max_t) {
  constexpr int N = Unit<T, VEC>::N;
  if (max_t == 0 || p.tpr < 32 || p.tpr % 32 != 0 || p.tpr > max_t) return false;
  if (p.tpr == 32 && (p.rpb < 1 || 32 * p.rpb > max_t)) return false;
  if (p.blocks < 1 || (VEC && dim % N != 0)) return false;
  return (long long)p.tpr * J * N >= dim;
}

template <typename T, bool VEC, int J>
int fwd_j(const void* x, const void* scale, void* out, int rows, int dim, float eps,
          const Plan& p, cudaStream_t stream) {
  constexpr Instance inst = instance(0, sizeof(T), VEC, J);
  if constexpr (inst.threads == 0) {
    return -1;
  } else {
    if (!plan_ok<T, VEC, J>(p, dim, inst.threads)) return -1;
    rmsnorm_fwd_rows<T, VEC, J, inst.prefetch != 0, inst.threads><<<p.blocks, p.threads(), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), rows,
        dim, eps, p.tpr);
    return (int)cudaGetLastError();
  }
}

template <typename T, bool VEC>
int fwd_vec(const void* x, const void* scale, void* out, int rows, int dim, float eps,
            const Plan& p, cudaStream_t s) {
  switch (p.j) {
    case 1: return fwd_j<T, VEC, 1>(x, scale, out, rows, dim, eps, p, s);
    case 2: return fwd_j<T, VEC, 2>(x, scale, out, rows, dim, eps, p, s);
    case 4: return fwd_j<T, VEC, 4>(x, scale, out, rows, dim, eps, p, s);
    case 8: return fwd_j<T, VEC, 8>(x, scale, out, rows, dim, eps, p, s);
    case 16: return fwd_j<T, VEC, 16>(x, scale, out, rows, dim, eps, p, s);
  }
  return -1;
}

template <typename T>
int fwd(const void* x, const void* scale, void* out, int rows, int dim, float eps,
        const Plan& p, cudaStream_t s) {
  if (p.vec) {
    if (!aligned(x) || !aligned(scale) || !aligned(out)) return -1;
    return fwd_vec<T, true>(x, scale, out, rows, dim, eps, p, s);
  }
  return fwd_vec<T, false>(x, scale, out, rows, dim, eps, p, s);
}

template <typename T, bool VEC, int J>
int bwd_j(const void* g, const void* x, const void* scale, void* dx, void* dscale, void* part,
          int rows, int dim, float eps, const Plan& p, cudaStream_t stream) {
  constexpr Instance inst = instance(1, sizeof(T), VEC, J);
  if constexpr (inst.threads == 0) {
    return -1;
  } else {
    if (!plan_ok<T, VEC, J>(p, dim, inst.threads)) return -1;
    float* pp = static_cast<float*>(part);
    rmsnorm_bwd_rows<T, VEC, J, inst.prefetch != 0, inst.threads><<<p.blocks, p.threads(), 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(dx), pp, rows, dim, eps, p.tpr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int blocks = (dim + kReduceCols - 1) / kReduceCols;
    T* ds = static_cast<T*>(dscale);
    if (dim % 4 == 0)
      rmsnorm_bwd_reduce<T, true><<<blocks, kReduceThreads, 0, stream>>>(pp, p.groups(), dim, ds);
    else
      rmsnorm_bwd_reduce<T, false><<<blocks, kReduceThreads, 0, stream>>>(pp, p.groups(), dim, ds);
    return (int)cudaGetLastError();
  }
}

template <typename T, bool VEC>
int bwd_vec(const void* g, const void* x, const void* scale, void* dx, void* dscale,
            void* part, int rows, int dim, float eps, const Plan& p, cudaStream_t s) {
  switch (p.j) {
    case 1: return bwd_j<T, VEC, 1>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
    case 2: return bwd_j<T, VEC, 2>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
    case 4: return bwd_j<T, VEC, 4>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
    case 8: return bwd_j<T, VEC, 8>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
    case 16: return bwd_j<T, VEC, 16>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
  }
  return -1;
}

template <typename T>
int bwd(const void* g, const void* x, const void* scale, void* dx, void* dscale, void* part,
        int rows, int dim, float eps, const Plan& p, cudaStream_t s) {
  if (!aligned(part)) return -1;
  if (p.vec) {
    if (!aligned(g) || !aligned(x) || !aligned(scale) || !aligned(dx)) return -1;
    return bwd_vec<T, true>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
  }
  return bwd_vec<T, false>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The plan (vec, tpr, j, rpb, blocks) is
// `launch_plan`'s. Returns cudaGetLastError() after the launch (0 =
// launched), or -1 for arguments or a plan the kernels do not take.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                                 int dim, float eps, int dtype, int vec, int tpr, int j,
                                 int rpb, int blocks, void* stream) {
  if (rows <= 0 || dim <= 0) return -1;
  const Plan p{vec, tpr, j, rpb, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, scale, out, rows, dim, eps, p, s);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, scale, out, rows, dim, eps, p, s);
  return -1;
}

// Backward: dx (rows, dim) and dscale (dim,) from the output gradient g;
// `part` is f32 scratch of (the plan's groups) x dim.
extern "C" int repro_rmsnorm_bwd(const void* g, const void* x, const void* scale, void* dx,
                                 void* dscale, void* part, int rows, int dim, float eps,
                                 int dtype, int vec, int tpr, int j, int rpb, int blocks,
                                 void* stream) {
  if (rows <= 0 || dim <= 0) return -1;
  const Plan p{vec, tpr, j, rpb, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
  if (dtype == 1) return bwd<__nv_bfloat16>(g, x, scale, dx, dscale, part, rows, dim, eps, p, s);
  return -1;
}
