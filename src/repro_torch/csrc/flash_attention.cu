// Flash attention for Hopper (sm_90a): GQA forward (K1) and its
// FlashAttention-2-style backward.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention/kernel.py, which the reference
// model's training forward reaches from `attention.gqa_apply` (no cache).
// The JAX package has no backward kernel: it differentiates the jnp
// attention with XLA. Here the backward is written by hand too, so the
// card's training step runs no plain version.
//
// Shapes follow the Pallas kernel: q (B, Sq, H, D), k (B, Skv, Hkv, D),
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv) in q's dtype, all contiguous.
// Query head h reads kv head h / G (G = H / Hkv, any G, not only powers
// of two). Causal masking is top-left aligned: query i sees keys j <= i.
// Ragged Sq and Skv are masked in the kernel; nothing is padded in
// device memory. q is scaled by 1/sqrt(D) AFTER its f32 cast, as the
// Pallas kernel does (kernel.py:47). D and Dv are each one of 32, 64, 128.
//
// Bound: bytes, narrowly, at the training shape. Causal attention at
// B 32, S 512, H 32, Hkv 8, D 64 does 34.4 GFLOP forward (~2.5x that
// backward) against 0.17 GB of inputs and outputs: ~200 operations per
// byte, just below the ~295 where the bf16 tensor cores would become the
// limit, so its least time is 0.051 ms of memory traffic (the operations
// alone would take 0.035 ms). Either way the work must be done on tensor
// cores to come near it. This first version is simple and right, not
// fast: it multiplies with f32 FMAs from shared memory (no tensor cores,
// no TMA, no warp specialisation), at ~20 TFLOP/s.
// What the design does keep:
//   * one block of 256 threads per (b, h, 64-row q tile): thousands of
//     blocks at the training shape, not the B * Hkv that limit decode;
//   * a loop over 64-row KV tiles inside the block replaces the Pallas
//     kernel's sequential 4th grid axis, and stops at the causal
//     frontier (tiles above it are skipped, not masked);
//   * the online softmax state (m, l, acc) stays in f32 registers; each
//     thread owns 4 rows x (Dv / 16) output columns, and a row's 16
//     threads sit in one half-warp, so row max and sum are shuffles;
//   * shared-memory tiles are f32 with rows padded by one word, so the
//     column-strided reads of the score products hit distinct banks;
//   * the forward writes the row log-sum-exp LSE (B, H, Sq) in f32,
//     which the TPU kernel computes internally and drops: the backward
//     recomputes P = exp(S - LSE) from it instead of storing P.
// Backward (deterministic, no atomics), two launches:
//   1. dQ: one block per (b, h, q tile). It first forms
//      Delta_i = rowsum(dO o O) in f32 for its rows (written for launch
//      2), then loops over KV tiles: dQ += P o (dP - Delta) . K * scale.
//   2. dK/dV: one block per (b, kv head, KV tile). It loops over the G
//      query heads of that kv head and over the q tiles at or below the
//      diagonal, so the sum over the G heads happens inside the block:
//      dV += P^T dO, dK += (P o (dP - Delta))^T (q * scale).
// Later work: mma.sync / wgmma bf16 tiles, cp.async or TMA double
// buffering, and a longer KV tile per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBKV = 64;         // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int kLDP = 65;         // padded row stride of the 64 x 64 score tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum / max over the 16 threads of one row group (a half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst[r * ld + c] = mul * src[r * stride + c] for r < 64 and c < ncols,
// zero for r >= valid (rows past the ragged end).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int64_t stride, int valid, int ncols, float mul) {
  for (int idx = threadIdx.x; idx < 64 * ncols; idx += kThreads) {
    const int r = idx / ncols, c = idx - r * ncols;
    dst[r * ld + c] = r < valid ? to_f(src[r * stride + c]) * mul : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBKV * (D + 1) +
                          (size_t)kBKV * (DV + 1) + (size_t)kBQ * kLDP);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
       float scale, int causal) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = DV + 1, CV = DV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LDQ;
  float* sV = sK + kBKV * LDK;
  float* sP = sV + kBKV * LDV;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;

  load_tile(sQ, LDQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs,
            min(kBQ, Sq - q0), D, scale);

  float m[4], l[4], acc[4][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();   // the previous tile's sK / sV / sP are consumed
    const int valid = min(kBKV, Skv - k0);
    load_tile(sK, LDK, k + ((int64_t)b * Skv + k0) * ks + (int64_t)hk * D, ks, valid, D, 1.f);
    load_tile(sV, LDV, v + ((int64_t)b * Skv + k0) * vs + (int64_t)hk * DV, vs, valid, DV, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < Skv && (!causal || col <= row);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
      }
      ps = row_sum(ps);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float vv = sV[kk * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / ll;
    T* orow = o + ((int64_t)b * Sq + row) * ((int64_t)H * DV) + (int64_t)h * DV;
#pragma unroll
    for (int c = 0; c < CV; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + row] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// Backward 1: Delta and dQ
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBQ * (DV + 1) +
                          (size_t)kBKV * (D + 1) + (size_t)kBKV * (DV + 1) +
                          (size_t)kBQ * kLDP + 2 * kBQ);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
          float scale, int causal) {
  constexpr int LDQ = D + 1, LDO = DV + 1, LDK = D + 1, LDV = DV + 1;
  constexpr int CD = D / 16, CV = DV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LDQ;
  float* sK = sdO + kBQ * LDO;
  float* sV = sK + kBKV * LDK;
  float* sdS = sV + kBKV * LDV;
  float* sL = sdS + kBQ * kLDP;
  float* sD = sL + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const int nq = min(kBQ, Sq - q0);
  const int64_t lrow = ((int64_t)b * H + h) * Sq + q0;

  load_tile(sQ, LDQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs, nq, D, scale);
  load_tile(sdO, LDO, dout + ((int64_t)b * Sq + q0) * os + (int64_t)h * DV, os, nq, DV, 1.f);
  __syncthreads();

  // Delta_i = sum_c dO[i, c] * O[i, c] for this block's rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float part = 0.f;
    if (r < nq) {
      const T* orow = o + ((int64_t)b * Sq + q0 + r) * os + (int64_t)h * DV;
#pragma unroll
      for (int c = 0; c < CV; ++c)
        part = fmaf(sdO[r * LDO + tx + 16 * c], to_f(orow[tx + 16 * c]), part);
    }
    part = row_sum(part);
    if (tx == 0) {
      sD[r] = part;
      sL[r] = r < nq ? lse[lrow + r] : 0.f;
      if (r < nq) delta[lrow + r] = part;
    }
  }

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();
    const int valid = min(kBKV, Skv - k0);
    load_tile(sK, LDK, k + ((int64_t)b * Skv + k0) * ks + (int64_t)hk * D, ks, valid, D, 1.f);
    load_tile(sV, LDV, v + ((int64_t)b * Skv + k0) * vs + (int64_t)hk * DV, vs, valid, DV, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll 8
    for (int d = 0; d < DV; ++d) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sdO[(ty * 4 + i) * LDO + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sV[(tx + 16 * j) * LDV + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = r < nq && col < Skv && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] - sL[r]) : 0.f;
        sdS[r * kLDP + tx + 16 * j] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty * 4 + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = sK[kk * LDK + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    T* drow = dq + ((int64_t)b * Sq + q0 + r) * qs + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) drow[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dK and dV, summed over the G query heads inside the block
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)kBKV * (D + 1) + (size_t)kBKV * (DV + 1) +
                          (size_t)kBQ * (D + 1) + (size_t)kBQ * (DV + 1) +
                          2 * (size_t)kBKV * kLDP + 2 * kBQ);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int Sq, int Skv, int H, int Hkv, float scale, int causal) {
  constexpr int LDK = D + 1, LDV = DV + 1, LDQ = D + 1, LDO = DV + 1;
  constexpr int CD = D / 16, CV = DV / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBKV * LDK;
  float* sQ = sV + kBKV * LDV;
  float* sdO = sQ + kBQ * LDQ;
  float* sP = sdO + kBQ * LDO;        // P^T: [key row][query col]
  float* sdS = sP + kBKV * kLDP;      // dS^T
  float* sL = sdS + kBKV * kLDP;
  float* sD = sL + kBQ;

  const int k0 = blockIdx.x * kBKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const int nk = min(kBKV, Skv - k0);

  load_tile(sK, LDK, k + ((int64_t)b * Skv + k0) * ks + (int64_t)hk * D, ks, nk, D, 1.f);
  load_tile(sV, LDV, v + ((int64_t)b * Skv + k0) * vs + (int64_t)hk * DV, vs, nk, DV, 1.f);

  float ak[4][CD], av[4][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CD; ++c) ak[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) av[i][c] = 0.f;
  }

  // Causal: only query rows >= k0 see this tile; start at their q tile.
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_begin; q0 < Sq; q0 += kBQ) {
      const int nq = min(kBQ, Sq - q0);
      const int64_t lrow = ((int64_t)b * H + h) * Sq + q0;
      __syncthreads();
      load_tile(sQ, LDQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs, nq, D, scale);
      load_tile(sdO, LDO, dout + ((int64_t)b * Sq + q0) * os + (int64_t)h * DV, os, nq, DV, 1.f);
      if (threadIdx.x < kBQ) {
        sL[threadIdx.x] = threadIdx.x < nq ? lse[lrow + threadIdx.x] : 0.f;
        sD[threadIdx.x] = threadIdx.x < nq ? delta[lrow + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: rows are keys (ty * 4 + i), columns queries (tx + 16 j).
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], bq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sK[(ty * 4 + i) * LDK + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bq[j] = sQ[(tx + 16 * j) * LDQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bq[j], s[i][j]);
      }
#pragma unroll 8
      for (int d = 0; d < DV; ++d) {
        float a[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sV[(ty * 4 + i) * LDV + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bo[j] = sdO[(tx + 16 * j) * LDO + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bo[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, row = q0 + c;
          const bool ok = r < nk && c < nq && (!causal || key <= row);
          const float p = ok ? expf(s[i][j] - sL[c]) : 0.f;
          sP[r * kLDP + c] = p;
          sdS[r * kLDP + c] = p * (dp[i][j] - sD[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[(ty * 4 + i) * kLDP + qq];
          ds[i] = sdS[(ty * 4 + i) * kLDP + qq];
        }
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const float dov = sdO[qq * LDO + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i][c] = fmaf(p[i], dov, av[i][c]);
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float qv = sQ[qq * LDQ + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[i][c] = fmaf(ds[i], qv, ak[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nk) continue;
    T* krow = dk + ((int64_t)b * Skv + k0 + r) * ks + (int64_t)hk * D;
    T* vrow = dv + ((int64_t)b * Skv + k0 + r) * vs + (int64_t)hk * DV;
#pragma unroll
    for (int c = 0; c < CD; ++c) krow[tx + 16 * c] = from_f<T>(ak[i][c]);
#pragma unroll
    for (int c = 0; c < CV; ++c) vrow[tx + 16 * c] = from_f<T>(av[i][c]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out, *lse_out, *delta, *dq, *dk, *dv;
  int B, Sq, Skv, H, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int DV>
int launch_fwd(const Args& a) {
  auto kern = fa_fwd<T, D, DV>;
  constexpr size_t smem = fwd_smem<D, DV>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.lse_out), a.Sq, a.Skv, a.H, a.Hkv,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch_bwd(const Args& a) {
  auto kdq = fa_bwd_dq<T, D, DV>;
  auto kdkv = fa_bwd_dkdv<T, D, DV>;
  constexpr size_t s1 = dq_smem<D, DV>(), s2 = dkv_smem<D, DV>();
  cudaError_t e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return (int)e;
  dim3 g1((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kdq<<<g1, kThreads, s1, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta), static_cast<T*>(a.dq),
      a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((a.Skv + kBKV - 1) / kBKV, a.Hkv, a.B);
  kdkv<<<g2, kThreads, s2, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, bool BWD, int D>
int dispatch_dv(const Args& a, int Dv) {
  switch (Dv) {
    case 32: return BWD ? launch_bwd<T, D, 32>(a) : launch_fwd<T, D, 32>(a);
    case 64: return BWD ? launch_bwd<T, D, 64>(a) : launch_fwd<T, D, 64>(a);
    case 128: return BWD ? launch_bwd<T, D, 128>(a) : launch_fwd<T, D, 128>(a);
  }
  return -1;
}

template <bool BWD>
int dispatch(const Args& a, int D, int Dv, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.Hkv <= 0 || a.H % a.Hkv) return -1;
  if (a.B > 65535 || a.H > 65535) return -1;
  if (dtype == 0) {
    switch (D) {
      case 32: return dispatch_dv<float, BWD, 32>(a, Dv);
      case 64: return dispatch_dv<float, BWD, 64>(a, Dv);
      case 128: return dispatch_dv<float, BWD, 128>(a, Dv);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return dispatch_dv<__nv_bfloat16, BWD, 32>(a, Dv);
      case 64: return dispatch_dv<__nv_bfloat16, BWD, 64>(a, Dv);
      case 128: return dispatch_dv<__nv_bfloat16, BWD, 128>(a, Dv);
    }
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launches (0 = launched), or -1 for arguments the kernels do not take.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* out, void* lse, int B, int Sq, int Skv,
                                         int H, int Hkv, int D, int Dv, float scale,
                                         int causal, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.Hkv = Hkv;
  a.scale = scale; a.causal = causal; a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a, D, Dv, dtype);
}

extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B,
                                         int Sq, int Skv, int H, int Hkv, int D, int Dv,
                                         float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.Hkv = Hkv;
  a.scale = scale; a.causal = causal; a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a, D, Dv, dtype);
}
