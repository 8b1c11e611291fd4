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
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv) in q's dtype, all contiguous
// and 16-byte aligned. Query head h reads kv head h / G (G = H / Hkv, any
// G, not only powers of two). Causal masking is top-left aligned: query i
// sees keys j <= i. Ragged Sq and Skv are masked in the kernel; nothing
// is padded in device memory. D and Dv are each one of 32, 64, 128, or
// both 80 (hubert-xlarge: rows of 160 bytes, 10 16-byte chunks, padded in
// shared memory to 176 = 11 x 16, odd, so `ldmatrix` stays free of bank
// conflicts as at 72 and 136; its bidirectional encoder is the one
// non-causal main path). The
// forward also writes the row log-sum-exp LSE (B, H, Sq) in f32, which
// the TPU kernel computes internally and drops: the backward recomputes
// P = exp(S - LSE) from it instead of storing P.
//
// Bound: bytes, narrowly, at the training shape. Causal attention at
// B 32, S 512, H 32, Hkv 8, D 64 does 34.4 GFLOP forward (~2.5x that
// backward) against 0.17 GB of inputs and outputs: ~200 operations per
// byte, just below the ~295 where the bf16 tensor cores would become the
// limit, so its least time is 0.051 ms of memory traffic (the operations
// alone would take 0.035 ms). Either way the work must run on the
// tensor cores to come near it.
//
// Two implementations, chosen by dtype (a bf16 call never reaches the
// f32 code, and nothing falls back from one to the other):
//
// bf16: tensor cores (`fa_fwd_mma`, `fa_bwd_dq_mma`, `fa_bwd_dkdv_mma`).
//   * Every product is `mma.sync.m16n8k16` bf16 x bf16 -> f32. Operands
//     reach registers with `ldmatrix` (`.trans` where the product runs
//     along the tile's rows: V in PV, K in dS K, Q in dS^T Q, dO in
//     P^T dO). Sums stay in f32.
//   * Tiles stay bf16 in shared memory, rows padded by 16 bytes so the
//     eight row addresses of one `ldmatrix` hit eight bank groups. They
//     are loaded with 16-byte `cp.async` into a two-stage ring: the next
//     KV tile (forward, dQ) or q tile (dK/dV) loads while this one
//     computes, with one `__syncthreads` per tile.
//   * Each warp owns 16 rows. The forward keeps its Q fragment in
//     registers across the KV loop; S lives in the accumulators; row max
//     and row sum are quad shuffles; P is rounded to bf16 in registers and
//     used at once as the A operand of PV (the m16n8 accumulator layout is
//     the m16n8k16 A layout), so P never touches shared memory. In the
//     backward dS (dQ launch) and P^T, dS^T (dK/dV launch) are A operands
//     straight from the accumulators in the same way.
//   * 1/sqrt(D) multiplies S in f32 after the product (q is not scaled in
//     bf16: for D = 128 that would add a rounding neither the Pallas
//     kernel nor the plain version has); exponentials are exp2 of scores
//     scaled by log2(e) / sqrt(D).
//   * Rounding P and dS to bf16 before their second product is the one
//     rounding the plain version does not make: `parity.py` states what it
//     may move each output by.
//   * Causal: tiles above the diagonal are skipped; only the diagonal and
//     the ragged edges are masked. q tiles are issued in order: longest
//     first measured no faster (tools/flash_tiles.py).
//   * 4 warps (64 query rows) a block in every launch.
//
// f32 (the parity checks' dtype): f32 FMAs from shared memory
// (`fa_fwd`, `fa_bwd_dq`, `fa_bwd_dkdv`), since TF32 tensor cores would
// change their precision. One block of 256 threads per (b, h, 64-row
// tile); each thread owns a 4 x 4 tile of scores; f32 tiles padded by one
// word; q scaled by 1/sqrt(D) after its f32 cast, as the Pallas kernel
// does (kernel.py:47).
//
// Backward (both dtypes; deterministic, no atomics), two launches:
//   1. dQ: one block per (b, h, q tile). It first forms
//      Delta_i = rowsum(dO o O) in f32 for its rows (written for launch
//      2), then loops over KV tiles: dQ += P o (dP - Delta) . K * scale.
//   2. dK/dV: one block per (b, kv head, KV tile). It loops over the G
//      query heads of that kv head and over the q tiles at or below the
//      diagonal, so the sum over the G heads happens inside the block:
//      dV += P^T dO, dK += (P o (dP - Delta))^T q * scale.
//   S and dP are formed in both launches (7 products where 5 would do):
//   the price of the fixed summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBKV = 64;         // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int kLDP = 65;         // padded row stride of the 64 x 64 score tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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
// f32: forward
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
// f32: backward 1, Delta and dQ
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
// f32: backward 2, dK and dV, summed over the G query heads inside the block
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
// bf16: tensor-core building blocks
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Warps of the bf16 forward, 16 query rows each: 8 (128-row q tiles)
// measured slower at D 64 and D 128 (tools/flash_tiles.py builds and
// times that choice and the others below against these constants).
constexpr int kFwdWarps = 4;
constexpr int kMmaWarps = 4;     // warps of the bf16 backward launches

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand (16 x 16, k-step kk) made of two m16n8 accumulator tiles:
// the accumulator layout of columns 16 kk .. 16 kk + 15 is the A layout.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Addresses of one `ldsm4` over a tile in shared memory with row stride
// LD, at (row r0, column c0):
//   a_at: with `ldsm4`, the A operand (rows r0 .. r0 + 15 x columns
//         c0 .. c0 + 15); with `ldsm4t`, B operands of two n8 tiles, the
//         tile's rows being the product's k and its columns the product's
//         n (registers 0, 1: columns c0 .. c0 + 7; 2, 3: c0 + 8 .. c0 + 15);
//   b_at: with `ldsm4`, B operands of two n8 tiles, the tile's rows being
//         the product's n and its columns the product's k (registers 0, 1:
//         rows r0 .. r0 + 7; 2, 3: rows r0 + 8 .. r0 + 15).
template <int LD>
__device__ __forceinline__ const bf16* a_at(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_at(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// c[BN/8] (16 x BN) += A (16 x K from shared, rows ar0 of sa) . B^T where
// B (BN x K) is rows br0 .. br0 + BN - 1 of sb: a product along K of two
// row-major tiles, such as S = Q K^T.
template <int K, int BN, int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&c)[BN / 8][4], const bf16* sa, int ar0,
                                        const bf16* sb, int br0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, a_at<LDA>(sa, ar0, kk * 16, lane));
#pragma unroll
    for (int nn = 0; nn < BN / 16; ++nn) {
      uint32_t b[4];
      ldsm4(b, b_at<LDB>(sb, br0 + nn * 16, kk * 16, lane));
      mma_bf16(c[2 * nn], a, b[0], b[1]);
      mma_bf16(c[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// c[N/8] (16 x N) += A (16 x BK, from accumulators) . B where B (BK x N)
// is the row-major tile sb: such as O += P V.
template <int BK, int N, int LDB>
__device__ __forceinline__ void mma_acc_b(float (&c)[N / 8][4], const float (&acc)[BK / 8][4],
                                          const bf16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, acc, kk);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      ldsm4t(b, a_at<LDB>(sb, kk * 16, nn * 16, lane));
      mma_bf16(c[2 * nn], a, b[0], b[1]);
      mma_bf16(c[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// ROWS rows of COLS bf16 from global (row stride `stride` elements) into
// shared memory with row stride COLS + 8, by 16-byte cp.async; rows at or
// past `valid` are zero-filled (their source address is row 0). Where the
// tile's 16-byte chunks do not divide among the threads (D 80: 10 a row,
// 320 for a 32-row tile over 128 threads) the last round is partial.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int64_t stride, int valid) {
  constexpr int CPR = COLS / 8, CHUNKS = ROWS * CPR;
  static_assert(COLS % 8 == 0, "rows are copied in 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (CHUNKS % NT != 0 && c >= CHUNKS) break;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (COLS + 8) + col, src + (int64_t)(ok ? r : 0) * stride + col, ok);
  }
}

// Row `row` (= this thread's g or g + 8) of an m16n8 tile pair of f32
// accumulators, scaled by `mul`, as bf16 pairs at dst[8 c + 2 t4].
template <int N>
__device__ __forceinline__ void store_row(bf16* dst, const float (&c)[N][4], int half, int t4,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * t4) =
        __floats2bfloat162_rn(c[i][2 * half] * mul, c[i][2 * half + 1] * mul);
}

// ---------------------------------------------------------------------------
// bf16: forward
// ---------------------------------------------------------------------------

constexpr int kMmaBKV = 64;   // keys per KV tile of the bf16 forward

template <int D, int DV, int NW>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * ((size_t)16 * NW * (D + 8) + 2 * (size_t)kMmaBKV * (D + 8) +
                         2 * (size_t)kMmaBKV * (DV + 8));
}

template <int D, int DV, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
           float scale, int causal) {
  constexpr int NT = NW * 32, BQ = 16 * NW, BKV = kMmaBKV;
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(fa_smem);
  bf16* sK = sQ + BQ * LDQ;          // two stages
  bf16* sV = sK + 2 * BKV * LDK;     // two stages

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const bf16* kb = k + (int64_t)b * Skv * ks + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Skv * vs + (int64_t)hk * DV;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  cp_tile<BQ, D, NT>(sQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs, Sq - q0);
  cp_tile<BKV, D, NT>(sK, kb, ks, Skv);
  cp_tile<BKV, DV, NT>(sV, vb, vs, Skv);
  cp_commit();

  const float sl2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0 and row0 + 8
  uint32_t qf[D / 16][4];
  float acc[DV / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV, st = t & 1;
    cp_wait_all();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int k1 = k0 + BKV;
      cp_tile<BKV, D, NT>(sK + (st ^ 1) * BKV * LDK, kb + (int64_t)k1 * ks, ks, Skv - k1);
      cp_tile<BKV, DV, NT>(sV + (st ^ 1) * BKV * LDV, vb + (int64_t)k1 * vs, vs, Skv - k1);
      cp_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm4(qf[kk], a_at<LDQ>(sQ, warp * 16, kk * 16, lane));
    }
    const bf16* cK = sK + st * BKV * LDK;
    float s[BKV / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nn = 0; nn < BKV / 16; ++nn) {
        uint32_t bk[4];
        ldsm4(bk, b_at<LDK>(cK, nn * 16, kk * 16, lane));
        mma_bf16(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
      }

    // Scores in log2 units; masked to -inf on the diagonal and ragged tiles.
    const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1), row = row0 + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      corr[r] = exp2f(m[r] - m_use);
      m[r] = m_new;
      mx[r] = m_use;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
      }
    // Each thread keeps its own share of the row sums; the quad adds them
    // up once, after the loop.
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      acc[c][0] *= corr[0];
      acc[c][1] *= corr[0];
      acc[c][2] *= corr[1];
      acc[c][3] *= corr[1];
    }
    mma_acc_b<BKV, DV, LDV>(acc, s, sV + st * BKV * LDV, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + r * 8;
    if (row < Sq) {
      const float ll = fmaxf(lr, 1e-30f);
      store_row(o + ((int64_t)b * Sq + row) * ((int64_t)H * DV) + (int64_t)h * DV, acc, r, t4,
                1.f / ll);
      if (t4 == 0) lse[((int64_t)b * H + h) * Sq + row] = m[r] * kLn2 + logf(ll);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: backward 1, Delta and dQ
// ---------------------------------------------------------------------------

// KV tile of the dQ launch and q tile of the dK/dV launch: 64 rows, or 32
// where D or Dv is 128 (two 16 x 128 f32 accumulators and two score tiles
// of 16 x 64 would not fit in 255 registers a thread).
template <int D, int DV>
__host__ __device__ constexpr int bwd_inner() {
  return (D > 64 || DV > 64) ? 32 : 64;
}

template <int D, int DV>
constexpr size_t dq_mma_smem() {
  constexpr int BQ = 16 * kMmaWarps, BKV = bwd_inner<D, DV>();
  return sizeof(bf16) * ((size_t)BQ * (D + 8) + (size_t)BQ * (DV + 8) +
                         2 * (size_t)BKV * (D + 8) + 2 * (size_t)BKV * (DV + 8)) +
         sizeof(float) * 2 * BQ;
}

template <int D, int DV>
__global__ void __launch_bounds__(kMmaWarps * 32)
fa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
              float scale, int causal) {
  constexpr int NT = kMmaWarps * 32, BQ = 16 * kMmaWarps, BKV = bwd_inner<D, DV>();
  constexpr int LDQ = D + 8, LDO = DV + 8, LDK = D + 8, LDV = DV + 8;
  static_assert(NT == 2 * BQ, "Delta takes two threads a row");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(fa_smem);
  bf16* sdO = sQ + BQ * LDQ;
  bf16* sK = sdO + BQ * LDO;         // two stages
  bf16* sV = sK + 2 * BKV * LDK;     // two stages
  float* sL = reinterpret_cast<float*>(sV + 2 * BKV * LDV);   // LSE * log2(e)
  float* sD = sL + BQ;                                         // Delta

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const bf16* kb = k + (int64_t)b * Skv * ks + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Skv * vs + (int64_t)hk * DV;
  const bf16* dob = dout + ((int64_t)b * Sq + q0) * os + (int64_t)h * DV;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  cp_tile<BQ, D, NT>(sQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs, Sq - q0);
  cp_tile<BQ, DV, NT>(sdO, dob, os, Sq - q0);
  cp_tile<BKV, D, NT>(sK, kb, ks, Skv);
  cp_tile<BKV, DV, NT>(sV, vb, vs, Skv);
  cp_commit();

  // Delta_i = sum_c dO[i, c] * O[i, c] for this block's rows, two threads
  // a row, from device memory while the tiles load.
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bool ok = q0 + r < Sq;
    float part = 0.f;
    if (ok) {
      const bf16* orow = o + ((int64_t)b * Sq + q0 + r) * os + (int64_t)h * DV + half * (DV / 2);
      const bf16* drow = dob + (int64_t)r * os + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv4 = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(op[i]), d = __bfloat1622float2(dp[i]);
          part = fmaf(a.x, d.x, part);
          part = fmaf(a.y, d.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const int64_t li = ((int64_t)b * H + h) * Sq + q0 + r;
      if (ok) delta[li] = part;
      sL[r] = ok ? lse[li] * kLog2e : 0.f;
      sD[r] = part;
    }
  }

  const float sl2 = scale * kLog2e;
  const int rl = warp * 16 + g;            // this thread's rows in the tile: rl, rl + 8
  float acc[D / 8][4];
  zero(acc);
  float nl[2], dl[2];

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV, st = t & 1;
    cp_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k1 = k0 + BKV;
      cp_tile<BKV, D, NT>(sK + (st ^ 1) * BKV * LDK, kb + (int64_t)k1 * ks, ks, Skv - k1);
      cp_tile<BKV, DV, NT>(sV + (st ^ 1) * BKV * LDV, vb + (int64_t)k1 * vs, vs, Skv - k1);
      cp_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        nl[r] = -sL[rl + 8 * r];
        dl[r] = sD[rl + 8 * r];
      }
    }
    const bf16* cK = sK + st * BKV * LDK;
    float s[BKV / 8][4], dp[BKV / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, BKV, LDQ, LDK>(s, sQ, warp * 16, cK, 0, lane);                      // Q K^T
    mma_abt<DV, BKV, LDO, LDV>(dp, sdO, warp * 16, sV + st * BKV * LDV, 0, lane);  // dO V^T
    const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], sl2, nl[e >> 1]));
        if (edge) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1), row = q0 + rl + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);   // dS
      }
    mma_acc_b<BKV, D, LDK>(acc, s, cK, lane);   // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    if (row < Sq)
      store_row(dq + ((int64_t)b * Sq + row) * qs + (int64_t)h * D, acc, r, t4, scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: backward 2, dK and dV, summed over the G query heads inside the block
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t dkv_mma_smem() {
  constexpr int BKV = 16 * kMmaWarps, BQ = bwd_inner<D, DV>();
  return sizeof(bf16) * ((size_t)BKV * (D + 8) + (size_t)BKV * (DV + 8) +
                         2 * (size_t)BQ * (D + 8) + 2 * (size_t)BQ * (DV + 8)) +
         sizeof(float) * 4 * BQ;
}

// Asking ptxas to fit one block per SM raises the dQ launch's registers
// at D 64 from 166 to 202 (2 blocks an SM, not 3; ~7 % slower backward),
// but here it keeps <128, 32> from spilling 8 bytes (tools/flash_tiles.py).
template <int D, int DV>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
fa_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                float scale, int causal) {
  constexpr int NT = kMmaWarps * 32, BKV = 16 * kMmaWarps, BQ = bwd_inner<D, DV>();
  constexpr int LDK = D + 8, LDV = DV + 8, LDQ = D + 8, LDO = DV + 8;
  static_assert(BQ <= NT, "one thread loads each row's LSE and Delta");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* sK = reinterpret_cast<bf16*>(fa_smem);
  bf16* sV = sK + BKV * LDK;
  bf16* sQ = sV + BKV * LDV;          // two stages
  bf16* sdO = sQ + 2 * BQ * LDQ;      // two stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * LDO);   // LSE, two stages
  float* sD = sL + 2 * BQ;                                     // Delta, two stages

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;

  cp_tile<BKV, D, NT>(sK, k + ((int64_t)b * Skv + k0) * ks + (int64_t)hk * D, ks, Skv - k0);
  cp_tile<BKV, DV, NT>(sV, v + ((int64_t)b * Skv + k0) * vs + (int64_t)hk * DV, vs, Skv - k0);

  // Causal: only query rows >= k0 see this tile; start at their q tile.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_q = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int total = G * n_q;   // (head, q tile) pairs, head-major

  auto issue = [&](int it, int st) {
    const int hh = hk * G + it / n_q, q0 = q_begin + (it % n_q) * BQ;
    cp_tile<BQ, D, NT>(sQ + st * BQ * LDQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)hh * D, qs,
                       Sq - q0);
    cp_tile<BQ, DV, NT>(sdO + st * BQ * LDO,
                        dout + ((int64_t)b * Sq + q0) * os + (int64_t)hh * DV, os, Sq - q0);
    if (threadIdx.x < BQ) {
      const int64_t base = ((int64_t)b * H + hh) * Sq;
      const bool ok = q0 + (int)threadIdx.x < Sq;
      const int64_t li = base + (ok ? q0 + threadIdx.x : 0);
      cp_async4(sL + st * BQ + threadIdx.x, lse + li, ok);
      cp_async4(sD + st * BQ + threadIdx.x, delta + li, ok);
    }
  };
  if (total > 0) issue(0, 0);
  cp_commit();

  const float sl2 = scale * kLog2e;
  const int kl = warp * 16 + g;            // this thread's keys in the tile: kl, kl + 8
  float ak[D / 8][4], av[DV / 8][4];
  zero(ak);
  zero(av);

  for (int it = 0; it < total; ++it) {
    const int st = it & 1, q0 = q_begin + (it % n_q) * BQ;
    cp_wait_all();
    __syncthreads();
    if (it + 1 < total) {
      issue(it + 1, st ^ 1);
      cp_commit();
    }
    const bf16* cQ = sQ + st * BQ * LDQ;
    const bf16* cO = sdO + st * BQ * LDO;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;
    // Transposed tiles: rows are this warp's 16 keys, columns the BQ queries.
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, BQ, LDK, LDQ>(s, sK, warp * 16, cQ, 0, lane);    // S^T = K Q^T
    mma_abt<DV, BQ, LDV, LDO>(dp, sV, warp * 16, cO, 0, lane);  // dP^T = V dO^T
    const bool edge = q0 + BQ > Sq || k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t4);
      const float2 dq2 = *reinterpret_cast<const float2*>(cD + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? lq.y : lq.x, dl = (e & 1) ? dq2.y : dq2.x;
        float p = exp2f(fmaf(s[j][e], sl2, -lv * kLog2e));
        if (edge) {
          const int key = k0 + kl + (e >> 1) * 8, qi = q0 + 8 * j + 2 * t4 + (e & 1);
          if (key >= Skv || qi >= Sq || (causal && key > qi)) p = 0.f;
        }
        s[j][e] = p;                      // P^T
        dp[j][e] = p * (dp[j][e] - dl);   // dS^T
      }
    }
    mma_acc_b<BQ, DV, LDO>(av, s, cO, lane);   // dV += P^T dO
    mma_acc_b<BQ, D, LDQ>(ak, dp, cQ, lane);   // dK += dS^T Q
  }
  cp_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl + 8 * r;
    if (key < Skv) {
      store_row(dk + ((int64_t)b * Skv + key) * ks + (int64_t)hk * D, ak, r, t4, scale);
      store_row(dv + ((int64_t)b * Skv + key) * vs + (int64_t)hk * DV, av, r, t4, 1.f);
    }
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

template <typename Kern, typename... A>
int launch(Kern kern, dim3 grid, int threads, size_t smem, cudaStream_t stream, A... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch_fwd(const Args& a) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  float* lse = static_cast<float*>(a.lse_out);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int BQ = 16 * kFwdWarps;
    return launch(fa_fwd_mma<D, DV, kFwdWarps>, dim3((a.Sq + BQ - 1) / BQ, a.H, a.B),
                  kFwdWarps * 32, fwd_mma_smem<D, DV, kFwdWarps>(), a.stream, q, k, v, out, lse,
                  a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
  } else {
    return launch(fa_fwd<T, D, DV>, dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads,
                  fwd_smem<D, DV>(), a.stream, q, k, v, out, lse, a.Sq, a.Skv, a.H, a.Hkv,
                  a.scale, a.causal);
  }
}

template <typename T, int D, int DV>
int launch_bwd(const Args& a) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *o = static_cast<const T*>(a.o),
          *dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  T *dq = static_cast<T*>(a.dq), *dk = static_cast<T*>(a.dk), *dv = static_cast<T*>(a.dv);
  int e;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int BQ = 16 * kMmaWarps, BKV = 16 * kMmaWarps;
    e = launch(fa_bwd_dq_mma<D, DV>, dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), kMmaWarps * 32,
               dq_mma_smem<D, DV>(), a.stream, q, k, v, o, dout, lse, delta, dq, a.Sq, a.Skv,
               a.H, a.Hkv, a.scale, a.causal);
    if (e != 0) return e;
    return launch(fa_bwd_dkdv_mma<D, DV>, dim3((a.Skv + BKV - 1) / BKV, a.Hkv, a.B),
                  kMmaWarps * 32, dkv_mma_smem<D, DV>(), a.stream, q, k, v, dout, lse,
                  (const float*)delta, dk, dv, a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
  } else {
    e = launch(fa_bwd_dq<T, D, DV>, dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads,
               dq_smem<D, DV>(), a.stream, q, k, v, o, dout, lse, delta, dq, a.Sq, a.Skv, a.H,
               a.Hkv, a.scale, a.causal);
    if (e != 0) return e;
    return launch(fa_bwd_dkdv<T, D, DV>, dim3((a.Skv + kBKV - 1) / kBKV, a.Hkv, a.B), kThreads,
                  dkv_smem<D, DV>(), a.stream, q, k, v, dout, lse, (const float*)delta, dk, dv,
                  a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
  }
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

// D and Dv each in {32, 64, 128}, or D = Dv = 80 (hubert-xlarge's heads),
// a pair of its own so that the build does not grow by the whole cross
// product.
template <typename T, bool BWD>
int dispatch_d(const Args& a, int D, int Dv) {
  switch (D) {
    case 32: return dispatch_dv<T, BWD, 32>(a, Dv);
    case 64: return dispatch_dv<T, BWD, 64>(a, Dv);
    case 128: return dispatch_dv<T, BWD, 128>(a, Dv);
    case 80:
      if (Dv == 80) return BWD ? launch_bwd<T, 80, 80>(a) : launch_fwd<T, 80, 80>(a);
  }
  return -1;
}

template <bool BWD>
int dispatch(const Args& a, int D, int Dv, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.Hkv <= 0 || a.H % a.Hkv) return -1;
  if (a.B > 65535 || a.H > 65535) return -1;
  if (dtype == 0) return dispatch_d<float, BWD>(a, D, Dv);
  if (dtype == 1) return dispatch_d<bf16, BWD>(a, D, Dv);
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
