// Mamba2 SSD chunked scan for Hopper (sm_90a): forward (K5) and backward.
//
// Replaces the Pallas TPU kernel `ssd_scan_fwd` in
// src/repro/kernels/ssd_scan/kernel.py, the TPU twin of the reference
// model's `mamba2.ssd_chunked`, which `mamba2_apply` runs in every Mamba2
// layer of training. The JAX package has no backward kernel: XLA
// differentiates `ssd_chunked` (and its gradient overflows, see below).
// Here the backward is written by hand too.
//
// Shapes follow the Pallas kernel: x (B, S, H, P), dt (B, S, H) f32
// (softplus'd), A (H,) f32 (< 0), Bm / Cm (B, S, G, N) in x's dtype; head
// h reads group h / (H / G). y (B, S, H, P) is in x's dtype. All
// contiguous. Per chunk of Q positions, in f32, with a = dt * A,
// a_cum its running sum in the chunk and a_tot its last value:
//   y_i = exp(a_cum_i) C_i S + sum_{j<=i} (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j x_j
//   S  <- exp(a_tot) S + sum_j exp(a_tot - a_cum_j) dt_j x_j B_j^T,
// S the (P, N) state, zero before the first chunk. The sequence's ragged
// tail is handled as the Pallas kernel pads it: rows past S load as zero
// (dt = 0, an inert step), nothing is padded in device memory.
//
// Every exponential is formed only where its argument is <= 0 (i >= j,
// a_tot <= a_cum): nothing can overflow. XLA's gradient of the
// reference's `where(causal, exp(seg), 0)` is NaN once seg above the
// diagonal passes f32's exp limit, as zamba2-1.2b's initial decay does.
//
// Bound, at the training shape (B 32, S 512, H 64, P 64, G 1, N 64,
// Q 128): the forward moves ~0.28 GB (x and y in bf16 dominate) and does
// ~51.5 GFLOP of small products, ~0.08 ms of memory traffic against
// ~0.05 ms at the bf16 tensor-core rate: bytes, narrowly. This first
// version is simple and right, not fast: f32 FMAs from shared memory, no
// tensor cores, one (b, h) per block. What the design keeps:
//   * one block of 512 threads per (b, h); a loop over the chunks inside
//     the block replaces the Pallas kernel's sequential grid axis, the
//     state staying in shared memory (2048 blocks at the training shape);
//   * each chunk stages x, B, C (and in the backward dy) in f32 shared
//     memory with rows padded by one word, and forms the (Q, Q) decay
//     matrix once; tile rows R = max(16, pow2 >= Q), rows past the chunk
//     are zero. a_cum is a serial sum by one thread (Q <= 128 adds).
//   * the forward writes the state entering every chunk and the final
//     state, `states` (B, H, nc + 1, P, N) f32, which the TPU kernel keeps
//     in VMEM only: the backward reads S_in and S_out from it, as K1's
//     backward reads the LSE, instead of rescanning the forward.
// Backward (deterministic, no atomics), two launches:
//   1. one block per (b, h), over the chunks in reverse, carrying G, the
//      gradient of the state leaving the chunk (zero after the last):
//        du_j = sum_{i>=j} P2_ij dy_i + exp(a_tot - a_cum_j) G B_j,
//        P2_ij = (C_i . B_j) L_ij;  dx_j = dt_j du_j,
//        dC_i = sum_{j<=i} P1_ij B_j + exp(a_cum_i) S_in^T dy_i,
//        dB_j = sum_{i>=j} P1_ij C_i + exp(a_tot - a_cum_j) dt_j G^T x_j,
//        P1_ij = L_ij dt_j (dy_i . x_j);
//      d a_cum_i = dy_i . y_i - dt_i (x_i . du_i), plus <G, S_out> at the
//      chunk's last row (a_tot); its reverse cumsum is da, and
//      ddt = x . du + A da, dA += sum da dt;  then
//      G <- exp(a_tot) G + sum_i exp(a_cum_i) dy_i C_i^T.
//      dB and dC are written per head, dA per (b, h), in f32;
//   2. a reduction sums dB and dC over the H / G heads of each group and
//      dA over the batch, each in a fixed order.
// Later work: mma.sync / wgmma tiles for the four in-chunk products,
// more than one block per SM (bf16 tiles), cp.async staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 128;
constexpr size_t kMaxSmem = 232448;   // what one block may use on Hopper

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Dims {
  int B, S, H, P, G, N, Q;   // Q: chunk length (positions per chunk)
  int R;                     // tile rows: max(16, next power of two >= Q)
  int nc;                    // chunks: ceil(S / Q)
};

// dst[r * ld + c] = src[r * stride + c] in f32 for r < valid, 0 for the
// tile's other rows.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          int64_t stride, int valid, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * ld + c] = r < valid ? to_f(src[r * stride + c]) : 0.f;
  }
}

// Stage one chunk's dt (sDT) and its running sum a_cum = cumsum(dt * A)
// (sAC, by one thread, in order).
__device__ __forceinline__ void load_decay(float* sDT, float* sAC, const float* __restrict__ dt,
                                           int64_t stride, int valid, int R, float A) {
  for (int r = threadIdx.x; r < R; r += kThreads) sDT[r] = r < valid ? dt[r * stride] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) {
      s += sDT[r] * A;
      sAC[r] = s;
    }
  }
}

// Sum over the `tpr` adjacent lanes that share one row (tpr divides 32).
__device__ __forceinline__ float lanes_sum(float v, int tpr) {
  for (int o = tpr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

size_t fwd_smem(const Dims& d) {
  return sizeof(float) * ((size_t)d.R * (d.P + 1) + 2 * (size_t)d.R * (d.N + 1) +
                          (size_t)d.R * (d.R + 1) + (size_t)d.P * (d.N + 1) + 2 * (size_t)d.R);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
        float* __restrict__ states, Dims d) {
  const int LP = d.P + 1, LN = d.N + 1, LR = d.R + 1, R = d.R, P = d.P, N = d.N;
  extern __shared__ float smem[];
  float* sX = smem;
  float* sB = sX + R * LP;
  float* sC = sB + R * LN;
  float* sQQ = sC + R * LN;
  float* sS = sQQ + R * LR;
  float* sDT = sS + P * LN;
  float* sAC = sDT + R;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / (d.H / d.G);
  const float Ah = A[h];
  const int tpr = kThreads / R, ri = tid / tpr, rk = tid - ri * tpr;
  const int64_t xs = (int64_t)d.H * P, bs = (int64_t)d.G * N, PN = (int64_t)P * N;
  float* st = states + ((int64_t)b * d.H + h) * (d.nc + 1) * PN;

  for (int idx = tid; idx < P * N; idx += kThreads) {
    sS[(idx / N) * LN + idx % N] = 0.f;
    st[idx] = 0.f;
  }

  for (int c = 0; c < d.nc; ++c) {
    const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
    const int64_t row0 = (int64_t)b * d.S + s0;
    __syncthreads();                               // the previous chunk is consumed
    load_rows(sX, LP, x + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    load_rows(sB, LN, Bm + row0 * bs + (int64_t)g * N, bs, valid, R, N);
    load_rows(sC, LN, Cm + row0 * bs + (int64_t)g * N, bs, valid, R, N);
    load_decay(sDT, sAC, dt + row0 * d.H + h, d.H, valid, R, Ah);
    __syncthreads();

    // sQQ_ij = (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j on i >= j, else 0.
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx - i * R;
      float v = 0.f;
      if (j <= i) {
        const float* ci = sC + i * LN;
        const float* bj = sB + j * LN;
        for (int n = 0; n < N; ++n) v = fmaf(ci[n], bj[n], v);
        v *= expf(sAC[i] - sAC[j]) * sDT[j];
      }
      sQQ[i * LR + j] = v;
    }
    __syncthreads();

    // y_i[p] = exp(a_cum_i) C_i . S[p] + sum_{j<=i} sQQ_ij x_j[p].
    {
      const int i = ri;
      const float ei = expf(sAC[i]);
      for (int p = rk; p < P; p += tpr) {
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(sC[i * LN + n], sS[p * LN + n], inter);
        float acc = ei * inter;
        for (int j = 0; j <= i; ++j) acc = fmaf(sQQ[i * LR + j], sX[j * LP + p], acc);
        if (i < valid) y[(row0 + i) * xs + (int64_t)h * P + p] = from_f<T>(acc);
      }
    }
    __syncthreads();

    // S <- exp(a_tot) S + sum_j exp(a_tot - a_cum_j) dt_j x_j B_j^T.
    const float a_tot = sAC[R - 1];
    for (int r = tid; r < R; r += kThreads) sDT[r] *= expf(a_tot - sAC[r]);
    __syncthreads();
    const float E = expf(a_tot);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      float acc = E * sS[p * LN + n];
      for (int j = 0; j < R; ++j) acc = fmaf(sDT[j] * sX[j * LP + p], sB[j * LN + n], acc);
      sS[p * LN + n] = acc;
      st[(c + 1) * PN + idx] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

size_t bwd_smem(const Dims& d) {
  return sizeof(float) * (2 * (size_t)d.R * (d.P + 1) + 2 * (size_t)d.R * (d.N + 1) +
                          (size_t)d.R * (d.R + 1) + (size_t)d.P * (d.N + 1) + 5 * (size_t)d.R +
                          kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states,
        const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ dB_part, float* __restrict__ dC_part,
        float* __restrict__ dA_part, Dims d) {
  const int LP = d.P + 1, LN = d.N + 1, LR = d.R + 1, R = d.R, P = d.P, N = d.N;
  extern __shared__ float smem[];
  float* sX = smem;
  float* sDY = sX + R * LP;
  float* sB = sDY + R * LP;
  float* sC = sB + R * LN;
  float* sQQ = sC + R * LN;
  float* sG = sQQ + R * LR;
  float* sDT = sG + P * LN;
  float* sAC = sDT + R;
  float* sR = sAC + R;       // dy_i . y_i
  float* sDD = sR + R;       // x_i . du_i
  float* sE = sDD + R;       // exp(a_cum_i)
  float* sRed = sE + R;      // one partial of <G, S_out> per thread

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / (d.H / d.G);
  const float Ah = A[h];
  const int tpr = kThreads / R, ri = tid / tpr, rk = tid - ri * tpr;
  const int64_t xs = (int64_t)d.H * P, bs = (int64_t)d.G * N, PN = (int64_t)P * N;
  const int64_t ps = (int64_t)d.H * N;            // row stride of dB_part / dC_part
  const float* st = states + ((int64_t)b * d.H + h) * (d.nc + 1) * PN;

  for (int idx = tid; idx < P * N; idx += kThreads) sG[(idx / N) * LN + idx % N] = 0.f;
  float dA_acc = 0.f;                              // thread 0's sum of da * dt

  for (int c = d.nc - 1; c >= 0; --c) {
    const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
    const int64_t row0 = (int64_t)b * d.S + s0;
    const float* s_in = st + c * PN;
    const float* s_out = s_in + PN;
    __syncthreads();                               // the previous chunk is consumed
    load_rows(sX, LP, x + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    load_rows(sDY, LP, dy + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    load_rows(sB, LN, Bm + row0 * bs + (int64_t)g * N, bs, valid, R, N);
    load_rows(sC, LN, Cm + row0 * bs + (int64_t)g * N, bs, valid, R, N);
    load_decay(sDT, sAC, dt + row0 * d.H + h, d.H, valid, R, Ah);
    __syncthreads();
    const float a_tot = sAC[R - 1];
    for (int r = tid; r < R; r += kThreads) sE[r] = expf(sAC[r]);   // read after 3 syncs

    // P2_ij = (C_i . B_j) L_ij on i >= j, else 0.
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx - i * R;
      float v = 0.f;
      if (j <= i) {
        const float* ci = sC + i * LN;
        const float* bj = sB + j * LN;
        for (int n = 0; n < N; ++n) v = fmaf(ci[n], bj[n], v);
        v *= expf(sAC[i] - sAC[j]);
      }
      sQQ[i * LR + j] = v;
    }
    __syncthreads();

    // Row i: y_i (recomputed) for dy_i . y_i; and du_i, dx_i, x_i . du_i.
    {
      const int i = ri;
      const float ei = expf(sAC[i]), fi = expf(a_tot - sAC[i]), dti = sDT[i];
      float r_part = 0.f, dd_part = 0.f;
      for (int p = rk; p < P; p += tpr) {
        float inter = 0.f, dstate = 0.f;
        for (int n = 0; n < N; ++n) {
          inter = fmaf(sC[i * LN + n], s_in[p * N + n], inter);
          dstate = fmaf(sG[p * LN + n], sB[i * LN + n], dstate);
        }
        float yv = ei * inter;
        for (int j = 0; j <= i; ++j) yv = fmaf(sQQ[i * LR + j] * sDT[j], sX[j * LP + p], yv);
        float du = fi * dstate;
        for (int k = i; k < R; ++k) du = fmaf(sQQ[k * LR + i], sDY[k * LP + p], du);
        r_part = fmaf(sDY[i * LP + p], yv, r_part);
        dd_part = fmaf(sX[i * LP + p], du, dd_part);
        if (i < valid) dx[(row0 + i) * xs + (int64_t)h * P + p] = from_f<T>(dti * du);
      }
      r_part = lanes_sum(r_part, tpr);
      dd_part = lanes_sum(dd_part, tpr);
      if (rk == 0) {
        sR[i] = r_part;
        sDD[i] = dd_part;
      }
    }
    __syncthreads();

    // P1_ij = L_ij dt_j (dy_i . x_j) on i >= j, else 0.
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx - i * R;
      float v = 0.f;
      if (j <= i) {
        const float* di = sDY + i * LP;
        const float* xj = sX + j * LP;
        for (int p = 0; p < P; ++p) v = fmaf(di[p], xj[p], v);
        v *= expf(sAC[i] - sAC[j]) * sDT[j];
      }
      sQQ[i * LR + j] = v;
    }
    // <G, S_out>: the gradient of a_tot through the state update.
    {
      float part = 0.f;
      for (int idx = tid; idx < P * N; idx += kThreads)
        part = fmaf(sG[(idx / N) * LN + idx % N], s_out[idx], part);
      sRed[tid] = part;
    }
    __syncthreads();

    // Row i: dC_i and dB_i (this head's share).
    {
      const int i = ri;
      const float ei = expf(sAC[i]), wi = expf(a_tot - sAC[i]) * sDT[i];
      for (int n = rk; n < N; n += tpr) {
        float dc = 0.f, db = 0.f;
        for (int p = 0; p < P; ++p) {
          dc = fmaf(sDY[i * LP + p], s_in[p * N + n], dc);
          db = fmaf(sG[p * LN + n], sX[i * LP + p], db);
        }
        dc *= ei;
        db *= wi;
        for (int j = 0; j <= i; ++j) dc = fmaf(sQQ[i * LR + j], sB[j * LN + n], dc);
        for (int k = i; k < R; ++k) db = fmaf(sQQ[k * LR + i], sC[k * LN + n], db);
        if (i < valid) {
          dC_part[(row0 + i) * ps + (int64_t)h * N + n] = dc;
          dB_part[(row0 + i) * ps + (int64_t)h * N + n] = db;
        }
      }
    }
    __syncthreads();

    // Thread 0: d a_cum, its reverse cumsum da, ddt and dA's share, in
    // order. The others: G <- exp(a_tot) G + sum_i exp(a_cum_i) dy_i C_i^T
    // (thread 0 takes its share of G after).
    if (tid == 0) {
      float datot = 0.f;
      for (int t = 0; t < kThreads; ++t) datot += sRed[t];
      float da = 0.f;
      for (int r = R - 1; r >= 0; --r) {
        da += sR[r] - sDT[r] * sDD[r] + (r == R - 1 ? datot : 0.f);
        if (r < valid) ddt[(row0 + r) * d.H + h] = sDD[r] + Ah * da;
        dA_acc = fmaf(da, sDT[r], dA_acc);
      }
    }
    const float E = expf(a_tot);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      float acc = 0.f;
      for (int r = 0; r < R; ++r)
        acc = fmaf(sE[r] * sDY[r * LP + p], sC[r * LN + n], acc);
      sG[p * LN + n] = fmaf(E, sG[p * LN + n], acc);
    }
  }
  if (tid == 0) dA_part[(int64_t)b * d.H + h] = dA_acc;
}

// dB, dC (B, S, G, N): each the sum over the H / G heads of its group, in
// head order; dA (H,): the sum over the batch, in order.
template <typename T>
__global__ void ssd_bwd_reduce(const float* __restrict__ dB_part,
                               const float* __restrict__ dC_part,
                               const float* __restrict__ dA_part, T* __restrict__ dB,
                               T* __restrict__ dC, float* __restrict__ dA, Dims d) {
  const int hg = d.H / d.G;
  const int64_t per = (int64_t)d.B * d.S * d.G * d.N;
  const int64_t total = 2 * per + d.H;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    if (idx < 2 * per) {
      const bool is_c = idx >= per;
      const int64_t e = is_c ? idx - per : idx;
      const int64_t row = e / ((int64_t)d.G * d.N);
      const int rem = (int)(e - row * d.G * d.N), g = rem / d.N, n = rem - g * d.N;
      const float* src = (is_c ? dC_part : dB_part) + (row * d.H + (int64_t)g * hg) * d.N + n;
      float s = 0.f;
      for (int q = 0; q < hg; ++q) s += src[(int64_t)q * d.N];
      (is_c ? dC : dB)[e] = from_f<T>(s);
    } else {
      const int h = (int)(idx - 2 * per);
      float s = 0.f;
      for (int bb = 0; bb < d.B; ++bb) s += dA_part[(int64_t)bb * d.H + h];
      dA[h] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool make_dims(Dims& d, int B, int S, int H, int P, int G, int N, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0) return false;
  if (H % G || B > 65535 || Q > kMaxRows) return false;
  int R = 16;
  while (R < Q) R <<= 1;
  d = Dims{B, S, H, P, G, N, Q, R, (S + Q - 1) / Q};
  return true;
}

template <typename T>
int launch_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               void* y, void* states, const Dims& d, cudaStream_t stream) {
  const size_t smem = fwd_smem(d);
  if (smem > kMaxSmem) return -1;
  auto kern = ssd_fwd<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(d.H, d.B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(states), d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* states, const void* dy, void* dx, void* ddt, void* dB_part,
               void* dC_part, void* dA_part, void* dB, void* dC, void* dA, const Dims& d,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(d);
  if (smem > kMaxSmem) return -1;
  auto kern = ssd_bwd<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(d.H, d.B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(states),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = 2 * (int64_t)d.B * d.S * d.G * d.N + d.H;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  ssd_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y, dy, dx, dB, dC); dt, A,
// ddt, dA and the states are f32. Each returns cudaGetLastError() after
// its launches (0 = launched), or -1 for arguments the kernels do not take.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, void* states,
                                  int B, int S, int H, int P, int G, int N, int Q, int dtype,
                                  void* stream) {
  Dims d;
  if (!make_dims(d, B, S, H, P, G, N, Q)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, dt, A, Bm, Cm, y, states, d, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, dt, A, Bm, Cm, y, states, d, s);
  return -1;
}

extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* states,
                                  const void* dy, void* dx, void* ddt, void* dB_part,
                                  void* dC_part, void* dA_part, void* dB, void* dC, void* dA,
                                  int B, int S, int H, int P, int G, int N, int Q, int dtype,
                                  void* stream) {
  Dims d;
  if (!make_dims(d, B, S, H, P, G, N, Q)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, dt, A, Bm, Cm, states, dy, dx, ddt, dB_part, dC_part,
                             dA_part, dB, dC, dA, d, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, states, dy, dx, ddt, dB_part,
                                     dC_part, dA_part, dB, dC, dA, d, s);
  return -1;
}
