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
// Bound, at the training shape (B 32, S 512, H 64, P 64, G 1, N 64,
// Q 128): the forward moves ~0.28 GB (x and y in bf16 dominate) and does
// ~34.5 GFLOP of small products, ~0.08 ms of memory traffic against
// ~0.035 ms at the bf16 tensor-core rate: bytes. The backward moves
// ~0.42 GB (~0.125 ms). Two paths:
//
// f32 (`ssd_fwd`, `ssd_bwd` on float; the f32 train-step parity runs):
// simple and right, not fast: f32 FMAs from f32 shared memory, one (b, h)
// per 512-thread block, a loop over the chunks inside the block (the
// state stays in shared memory), the (Q, Q) decay matrix formed once per
// chunk, a_cum summed by one thread.
//
// bf16 (`ssd_fwd_mma`, `ssd_bwd_mma`; the training path): the in-chunk
// products on the tensor cores (mma.sync m16n8k16, bf16 -> f32, operands
// by ldmatrix), one block of 8 warps per (b, h), the chunks in a loop
// inside the block as in the Pallas kernel's sequential grid axis. Per
// chunk, x, B, C (and dy) are staged as bf16 by 16-byte cp.async (at
// P = N = 64, ~75 KB of shared memory forward and ~112 KB backward, so
// three forward or two backward blocks share an SM and overlap one's
// loads with the others' products); a_cum is a warp scan with shuffles.
// No block keeps a second stage of tiles in flight. Warp w owns
// rows 16w .. 16w + 15 of the chunk and walks the causal 16 x 16 tiles of
// its row (and, in the backward, of its column) in registers:
//   S_ij = C_i . B_j (bf16 operands, exact), M_ij = S_ij L_ij dt_j masked
//   on i >= j before the exp, then y_i += M_ij x_j with M's accumulator
//   tile reused as the A operand (as FlashAttention-2 reuses P).
// An operand that is f32 by nature (M, the states S and G, w * x, e * dy,
// P1, P2) is split into hi = bf16(v) and lo = bf16(v - hi) and fed as two
// products: each term keeps 16 of f32's 24 bits (relative error <= 2^-16),
// inside the tolerances the f32 kernels are held to (`parity.ssd_within`).
// The state update S <- exp(a_tot) S + (w * x)^T B, (P, N) over the 8
// warps with K = Q, adds onto the f32 state in shared memory and writes
// `states[c + 1]`. The backward walks the chunks in reverse carrying G in
// shared memory (f32); per chunk a warp forms, for its rows i, S and
// D = dy x^T tiles, P1 = L dt D and r_i = dy_i . y_i = sum_j S_ij P1_ij +
// e_i C_i . (dy_i S_in) (y is never re-formed), and dC_i; for its rows j,
// S^T and D^T tiles, P2^T and P1^T, and du_j, then dB_j in a second pass
// (so du and dB are never live together, which keeps it within the 128
// registers of two blocks an SM). Each head writes its own share of dB
// and dC. The scalar tails (a_cum, the reverse cumsum of d a_cum, <G, S_out>, dA's
// share) are warp scans and fixed-order shuffle trees: two launches give
// equal bits.
//
// Every exponential is formed only where its argument is <= 0 (i >= j,
// a_tot <= a_cum; the tensor-core path also clamps each argument at 0
// against a_cum's rounding): nothing can overflow. XLA's gradient of the
// reference's `where(causal, exp(seg), 0)` is NaN once seg above the
// diagonal passes f32's exp limit, as zamba2-1.2b's initial decay does.
//
// Both forwards write the state entering every chunk and the final state,
// `states` (B, H, nc + 1, P, N) f32, which the TPU kernel keeps in VMEM
// only: the backward reads S_in and S_out from it, as K1's backward reads
// the LSE, instead of rescanning the forward.
// Backward (deterministic, no atomics), two launches:
//   1. the chunks in reverse, carrying G, the gradient of the state
//      leaving the chunk (zero after the last):
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
//   2. a reduction sums dB and dC over the heads of each group and dA
//      over the batch, each in a fixed order.

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
  int R;                     // f32 tile rows: max(16, next power of two >= Q)
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
// bf16: tensor-core building blocks
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;     // 16 of a chunk's kMaxRows rows each
constexpr int kTcThreads = kTcWarps * 32;
static_assert(kMaxRows == 16 * kTcWarps && kMaxRows == 4 * 32,
              "a warp owns 16 rows; the decay scan gives a lane 4");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (`.trans`: each matrix transposed).
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
// Two transposed matrices: lanes 0-15 give the addresses of their rows.
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// Two products, hi and lo parts of one f32 operand against one bf16 operand.
__device__ __forceinline__ void mma_hl(float (&c)[4], const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);
}
__device__ __forceinline__ void mma_bhl(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&hi)[2],
                                        const uint32_t (&lo)[2]) {
  mma_bf16(c, a, hi[0], hi[1]);
  mma_bf16(c, a, lo[0], lo[1]);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(v) and lo = bf16(v - hi) of the pair (v0, v1): v - hi is exact
// in f32, so hi + lo is v to within 2^-16 of |v|.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// hi / lo A operands of the 16 x 16 tile held as two m16n8 accumulator
// tiles (the accumulator layout of 16 columns is the A layout).
__device__ __forceinline__ void acc_to_a_hl(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float (&c)[2][4]) {
  split2(c[0][0], c[0][1], hi[0], lo[0]);
  split2(c[0][2], c[0][3], hi[1], lo[1]);
  split2(c[1][0], c[1][1], hi[2], lo[2]);
  split2(c[1][2], c[1][3], hi[3], lo[3]);
}

// Addresses of one `ldsm4` over a bf16 tile with row stride LD at (row
// r0, column c0):
//   a_at: with `ldsm4`, the A operand (rows r0 .. r0 + 15 x columns
//         c0 .. c0 + 15); with `ldsm4t`, B operands of two n8 tiles, the
//         tile's rows being the product's k and its columns its n
//         (registers 0, 1: columns c0 .. c0 + 7; 2, 3: c0 + 8 .. c0 + 15);
//   b_at: with `ldsm4`, B operands of two n8 tiles, the tile's rows being
//         the product's n and its columns its k (registers 0, 1: rows
//         r0 .. r0 + 7; 2, 3: r0 + 8 .. r0 + 15); with `ldsm4t`, the A
//         operand of the transpose (rows c0 .. c0 + 15 of the product
//         from the tile's columns, k from its rows r0 .. r0 + 15).
template <int LD>
__device__ __forceinline__ const bf16* a_at(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_at(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Rows [0, rows) of a tile of `cols` bf16 (a multiple of 8) from global
// (row stride `stride`) into shared memory (row stride ld) by 16-byte
// cp.async; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src, int64_t stride,
                                        int valid, int rows, int cols) {
  const int cpr = cols / 8;
  for (int c = threadIdx.x; c < rows * cpr; c += kTcThreads) {
    const int r = c / cpr, col = (c - r * cpr) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + col, src + (int64_t)(ok ? r : 0) * stride + col, ok);
  }
}

// A contiguous (rows, cols) f32 matrix into shared memory, row stride ld.
__device__ __forceinline__ void cp_f32(float* dst, int ld, const float* src, int rows,
                                       int cols) {
  const int cpr = cols / 4;
  for (int c = threadIdx.x; c < rows * cpr; c += kTcThreads) {
    const int r = c / cpr, col = (c - r * cpr) * 4;
    cp_async16(dst + r * ld + col, src + r * cols + col, true);
  }
}

// The B operand (k = 16 rows from k0, n = 8 columns from n0) of a product
// against an f32 matrix M in shared memory (row stride ld), hi and lo:
//   kn_rows: B[k][n] = M[n][k] (M's rows are the product's n);
//   kn_cols: B[k][n] = M[k][n] (M's rows are the product's k).
template <int LD>
__device__ __forceinline__ void b_f32_nk(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* m,
                                         int k0, int n0, int g, int t4) {
  const float* p = m + (n0 + g) * LD + k0 + 2 * t4;
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
  split2(v0.x, v0.y, hi[0], lo[0]);
  split2(v1.x, v1.y, hi[1], lo[1]);
}
template <int LD>
__device__ __forceinline__ void b_f32_kn(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* m,
                                         int k0, int n0, int g, int t4) {
  const float* p = m + (k0 + 2 * t4) * LD + n0 + g;
  split2(p[0], p[LD], hi[0], lo[0]);
  split2(p[8 * LD], p[9 * LD], hi[1], lo[1]);
}

// Warp 0: one chunk's dt (rows < valid; 0 past them) and its running sum
// a_cum = cumsum(dt * A) over all kMaxRows rows, 4 consecutive rows a lane,
// then a shuffle scan across the lanes (a fixed order). Writes sDT, sAC,
// sE = exp(a_cum) and sF = exp(a_tot - a_cum) (a_tot: the last a_cum).
__device__ __forceinline__ void decay_scan(const float* __restrict__ dt, int64_t stride,
                                            int valid, float A, float* sDT, float* sAC,
                                            float* sE, float* sF, int lane) {
  float d[4], a[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * lane + k;
    d[k] = r < valid ? dt[r * stride] : 0.f;
    run += d[k] * A;
    a[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float a_tot = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * lane + k;
    const float ac = excl + a[k];
    sDT[r] = d[k];
    sAC[r] = ac;
    sE[r] = expf(fminf(ac, 0.f));
    sF[r] = expf(fminf(a_tot - ac, 0.f));
  }
}

// L_ij = exp(a_cum_i - a_cum_j) for i >= j, else 0 (masked before the exp).
__device__ __forceinline__ float decay(float ac_i, float ac_j, int i, int j) {
  return j <= i ? expf(fminf(ac_i - ac_j, 0.f)) : 0.f;
}

// The (P, N) state-shaped outputs over the 8 warps: T = (P / 16) (N / 8)
// m16n8 tiles, TPW consecutive ones a warp (all in one 16-row band pb).
template <int P, int N>
struct Slab {
  static constexpr int T = (P / 16) * (N / 8);
  static constexpr int TPW = T >= kTcWarps ? T / kTcWarps : 1;
};

// acc[k] (16 x 8, rows p of band pb, columns 8 (nt0 + k)) = sum over the
// tile's rows j < 16 nb of (s_j * V[j][p]) W[j][n]: V (rows j, P columns)
// and W (rows j, N columns) bf16 tiles, s f32 per row; s * V split hi / lo.
template <int P, int N>
__device__ __forceinline__ void slab_product(float (&acc)[Slab<P, N>::TPW][4], const bf16* sV,
                                             const bf16* sW, const float* s, int nb, int pb,
                                             int nt0, int lane) {
  constexpr int LDP = P + 8, LDN = N + 8;
  const int t4 = lane & 3;
  zero(acc);
  for (int ki = 0; ki < nb; ++ki) {
    uint32_t v[4], hi[4], lo[4];
    ldsm4t(v, b_at<LDP>(sV, ki * 16, pb * 16, lane));
    const int j = ki * 16 + 2 * t4;
    const float s0 = s[j], s1 = s[j + 1], s8 = s[j + 8], s9 = s[j + 9];
    float2 f = unpack(v[0]);
    split2(f.x * s0, f.y * s1, hi[0], lo[0]);
    f = unpack(v[1]);
    split2(f.x * s0, f.y * s1, hi[1], lo[1]);
    f = unpack(v[2]);
    split2(f.x * s8, f.y * s9, hi[2], lo[2]);
    f = unpack(v[3]);
    split2(f.x * s8, f.y * s9, hi[3], lo[3]);
#pragma unroll
    for (int k = 0; k < Slab<P, N>::TPW; ++k) {
      uint32_t w[2];
      ldsm2t(w, sW + (ki * 16 + (lane & 15)) * LDN + (nt0 + k) * 8);
      mma_hl(acc[k], hi, lo, w[0], w[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: forward
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (2 * (size_t)kMaxRows * (N + 8) + (size_t)kMaxRows * (P + 8)) +
         sizeof(float) * ((size_t)P * (N + 4) + 4 * (size_t)kMaxRows);
}

// Three blocks an SM (~75 KB of shared memory each at P = N = 64, at
// most 85 registers a thread): faster on an H100 than two or one
// (`tools/ssd_tiles.py`).
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_fwd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, bf16* __restrict__ y, float* __restrict__ states,
            Dims d) {
  constexpr int LDN = N + 8, LDP = P + 8, LDS = N + 4;
  using SL = Slab<P, N>;
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* sC = reinterpret_cast<bf16*>(ssd_smem);
  bf16* sB = sC + kMaxRows * LDN;
  bf16* sX = sB + kMaxRows * LDN;
  float* sS = reinterpret_cast<float*>(sX + kMaxRows * LDP);   // the state (P, LDS)
  float* sDT = sS + P * LDS;
  float* sAC = sDT + kMaxRows;
  float* sE = sAC + kMaxRows;
  float* sW = sE + kMaxRows;    // exp(a_tot - a_cum_j), then times dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = h / (d.H / d.G);
  const int R = (d.Q + 15) & ~15, NB = R / 16;
  const int64_t xs = (int64_t)d.H * P, bs = (int64_t)d.G * N, PN = (int64_t)P * N;
  const int t0 = warp * SL::TPW, pb = t0 / (N / 8), nt0 = t0 % (N / 8);
  const bool slab = t0 < SL::T;
  float* const st0 = states + ((int64_t)b * d.H + h) * (d.nc + 1) * PN;

  for (int idx = threadIdx.x; idx < P * LDS; idx += kTcThreads) sS[idx] = 0.f;
  for (int idx = threadIdx.x; idx < P * N; idx += kTcThreads) st0[idx] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
    const int64_t row0 = (int64_t)b * d.S + s0;
    cp_rows(sC, LDN, Cm + row0 * bs + (int64_t)grp * N, bs, valid, R, N);
    cp_rows(sB, LDN, Bm + row0 * bs + (int64_t)grp * N, bs, valid, R, N);
    cp_rows(sX, LDP, x + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    cp_commit();
    if (warp == 0) {
      decay_scan(dt + row0 * d.H + h, d.H, valid, A[h], sDT, sAC, sE, sW, lane);
      __syncwarp();
      for (int r = lane; r < kMaxRows; r += 32) sW[r] *= sDT[r];
    }
    cp_wait_all();
    __syncthreads();

    // y for this warp's 16 rows: exp(a_cum_i) C_i S^T, then the causal
    // tiles' (C_i . B_j) L_ij dt_j x_j.
    if (warp < NB) {
      const int i0 = warp * 16 + g, i1 = i0 + 8;
      const float ac0 = sAC[i0], ac1 = sAC[i1];
      uint32_t cf[N / 16][4];
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) ldsm4(cf[kn], a_at<LDN>(sC, warp * 16, kn * 16, lane));
      float acc[P / 8][4];
      zero(acc);
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn)
#pragma unroll
        for (int pn = 0; pn < P / 8; ++pn) {
          uint32_t hi[2], lo[2];
          b_f32_nk<LDS>(hi, lo, sS, kn * 16, pn * 8, g, t4);
          mma_bhl(acc[pn], cf[kn], hi, lo);
        }
      const float e0 = sE[i0], e1 = sE[i1];
#pragma unroll
      for (int pn = 0; pn < P / 8; ++pn) {
        acc[pn][0] *= e0;
        acc[pn][1] *= e0;
        acc[pn][2] *= e1;
        acc[pn][3] *= e1;
      }
      for (int kb = 0; kb <= warp; ++kb) {
        float s[2][4];
        zero(s);
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t bb[4];
          ldsm4(bb, b_at<LDN>(sB, kb * 16, kn * 16, lane));
          mma_bf16(s[0], cf[kn], bb[0], bb[1]);
          mma_bf16(s[1], cf[kn], bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = kb * 16 + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] *= decay(e < 2 ? ac0 : ac1, sAC[j], i, j) * sDT[j];
          }
        uint32_t hi[4], lo[4];
        acc_to_a_hl(hi, lo, s);
#pragma unroll
        for (int pn = 0; pn < P / 16; ++pn) {
          uint32_t bx[4];
          ldsm4t(bx, a_at<LDP>(sX, kb * 16, pn * 16, lane));
          mma_hl(acc[2 * pn], hi, lo, bx[0], bx[1]);
          mma_hl(acc[2 * pn + 1], hi, lo, bx[2], bx[3]);
        }
      }
      bf16* yr = y + (row0 + i0) * xs + (int64_t)h * P + 2 * t4;
#pragma unroll
      for (int pn = 0; pn < P / 8; ++pn) {
        if (i0 < valid)
          *reinterpret_cast<__nv_bfloat162*>(yr + pn * 8) =
              __floats2bfloat162_rn(acc[pn][0], acc[pn][1]);
        if (i1 < valid)
          *reinterpret_cast<__nv_bfloat162*>(yr + 8 * xs + pn * 8) =
              __floats2bfloat162_rn(acc[pn][2], acc[pn][3]);
      }
    }
    __syncthreads();   // every warp is done with S_in

    // S <- exp(a_tot) S + sum_j w_j x_j B_j^T, w_j = exp(a_tot - a_cum_j) dt_j.
    if (slab) {
      float acc[SL::TPW][4];
      slab_product<P, N>(acc, sX, sB, sW, NB, pb, nt0, lane);
      const float E = sE[kMaxRows - 1];
      float* st = st0 + (c + 1) * PN;
#pragma unroll
      for (int k = 0; k < SL::TPW; ++k)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = pb * 16 + g + 8 * half, n = (nt0 + k) * 8 + 2 * t4;
          float2* cell = reinterpret_cast<float2*>(sS + p * LDS + n);
          const float2 old = *cell;
          const float2 v = make_float2(fmaf(E, old.x, acc[k][2 * half]),
                                       fmaf(E, old.y, acc[k][2 * half + 1]));
          *cell = v;
          *reinterpret_cast<float2*>(st + p * N + n) = v;
        }
    }
    __syncthreads();   // the tiles and the decay rows are consumed
  }
}

// ---------------------------------------------------------------------------
// bf16: backward
// ---------------------------------------------------------------------------

template <int P, int N>
constexpr size_t bwd_mma_smem() {
  return sizeof(bf16) * (2 * (size_t)kMaxRows * (N + 8) + 2 * (size_t)kMaxRows * (P + 8)) +
         sizeof(float) * (2 * (size_t)P * (N + 4) + 6 * (size_t)kMaxRows + kTcWarps);
}

// Two blocks an SM (~112 KB of shared memory each at P = N = 64).
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, const float* __restrict__ states,
            const bf16* __restrict__ dy, bf16* __restrict__ dx, float* __restrict__ ddt,
            float* __restrict__ dB_part, float* __restrict__ dC_part,
            float* __restrict__ dA_part, Dims d) {
  constexpr int LDN = N + 8, LDP = P + 8, LDS = N + 4;
  using SL = Slab<P, N>;
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* sC = reinterpret_cast<bf16*>(ssd_smem);
  bf16* sB = sC + kMaxRows * LDN;
  bf16* sX = sB + kMaxRows * LDN;
  bf16* sDY = sX + kMaxRows * LDP;
  float* sSin = reinterpret_cast<float*>(sDY + kMaxRows * LDP);   // (P, LDS)
  float* sG = sSin + P * LDS;                                     // (P, LDS)
  float* sDT = sG + P * LDS;
  float* sAC = sDT + kMaxRows;
  float* sE = sAC + kMaxRows;     // exp(a_cum_i)
  float* sF = sE + kMaxRows;      // exp(a_tot - a_cum_j)
  float* sR = sF + kMaxRows;      // dy_i . y_i
  float* sDD = sR + kMaxRows;     // x_j . du_j
  float* sRed = sDD + kMaxRows;   // one partial of <G, S_out> per warp

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = h / (d.H / d.G);
  const int R = (d.Q + 15) & ~15, NB = R / 16;
  const int64_t xs = (int64_t)d.H * P, bs = (int64_t)d.G * N, PN = (int64_t)P * N;
  const int64_t ps = (int64_t)d.H * N;               // row stride of dB_part / dC_part
  const int t0 = warp * SL::TPW, pb = t0 / (N / 8), nt0 = t0 % (N / 8);
  const bool slab = t0 < SL::T;
  const int r0 = warp * 16 + g, r1 = r0 + 8;        // this thread's rows of the chunk
  const float* const st = states + ((int64_t)b * d.H + h) * (d.nc + 1) * PN;
  const float Ah = A[h];
  float dA_acc = 0.f;                               // warp 0's: this head's dA share

  for (int idx = threadIdx.x; idx < P * LDS; idx += kTcThreads) sG[idx] = 0.f;

  for (int c = d.nc - 1; c >= 0; --c) {
    const int s0 = c * d.Q, valid = min(d.Q, d.S - s0);
    const int64_t row0 = (int64_t)b * d.S + s0;
    cp_rows(sC, LDN, Cm + row0 * bs + (int64_t)grp * N, bs, valid, R, N);
    cp_rows(sB, LDN, Bm + row0 * bs + (int64_t)grp * N, bs, valid, R, N);
    cp_rows(sX, LDP, x + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    cp_rows(sDY, LDP, dy + row0 * xs + (int64_t)h * P, xs, valid, R, P);
    cp_f32(sSin, LDS, st + c * PN, P, N);
    cp_commit();
    if (warp == 0) decay_scan(dt + row0 * d.H + h, d.H, valid, Ah, sDT, sAC, sE, sF, lane);
    cp_wait_all();
    __syncthreads();

    // Rows i: r_i = e_i C_i . (dy_i S_in) + sum_j S_ij P1_ij and
    // dC_i += e_i dy_i S_in + sum_j P1_ij B_j, P1_ij = L_ij dt_j (dy_i . x_j).
    if (warp < NB) {
      const float ac0 = sAC[r0], ac1 = sAC[r1], e0 = sE[r0], e1 = sE[r1];
      float dC[N / 8][4], rr[2];
      zero(dC);
      {
        float t[N / 8][4];
        zero(t);
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t a[4];
          ldsm4(a, a_at<LDP>(sDY, warp * 16, kp * 16, lane));
#pragma unroll
          for (int nn = 0; nn < N / 8; ++nn) {
            uint32_t hi[2], lo[2];
            b_f32_kn<LDS>(hi, lo, sSin, kp * 16, nn * 8, g, t4);
            mma_bhl(t[nn], a, hi, lo);
          }
        }
        float q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int nn = 0; nn < N / 8; ++nn) {
          const int n = nn * 8 + 2 * t4;
          const float2 c0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sC + r0 * LDN + n));
          const float2 c1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sC + r1 * LDN + n));
          q0 = fmaf(c0.x, t[nn][0], fmaf(c0.y, t[nn][1], q0));
          q1 = fmaf(c1.x, t[nn][2], fmaf(c1.y, t[nn][3], q1));
          dC[nn][0] = fmaf(e0, t[nn][0], dC[nn][0]);
          dC[nn][1] = fmaf(e0, t[nn][1], dC[nn][1]);
          dC[nn][2] = fmaf(e1, t[nn][2], dC[nn][2]);
          dC[nn][3] = fmaf(e1, t[nn][3], dC[nn][3]);
        }
        rr[0] = e0 * q0;
        rr[1] = e1 * q1;
      }
      for (int kb = 0; kb <= warp; ++kb) {
        float s[2][4], p1[2][4];
        zero(s);
        zero(p1);
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t a[4], bb[4];
          ldsm4(a, a_at<LDN>(sC, warp * 16, kn * 16, lane));
          ldsm4(bb, b_at<LDN>(sB, kb * 16, kn * 16, lane));
          mma_bf16(s[0], a, bb[0], bb[1]);
          mma_bf16(s[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t a[4], bb[4];
          ldsm4(a, a_at<LDP>(sDY, warp * 16, kp * 16, lane));
          ldsm4(bb, b_at<LDP>(sX, kb * 16, kp * 16, lane));
          mma_bf16(p1[0], a, bb[0], bb[1]);
          mma_bf16(p1[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1, j = kb * 16 + nt * 8 + 2 * t4 + (e & 1);
            p1[nt][e] *= decay(e < 2 ? ac0 : ac1, sAC[j], i, j) * sDT[j];
            rr[e >> 1] = fmaf(s[nt][e], p1[nt][e], rr[e >> 1]);
          }
        uint32_t hi[4], lo[4];
        acc_to_a_hl(hi, lo, p1);
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          uint32_t bb[4];
          ldsm4t(bb, a_at<LDN>(sB, kb * 16, nn * 16, lane));
          mma_hl(dC[2 * nn], hi, lo, bb[0], bb[1]);
          mma_hl(dC[2 * nn + 1], hi, lo, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rr[k] += __shfl_xor_sync(0xffffffffu, rr[k], 1);
        rr[k] += __shfl_xor_sync(0xffffffffu, rr[k], 2);
      }
      if (t4 == 0) {
        sR[r0] = rr[0];
        sR[r1] = rr[1];
      }
      float* out = dC_part + (row0 + r0) * ps + (int64_t)h * N + 2 * t4;
#pragma unroll
      for (int nn = 0; nn < N / 8; ++nn) {
        if (r0 < valid)
          *reinterpret_cast<float2*>(out + nn * 8) = make_float2(dC[nn][0], dC[nn][1]);
        if (r1 < valid)
          *reinterpret_cast<float2*>(out + 8 * ps + nn * 8) =
              make_float2(dC[nn][2], dC[nn][3]);
      }
    } else if (t4 == 0) {
      sR[r0] = sR[r1] = 0.f;
    }

    // Rows j, in two passes over the causal tiles of this warp's column,
    // so that du and dB are never live together: du_j = f_j
    // G B_j + sum_{i>=j} P2_ij dy_i, dx_j = dt_j du_j and x_j . du_j;
    // then dB_j += sum_{i>=j} P1_ij C_i + f_j dt_j G^T x_j.
    if (warp < NB) {
      const float ac0 = sAC[r0], ac1 = sAC[r1];
      const float f0 = sF[r0], f1 = sF[r1], dt0 = sDT[r0], dt1 = sDT[r1];
      float du[P / 8][4];
      zero(du);
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t a[4];
        ldsm4(a, a_at<LDN>(sB, warp * 16, kn * 16, lane));
#pragma unroll
        for (int pn = 0; pn < P / 8; ++pn) {
          uint32_t hi[2], lo[2];
          b_f32_nk<LDS>(hi, lo, sG, kn * 16, pn * 8, g, t4);
          mma_bhl(du[pn], a, hi, lo);
        }
      }
#pragma unroll
      for (int pn = 0; pn < P / 8; ++pn) {
        du[pn][0] *= f0;
        du[pn][1] *= f0;
        du[pn][2] *= f1;
        du[pn][3] *= f1;
      }
      for (int kb = warp; kb < NB; ++kb) {
        // P2^T tile: rows j (this warp), columns i (kb).
        float s[2][4];
        zero(s);
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t a[4], bb[4];
          ldsm4(a, a_at<LDN>(sB, warp * 16, kn * 16, lane));
          ldsm4(bb, b_at<LDN>(sC, kb * 16, kn * 16, lane));
          mma_bf16(s[0], a, bb[0], bb[1]);
          mma_bf16(s[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? r0 : r1, i = kb * 16 + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] *= decay(sAC[i], e < 2 ? ac0 : ac1, i, j);
          }
        uint32_t hi[4], lo[4];
        acc_to_a_hl(hi, lo, s);
#pragma unroll
        for (int pn = 0; pn < P / 16; ++pn) {
          uint32_t bb[4];
          ldsm4t(bb, a_at<LDP>(sDY, kb * 16, pn * 16, lane));
          mma_hl(du[2 * pn], hi, lo, bb[0], bb[1]);
          mma_hl(du[2 * pn + 1], hi, lo, bb[2], bb[3]);
        }
      }
      float dd0 = 0.f, dd1 = 0.f;
      bf16* dxr = dx + (row0 + r0) * xs + (int64_t)h * P + 2 * t4;
#pragma unroll
      for (int pn = 0; pn < P / 8; ++pn) {
        const int p = pn * 8 + 2 * t4;
        const float2 x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sX + r0 * LDP + p));
        const float2 x1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sX + r1 * LDP + p));
        dd0 = fmaf(x0.x, du[pn][0], fmaf(x0.y, du[pn][1], dd0));
        dd1 = fmaf(x1.x, du[pn][2], fmaf(x1.y, du[pn][3], dd1));
        if (r0 < valid)
          *reinterpret_cast<__nv_bfloat162*>(dxr + pn * 8) =
              __floats2bfloat162_rn(dt0 * du[pn][0], dt0 * du[pn][1]);
        if (r1 < valid)
          *reinterpret_cast<__nv_bfloat162*>(dxr + 8 * xs + pn * 8) =
              __floats2bfloat162_rn(dt1 * du[pn][2], dt1 * du[pn][3]);
      }
      dd0 += __shfl_xor_sync(0xffffffffu, dd0, 1);
      dd0 += __shfl_xor_sync(0xffffffffu, dd0, 2);
      dd1 += __shfl_xor_sync(0xffffffffu, dd1, 1);
      dd1 += __shfl_xor_sync(0xffffffffu, dd1, 2);
      if (t4 == 0) {
        sDD[r0] = dd0;
        sDD[r1] = dd1;
      }

      float dB[N / 8][4];
      zero(dB);
      for (int kb = warp; kb < NB; ++kb) {
        // P1^T tile: rows j (this warp), columns i (kb).
        float q[2][4];
        zero(q);
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t a[4], bb[4];
          ldsm4(a, a_at<LDP>(sX, warp * 16, kp * 16, lane));
          ldsm4(bb, b_at<LDP>(sDY, kb * 16, kp * 16, lane));
          mma_bf16(q[0], a, bb[0], bb[1]);
          mma_bf16(q[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? r0 : r1, i = kb * 16 + nt * 8 + 2 * t4 + (e & 1);
            q[nt][e] *= decay(sAC[i], e < 2 ? ac0 : ac1, i, j) * (e < 2 ? dt0 : dt1);
          }
        uint32_t hi[4], lo[4];
        acc_to_a_hl(hi, lo, q);
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          uint32_t bb[4];
          ldsm4t(bb, a_at<LDN>(sC, kb * 16, nn * 16, lane));
          mma_hl(dB[2 * nn], hi, lo, bb[0], bb[1]);
          mma_hl(dB[2 * nn + 1], hi, lo, bb[2], bb[3]);
        }
      }
      {
        float t[N / 8][4];
        zero(t);
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t a[4];
          ldsm4(a, a_at<LDP>(sX, warp * 16, kp * 16, lane));
#pragma unroll
          for (int nn = 0; nn < N / 8; ++nn) {
            uint32_t hi[2], lo[2];
            b_f32_kn<LDS>(hi, lo, sG, kp * 16, nn * 8, g, t4);
            mma_bhl(t[nn], a, hi, lo);
          }
        }
        const float w0 = f0 * dt0, w1 = f1 * dt1;
#pragma unroll
        for (int nn = 0; nn < N / 8; ++nn) {
          dB[nn][0] = fmaf(w0, t[nn][0], dB[nn][0]);
          dB[nn][1] = fmaf(w0, t[nn][1], dB[nn][1]);
          dB[nn][2] = fmaf(w1, t[nn][2], dB[nn][2]);
          dB[nn][3] = fmaf(w1, t[nn][3], dB[nn][3]);
        }
      }
      float* out = dB_part + (row0 + r0) * ps + (int64_t)h * N + 2 * t4;
#pragma unroll
      for (int nn = 0; nn < N / 8; ++nn) {
        if (r0 < valid)
          *reinterpret_cast<float2*>(out + nn * 8) = make_float2(dB[nn][0], dB[nn][1]);
        if (r1 < valid)
          *reinterpret_cast<float2*>(out + 8 * ps + nn * 8) =
              make_float2(dB[nn][2], dB[nn][3]);
      }
    } else if (t4 == 0) {
      sDD[r0] = sDD[r1] = 0.f;
    }
    __syncthreads();   // sR, sDD written; every warp is done reading G

    // <G, S_out> and G <- exp(a_tot) G + sum_i e_i dy_i C_i^T on the slab.
    {
      float part = 0.f;
      if (slab) {
        float acc[SL::TPW][4];
        slab_product<P, N>(acc, sDY, sC, sE, NB, pb, nt0, lane);
        const float E = sE[kMaxRows - 1];
        const float* so = st + (c + 1) * PN;
#pragma unroll
        for (int k = 0; k < SL::TPW; ++k)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = pb * 16 + g + 8 * half, n = (nt0 + k) * 8 + 2 * t4;
            float2* cell = reinterpret_cast<float2*>(sG + p * LDS + n);
            const float2 old = *cell;
            const float2 out = *reinterpret_cast<const float2*>(so + p * N + n);
            part = fmaf(old.x, out.x, fmaf(old.y, out.y, part));
            *cell = make_float2(fmaf(E, old.x, acc[k][2 * half]),
                                fmaf(E, old.y, acc[k][2 * half + 1]));
          }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sRed[warp] = part;
    }
    __syncthreads();

    // Warp 0: d a_cum_i = r_i - dt_i (x_i . du_i) (+ <G, S_out> at the
    // last row), its reverse cumsum da (4 rows a lane, then a shuffle
    // scan), ddt = x . du + A da and this chunk's share of dA, sum da dt.
    if (warp == 0) {
      float datot = 0.f;
      for (int w = 0; w < kTcWarps; ++w) datot += sRed[w];
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const int r = 4 * lane + k;
        run += sR[r] - sDT[r] * sDD[r] + (r == kMaxRows - 1 ? datot : 0.f);
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
      float da_dt = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * lane + k;
        const float da = excl + v[k];
        if (r < valid) ddt[(row0 + r) * d.H + h] = sDD[r] + Ah * da;
        da_dt = fmaf(da, sDT[r], da_dt);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da_dt += __shfl_xor_sync(0xffffffffu, da_dt, o);
      dA_acc += da_dt;
    }
    __syncthreads();   // the tiles, decay rows and tails are consumed
  }
  if (threadIdx.x == 0) dA_part[(int64_t)b * d.H + h] = dA_acc;
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

// The second launch of both backward paths.
template <typename T>
int launch_reduce(const void* dB_part, const void* dC_part, const void* dA_part, void* dB,
                  void* dC, void* dA, const Dims& d, cudaStream_t stream) {
  const int64_t total = 2 * (int64_t)d.B * d.S * d.G * d.N + d.H;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  ssd_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), d);
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
  return launch_reduce<T>(dB_part, dC_part, dA_part, dB, dC, dA, d, stream);
}

// The tensor-core instances: P and N in {16, 32, 64}. `f` is called with
// Tc<P, N>{}; -1 for any other shape.
template <int P_, int N_>
struct Tc {
  static constexpr int P = P_, N = N_;
};

template <typename F>
int tc_dispatch(const Dims& d, F f) {
  switch (d.P * 1000 + d.N) {
    case 16016: return f(Tc<16, 16>{});
    case 16032: return f(Tc<16, 32>{});
    case 16064: return f(Tc<16, 64>{});
    case 32016: return f(Tc<32, 16>{});
    case 32032: return f(Tc<32, 32>{});
    case 32064: return f(Tc<32, 64>{});
    case 64016: return f(Tc<64, 16>{});
    case 64032: return f(Tc<64, 32>{});
    case 64064: return f(Tc<64, 64>{});
    default: return -1;
  }
}

template <typename K>
int launch_fwd_mma(K, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* states, const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = fwd_mma_smem<K::P, K::N>();
  auto kern = ssd_fwd_mma<K::P, K::N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(d.H, d.B), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y), static_cast<float*>(states), d);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_bwd_mma(K, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* states, const void* dy, void* dx, void* ddt,
                   void* dB_part, void* dC_part, void* dA_part, void* dB, void* dC, void* dA,
                   const Dims& d, cudaStream_t stream) {
  constexpr size_t smem = bwd_mma_smem<K::P, K::N>();
  auto kern = ssd_bwd_mma<K::P, K::N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(d.H, d.B), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(states),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce<bf16>(dB_part, dC_part, dA_part, dB, dC, dA, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y, dy, dx, dB, dC); dt, A,
// ddt, dA and the states are f32; for bfloat16 a tensor-core instance must
// exist (`tc_dispatch`). dB_part / dC_part are (B, S, H, N) f32, dA_part
// (B, H). Each returns cudaGetLastError()
// after its launches (0 = launched), or -1 for arguments the kernels do
// not take.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, void* states,
                                  int B, int S, int H, int P, int G, int N, int Q, int dtype,
                                  void* stream) {
  Dims d;
  if (!make_dims(d, B, S, H, P, G, N, Q)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, dt, A, Bm, Cm, y, states, d, s);
  if (dtype == 1)
    return tc_dispatch(d, [&](auto k) {
      return launch_fwd_mma(k, x, dt, A, Bm, Cm, y, states, d, s);
    });
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
    return tc_dispatch(d, [&](auto k) {
      return launch_bwd_mma(k, x, dt, A, Bm, Cm, states, dy, dx, ddt, dB_part, dC_part,
                            dA_part, dB, dC, dA, d, s);
    });
  return -1;
}
