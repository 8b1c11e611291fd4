// Flash attention's f32 kernels for Hopper (sm_90a): K1's forward and its
// backward, on the tensor cores. Shapes, masking, the LSE and the
// backward's two launches are as flash_attention.cu states. This source
// holds the forward and dQ kernels and the f32 entry (`launch_tf32`);
// the dK/dV kernel is in flash_attention_tf32_dkdv.cu, and their building
// blocks in flash_attention_tf32.cuh, so that nvcc builds the three
// sources side by side.
//
// f32: tensor cores in 3xTF32 (`fa_fwd_tf32`, `fa_bwd_dq_tf32`,
// `fa_bwd_dkdv_tf32`), the training entry points' dtype
// (`examples/train_lm_torch.py`, `elastic_failover_torch.py`) and the
// step-parity cuts'.
//   * Every product is three `mma.sync.m16n8k8` tf32 x tf32 -> f32: each
//     f32 operand x is split into big = x rounded to TF32 as
//     `cvt.rna.tf32.f32` rounds it and small = (x - big) rounded the same
//     way, and small.big + big.small are accumulated before big.big. Each
//     product then carries about 2^-21 of its size, not one TF32's 2^-11,
//     so the f32 rule of `parity.within` holds unchanged. P and dS are
//     split as well: nothing is rounded to TF32 alone.
//   * Why: f32 FMAs peak at 67 TFLOP/s on the H100, TF32 at 494.7 dense,
//     so three products give ~165. At smollm-135m's step (q (32, 128, 9,
//     64), causal) that leaves both launches bound by bytes: 0.0076 ms
//     forward, 0.0151 ms backward at 3.35 TB/s.
//   * Tiles stay f32 in shared memory, loaded with 16-byte `cp.async` into
//     the same two-stage ring as bf16. `ldmatrix` has no 32-bit transposed
//     form, so fragments are 32-bit shared loads; rows are padded by 12
//     words (`kF32Pad`), which puts the 32 addresses of every fragment
//     load on 32 banks. Most operands are split as a warp reads them; q
//     and dO, B operands of all four products of the dK/dV launch, are
//     split once a q tile for the block (`split_tile`).
//   * Each warp owns 16 rows; S lives in the accumulators; row max and row
//     sum are quad shuffles. P, dS and their transposes feed their second
//     product straight from the accumulators: the m16n8k8 A fragment holds
//     columns (t, t + 4) where the accumulator holds (2t, 2t + 1), so
//     within each 8-key slice k-slot t stands for key 2t and slot t + 4
//     for key 2t + 1, and the B operand (V, K, dO, q) is read at the same
//     keys. P never touches shared memory.
//   * The three passes of a product walk 4 n-tiles each before the next
//     pass (`mma3`), so the dependent products into one accumulator stand
//     apart.
//   * q is scaled by 1/sqrt(D) in f32 as it is read, before it is split,
//     as the Pallas kernel (kernel.py:47) and the plain version do;
//     exponentials are expf of natural-unit scores, as the plain
//     version's. dS = P o (dP - Delta) is formed in f32 and then split.
//   * Causal tiles above the diagonal are skipped; the diagonal and ragged
//     edges are masked in the kernel. 4 warps (64 rows) a block; KV tiles
//     (forward, dQ) and q tiles (dK/dV) of 32 rows (`kF32Tile`). The
//     grids put the tile index slowest and issue a causal launch's longest
//     blocks first (`q_tile`).
//
#include "flash_attention_tf32.cuh"

namespace repro_fa {
namespace {

// ---------------------------------------------------------------------------
// f32: forward
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t fwd_tf32_smem() {
  constexpr int BQ = 16 * kF32Warps, BKV = kF32Tile;
  return sizeof(float) * ((size_t)BQ * (D + kF32Pad) + 2 * (size_t)BKV * (D + kF32Pad) +
                          2 * (size_t)BKV * (DV + kF32Pad));
}

template <int D, int DV>
__global__ void __launch_bounds__(kF32Warps * 32, 1)
fa_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int Sq,
            int Skv, int H, int Hkv, float scale, int causal) {
  constexpr int NT = kF32Warps * 32, BQ = 16 * kF32Warps, BKV = kF32Tile;
  constexpr int LDQ = D + kF32Pad, LDK = D + kF32Pad, LDV = DV + kF32Pad;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sK = sQ + BQ * LDQ;          // two stages
  float* sV = sK + 2 * BKV * LDK;     // two stages

  const int q0 = q_tile(causal) * BQ, h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const float* kb = k + (int64_t)b * Skv * ks + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Skv * vs + (int64_t)hk * DV;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  cp_tile<BQ, D, NT>(sQ, q + ((int64_t)b * Sq + q0) * qs + (int64_t)h * D, qs, Sq - q0);
  cp_tile<BKV, D, NT>(sK, kb, ks, Skv);
  cp_tile<BKV, DV, NT>(sV, vb, vs, Skv);
  cp_commit();

  const int row0 = q0 + warp * 16 + g;     // this thread's rows: row0 and row0 + 8
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
    // S = (q / sqrt(D)) K^T: q is scaled in f32 before it is split.
    float s[BKV / 8][4];
    zero(s);
    mma3_abt<D, BKV, LDQ, LDK>(s, RawTile{sQ, scale}, warp * 16,
                               RawTile{sK + st * BKV * LDK, 1.f}, 0, g, t4);

    // Masked to -inf on the diagonal and ragged tiles.
    const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1), row = row0 + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) s[j][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      corr[r] = expf(m[r] - m_use);
      m[r] = m_new;
      mx[r] = m_use;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
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
    mma3_acc_b<BKV, DV, LDV>(acc, s, RawTile{sV + st * BKV * LDV, 1.f}, g, t4);   // O += P V
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
      if (t4 == 0) lse[((int64_t)b * H + h) * Sq + row] = m[r] + logf(ll);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: backward 1, Delta and dQ
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t dq_tf32_smem() {
  constexpr int BQ = 16 * kF32Warps, BKV = kF32Tile;
  return sizeof(float) * ((size_t)BQ * (D + kF32Pad) + (size_t)BQ * (DV + kF32Pad) +
                          2 * (size_t)BKV * (D + kF32Pad) + 2 * (size_t)BKV * (DV + kF32Pad) +
                          2 * BQ);
}

template <int D, int DV>
__global__ void __launch_bounds__(kF32Warps * 32, 1)
fa_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
               float scale, int causal) {
  constexpr int NT = kF32Warps * 32, BQ = 16 * kF32Warps, BKV = kF32Tile;
  constexpr int LDQ = D + kF32Pad, LDO = DV + kF32Pad, LDK = D + kF32Pad, LDV = DV + kF32Pad;
  static_assert(NT == 2 * BQ, "Delta takes two threads a row");
  static_assert(DV % 8 == 0, "Delta reads half a row in 16-byte pieces");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sdO = sQ + BQ * LDQ;
  float* sK = sdO + BQ * LDO;        // two stages
  float* sV = sK + 2 * BKV * LDK;    // two stages
  float* sL = sV + 2 * BKV * LDV;    // LSE
  float* sD = sL + BQ;               // Delta

  const int q0 = q_tile(causal) * BQ, h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;
  const float* kb = k + (int64_t)b * Skv * ks + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Skv * vs + (int64_t)hk * DV;
  const float* dob = dout + ((int64_t)b * Sq + q0) * os + (int64_t)h * DV;
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
      const float* orow = o + ((int64_t)b * Sq + q0 + r) * os + (int64_t)h * DV + half * (DV / 2);
      const float* drow = dob + (int64_t)r * os + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(orow + c);
        const float4 d = *reinterpret_cast<const float4*>(drow + c);
        part = fmaf(a.x, d.x, part);
        part = fmaf(a.y, d.y, part);
        part = fmaf(a.z, d.z, part);
        part = fmaf(a.w, d.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const int64_t li = ((int64_t)b * H + h) * Sq + q0 + r;
      if (ok) delta[li] = part;
      sL[r] = ok ? lse[li] : 0.f;
      sD[r] = part;
    }
  }

  const int rl = warp * 16 + g;            // this thread's rows in the tile: rl, rl + 8
  float acc[D / 8][4];
  zero(acc);
  float ll[2], dl[2];

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
        ll[r] = sL[rl + 8 * r];
        dl[r] = sD[rl + 8 * r];
      }
    }
    // K and V split as each warp reads them: splitting them once for the
    // block measured no faster here (tools/flash_tiles.py --f32), unlike
    // q and dO in the dK/dV launch.
    const RawTile tK{sK + st * BKV * LDK, 1.f}, tV{sV + st * BKV * LDV, 1.f};
    float s[BKV / 8][4], dp[BKV / 8][4];
    zero(s);
    zero(dp);
    mma3_abt<D, BKV, LDQ, LDK>(s, RawTile{sQ, scale}, warp * 16, tK, 0, g, t4);    // Q K^T
    mma3_abt<DV, BKV, LDO, LDV>(dp, RawTile{sdO, 1.f}, warp * 16, tV, 0, g, t4);   // dO V^T
    const bool edge = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - ll[e >> 1]);
        if (edge) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1), row = q0 + rl + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);   // dS, formed in f32
      }
    mma3_acc_b<BKV, D, LDK>(acc, s, tK, g, t4);   // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    if (row < Sq)
      store_row(dq + ((int64_t)b * Sq + row) * qs + (int64_t)h * D, acc, r, t4, scale);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct Tf32Fwd {
  template <int D, int DV>
  static int run(const Args& a) {
    constexpr int BQ = 16 * kF32Warps;
    return launch(fa_fwd_tf32<D, DV>, dim3(a.H, a.B, (a.Sq + BQ - 1) / BQ), kF32Warps * 32,
                  fwd_tf32_smem<D, DV>(), a.stream, static_cast<const float*>(a.q),
                  static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                  static_cast<float*>(a.out), static_cast<float*>(a.lse_out), a.Sq, a.Skv, a.H,
                  a.Hkv, a.scale, a.causal);
  }
};

struct Tf32Bwd {
  template <int D, int DV>
  static int run(const Args& a) {
    const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
                *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
    const float* lse = static_cast<const float*>(a.lse);
    float* delta = static_cast<float*>(a.delta);
    constexpr int BQ = 16 * kF32Warps;
    const int e = launch(fa_bwd_dq_tf32<D, DV>, dim3(a.H, a.B, (a.Sq + BQ - 1) / BQ),
                         kF32Warps * 32, dq_tf32_smem<D, DV>(), a.stream, q, k, v,
                         static_cast<const float*>(a.o), dout, lse, delta,
                         static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.Hkv, a.scale, a.causal);
    return e != 0 ? e : launch_dkdv_tf32<D, DV>(a);
  }
};

}  // namespace

int launch_tf32(const Args& a, bool bwd, int D, int Dv) {
  return bwd ? dispatch_head_dims<Tf32Bwd>(a, D, Dv) : dispatch_head_dims<Tf32Fwd>(a, D, Dv);
}

}  // namespace repro_fa
