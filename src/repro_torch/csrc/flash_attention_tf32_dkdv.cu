// Flash attention's f32 dK/dV kernel (the second launch of K1's f32
// backward), a source of its own so that nvcc builds it beside the forward
// and dQ kernels (flash_attention_tf32.cu states the design).

#include "flash_attention_tf32.cuh"

namespace repro_fa {
namespace {

// ---------------------------------------------------------------------------
// f32: backward 2, dK and dV, summed over the G query heads inside the block
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t dkv_tf32_smem() {
  constexpr int BKV = 16 * kF32Warps, BQ = kF32Tile;
  return sizeof(float) * ((size_t)BKV * (D + kF32Pad) + (size_t)BKV * (DV + kF32Pad) +
                          3 * (size_t)BQ * (D + kF32Pad) + 3 * (size_t)BQ * (DV + kF32Pad) +
                          4 * BQ);
}

template <int D, int DV>
__global__ void __launch_bounds__(kF32Warps * 32, 1)
fa_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                 float scale, int causal) {
  constexpr int NT = kF32Warps * 32, BKV = 16 * kF32Warps, BQ = kF32Tile;
  constexpr int LDK = D + kF32Pad, LDV = DV + kF32Pad, LDQ = D + kF32Pad, LDO = DV + kF32Pad;
  static_assert(BQ <= NT, "one thread loads each row's LSE and Delta");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* sK = reinterpret_cast<float*>(fa_smem);
  float* sV = sK + BKV * LDK;
  float* sQ = sV + BKV * LDV;         // two stages
  float* sdO = sQ + 2 * BQ * LDQ;     // two stages
  float* sL = sdO + 2 * BQ * LDO;     // LSE, two stages
  float* sD = sL + 2 * BQ;            // Delta, two stages
  float* sQs = sD + 2 * BQ;           // the small parts of this stage's q and dO
  float* sdOs = sQs + BQ * LDQ;

  const int k0 = blockIdx.z * BKV, hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)H * D, os = (int64_t)H * DV;
  const int64_t ks = (int64_t)Hkv * D, vs = (int64_t)Hkv * DV;

  cp_tile<BKV, D, NT>(sK, k + ((int64_t)b * Skv + k0) * ks + (int64_t)hk * D, ks, Skv - k0);
  cp_tile<BKV, DV, NT>(sV, v + ((int64_t)b * Skv + k0) * vs + (int64_t)hk * DV, vs, Skv - k0);

  // Causal: only query rows >= k0 see this tile; start at their q tile.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_q = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  const int total = G * n_q;   // (head, q tile) pairs, head-major: a fixed order

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
    float* cQ = sQ + st * BQ * LDQ;
    float* cO = sdO + st * BQ * LDO;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;
    // q / sqrt(D) and dO are B operands of all four products in every warp:
    // split them once for the block.
    split_tile<BQ, D, NT>(cQ, sQs, scale);
    split_tile<BQ, DV, NT>(cO, sdOs, 1.f);
    __syncthreads();
    const SplitTile tQ{cQ, sQs}, tO{cO, sdOs};
    // Transposed tiles: rows are this warp's 16 keys, columns the BQ queries.
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    mma3_abt<D, BQ, LDK, LDQ>(s, RawTile{sK, 1.f}, warp * 16, tQ, 0, g, t4);    // S^T = K q^T
    mma3_abt<DV, BQ, LDV, LDO>(dp, RawTile{sV, 1.f}, warp * 16, tO, 0, g, t4);  // dP^T = V dO^T
    const bool edge = q0 + BQ > Sq || k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t4);
      const float2 dq2 = *reinterpret_cast<const float2*>(cD + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - ((e & 1) ? lq.y : lq.x));
        if (edge) {
          const int key = k0 + kl + (e >> 1) * 8, qi = q0 + 8 * j + 2 * t4 + (e & 1);
          if (key >= Skv || qi >= Sq || (causal && key > qi)) p = 0.f;
        }
        s[j][e] = p;                                               // P^T
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? dq2.y : dq2.x));     // dS^T, formed in f32
      }
    }
    mma3_acc_b<BQ, DV, LDO>(av, s, tO, g, t4);   // dV += P^T dO
    mma3_acc_b<BQ, D, LDQ>(ak, dp, tQ, g, t4);   // dK += dS^T (q / sqrt(D))
  }
  cp_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl + 8 * r;
    if (key < Skv) {
      store_row(dk + ((int64_t)b * Skv + key) * ks + (int64_t)hk * D, ak, r, t4, 1.f);
      store_row(dv + ((int64_t)b * Skv + key) * vs + (int64_t)hk * DV, av, r, t4, 1.f);
    }
  }
}

}  // namespace

template <int D, int DV>
int launch_dkdv_tf32(const Args& a) {
  constexpr int BKV = 16 * kF32Warps;
  return launch(fa_bwd_dkdv_tf32<D, DV>, dim3(a.Hkv, a.B, (a.Skv + BKV - 1) / BKV),
                kF32Warps * 32, dkv_tf32_smem<D, DV>(), a.stream,
                static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
                static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H, a.Hkv,
                a.scale, a.causal);
}

template int launch_dkdv_tf32<32, 32>(const Args&);
template int launch_dkdv_tf32<32, 64>(const Args&);
template int launch_dkdv_tf32<32, 128>(const Args&);
template int launch_dkdv_tf32<64, 32>(const Args&);
template int launch_dkdv_tf32<64, 64>(const Args&);
template int launch_dkdv_tf32<64, 128>(const Args&);
template int launch_dkdv_tf32<128, 32>(const Args&);
template int launch_dkdv_tf32<128, 64>(const Args&);
template int launch_dkdv_tf32<128, 128>(const Args&);
template int launch_dkdv_tf32<80, 80>(const Args&);

}  // namespace repro_fa
