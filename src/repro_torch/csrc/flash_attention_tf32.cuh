// Shared by the f32 (3xTF32) sources of flash attention:
// flash_attention_tf32.cu (the forward and dQ kernels, and the f32 entry)
// and flash_attention_tf32_dkdv.cu (the dK/dV kernel), which nvcc builds
// side by side.
#pragma once

#include "flash_attention.cuh"

namespace repro_fa {

// ---------------------------------------------------------------------------
// f32: 3xTF32 tensor-core building blocks
// ---------------------------------------------------------------------------

// Warps of every f32 launch, 16 rows (dK/dV: keys) each. Each launch asks
// `__launch_bounds__` for one block an SM, which leaves ptxas all 255
// registers, so that no instance spills.
constexpr int kF32Warps = 4;
// KV tile of the forward and dQ launches and q tile of the dK/dV launch.
// At smollm-135m's shape 64 measured slower in the backward and no faster
// in the forward: its f32 tiles leave fewer blocks an SM
// (tools/flash_tiles.py --f32).
constexpr int kF32Tile = 32;

// The f32 grids are (heads, batch, tiles), the tile index slowest, so a
// causal launch issues its longest blocks first: the forward's and dQ's
// last q tiles (q_tile), the dK/dV launch's first KV tiles. The short ones
// then fill the SMs the long ones leave, where issued in index order a
// short block's SM could take a second long one last.
__device__ __forceinline__ int q_tile(int causal) {
  return causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
}

// x rounded to TF32 as `cvt.rna.tf32.f32` rounds a finite x: to nearest
// at 10 mantissa bits, ties away from zero, the low 13 bits cleared. An
// integer add and mask take 2 instructions where the cvt takes 4 (it also
// screens NaN and infinity, which no operand of these products is).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An f32 operand as big + small, both TF32 (10 explicit mantissa bits):
// big = x rounded to nearest, small = (x - big) rounded to nearest, so
// big + small is x to about 2^-21 of |x|.
struct Tf32A {   // a 16 x 8 A operand
  uint32_t big[4], small[4];
};
struct Tf32B {   // an 8 x 8 B operand
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col). Not
// volatile: the compiler may interleave products into other accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 over NB n-tiles c[n0 .. n0 + NB - 1] with one A: the two cross
// terms first, then big . big (small . small, about 2^-22 of the product,
// is dropped), each pass over all NB tiles before the next, so that the
// three dependent products into one accumulator stand NB apart.
template <int NB, int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], int n0, const Tf32A& a,
                                     const Tf32B (&b)[NB]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[n0 + i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[n0 + i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(c[n0 + i], a.big, b[i].big);
}

// n-tiles a 3xTF32 pass walks before the next pass (`mma3`): kF32Group,
// or where that does not divide the N n-tiles (Dv 80: 10), 5, else N.
constexpr int kF32Group = 4;
template <int N>
__host__ __device__ constexpr int f32_group() {
  return N % kF32Group == 0 ? kF32Group : (N % 5 == 0 ? 5 : N);
}

// A row-major f32 tile of operands in shared memory, in one of two forms:
//   RawTile:   f32 values, each split as a fragment reads it, times `mul`;
//   SplitTile: split once for the whole block (`split_tile`), big in the
//              tile itself and small at the same place of a plane beside it.
struct RawTile {
  const float* s;
  float mul;
};
struct SplitTile {
  const float* big;
  const float* small;
};

__device__ __forceinline__ void take(const RawTile& t, int i, uint32_t& big, uint32_t& small) {
  split(t.s[i] * t.mul, big, small);
}
__device__ __forceinline__ void take(const SplitTile& t, int i, uint32_t& big,
                                     uint32_t& small) {
  big = __float_as_uint(t.big[i]);
  small = __float_as_uint(t.small[i]);
}

// Splits the ROWS x COLS tile t (row stride COLS + kF32Pad), each value
// times `mul`, once for the block: big in place, small into `small`.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void split_tile(float* t, float* small, float mul) {
  constexpr int LD = COLS + kF32Pad, CPR = COLS / 4, CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % NT == 0, "every thread splits as many 16-byte pieces");
#pragma unroll
  for (int c = threadIdx.x; c < CHUNKS; c += NT) {
    const int i = (c / CPR) * LD + (c % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + i);
    uint4 bg, sm;
    split(x.x * mul, bg.x, sm.x);
    split(x.y * mul, bg.y, sm.y);
    split(x.z * mul, bg.z, sm.z);
    split(x.w * mul, bg.w, sm.w);
    *reinterpret_cast<uint4*>(t + i) = bg;
    *reinterpret_cast<uint4*>(small + i) = sm;
  }
}

// Fragment loads from such a tile (row stride LD words); g = lane / 4,
// t4 = lane % 4.
//   load_a:  the A operand rows r0 .. r0 + 15 x columns c0 .. c0 + 7
//            (a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4));
//   load_bt: the B operand of a product along the tile's columns (such as
//            K in S = Q K^T): k = columns c0 .. c0 + 7, n = rows n0 .. n0 + 7;
//   load_bp: the B operand of a product along the tile's rows (such as V
//            in O = P V), k = rows k0 .. k0 + 7 in the order acc_to_a3
//            gives P's columns: k-slot t4 is row k0 + 2 t4, slot t4 + 4
//            row k0 + 2 t4 + 1.
template <int LD, typename Tile>
__device__ __forceinline__ void load_a(Tf32A& a, const Tile& t, int r0, int c0, int g, int t4) {
  const int i = (r0 + g) * LD + c0 + t4;
  take(t, i, a.big[0], a.small[0]);
  take(t, i + 8 * LD, a.big[1], a.small[1]);
  take(t, i + 4, a.big[2], a.small[2]);
  take(t, i + 8 * LD + 4, a.big[3], a.small[3]);
}
template <int LD, typename Tile>
__device__ __forceinline__ void load_bt(Tf32B& b, const Tile& t, int n0, int c0, int g, int t4) {
  const int i = (n0 + g) * LD + c0 + t4;
  take(t, i, b.big[0], b.small[0]);
  take(t, i + 4, b.big[1], b.small[1]);
}
template <int LD, typename Tile>
__device__ __forceinline__ void load_bp(Tf32B& b, const Tile& t, int k0, int n0, int g, int t4) {
  const int i = (k0 + 2 * t4) * LD + n0 + g;
  take(t, i, b.big[0], b.small[0]);
  take(t, i + LD, b.big[1], b.small[1]);
}

// The A operand (16 x 8) made of one m16n8 accumulator tile c (columns
// 2 t4, 2 t4 + 1 of rows g, g + 8): k-slot t4 takes column 2 t4 and slot
// t4 + 4 column 2 t4 + 1, so the accumulators are the A fragment as they
// stand and the B operand is read in the same order (load_bp).
__device__ __forceinline__ void acc_to_a3(Tf32A& a, const float (&c)[4]) {
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
}

// c[BN/8] (16 x BN) += A . B^T, A rows ar0 .. ar0 + 15 of tile ta and B
// (BN x K) rows br0 .. of tile tb, both row-major with K columns:
// S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T.
template <int K, int BN, int LDA, int LDB, typename TA, typename TB>
__device__ __forceinline__ void mma3_abt(float (&c)[BN / 8][4], const TA& ta, int ar0,
                                         const TB& tb, int br0, int g, int t4) {
  constexpr int NB = f32_group<BN / 8>();
  static_assert((BN / 8) % NB == 0, "the groups cover the n-tiles");
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    Tf32A a;
    load_a<LDA>(a, ta, ar0, kk * 8, g, t4);
#pragma unroll
    for (int nn = 0; nn < BN / 8; nn += NB) {
      Tf32B b[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        load_bt<LDB>(b[i], tb, br0 + (nn + i) * 8, kk * 8, g, t4);
      mma3<NB>(c, nn, a, b);
    }
  }
}

// c[N/8] (16 x N) += A . B, A (16 x BK) in the accumulators acc and B
// (BK x N) the row-major tile tb: O += P V, dQ += dS K, dV += P^T dO,
// dK += dS^T q.
template <int BK, int N, int LDB, typename TB>
__device__ __forceinline__ void mma3_acc_b(float (&c)[N / 8][4], const float (&acc)[BK / 8][4],
                                           const TB& tb, int g, int t4) {
  constexpr int NB = f32_group<N / 8>();
  static_assert((N / 8) % NB == 0, "the groups cover the n-tiles");
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    Tf32A a;
    acc_to_a3(a, acc[kk]);
#pragma unroll
    for (int nn = 0; nn < N / 8; nn += NB) {
      Tf32B b[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) load_bp<LDB>(b[i], tb, kk * 8, (nn + i) * 8, g, t4);
      mma3<NB>(c, nn, a, b);
    }
  }
}

// The f32 dK/dV launch (flash_attention_tf32_dkdv.cu), built for the (D, Dv)
// pairs of `dispatch_head_dims`.
template <int D, int DV>
int launch_dkdv_tf32(const Args& a);

}  // namespace repro_fa
