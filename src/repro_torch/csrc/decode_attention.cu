// Flash-decode for Hopper (sm_90a): one query per sequence against its
// KV cache, contiguous (K3) or paged through block tables (K4).
//
// Replaces the Pallas TPU kernels `decode_attention_fwd` and
// `paged_decode_attention_fwd` in
// src/repro/kernels/decode_attention/kernel.py (and the jnp
// `attention.decode_attention` / `paged_kv_view` path the reference model
// decodes with).
//
// Bound: bytes. A decode step reads every live K and V row once and does
// about four operations per byte read, far below the card's ridge, so the
// design spends its effort on keeping bytes in flight on every SM:
//   * split-KV (flash-decoding): the grid is (n_splits, Hkv, B). The TPU
//     walks a sequence's rows on a sequential grid axis; here each of
//     n_splits blocks of a (sequence b, kv head h) takes an even share of
//     [0, lengths[b]) in whole granules of kGranule rows, so short rows
//     do not leave most splits idle. n_splits comes from the host
//     (`split_plan` in kernels/decode_attention.py), fixed by the shapes
//     alone: lengths stay on the card;
//   * each block loads the G = H / Hkv grouped queries once into
//     registers and reads each K/V row of its share ONCE for all G of
//     them (the GQA saving the TPU kernel also makes);
//   * 16-byte loads: LPR lanes hold one K/V row (8 bf16 or 4 f32 values
//     each), so a warp reads 32 / LPR rows per load; the G dot products
//     are summed across the LPR lanes by shuffles;
//   * each warp keeps kStages - 1 loads in flight through its own
//     `cp.async` ring in shared memory, in the cache's own dtype; a lane
//     reads back only the 16-byte slots it filled itself, so the ring
//     needs no barrier;
//   * online softmax (running max m, sum l, accumulator acc) in f32
//     registers, per group of LPR lanes; the groups, then the warps,
//     then the splits are combined in a fixed order, so two launches
//     give the same bits and no atomics are needed. The queries carry a
//     factor log2(e), so exp2f (one MUFU instruction) stands for exp;
//   * the paged variant reads one block-table entry for each arena block
//     a warp's load touches (one lane each, shared by shuffle), a stage
//     before the load that needs it, and only for rows < lengths[b]: dead
//     table slots are never touched (the TPU kernel instead clamps them
//     to the last live block);
//   * with more than one split, each split writes (m, l) and its
//     unnormalized f32 accumulator to a workspace the wrapper allocates,
//     and a second launch from the same entry point (decode_merge_kernel)
//     combines them in split order. With one split the split kernel
//     writes the output itself. A row whose splits are all empty (K4 at
//     length 0) merges to exact zeros: the running max starts at the
//     finite kNegInf, never at -inf, so no exp(-inf - -inf) = NaN arises;
//   * the partial form (repro_decode_attention_fwd with an lse: a rank's
//     block of a cache cut along its rows) is the same launches with an
//     f32 output O, normalised but not rounded to q's dtype, and each
//     (sequence, head)'s log-sum-exp of its scores in natural units,
//     (m + log2 l) ln 2, or -inf where no row is live (l = 0; its output
//     is exact zeros), so that a merge of partials across ranks gives it
//     weight 0.
// K3 and K4 are one template with two row-address functors, so on the
// same rows (and the same n_splits) they produce bit-identical results.
// No tensor cores: G <= 8 query rows per kv head do not fill an mma tile.
//
// The query scale is applied in q's dtype before the f32 cast, as
// `attention.decode_attention` does in jnp: the scale is rounded to q's
// dtype, and so is the product (both exact for head_dim 64, where
// scale = 1/8; at head_dim 128 neither is).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;        // cp.async ring depth of each warp
constexpr int kPieces = 2;        // rows per lane x 16-byte pieces per row, a stage
constexpr int kGranule = 16;      // split boundaries fall on multiples of this
constexpr int kMaxG = 8;          // grouped queries per kv head
constexpr int kMaxD = 256;        // head_dim
constexpr int kMaxSplits = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// Each warp's ring: kStages x kPieces x (K, V) x 32 lanes of 16 bytes
// (8 KB); after the walk it holds the warp's accumulators (kMaxG * kMaxD
// f32 = 8 KB) for the cross-warp merge.
constexpr int kRingSlots = kStages * kPieces * 2 * 32;
static_assert(kRingSlots * 16 >= kMaxG * kMaxD * 4, "ring too small for the merge");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of values as f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float to_dtype(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the high half of an f32: element 2i is the low half-word.
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float to_dtype(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Eight (bf16) or four (f32) output values of one lane: in q's dtype as
// one 16-byte store; in f32 (the partial form's output) as float4s.
template <typename O, int N>
__device__ __forceinline__ void store_vals(O* dst, const float (&o)[N]) {
  *reinterpret_cast<uint4*>(dst) = Vec<O>::pack(o);
}
template <int N>
__device__ __forceinline__ void store_vals(float* dst, const float (&o)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
}

// A row's log-sum-exp in natural units from its (m, l) in log2 units;
// -inf where no row was live.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
}

// Row addresses of (sequence b, kv head h) in a contiguous cache
// (B, S, Hkv, D): ``offsets`` gives the element offsets of the U rows
// base + u * RPW + grp (u < U); ``fetch`` (what offsets needs from memory
// first) and ``prefetch`` are nothing.
struct ContiguousRows {
  int64_t seq_stride;   // S * Hkv * D
  int64_t row_stride;   // Hkv * D
  __device__ __forceinline__ void prefetch(int, int, int) const {}
  template <int ROWS>
  __device__ __forceinline__ int fetch(int, int, int) const { return 0; }
  template <int U, int RPW>
  __device__ __forceinline__ void offsets(int, int b, int h, int base, int grp, int D,
                                          int64_t (&off)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u)
      off[u] = b * seq_stride + (int64_t)(base + u * RPW + grp) * row_stride + (int64_t)h * D;
  }
};

// The same in a block arena (num_blocks + 1, block_size, Hkv, D) read
// through block_tables (B, T). Warp-collective: ``fetch`` gives lane j the
// table entry of the j-th arena block that rows [base, min(base + ROWS,
// end)) touch (one load per block, only of live table slots), a stage
// ahead of its use; ``offsets`` hands each lane its rows' entries by
// shuffle. ``prefetch`` asks L2 for the table lines of a split's rows
// before the walk starts, so those fetches do not wait on device memory.
struct PagedRows {
  const int* tables;
  int table_width;      // T
  int block_size;
  int block_shift;      // log2(block_size) for a power of two, else -1
  int64_t block_stride; // block_size * Hkv * D
  int64_t row_stride;   // Hkv * D
  // Row r's arena block index in the table, and its row within the block
  // (a shift and a mask for a power-of-two block size).
  __device__ __forceinline__ int block_of(int r) const {
    return block_shift >= 0 ? r >> block_shift : r / block_size;
  }
  __device__ __forceinline__ int row_in_block(int r) const {
    return block_shift >= 0 ? r & (block_size - 1) : r % block_size;
  }
  __device__ __forceinline__ void prefetch(int b, int begin, int end) const {
    if (end <= begin) return;
    const int* row = tables + (int64_t)b * table_width;
    const uintptr_t stop = reinterpret_cast<uintptr_t>(row + block_of(end - 1) + 1);
    for (uintptr_t a = (reinterpret_cast<uintptr_t>(row + block_of(begin)) & ~uintptr_t(127)) +
                       threadIdx.x * 128;
         a < stop; a += kThreads * 128)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
  }
  template <int ROWS>
  __device__ __forceinline__ int fetch(int b, int base, int end) const {
    const int lane = threadIdx.x & 31;
    const int first = block_of(base);
    const int last = block_of(min(base + ROWS, end) - 1);
    return first + lane <= last ? tables[(int64_t)b * table_width + first + lane] : 0;
  }
  template <int U, int RPW>
  __device__ __forceinline__ void offsets(int entry, int b, int h, int base, int grp, int D,
                                          int64_t (&off)[U]) const {
    const int first = block_of(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * RPW + grp;
      const int bid = __shfl_sync(0xffffffffu, entry, min(block_of(r) - first, 31));
      off[u] = (int64_t)bid * block_stride + (int64_t)row_in_block(r) * row_stride +
               (int64_t)h * D;
    }
  }
};

// (m, l, acc) <- the softmax state of rows A then rows B (m in log2
// units: scores carry a factor log2(e), so exp2 stands for exp).
template <int N>
__device__ __forceinline__ void combine(float& m, float& l, float (&acc)[N], float m2, float l2,
                                        const float (&acc2)[N]) {
  const float mx = fmaxf(m, m2);
  const float c1 = exp2f(m - mx), c2 = exp2f(m2 - mx);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * c1 + acc2[i] * c2;
  m = mx;
}

// One block per (split, kv head h, sequence b). LPR lanes per row, NC
// 16-byte pieces per lane per row (NC * LPR * VEC >= D), GM >= G. O is
// the output's type: T, or float for the partial form, which also writes
// each row's log-sum-exp to ``lse`` (null otherwise).
template <typename T, typename O, typename Rows, int LPR, int NC, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, O* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int n_heads,
                    int n_kv_heads, int head_dim, int max_rows, float scale, Rows rows) {
  constexpr int VEC = Vec<T>::N;
  constexpr int RPW = 32 / LPR;        // rows a warp covers per load
  constexpr int U = kPieces / NC;      // rows per lane per stage
  constexpr int RW = RPW * U;          // rows per warp stage
  constexpr int NA = NC * VEC;         // accumulator values per lane per query
  __shared__ uint4 ring[kWarps][kRingSlots];
  __shared__ float s_ml[kWarps][GM][2];

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int D = head_dim, G = n_heads / n_kv_heads, n_vec = D / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, li = lane % LPR;

  // Grouped queries of this kv head (heads h*G .. h*G+G-1), scaled in q's
  // dtype, then by log2(e) in f32; lane li holds pieces li + n * LPR.
  const float qscale = Vec<T>::to_dtype(scale);
  float qf[GM][NA];
  const T* qb = q + ((int64_t)b * n_heads + (int64_t)h * G) * D;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = li + n * LPR;
      float f[VEC];
      if (g < G && c < n_vec) {
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(qb + g * D + c * VEC), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = Vec<T>::to_dtype(f[e] * qscale) * kLog2e;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][n * VEC + e] = f[e];
    }
  // This split's rows: an even share of [0, len) in whole granules.
  const int len = max(0, min(lengths[b], max_rows));
  const int64_t n_gran = (len + kGranule - 1) / kGranule;
  const int begin = (int)(n_gran * split / n_splits) * kGranule;
  const int end = min(len, (int)(n_gran * (split + 1) / n_splits) * kGranule);
  const int n_rows = max(0, end - begin);
  rows.prefetch(b, begin, end);

  float m[GM], l[GM], acc[GM][NA];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[g][i] = 0.f;
  }

  // Warp stage i covers rows begin + (warp + i * kWarps) * RW + [0, RW).
  const int n_stages_all = (n_rows + RW - 1) / RW;
  const int my = n_stages_all > warp ? (n_stages_all - warp + kWarps - 1) / kWarps : 0;
  uint4* wring = ring[warp];
  auto slot = [&](int stage, int u, int n, int kv) -> uint4* {
    return wring + (((stage * U + u) * NC + n) * 2 + kv) * 32 + lane;
  };
  auto stage_base = [&](int i) { return begin + (warp + i * kWarps) * RW; };
  auto fetch = [&](int i) { return rows.template fetch<RW>(b, stage_base(i), end); };
  auto issue = [&](int i, int entry) {
    const int base = stage_base(i);
    int64_t off[U];
    rows.template offsets<U, RPW>(entry, b, h, base, grp, D, off);
    const int stage = i % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = li + n * LPR;
        const bool ok = base + u * RPW + grp < end && c < n_vec;
        const int64_t o = ok ? off[u] + c * VEC : 0;
        cp_async16(slot(stage, u, n, 0), k + o, ok);
        cp_async16(slot(stage, u, n, 1), v + o, ok);
      }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my) issue(i, fetch(i));
    cp_commit();
  }
  int entry = kStages - 1 < my ? fetch(kStages - 1) : 0;
  for (int i = 0; i < my; ++i) {
    if (i + kStages - 1 < my) {
      issue(i + kStages - 1, entry);
      if (i + kStages < my) entry = fetch(i + kStages);
    }
    cp_commit();
    cp_wait<kStages - 1>();            // stage i has landed
    const int stage = i % kStages;
    const int base = stage_base(i);
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float kf[VEC];
        Vec<T>::unpack(*slot(stage, u, n, 0), kf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[u][g] += qf[g][n * VEC + e] * kf[e];
      }
    }
    // Sum each score over the row's LPR lanes: every lane of the group
    // ends with the same bits (a + b == b + a).
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) valid[u] = base + u * RPW + grp < end;
    float vf[U][NA];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float f[VEC];
        Vec<T>::unpack(*slot(stage, u, n, 1), f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[u][n * VEC + e] = f[e];
      }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = exp2f(m[g] - mx);
      float p[U];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = valid[u] ? exp2f(s[u][g] - mx) : 0.f;
        sum += p[u];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int i2 = 0; i2 < NA; ++i2) {
        float a = acc[g][i2] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a += p[u] * vf[u][i2];
        acc[g][i2] = a;
      }
    }
  }
  cp_wait<0>();

  // Combine the warp's row groups, lower rows first: group 0 ends with
  // the warp's state.
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m2 = __shfl_down_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_down_sync(0xffffffffu, l[g], o);
      float a2[NA];
#pragma unroll
      for (int i2 = 0; i2 < NA; ++i2) a2[i2] = __shfl_down_sync(0xffffffffu, acc[g][i2], o);
      combine(m[g], l[g], acc[g], m2, l2, a2);
    }

  // Then the warps, in order: warps 1.. park their state in their own
  // ring (its loads have all landed), warp 0 folds them in.
  float* park = reinterpret_cast<float*>(wring);
  if (warp > 0 && grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          park[g * kMaxD + (li + n * LPR) * VEC + e] = acc[g][n * VEC + e];
      if (li == 0) {
        s_ml[warp][g][0] = m[g];
        s_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  if (warp != 0 || grp != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    const float* pw = reinterpret_cast<const float*>(ring[w]);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float a2[NA];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          a2[n * VEC + e] = pw[g * kMaxD + (li + n * LPR) * VEC + e];
      combine(m[g], l[g], acc[g], s_ml[w][g][0], s_ml[w][g][1], a2);
    }
  }

  const int64_t head0 = (int64_t)b * n_heads + (int64_t)h * G;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = li + n * LPR;
      if (c >= n_vec) continue;
      if (n_splits == 1) {
        float o[VEC];
        const float den = fmaxf(l[g], 1e-30f);   // length 0 -> zeros
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = acc[g][n * VEC + e] / den;
        store_vals(out + (head0 + g) * D + c * VEC, o);
      } else {
        float* dst = ws_acc + ((head0 + g) * n_splits + split) * D + c * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(acc[g][n * VEC + e], acc[g][n * VEC + e + 1],
                          acc[g][n * VEC + e + 2], acc[g][n * VEC + e + 3]);
      }
    }
    if (n_splits > 1 && li == 0) {
      float* ml = ws_ml + ((head0 + g) * n_splits + split) * 2;
      ml[0] = m[g];
      ml[1] = l[g];
    } else if (lse != nullptr && li == 0) {
      lse[head0 + g] = row_lse(m[g], l[g]);
    }
  }
}

// One block per (query head, sequence): the splits' partial states,
// combined in split order. The splits' (m, l) are read at once into
// shared memory; thread t owns the 16 bytes of output at values
// VEC * t .. VEC * t + VEC - 1 and reads its splits' pieces eight splits
// at a time. Rows (the split kernel's functor) only names the kernel; O
// and ``lse`` are the split kernel's.
template <typename T, typename O, typename Rows>
__global__ void __launch_bounds__(kMaxD / Vec<T>::N)
decode_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                    O* __restrict__ out, float* __restrict__ lse, int n_heads, int head_dim,
                    int n_splits) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float s_m[kMaxSplits], s_l[kMaxSplits], s_w[kMaxSplits];
  const int64_t bh = (int64_t)blockIdx.y * n_heads + blockIdx.x;
  const float* ml = ws_ml + bh * n_splits * 2;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    s_m[s] = ml[2 * s];
    s_l[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, s_m[s]);
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) s_w[s] = exp2f(s_m[s] - mx);
  __syncthreads();
  const int d = threadIdx.x * VEC;
  if (d >= head_dim) return;
  const float* src = ws_acc + bh * n_splits * head_dim + d;
  float l = 0.f, a[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = s_w[s];
    l += s_l[s] * w;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 p = *reinterpret_cast<const float4*>(src + (int64_t)s * head_dim + e);
      a[e] += p.x * w;
      a[e + 1] += p.y * w;
      a[e + 2] += p.z * w;
      a[e + 3] += p.w * w;
    }
  }
  const float den = fmaxf(l, 1e-30f);   // all splits empty -> zeros
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] /= den;
  store_vals(out + bh * head_dim + d, a);
  if (lse != nullptr && threadIdx.x == 0) lse[bh] = row_lse(mx, l);
}

bool shape_ok(int B, int H, int Hkv, int D, int n_splits) {
  return B > 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= kMaxG && D > 0 && D <= kMaxD &&
         D % 8 == 0 && n_splits >= 1 && n_splits <= kMaxSplits;
}

template <typename T, typename O, typename Rows, int LPR, int NC>
void launch_split(const void* q, const void* k, const void* v, const int* lengths, void* out,
                  float* lse, float* ws, int B, int H, int Hkv, int D, int max_rows,
                  int n_splits, Rows rows, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(n_splits, Hkv, B);
  float* ws_ml = ws ? ws + (int64_t)B * H * n_splits * D : nullptr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  O* ot = static_cast<O*>(out);
  if (H / Hkv <= 4)
    decode_split_kernel<T, O, Rows, LPR, NC, 4><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, lse, ws, ws_ml, H, Hkv, D, max_rows, scale, rows);
  else
    decode_split_kernel<T, O, Rows, LPR, NC, 8><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, lse, ws, ws_ml, H, Hkv, D, max_rows, scale, rows);
}

// The split launch (lanes per row from D), then, with more than one
// split, the merge; cudaGetLastError() after both. O = T writes the
// output in q's dtype; O = float with ``lse`` is the partial form.
template <typename T, typename Rows, typename O = T>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out, void* ws,
           int B, int H, int Hkv, int D, int max_rows, int n_splits, Rows rows,
           cudaStream_t stream, float* lse = nullptr) {
  if (n_splits > 1 && ws == nullptr) return -1;
  float* wsf = static_cast<float*>(ws);
  const int n_vec = D / Vec<T>::N;   // 16-byte pieces per row
  if (n_vec <= 4)
    launch_split<T, O, Rows, 4, 1>(q, k, v, lengths, out, lse, wsf, B, H, Hkv, D, max_rows,
                                   n_splits, rows, stream);
  else if (n_vec <= 8)
    launch_split<T, O, Rows, 8, 1>(q, k, v, lengths, out, lse, wsf, B, H, Hkv, D, max_rows,
                                   n_splits, rows, stream);
  else if (n_vec <= 16)
    launch_split<T, O, Rows, 16, 1>(q, k, v, lengths, out, lse, wsf, B, H, Hkv, D, max_rows,
                                    n_splits, rows, stream);
  else if (n_vec <= 32)
    launch_split<T, O, Rows, 32, 1>(q, k, v, lengths, out, lse, wsf, B, H, Hkv, D, max_rows,
                                    n_splits, rows, stream);
  else if constexpr (Vec<T>::N == 4)   // f32 above D 128
    launch_split<T, O, Rows, 32, 2>(q, k, v, lengths, out, lse, wsf, B, H, Hkv, D, max_rows,
                                    n_splits, rows, stream);
  else
    return -1;
  if (n_splits > 1)
    decode_merge_kernel<T, O, Rows><<<dim3(H, B), kMaxD / Vec<T>::N, 0, stream>>>(
        wsf, wsf + (int64_t)B * H * n_splits * D, static_cast<O*>(out), lse, H, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. q (B, H, D), k/v (B, S, Hkv, D), lengths (B,) int32, out (B, H, D);
// ws: f32 workspace of B * H * n_splits * (D + 2) values (unused, and may
// be null, when n_splits is 1). dtype: 0 = float32, 1 = bfloat16. lse
// null: out in q's dtype. lse non-null selects K3's partial form: out is
// f32 (B, H, D) whatever q's dtype (normalised, not rounded), and lse f32
// (B, H) each row's log-sum-exp of its scaled scores in natural units,
// -inf where lengths[b] <= 0 (whose out is exact zeros). Every pointer
// 16-byte aligned, D a multiple of 8. Returns cudaGetLastError() after
// the launches (0 = launched), or -1 for a shape the kernel does not
// take.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* lengths, void* out, void* lse, void* ws,
                                          int B, int H, int Hkv, int D, int S, int n_splits,
                                          int dtype, void* stream) {
  if (!shape_ok(B, H, Hkv, D, n_splits) || S <= 0) return -1;
  ContiguousRows rows{(int64_t)S * Hkv * D, (int64_t)Hkv * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)   // f32: K3 and its partial form are one instance
    return launch<float>(q, k, v, lens, out, ws, B, H, Hkv, D, S, n_splits, rows, s, l);
  if (dtype == 1 && l == nullptr)
    return launch<__nv_bfloat16>(q, k, v, lens, out, ws, B, H, Hkv, D, S, n_splits, rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, ContiguousRows, float>(q, k, v, lens, out, ws, B, H, Hkv, D,
                                                        S, n_splits, rows, s, l);
  return -1;
}

// K4. q (B, H, D), k/v arenas (num_blocks + 1, block_size, Hkv, D),
// block_tables (B, T) int32, lengths (B,) int32, out (B, H, D); ws and
// the rest as for K3, with max_rows = T * block_size.
extern "C" int repro_paged_decode_attention_fwd(const void* q, const void* k_arena,
                                                const void* v_arena, const void* block_tables,
                                                const void* lengths, void* out, void* ws, int B,
                                                int H, int Hkv, int D, int block_size, int T,
                                                int n_splits, int dtype, void* stream) {
  if (!shape_ok(B, H, Hkv, D, n_splits) || block_size <= 0 || T <= 0) return -1;
  int shift = 0;
  while ((1 << shift) < block_size) ++shift;
  PagedRows rows{static_cast<const int*>(block_tables), T, block_size,
                 (1 << shift) == block_size ? shift : -1, (int64_t)block_size * Hkv * D,
                 (int64_t)Hkv * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int max_rows = T * block_size;
  if (dtype == 0)
    return launch<float>(q, k_arena, v_arena, lens, out, ws, B, H, Hkv, D, max_rows, n_splits,
                         rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, lens, out, ws, B, H, Hkv, D, max_rows,
                                 n_splits, rows, s);
  return -1;
}
