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
// about four operations per byte read, far below the card's ridge. Design
// for that:
//   * one block per (sequence b, kv head h): it loads the G = H / Hkv
//     grouped queries once and reads each K/V row of the head ONCE for
//     all G of them (the GQA saving the TPU kernel also makes);
//   * it walks only rows < lengths[b], in tiles of about 4096 values per
//     operand (64 rows at head_dim 64), staged in shared memory as f32;
//     nothing past the length is read, so no mask over the dead tail is
//     needed and no per-tick pad of the cache ever happens (the TPU's
//     "largest divisor of S" block rule is not carried over);
//   * online softmax (running max m, sum l, accumulator acc) in f32
//     registers and shared memory; the output is written once, in q's
//     dtype;
//   * the paged variant computes each row's arena address from its own
//     block-table entry table[b, r / block_size] for r < length, so dead
//     table slots are never touched (the TPU kernel instead clamps them
//     to the last live block), and a length-0 row writes exact zeros.
// K3 and K4 are one template with two row-address functors, so on the
// same rows they produce bit-identical results.
// Not yet done (later work): split-KV across blocks to fill more than
// B * Hkv SMs, TMA / cp.async double buffering, tensor-core products.
//
// The query scale is applied in q's dtype before the f32 cast, as
// `attention.decode_attention` does: (q * scale) rounds to bf16 for a
// bf16 query (exact for head_dim 64, where scale = 1/8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileValues = 4096;        // values per operand per tile
constexpr int kMaxTile = 128;            // rows per tile, upper bound
constexpr int kMaxG = 8;                 // grouped queries per kv head
constexpr int kMaxD = 256;               // head_dim
constexpr int kMaxOut = kMaxG * kMaxD / kThreads;   // outputs per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element offset of row r of (sequence b, kv head h) in a contiguous
// cache (B, S, Hkv, D).
struct ContiguousRows {
  int64_t seq_stride;   // S * Hkv * D
  int64_t row_stride;   // Hkv * D
  __device__ __forceinline__ int64_t operator()(int b, int h, int r, int head_dim) const {
    return b * seq_stride + r * row_stride + (int64_t)h * head_dim;
  }
};

// Element offset of row r of (sequence b, kv head h) in a block arena
// (num_blocks + 1, block_size, Hkv, D) read through block_tables (B, T).
struct PagedRows {
  const int* tables;
  int table_width;      // T
  int block_size;
  int64_t block_stride; // block_size * Hkv * D
  int64_t row_stride;   // Hkv * D
  __device__ __forceinline__ int64_t operator()(int b, int h, int r, int head_dim) const {
    const int bid = tables[(int64_t)b * table_width + r / block_size];
    return bid * block_stride + (r % block_size) * row_stride + (int64_t)h * head_dim;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ out, int n_heads,
              int n_kv_heads, int head_dim, int max_rows, float scale, Rows rows) {
  __shared__ float sq[kMaxG * kMaxD];
  __shared__ float sk[kTileValues + kMaxTile];   // tile rows at stride D + 1
  __shared__ float sv[kTileValues];
  __shared__ float sp[kMaxG * kMaxTile];          // scores, then probabilities
  __shared__ float s_m[kMaxG], s_l[kMaxG], s_corr[kMaxG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = head_dim;
  const int G = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int tile = kTileValues / D;
  if (tile > kMaxTile) tile = kMaxTile;
  int len = lengths[b];
  if (len > max_rows) len = max_rows;

  // Grouped queries of this kv head: heads h*G .. h*G+G-1, scaled in q's dtype.
  const T* qb = q + ((int64_t)b * n_heads + (int64_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    sq[i] = to_f(from_f<T>(to_f(qb[i]) * scale));
  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int r0 = 0; r0 < len; r0 += tile) {
    const int n = min(tile, len - r0);
    // Stage K and V rows [r0, r0 + n) of this head.
    for (int i = tid; i < n * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int64_t off = rows(b, h, r0 + r, D) + d;
      sk[r * (D + 1) + d] = to_f(k[off]);
      sv[r * D + d] = to_f(v[off]);
    }
    __syncthreads();
    // Scores s[g][r] = q_g . k_r for every (g, r) pair of the tile.
    for (int i = tid; i < G * tile; i += kThreads) {
      const int g = i / tile, r = i - g * tile;
      if (r < n) {
        const float* qg = sq + g * D;
        const float* kr = sk + r * (D + 1);
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qg[d] * kr[d];
        sp[g * kMaxTile + r] = s;
      }
    }
    __syncthreads();
    // Online-softmax statistics, one warp per grouped query.
    for (int g = warp; g < G; g += kWarps) {
      float* pg = sp + g * kMaxTile;
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, pg[r]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(pg[r] - m_new);
        pg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
        s_corr[g] = corr;
      }
    }
    __syncthreads();
    // acc[g][d] = acc[g][d] * corr[g] + sum_r p[g][r] * v[r][d].
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < G * D) {
        const int g = o / D, d = o - g * D;
        const float* pg = sp + g * kMaxTile;
        float a = acc[j] * s_corr[g];
        for (int r = 0; r < n; ++r) a += pg[r] * sv[r * D + d];
        acc[j] = a;
      }
    }
    __syncthreads();   // the next tile overwrites sk / sv / sp
  }

  T* ob = out + ((int64_t)b * n_heads + (int64_t)h * G) * D;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < G * D) {
      const int g = o / D;
      ob[o] = from_f<T>(acc[j] / fmaxf(s_l[g], 1e-30f));   // length 0 -> zeros
    }
  }
}

bool shape_ok(int B, int H, int Hkv, int D) {
  return B > 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= kMaxG && D > 0 && D <= kMaxD;
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int H, int Hkv, int D, int max_rows, Rows rows, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(Hkv, B);
  decode_kernel<T, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), H, Hkv, D, max_rows, scale, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. q (B, H, D), k/v (B, S, Hkv, D), lengths (B,) int32, out (B, H, D).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched), or -1 for a shape the kernel does not take.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* lengths, void* out, int B, int H,
                                          int Hkv, int D, int S, int dtype, void* stream) {
  if (!shape_ok(B, H, Hkv, D) || S <= 0) return -1;
  ContiguousRows rows{(int64_t)S * Hkv * D, (int64_t)Hkv * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 0) return launch<float>(q, k, v, lens, out, B, H, Hkv, D, S, rows, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, lens, out, B, H, Hkv, D, S, rows, s);
  return -1;
}

// K4. q (B, H, D), k/v arenas (num_blocks + 1, block_size, Hkv, D),
// block_tables (B, T) int32, lengths (B,) int32, out (B, H, D).
extern "C" int repro_paged_decode_attention_fwd(const void* q, const void* k_arena,
                                                const void* v_arena, const void* block_tables,
                                                const void* lengths, void* out, int B, int H,
                                                int Hkv, int D, int block_size, int T,
                                                int dtype, void* stream) {
  if (!shape_ok(B, H, Hkv, D) || block_size <= 0 || T <= 0) return -1;
  PagedRows rows{static_cast<const int*>(block_tables), T, block_size,
                 (int64_t)block_size * Hkv * D, (int64_t)Hkv * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int max_rows = T * block_size;
  if (dtype == 0)
    return launch<float>(q, k_arena, v_arena, lens, out, B, H, Hkv, D, max_rows, rows, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, lens, out, B, H, Hkv, D, max_rows,
                                 rows, s);
  return -1;
}
