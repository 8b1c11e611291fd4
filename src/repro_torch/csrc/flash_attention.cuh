// Shared by flash attention's two sources: flash_attention.cu (the bf16
// kernels and the C entry points) and flash_attention_tf32.cu (the f32
// kernels), which nvcc builds side by side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace repro_fa {

using bf16 = __nv_bfloat16;

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

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Padding of a tile row in shared memory, in elements. bf16: 16 bytes,
// so the eight row addresses of one `ldmatrix` hit eight bank groups.
// f32: 12 words, so the row stride is 4 x an odd number of words mod 32
// and 12 mod 16, and the 32 addresses of each f32 fragment load (8 rows
// x 4 columns, or 4 row pairs x 8 columns) fall on 32 banks at D 32, 64,
// 80 and 128. 4 words would do so too, and 8 would not;
// `tools/flash_tiles.py --f32` times both beside 12, which measured
// fastest.
constexpr int kF32Pad = 12;
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return std::is_same<T, bf16>::value ? 8 : kF32Pad;
}

// ROWS rows of COLS elements from global (row stride `stride` elements)
// into shared memory with row stride COLS + row_pad<T>(), by 16-byte
// cp.async; rows at or past `valid` are zero-filled (their source address
// is row 0). Where the tile's 16-byte chunks do not divide among the
// threads (bf16 D 80: 10 a row, 320 for a 32-row tile over 128 threads)
// the last round is partial.
template <int ROWS, int COLS, int NT, typename T>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int64_t stride, int valid) {
  constexpr int EPC = 16 / sizeof(T), CPR = COLS / EPC, CHUNKS = ROWS * CPR;
  static_assert(COLS % EPC == 0, "rows are copied in 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (CHUNKS % NT != 0 && c >= CHUNKS) break;
    const int r = c / CPR, col = (c % CPR) * EPC;
    const bool ok = r < valid;
    cp_async16(dst + r * (COLS + row_pad<T>()) + col, src + (int64_t)(ok ? r : 0) * stride + col,
               ok);
  }
}

// Row `row` (= this thread's g or g + 8) of an m16n8 tile pair of f32
// accumulators, scaled by `mul`, as bf16 or f32 pairs at dst[8 c + 2 t4].
template <int N>
__device__ __forceinline__ void store_row(bf16* dst, const float (&c)[N][4], int half, int t4,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * t4) =
        __floats2bfloat162_rn(c[i][2 * half] * mul, c[i][2 * half + 1] * mul);
}
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&c)[N][4], int half, int t4,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    *reinterpret_cast<float2*>(dst + 8 * i + 2 * t4) =
        make_float2(c[i][2 * half] * mul, c[i][2 * half + 1] * mul);
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

// Runs L::run<D, DV>(a) (L: one launch plan of one dtype) for the (D, Dv)
// pairs the kernels are built for: D and Dv each in {32, 64, 128}, or
// D = Dv = 80 (hubert-xlarge's heads), a pair of its own so that the
// build does not grow by the whole cross product. -1 for any other pair.
template <class L, int D>
int dispatch_dv(const Args& a, int Dv) {
  switch (Dv) {
    case 32: return L::template run<D, 32>(a);
    case 64: return L::template run<D, 64>(a);
    case 128: return L::template run<D, 128>(a);
  }
  return -1;
}
template <class L>
int dispatch_head_dims(const Args& a, int D, int Dv) {
  switch (D) {
    case 32: return dispatch_dv<L, 32>(a, Dv);
    case 64: return dispatch_dv<L, 64>(a, Dv);
    case 128: return dispatch_dv<L, 128>(a, Dv);
    case 80:
      if (Dv == 80) return L::template run<80, 80>(a);
  }
  return -1;
}

// The f32 forward (bwd false) or backward (flash_attention_tf32.cu).
int launch_tf32(const Args& a, bool bwd, int D, int Dv);

}  // namespace repro_fa
