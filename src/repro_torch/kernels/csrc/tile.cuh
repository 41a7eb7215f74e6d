// Shared tile product for the FAuST block-sparse kernels (bsr_matmul.cu,
// chain_matmul.cu).
//
// One CTA of 256 threads (16 x 16) owns an output tile of TM rows (batch)
// by kTN = 128 columns (one value block's width) and accumulates it in f32
// registers: thread (ty, tx) holds rows ty + 16*i and columns tx + 16*j, so
// a warp reads 16 consecutive columns of the value tile (no bank
// conflicts) and two rows of the activation tile (broadcast).
//
// The reduction runs in chunks of kKC rows: each chunk stages a TM x kKC
// activation tile and a kKC x kTN value tile in shared memory, converted to
// f32, then does plain FFMA.  No TF32: the f32 path keeps full f32
// products, so it matches the plain PyTorch version to f32 rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace faust {

constexpr int kThreads = 256;
constexpr int kKC = 32;
constexpr int kTN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <int TM>
struct Smem {
  float a[TM][kKC + 1];  // +1: rows of one warp fall in different banks
  float b[kKC][kTN];
};

template <int TM>
__device__ __forceinline__ void zero_acc(float (&acc)[TM / 16][kTN / 16]) {
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kTN / 16; ++j) acc[i][j] = 0.f;
}

// acc += A @ B where A is `a_rows` x `kdim` (row stride lda; rows >= a_rows
// read as 0) and B is `kdim` x `b_cols` (row stride ldb; columns >= b_cols
// read as 0).  Every thread of the CTA must call it (it synchronizes).
// `a` is not __restrict__: the chain kernel reads activations that the same
// CTA wrote earlier, which the non-coherent read-only path may not serve.
template <typename T, int TM>
__device__ __forceinline__ void tile_mma(float (&acc)[TM / 16][kTN / 16], Smem<TM>& sm,
                                         const T* a, long long lda, int a_rows,
                                         const T* __restrict__ b, long long ldb, int b_cols,
                                         int kdim) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < kdim; k0 += kKC) {
    for (int e = tid; e < TM * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC;
      sm.a[r][c] = (r < a_rows && k0 + c < kdim) ? to_f32(a[r * lda + k0 + c]) : 0.f;
    }
    for (int e = tid; e < kKC * kTN; e += kThreads) {
      const int r = e / kTN, c = e % kTN;
      sm.b[r][c] = (k0 + r < kdim && c < b_cols) ? to_f32(b[(k0 + r) * ldb + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float av[TM / 16], bv[kTN / 16];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) av[i] = sm.a[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < kTN / 16; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kTN / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Write the accumulator tile: rows < rows, columns < cols; columns >= ncols
// (a ragged feature boundary) are written as 0.
template <typename T, int TM>
__device__ __forceinline__ void store_tile(const float (&acc)[TM / 16][kTN / 16], T* dst,
                                           long long ldd, int rows, int cols, int ncols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN / 16; ++j) {
      const int c = tx + 16 * j;
      if (r < rows && c < cols) dst[r * ldd + c] = from_f32<T>(c < ncols ? acc[i][j] : 0.f);
    }
  }
}

}  // namespace faust
