// Shared tile product of the one-CTA-per-tile kernels (bsr_matmul.cu,
// chain_wgrad.cu); its type helpers (to_f32, from_f32, is_code, kThreads)
// serve every kernel, the persistent ones through pipeline.cuh.
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
//
// Quantized values (int8 / fp8 codes, stored type V other than the
// activation type T) are dequantized where the value tile is staged: one
// f32 multiply of the code by its block row's scale, the same product as
// the plain version's q.float() * scale[:, None].
//
// The wgrad walk reads a value block transposed (g @ F^T): element
// (k, c) of B is the stored b[c * ldb + k], and its dequantizing scale is
// that of stored row c.  Rows scaled before the transposed read give the
// same product as scaling after it, so dequantize-then-multiply is exact
// there too.  Their shared-memory B tile is one column wider (kBPad = 1),
// so the transposed staging writes down a column without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace faust {

constexpr int kThreads = 256;
constexpr int kKC = 32;
constexpr int kTN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <int TM, int kBPad = 0>
struct Smem {
  float a[TM][kKC + 1];  // +1: rows of one warp fall in different banks
  float b[kKC][kTN + kBPad];
};

// Stored value types that are codes with row scales (not plain values).
template <typename V>
struct is_code : std::false_type {};
template <>
struct is_code<int8_t> : std::true_type {};
template <>
struct is_code<__nv_fp8_e4m3> : std::true_type {};
template <>
struct is_code<__nv_fp8_e5m2> : std::true_type {};

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
// `a` is not __restrict__: the chain kernels read activations that the same
// CTA wrote earlier, which the non-coherent read-only path may not serve.
// With kDequant (the forward kernels: V != T), row r of the stored block is
// b[r] * b_row_scale[r].  With kTransB, B is the stored block transposed.
template <typename T, int TM, typename V, int kBPad = 0, bool kTransB = false,
          bool kDequant = !std::is_same<V, T>::value>
__device__ __forceinline__ void tile_mma(float (&acc)[TM / 16][kTN / 16], Smem<TM, kBPad>& sm,
                                         const T* a, long long lda, int a_rows,
                                         const V* __restrict__ b, long long ldb, int b_cols,
                                         int kdim, const float* __restrict__ b_row_scale = nullptr) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < kdim; k0 += kKC) {
    for (int e = tid; e < TM * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC;
      sm.a[r][c] = (r < a_rows && k0 + c < kdim) ? to_f32(a[r * lda + k0 + c]) : 0.f;
    }
    if constexpr (kTransB) {
      // neighbouring threads read neighbouring k of one stored row c
      for (int e = tid; e < kKC * kTN; e += kThreads) {
        const int c = e / kKC, r = e % kKC;
        float v = 0.f;
        if (k0 + r < kdim && c < b_cols) {
          v = to_f32(b[c * ldb + k0 + r]);
          if constexpr (kDequant) v *= b_row_scale[c];
        }
        sm.b[r][c] = v;
      }
    } else {
      for (int e = tid; e < kKC * kTN; e += kThreads) {
        const int r = e / kTN, c = e % kTN;
        float v = 0.f;
        if (k0 + r < kdim && c < b_cols) {
          v = to_f32(b[(k0 + r) * ldb + c]);
          if constexpr (kDequant) v *= b_row_scale[k0 + r];
        }
        sm.b[r][c] = v;
      }
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

// dst += the accumulator tile: rows < rows, columns < cols (f32 scatter-add
// target of the backward walks).  Each element belongs to one thread, so
// successive adds into one block need no barrier between them.
template <int TM>
__device__ __forceinline__ void add_tile(const float (&acc)[TM / 16][kTN / 16], float* dst,
                                         long long ldd, int rows, int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN / 16; ++j) {
      const int c = tx + 16 * j;
      if (r < rows && c < cols) dst[r * ldd + c] += acc[i][j];
    }
  }
}

// Zero rows < rows, columns < cols of a row-major f32 region (whole CTA).
__device__ __forceinline__ void zero_rows(float* dst, long long ldd, int rows, int cols) {
  for (long long e = threadIdx.x; e < (long long)rows * cols; e += kThreads) {
    dst[(e / cols) * ldd + e % cols] = 0.f;
  }
}

}  // namespace faust
