// K1: the whole FAuST chain y = x @ F_1 @ ... @ F_J in one launch, on
// Hopper (sm_90a), and K4: the same walk over a quantized chain.
//
// K1 replaces the TPU kernel repro/kernels/chain.py:125 chain_matmul (body
// _chain_kernel at :79; grid (batch tiles, S steps) running in order and carrying
// a (2, max_blocks, bt, blk) VMEM ping-pong activation buffer and an f32
// accumulator from step to step).  K4 replaces the same function called
// with scales= (dequant in _chain_kernel at chain.py:103-104, the (1, blk)
// scale row streamed beside each value block at chain.py:166-169).
//
//   x       (B, IB_1*blk)      f32 or bf16
//   values  (S, blk, blk)      K1: x's dtype; K4: int8, fp8 e4m3 or fp8 e5m2 codes,
//                              flat chain in (factor, out block, slot) order
//   scales  (S, blk)           K4 only: f32 scale of each block row (per_block
//                              scales arrive broadcast); value = code * scale
//   meta    (S, 7)             int32 step table (repro_torch/kernels/ops.py chain_meta):
//                              in_blk, out_blk, parity, is_k0, is_kend, is_last, ncols
//   ws      (2, B, ws_w)       workspace for the intermediate activations (J > 1)
//   y       (B, O_J*blk)       x.dtype, ragged tail columns already zeroed
//
// Design.  Hopper blocks run in no order, so the TPU's sequential step
// axis becomes a loop over the S steps inside one CTA per batch tile; a
// CTA reads meta row s at step s and no CTA waits on another.  The
// activations cannot stay on chip: the chain's widest intermediate is
// B_tile x ws_w elements per buffer, far beyond a block's 227 KB of shared
// memory at real widths (2048 features: 512 KB at 64 f32 rows), so they
// live in a global workspace the wrapper allocates, sized by the widest
// intermediate (max in_blocks[1:]), which stays L2-resident at serving
// batches.  Factor 1 reads x directly and factor J writes y directly.
// Shared memory holds the current value chunk and activation chunk.
//
// Hazards: factor j+1 writes the buffer factor j read, and reads blocks
// other threads flushed.  tile_mma ends with __syncthreads() (every read of
// a step is done before any thread moves on), and every flush is followed
// by __syncthreads() (a flushed block is visible before the next step
// loads it).
//
// Numerics as the reference: f32 accumulation, intermediates stored in
// x.dtype (bf16 rounds between factors), tail columns >= ncols zeroed at
// each flush.  lambda and the feature/batch slicing stay in the caller.
// K4 dequantizes each code to f32 as the value tile is staged (tile.cuh),
// also for bf16 activations: the values are never rounded to bf16.
//
// Bound on this card: the chain moves s_tot weights once per batch tile
// (from L2 after the first tile) and does 2*B*s_tot FLOPs.  One CTA per
// batch tile leaves most of the 132 SMs idle at serving batches (B = 128
// at bt = 32 is 4 CTAs); splitting a factor's output blocks across CTAs
// or a cluster is the next design step.  This first version is FFMA from
// shared memory, with no tensor cores, TMA or pipelining.  K4 moves 1 byte
// per value instead of 4 (plus 4*S*blk scale bytes), which does not show
// while the walk is latency-bound; fp8/int8 tensor cores belong to the
// redesign.
#include "tile.cuh"

namespace faust {

constexpr int kMetaCols = 7;

template <typename T, typename V, int TM>
__global__ void __launch_bounds__(kThreads)
    chain_matmul_kernel(const T* __restrict__ x, const V* __restrict__ values,
                        const float* __restrict__ scales, const int* __restrict__ meta, T* ws,
                        T* __restrict__ out, int B, int S, int blk, int in_w, int ws_w, int out_w,
                        int n0_steps) {
  __shared__ Smem<TM> sm;
  const int b0 = blockIdx.x * TM;
  const int rows = min(TM, B - b0);
  const long long buf = (long long)B * ws_w;  // elements in one ping-pong buffer
  float acc[TM / 16][kTN / 16];
  zero_acc<TM>(acc);
  for (int s = 0; s < S; ++s) {
    const int* m = meta + (long long)s * kMetaCols;
    const int i_blk = m[0], o_blk = m[1], par = m[2];
    const int is_k0 = m[3], is_kend = m[4], is_last = m[5], ncols = m[6];
    if (is_k0) zero_acc<TM>(acc);
    const T* src;
    long long lda;
    if (s < n0_steps) {  // factor 1 reads x itself
      src = x + (long long)b0 * in_w + (long long)i_blk * blk;
      lda = in_w;
    } else {
      src = ws + par * buf + (long long)b0 * ws_w + (long long)i_blk * blk;
      lda = ws_w;
    }
    tile_mma<T, TM>(acc, sm, src, lda, rows, values + (long long)s * blk * blk, blk, blk, blk,
                    scales == nullptr ? nullptr : scales + (long long)s * blk);
    if (is_kend) {
      if (is_last) {
        store_tile<T, TM>(acc, out + (long long)b0 * out_w + (long long)o_blk * blk, out_w, rows,
                          blk, ncols);
      } else {
        store_tile<T, TM>(acc, ws + (1 - par) * buf + (long long)b0 * ws_w + (long long)o_blk * blk,
                          ws_w, rows, blk, ncols);
      }
      __syncthreads();
    }
  }
}

template <typename T, typename V>
int launch(const void* x, const void* values, const float* scales, const void* meta, void* ws,
           void* out, int B, int S, int blk, int in_w, int ws_w, int out_w, int n0_steps, int bt,
           void* stream) {
  const dim3 grid((B + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const V* vp = static_cast<const V*>(values);
  const int* mp = static_cast<const int*>(meta);
  T* wp = static_cast<T*>(ws);
  T* op = static_cast<T*>(out);
  switch (bt) {
    case 16:
      chain_matmul_kernel<T, V, 16><<<grid, kThreads, 0, st>>>(xp, vp, scales, mp, wp, op, B, S,
                                                               blk, in_w, ws_w, out_w, n0_steps);
      break;
    case 32:
      chain_matmul_kernel<T, V, 32><<<grid, kThreads, 0, st>>>(xp, vp, scales, mp, wp, op, B, S,
                                                               blk, in_w, ws_w, out_w, n0_steps);
      break;
    case 64:
      chain_matmul_kernel<T, V, 64><<<grid, kThreads, 0, st>>>(xp, vp, scales, mp, wp, op, B, S,
                                                               blk, in_w, ws_w, out_w, n0_steps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace faust

extern "C" {

// K1: values in x's dtype.
#define FAUST_CHAIN_K1(suffix, T)                                                              \
  int chain_matmul_##suffix(const void* x, const void* values, const void* meta, void* ws,     \
                            void* out, int B, int S, int blk, int in_w, int ws_w, int out_w,    \
                            int n0_steps, int bt, void* stream) {                               \
    return faust::launch<T, T>(x, values, nullptr, meta, ws, out, B, S, blk, in_w, ws_w, out_w, \
                               n0_steps, bt, stream);                                           \
  }

// K4: int8 / fp8 codes with (S, blk) f32 row scales.
#define FAUST_CHAIN_K4(suffix, T, V)                                                           \
  int chain_matmul_q_##suffix(const void* x, const void* values, const void* scales,           \
                              const void* meta, void* ws, void* out, int B, int S, int blk,     \
                              int in_w, int ws_w, int out_w, int n0_steps, int bt,              \
                              void* stream) {                                                   \
    return faust::launch<T, V>(x, values, static_cast<const float*>(scales), meta, ws, out, B,  \
                               S, blk, in_w, ws_w, out_w, n0_steps, bt, stream);                \
  }

FAUST_CHAIN_K1(f32, float)
FAUST_CHAIN_K1(bf16, __nv_bfloat16)
FAUST_CHAIN_K4(f32_int8, float, int8_t)
FAUST_CHAIN_K4(f32_e4m3, float, __nv_fp8_e4m3)
FAUST_CHAIN_K4(f32_e5m2, float, __nv_fp8_e5m2)
FAUST_CHAIN_K4(bf16_int8, __nv_bfloat16, int8_t)
FAUST_CHAIN_K4(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
FAUST_CHAIN_K4(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)

}  // extern "C"
