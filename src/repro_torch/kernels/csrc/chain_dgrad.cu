// K2: the input gradient of the FAuST chain, dx = dy @ F_J^T @ ... @ F_1^T,
// in one launch on Hopper (sm_90a), and K5's dgrad half: the same walk over
// a quantized chain (int8 / fp8 codes with f32 row scales).
//
// K2 replaces the TPU kernel repro/kernels/chain_bwd.py:283 chain_dgrad
// (body _dgrad_kernel at :231: grid (batch tiles, S reversed steps) running
// in order, dy staged into a (2, max_blocks, bt, blk) f32 VMEM ping-pong,
// each step scatter-accumulating g @ F[s]^T into the other buffer).  K5's
// dgrad half replaces the same function called with scales= (dequant of
// the streamed block at chain_bwd.py:262-263).
//
//   dy      (B, O_J*blk)       f32 or bf16, the cotangent of the padded output
//   values  (S, blk, blk)      dy's dtype, or int8 / fp8 e4m3 / fp8 e5m2 codes
//   scales  (S, blk)           codes only: f32 scale of each stored block row
//   meta    (S, 5)             int32 reversed step table (chain_bwd.py dgrad_meta):
//                              dst_blk, src_blk, parity, is_j0, ncols
//   ws      (2, B, ws_w)       f32 cotangent ping-pong (J > 1)
//   dxacc   (B, IB_1*blk)      f32 accumulator of dx (dx itself when dx is f32)
//   dx      (B, IB_1*blk)      dy's dtype
//
// Design.  As K1: the sequential step axis becomes a loop inside one CTA
// per batch tile, and the cotangents live in a global workspace sized by
// the widest *intermediate* (max in_blocks[1:]), not by max_blocks; the
// first reversed factor reads dy where it lies, so the chain's widest edge
// (the output, 256000 columns for a vocabulary) is never staged.  A step
// reads the source cotangent block (columns >= ncols masked: the forward
// zeroed them, so their cotangent is dropped), multiplies it by its value
// block read transposed from the packed layout, and adds the (bt x blk)
// result into the destination block.  The scatter stays inside the CTA's
// own rows and its sequential walk: no atomics.  The destination buffer
// is zeroed at the first step of each factor.  Everything is f32 inside;
// dx is converted to dy's dtype at the end.
//
// Hazards: each accumulator element is read, added and written by the
// one thread that owns it, so successive adds need no barrier; a
// __syncthreads() after every step makes a finished block visible before
// the next factor stages it, and after the zeroing before the first add.
//
// Bound on this card: 2*B*s_tot FLOPs (f32 FFMA, 67 TFLOP/s) and the
// weights once per batch tile (from L2 after the first tile).  Like K1,
// one CTA per batch tile walking every step is latency-bound at serving
// batches; splitting a factor's blocks across CTAs and tensor cores belong
// to the redesign.
#include "tile.cuh"

namespace faust {

constexpr int kDgradCols = 5;

template <typename T, typename V, int TM>
__global__ void __launch_bounds__(kThreads)
    chain_dgrad_kernel(const T* __restrict__ dy, const V* __restrict__ values,
                       const float* __restrict__ scales, const int* __restrict__ meta, float* ws,
                       float* dxacc, T* dx, int B, int S, int J, int blk, int out_w, int ws_w,
                       int in_w) {
  constexpr bool kQ = is_code<V>::value;
  __shared__ Smem<TM, 1> sm;
  const int b0 = blockIdx.x * TM;
  const int rows = min(TM, B - b0);
  const long long buf = (long long)B * ws_w;  // elements in one ping-pong buffer
  float acc[TM / 16][kTN / 16];
  int j = J;  // factor of the current step
  for (int t = 0; t < S; ++t) {
    const int* m = meta + (long long)t * kDgradCols;
    const int dst = m[0], src = m[1], par = m[2], is_j0 = m[3], ncols = m[4];
    const int s = S - 1 - t;  // flat step of the value block
    float* dbase;
    long long ldd;
    if (is_j0) --j;
    if (j == 0) {
      dbase = dxacc + (long long)b0 * in_w;
      ldd = in_w;
    } else {
      dbase = ws + (1 - par) * buf + (long long)b0 * ws_w;
      ldd = ws_w;
    }
    if (is_j0) {  // a fresh scatter target: blocks never written read 0
      zero_rows(dbase, ldd, rows, (int)ldd);
      __syncthreads();
    }
    zero_acc<TM>(acc);
    const V* vb = values + (long long)s * blk * blk;
    const float* sc = kQ ? scales + (long long)s * blk : nullptr;
    if (j == J - 1) {  // the last factor's cotangent is dy itself
      tile_mma<T, TM, V, 1, true, kQ>(acc, sm, dy + (long long)b0 * out_w + (long long)src * blk,
                                      out_w, rows, vb, blk, blk, ncols, sc);
    } else {
      tile_mma<float, TM, V, 1, true, kQ>(
          acc, sm, ws + par * buf + (long long)b0 * ws_w + (long long)src * blk, ws_w, rows, vb,
          blk, blk, ncols, sc);
    }
    add_tile<TM>(acc, dbase + (long long)dst * blk, ldd, rows, blk);
    __syncthreads();
  }
  if ((const void*)dxacc != (const void*)dx) {
    for (long long e = threadIdx.x; e < (long long)rows * in_w; e += kThreads) {
      const long long i = (long long)b0 * in_w + e;
      dx[i] = from_f32<T>(dxacc[i]);
    }
  }
}

template <typename T, typename V>
int launch(const void* dy, const void* values, const float* scales, const void* meta, void* ws,
           void* dxacc, void* dx, int B, int S, int J, int blk, int out_w, int ws_w, int in_w,
           int bt, void* stream) {
  const dim3 grid((B + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* dp = static_cast<const T*>(dy);
  const V* vp = static_cast<const V*>(values);
  const int* mp = static_cast<const int*>(meta);
  float* wp = static_cast<float*>(ws);
  float* ap = static_cast<float*>(dxacc);
  T* op = static_cast<T*>(dx);
  switch (bt) {
    case 16:
      chain_dgrad_kernel<T, V, 16><<<grid, kThreads, 0, st>>>(dp, vp, scales, mp, wp, ap, op, B, S,
                                                              J, blk, out_w, ws_w, in_w);
      break;
    case 32:
      chain_dgrad_kernel<T, V, 32><<<grid, kThreads, 0, st>>>(dp, vp, scales, mp, wp, ap, op, B, S,
                                                              J, blk, out_w, ws_w, in_w);
      break;
    case 64:
      chain_dgrad_kernel<T, V, 64><<<grid, kThreads, 0, st>>>(dp, vp, scales, mp, wp, ap, op, B, S,
                                                              J, blk, out_w, ws_w, in_w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace faust

extern "C" {

// K2: values in dy's dtype.
#define FAUST_DGRAD(suffix, T)                                                                 \
  int chain_dgrad_##suffix(const void* dy, const void* values, const void* meta, void* ws,     \
                           void* dxacc, void* dx, int B, int S, int J, int blk, int out_w,      \
                           int ws_w, int in_w, int bt, void* stream) {                          \
    return faust::launch<T, T>(dy, values, nullptr, meta, ws, dxacc, dx, B, S, J, blk, out_w,   \
                               ws_w, in_w, bt, stream);                                         \
  }

// K5 (dgrad): int8 / fp8 codes with (S, blk) f32 row scales.
#define FAUST_DGRAD_Q(suffix, T, V)                                                            \
  int chain_dgrad_q_##suffix(const void* dy, const void* values, const void* scales,           \
                             const void* meta, void* ws, void* dxacc, void* dx, int B, int S,   \
                             int J, int blk, int out_w, int ws_w, int in_w, int bt,             \
                             void* stream) {                                                    \
    return faust::launch<T, V>(dy, values, static_cast<const float*>(scales), meta, ws, dxacc,  \
                               dx, B, S, J, blk, out_w, ws_w, in_w, bt, stream);                \
  }

FAUST_DGRAD(f32, float)
FAUST_DGRAD(bf16, __nv_bfloat16)
FAUST_DGRAD_Q(f32_int8, float, int8_t)
FAUST_DGRAD_Q(f32_e4m3, float, __nv_fp8_e4m3)
FAUST_DGRAD_Q(f32_e5m2, float, __nv_fp8_e5m2)
FAUST_DGRAD_Q(bf16_int8, __nv_bfloat16, int8_t)
FAUST_DGRAD_Q(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
FAUST_DGRAD_Q(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)

}  // extern "C"
