// K3: the packed-values gradient of the FAuST chain, dvalues[s] = a_j^T g_j
// for every stored block, on Hopper (sm_90a), and K5's wgrad half: the same
// over a quantized chain (int8 / fp8 codes with f32 row scales), where the
// gradient is taken with respect to the dequantized f32 values.
//
// K3 replaces the TPU kernel repro/kernels/chain_bwd.py:433 chain_wgrad
// (body _wgrad_kernel at :346: grid (batch tiles, S_pre + S steps) in
// order; a forward recompute of factors 1..J-1 into a flat VMEM scratch,
// then a reversed cotangent walk that emits one (blk, blk) block per step
// into a per-batch-tile partial slab, the slabs summed outside).  K5's wgrad
// half replaces the same function called with scales= (chain_bwd.py:356-357).
//
//   x       (B, IB_1*blk)      f32 or bf16, the padded forward input
//   dy      (B, O_J*blk)       x's dtype, the cotangent of the padded output
//   values  (S, blk, blk)      x's dtype, or int8 / fp8 e4m3 / fp8 e5m2 codes
//   scales  (S, blk)           codes only: f32 scale of each stored block row
//   meta    (S_pre + S, 7)     int32 two-phase table (chain_bwd.py wgrad_meta):
//     recompute rows: in_blk, out_blk, is_k0, is_kend, ncols, act_off_in, act_off_out
//     walk rows:      dst_blk, src_blk, parity, is_j0, ncols, act_off_j, propagate
//   fac     (2*(J+1),)         int32: the plan's step offsets, then act offsets
//   act     (B, aw)            f32: the input activation of factors 2..J
//   cot     (B, aw)            f32: the cotangent of those same activations
//   dvalues (S, blk, blk)      f32
//
// Design.  Hopper blocks run in parallel, and a sum of per-batch-tile
// partial slabs would cost one (S, blk, blk) f32 slab per tile: 11.3 GB at
// the gemma-2b MLP chain (s_tot 11.0 M) and B = 4096 with bt = 16.  So the
// batch reduction gets a second pass instead, and no slab exists:
//   1. walk, one CTA per batch tile: the forward recompute of factors
//      1..J-1 (K1's step walk, f32 outputs, tails zeroed) writes every
//      intermediate activation into `act`; the reversed walk over factors
//      J..2 (K2's transposed steps; dy read where it lies) writes every
//      intermediate cotangent into `cot`, one region per factor, so none is
//      overwritten.  Factor 1's walk would only feed dx, which is K2's job.
//   2. emit, one CTA per stored block: dvalues[s] = sum over the whole batch
//      of A[:, in_blk]^T G[:, out_blk], with A the factor's input (x for
//      factor 1) and G its output cotangent (dy for factor J), columns >=
//      ncols masked.  Each block is written once; the sum runs in one
//      order: deterministic, no atomics.
// The two workspaces hold B * sum(in_blocks[1:]) * blk floats each (the
// chain's intermediate widths, 2 x 67 MB at B = 4096 for that chain), not
// slabs of s_tot.  Everything is f32 inside.
//
// Bound on this card: the FLOPs of the recompute, the walk and the
// emission, 2*B*(s_1 + ... + s_{J-1}) + 2*B*(s_2 + ... + s_J) + 2*B*s_tot,
// at the f32 FFMA rate, and the bytes of x, dy, the weights and dvalues.
// Phase 1 is latency-bound like K1 and K2 (one CTA per batch tile walking
// every step); phase 2 runs S CTAs in parallel.
#include "tile.cuh"

namespace faust {

constexpr int kWgradCols = 7;
constexpr int kEC = 32;  // batch rows per emission chunk

template <typename T, typename V, int TM>
__global__ void __launch_bounds__(kThreads)
    chain_wgrad_walk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const V* __restrict__ values, const float* __restrict__ scales,
                            const int* __restrict__ meta, float* act, float* cot, int B, int S,
                            int s_pre, int n_walk, int blk, int in_w, int out_w, int aw, int ib0) {
  constexpr bool kQ = is_code<V>::value;
  __shared__ Smem<TM, 1> sm;
  const int b0 = blockIdx.x * TM;
  const int rows = min(TM, B - b0);
  float* act_t = act + (long long)b0 * aw;
  float* cot_t = cot + (long long)b0 * aw;
  float acc[TM / 16][kTN / 16];
  zero_acc<TM>(acc);
  // 1a. forward recompute of factors 1..J-1 (flat steps 0..s_pre-1)
  for (int t = 0; t < s_pre; ++t) {
    const int* m = meta + (long long)t * kWgradCols;
    const int i_blk = m[0], o_blk = m[1], is_k0 = m[2], is_kend = m[3], ncols = m[4];
    const int off_in = m[5], off_out = m[6];
    if (is_k0) zero_acc<TM>(acc);
    const V* vb = values + (long long)t * blk * blk;
    const float* sc = kQ ? scales + (long long)t * blk : nullptr;
    if (off_in == 0) {  // factor 1 reads x itself
      tile_mma<T, TM, V, 1, false, kQ>(acc, sm, x + (long long)b0 * in_w + (long long)i_blk * blk,
                                       in_w, rows, vb, blk, blk, blk, sc);
    } else {
      tile_mma<float, TM, V, 1, false, kQ>(acc, sm, act_t + (long long)(off_in - ib0 + i_blk) * blk,
                                           aw, rows, vb, blk, blk, blk, sc);
    }
    if (is_kend) {
      store_tile<float, TM>(acc, act_t + (long long)(off_out - ib0 + o_blk) * blk, aw, rows, blk,
                            ncols);
      __syncthreads();
    }
  }
  // 1b. reversed walk over factors J..2: cot region of factor j's input
  // gets g_j @ F_j^T; the source is dy (factor J) or the previous region
  int src_off = -1, dst_off = aw / blk;  // block offsets inside act / cot
  for (int t = s_pre; t < s_pre + n_walk; ++t) {
    const int* m = meta + (long long)t * kWgradCols;
    const int dst = m[0], src = m[1], is_j0 = m[3], ncols = m[4], off_j = m[5];
    const int s = S - 1 - (t - s_pre);
    if (is_j0) {
      src_off = (t == s_pre) ? -1 : dst_off;
      const int end = dst_off;
      dst_off = off_j - ib0;
      zero_rows(cot_t + (long long)dst_off * blk, aw, rows, (end - dst_off) * blk);
      __syncthreads();
    }
    zero_acc<TM>(acc);
    const V* vb = values + (long long)s * blk * blk;
    const float* sc = kQ ? scales + (long long)s * blk : nullptr;
    if (src_off < 0) {
      tile_mma<T, TM, V, 1, true, kQ>(acc, sm, dy + (long long)b0 * out_w + (long long)src * blk,
                                      out_w, rows, vb, blk, blk, ncols, sc);
    } else {
      tile_mma<float, TM, V, 1, true, kQ>(acc, sm, cot_t + (long long)(src_off + src) * blk, aw,
                                          rows, vb, blk, blk, ncols, sc);
    }
    add_tile<TM>(acc, cot_t + (long long)(dst_off + dst) * blk, aw, rows, blk);
    __syncthreads();
  }
}

// Stage kEC rows x NB columns of a row-major matrix as f32 (rows >= nrows
// and columns >= ncols read as 0).
template <typename A, int NB>
__device__ __forceinline__ void stage_rows(float (&dst)[kEC][NB + 1], const A* src, long long ld,
                                           int nrows, int ncols) {
  for (int e = threadIdx.x; e < kEC * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    dst[r][c] = (r < nrows && c < ncols) ? to_f32(src[r * ld + c]) : 0.f;
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
    chain_wgrad_emit_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ act, const float* __restrict__ cot,
                            const int* __restrict__ meta, const int* __restrict__ fac,
                            float* __restrict__ dvalues, int B, int S, int s_pre, int J, int blk,
                            int in_w, int out_w, int aw, int ib0) {
  __shared__ float sa[kEC][NB + 1];
  __shared__ float sg[kEC][NB + 1];
  const int s = blockIdx.x;  // flat step: one stored block per CTA
  const int* m = meta + (long long)(s_pre + S - 1 - s) * kWgradCols;
  const int i_blk = m[0], o_blk = m[1], ncols = m[4];
  int j = 0;
  while (j + 1 < J && fac[j + 1] <= s) ++j;
  const int* actoff = fac + J + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[NB / 16][NB / 16];
#pragma unroll
  for (int i = 0; i < NB / 16; ++i)
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) acc[i][k] = 0.f;
  for (int r0 = 0; r0 < B; r0 += kEC) {
    const int nrows = min(kEC, B - r0);
    if (j == 0) {
      stage_rows<T, NB>(sa, x + (long long)r0 * in_w + (long long)i_blk * blk, in_w, nrows, blk);
    } else {
      stage_rows<float, NB>(sa, act + (long long)r0 * aw + (long long)(actoff[j] - ib0 + i_blk) * blk,
                            aw, nrows, blk);
    }
    if (j == J - 1) {
      stage_rows<T, NB>(sg, dy + (long long)r0 * out_w + (long long)o_blk * blk, out_w, nrows,
                        ncols);
    } else {
      stage_rows<float, NB>(
          sg, cot + (long long)r0 * aw + (long long)(actoff[j + 1] - ib0 + o_blk) * blk, aw, nrows,
          ncols);
    }
    __syncthreads();
#pragma unroll 4
    for (int kb = 0; kb < kEC; ++kb) {
      float av[NB / 16], gv[NB / 16];
#pragma unroll
      for (int i = 0; i < NB / 16; ++i) av[i] = sa[kb][ty + 16 * i];
#pragma unroll
      for (int k = 0; k < NB / 16; ++k) gv[k] = sg[kb][tx + 16 * k];
#pragma unroll
      for (int i = 0; i < NB / 16; ++i)
#pragma unroll
        for (int k = 0; k < NB / 16; ++k) acc[i][k] = fmaf(av[i], gv[k], acc[i][k]);
    }
    __syncthreads();
  }
  float* out = dvalues + (long long)s * blk * blk;
#pragma unroll
  for (int i = 0; i < NB / 16; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int k = 0; k < NB / 16; ++k) {
      const int c = tx + 16 * k;
      if (r < blk && c < blk) out[r * blk + c] = acc[i][k];
    }
  }
}

template <typename T, typename V, int TM>
void launch_walk(const T* x, const T* dy, const V* values, const float* scales, const int* meta,
                 float* act, float* cot, int B, int S, int s_pre, int n_walk, int blk, int in_w,
                 int out_w, int aw, int ib0, cudaStream_t st) {
  chain_wgrad_walk_kernel<T, V, TM><<<(B + TM - 1) / TM, kThreads, 0, st>>>(
      x, dy, values, scales, meta, act, cot, B, S, s_pre, n_walk, blk, in_w, out_w, aw, ib0);
}

template <typename T, int NB>
void launch_emit(const T* x, const T* dy, const float* act, const float* cot, const int* meta,
                 const int* fac, float* dvalues, int B, int S, int s_pre, int J, int blk,
                 int in_w, int out_w, int aw, int ib0, cudaStream_t st) {
  chain_wgrad_emit_kernel<T, NB><<<S, kThreads, 0, st>>>(x, dy, act, cot, meta, fac, dvalues, B,
                                                         S, s_pre, J, blk, in_w, out_w, aw, ib0);
}

template <typename T, typename V>
int launch(const void* x, const void* dy, const void* values, const float* scales,
           const void* meta, const void* fac, void* act, void* cot, void* dvalues, int B, int S,
           int s_pre, int n_walk, int J, int blk, int in_w, int out_w, int aw, int ib0, int bt,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  const V* vp = static_cast<const V*>(values);
  const int* mp = static_cast<const int*>(meta);
  const int* fp = static_cast<const int*>(fac);
  float* ap = static_cast<float*>(act);
  float* cp = static_cast<float*>(cot);
  float* op = static_cast<float*>(dvalues);
  if (blk > kTN) return (int)cudaErrorInvalidValue;
  if (J > 1) {
    switch (bt) {
      case 16:
        launch_walk<T, V, 16>(xp, dp, vp, scales, mp, ap, cp, B, S, s_pre, n_walk, blk, in_w, out_w,
                              aw, ib0, st);
        break;
      case 32:
        launch_walk<T, V, 32>(xp, dp, vp, scales, mp, ap, cp, B, S, s_pre, n_walk, blk, in_w, out_w,
                              aw, ib0, st);
        break;
      case 64:
        launch_walk<T, V, 64>(xp, dp, vp, scales, mp, ap, cp, B, S, s_pre, n_walk, blk, in_w, out_w,
                              aw, ib0, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (blk <= 16) {
    launch_emit<T, 16>(xp, dp, ap, cp, mp, fp, op, B, S, s_pre, J, blk, in_w, out_w, aw, ib0, st);
  } else if (blk <= 32) {
    launch_emit<T, 32>(xp, dp, ap, cp, mp, fp, op, B, S, s_pre, J, blk, in_w, out_w, aw, ib0, st);
  } else if (blk <= 64) {
    launch_emit<T, 64>(xp, dp, ap, cp, mp, fp, op, B, S, s_pre, J, blk, in_w, out_w, aw, ib0, st);
  } else {
    launch_emit<T, 128>(xp, dp, ap, cp, mp, fp, op, B, S, s_pre, J, blk, in_w, out_w, aw, ib0, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace faust

extern "C" {

// K3: values in x's dtype.
#define FAUST_WGRAD(suffix, T)                                                                 \
  int chain_wgrad_##suffix(const void* x, const void* dy, const void* values, const void* meta, \
                           const void* fac, void* act, void* cot, void* dvalues, int B, int S,  \
                           int s_pre, int n_walk, int J, int blk, int in_w, int out_w, int aw,  \
                           int ib0, int bt, void* stream) {                                     \
    return faust::launch<T, T>(x, dy, values, nullptr, meta, fac, act, cot, dvalues, B, S,     \
                               s_pre, n_walk, J, blk, in_w, out_w, aw, ib0, bt, stream);        \
  }

// K5 (wgrad): int8 / fp8 codes with (S, blk) f32 row scales.
#define FAUST_WGRAD_Q(suffix, T, V)                                                            \
  int chain_wgrad_q_##suffix(const void* x, const void* dy, const void* values,                \
                             const void* scales, const void* meta, const void* fac, void* act,  \
                             void* cot, void* dvalues, int B, int S, int s_pre, int n_walk,     \
                             int J, int blk, int in_w, int out_w, int aw, int ib0, int bt,      \
                             void* stream) {                                                    \
    return faust::launch<T, V>(x, dy, values, static_cast<const float*>(scales), meta, fac,    \
                               act, cot, dvalues, B, S, s_pre, n_walk, J, blk, in_w, out_w, aw, \
                               ib0, bt, stream);                                                \
  }

FAUST_WGRAD(f32, float)
FAUST_WGRAD(bf16, __nv_bfloat16)
FAUST_WGRAD_Q(f32_int8, float, int8_t)
FAUST_WGRAD_Q(f32_e4m3, float, __nv_fp8_e4m3)
FAUST_WGRAD_Q(f32_e5m2, float, __nv_fp8_e5m2)
FAUST_WGRAD_Q(bf16_int8, __nv_bfloat16, int8_t)
FAUST_WGRAD_Q(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
FAUST_WGRAD_Q(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)

}  // extern "C"
