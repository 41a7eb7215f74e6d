// K6: one block-sparse factor, y = x @ F, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_matmul.py:63 bsr_matmul (grid
// (batch tiles, output blocks, k) with a VMEM f32 accumulator carried over
// the k axis).
//
//   x       (B, IB*bk)      f32 or bf16, row-major
//   values  (O, K, bk, bn)  same dtype as x
//   in_idx  (O, K)          int32, input block gathered by each slot
//   y       (B, O*bn)       x.dtype; y[:, o*bn:(o+1)*bn] = sum_k x[:, in_idx[o,k]*bk:+bk] @ values[o,k]
//
// Design: one CTA per (batch tile of TM rows, output block o, 128-column
// slice of the block).  The TPU grid's sequential k axis becomes a loop
// inside the CTA, so the f32 accumulator stays in registers and nothing
// crosses CTAs: no atomics, deterministic sums.  Batch rows beyond B are
// masked, so callers need not pad the batch.
//
// Bound on this card: each output tile reads K value blocks once and K
// gathered activation tiles; at serving batches the value stream (s_tot
// elements) dominates the bytes, at large batches the 2*B*s_tot FLOPs do.
// This first version is plain FFMA from shared memory (no tensor cores,
// no TMA, no software pipelining); it is correct first and its times are
// recorded in PERF.md against that bound.
#include "tile.cuh"

namespace faust {

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
    bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ values,
                      const int* __restrict__ in_idx, T* __restrict__ out, int B, int in_w, int O,
                      int K, int bk, int bn) {
  __shared__ Smem<TM> sm;
  const int n_ctiles = (bn + kTN - 1) / kTN;
  const int o = blockIdx.y / n_ctiles;
  const int n0 = (blockIdx.y % n_ctiles) * kTN;
  const int b0 = blockIdx.x * TM;
  const int rows = min(TM, B - b0);
  const int cols = min(kTN, bn - n0);
  float acc[TM / 16][kTN / 16];
  zero_acc<TM>(acc);
  for (int k = 0; k < K; ++k) {
    const long long slot = (long long)o * K + k;
    const int ib = in_idx[slot];
    tile_mma<T, TM>(acc, sm, x + (long long)b0 * in_w + (long long)ib * bk, in_w, rows,
                    values + slot * bk * bn + n0, bn, cols, bk);
  }
  const long long out_w = (long long)O * bn;
  store_tile<T, TM>(acc, out + (long long)b0 * out_w + (long long)o * bn + n0, out_w, rows, cols,
                    cols);
}

template <typename T>
int launch(const void* x, const void* values, const void* in_idx, void* out, int B, int in_w,
           int O, int K, int bk, int bn, int bt, void* stream) {
  const int n_ctiles = (bn + kTN - 1) / kTN;
  const dim3 grid((B + bt - 1) / bt, O * n_ctiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* vp = static_cast<const T*>(values);
  const int* ip = static_cast<const int*>(in_idx);
  T* op = static_cast<T*>(out);
  switch (bt) {
    case 16:
      bsr_matmul_kernel<T, 16><<<grid, kThreads, 0, s>>>(xp, vp, ip, op, B, in_w, O, K, bk, bn);
      break;
    case 32:
      bsr_matmul_kernel<T, 32><<<grid, kThreads, 0, s>>>(xp, vp, ip, op, B, in_w, O, K, bk, bn);
      break;
    case 64:
      bsr_matmul_kernel<T, 64><<<grid, kThreads, 0, s>>>(xp, vp, ip, op, B, in_w, O, K, bk, bn);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

__global__ void noop_kernel() {}

}  // namespace faust

extern "C" {

int bsr_matmul_f32(const void* x, const void* values, const void* in_idx, void* out, int B,
                   int in_w, int O, int K, int bk, int bn, int bt, void* stream) {
  return faust::launch<float>(x, values, in_idx, out, B, in_w, O, K, bk, bn, bt, stream);
}

int bsr_matmul_bf16(const void* x, const void* values, const void* in_idx, void* out, int B,
                    int in_w, int O, int K, int bk, int bn, int bt, void* stream) {
  return faust::launch<__nv_bfloat16>(x, values, in_idx, out, B, in_w, O, K, bk, bn, bt, stream);
}

// An empty kernel: chip_smoke.py times its launches as the per-launch
// overhead the dispatch cost model prices (t_launch_us).
int launch_noop(void* stream) {
  faust::noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
