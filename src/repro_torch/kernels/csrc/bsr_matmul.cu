// K6: one block-sparse factor, y = x @ F, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_matmul.py:63 bsr_matmul (body
// _bsr_matmul_kernel at :45; grid (batch tiles, output blocks, k) with a VMEM f32
// accumulator carried over the k axis).
//
//   x       (B, IB*bk)      f32 or bf16, row-major
//   values  (O, K, bk, bn)  same dtype as x
//   in_idx  (O, K)          int32, input block gathered by each slot
//   y       (B, O*bn)       x.dtype; y[:, o*bn:(o+1)*bn] = sum_k x[:, in_idx[o,k]*bk:+bk] @ values[o,k]
//
// What bounds it.  2*B*s_tot operations on s_tot weights: bytes at serving
// batches (each weight read once), operations at prefill batches (bf16
// tensor cores, or f32 FFMA at 67e12/s, no TF32).  The first version ran
// plain FFMA from shared memory with synchronous loads: bf16 took 11x one
// torch.matmul on the dense matrix at both B = 128 and 4096.
//
// Design.  One CTA per (batch tile of TM rows, output block o, 128-column
// slice of the block), so at serving batch a small tile still gives many
// CTAs (TM = 16 at B = 128: 128 CTAs for a factor of 16 output blocks),
// and at most a few CTAs share an SM.  The TPU grid's sequential k axis is
// a loop inside the CTA over the K slots (and 128-row pieces of a slot
// when bk > 128): the f32 accumulator stays in registers, nothing crosses
// CTAs, no atomics, and the sum runs in one order.
// - Staging: slot q + 1's activation rows (gathered through in_idx) and
//   value block go into a 2-stage cp.async ring (pipeline.cuh) while slot
//   q computes; shared memory is dynamic, sized from TM.
// - bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate), A by ldmatrix, the
//   value block (k rows, n columns, as stored) by ldmatrix.trans: K1's slot
//   product (pipeline.cuh mma_slot).  f32: full-f32 FFMA with 128-bit
//   shared loads (fma_slot), no TF32.
// - Ragged blocks: bk is zero-padded to a multiple of 16 in shared memory
//   (pad rows and columns are zeroed once, or again where a shorter piece
//   of the slot follows a longer one), a slice narrower than 128 columns
//   leaves the rest of the tile unused; batch rows past B are never stored.
#include "pipeline.cuh"

namespace faust {
namespace bsr {
namespace {

struct Args {
  const void* x;
  const void* values;
  const int* in_idx;
  void* out;
  int B, in_w, O, K, bk, bn, n_kc, vec;
};

template <typename T, int TM>
struct Layout {
  static constexpr int kPitch = kWidth + 16 / (int)sizeof(T);
  static constexpr int kA = TM * kPitch * (int)sizeof(T);      // activation rows
  static constexpr int kB = kWidth * kPitch * (int)sizeof(T);  // up to 128 rows of the value block
  static constexpr int kStage = kA + kB;
  static constexpr int kTotal = 2 * kStage;
};

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads) bsr_matmul_kernel(const __grid_constant__ Args a) {
  using Lay = Layout<T, TM>;
  constexpr int P = Lay::kPitch;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  for (int e = threadIdx.x; e < Lay::kTotal / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n_ctiles = (a.bn + kWidth - 1) / kWidth;
  const int o = blockIdx.y / n_ctiles;
  const int n0 = (blockIdx.y - o * n_ctiles) * kWidth;
  const int b0 = blockIdx.x * TM;
  const int rows = min(TM, a.B - b0);
  const int cols = min(kWidth, a.bn - n0);
  const int n_steps = a.K * a.n_kc;  // (slot, 128-row piece) pairs
  const T* x = static_cast<const T*>(a.x) + (long long)b0 * a.in_w;
  const T* values = static_cast<const T*>(a.values);
  const bool vec = a.vec != 0;
  auto width = [&](int q) { return min(kWidth, a.bk - (q % a.n_kc) * kWidth); };
  auto fetch = [&](int q) {
    const int k = q / a.n_kc, k0 = (q % a.n_kc) * kWidth, w = width(q);
    unsigned char* stage = smem + (q % 2) * Lay::kStage;
    T* sa = reinterpret_cast<T*>(stage);
    T* sb = reinterpret_cast<T*>(stage + Lay::kA);
    const long long slot = (long long)o * a.K + k;
    const int ib = __ldg(a.in_idx + slot);
    stage_rows<T>(sa, 0, P, 1, rows, w, a.in_w, vec, [&](int) { return x + (long long)ib * a.bk + k0; });
    stage_rows<T>(sb, 0, P, 1, w, cols, a.bn, vec,
                  [&](int) { return values + (slot * a.bk + k0) * a.bn + n0; });
    if (w % 16 && a.n_kc > 1) {  // a shorter piece after a longer one: zero its pad band
      const int wp = (w + 15) / 16 * 16;
      for (int e = threadIdx.x; e < TM * (wp - w); e += kThreads) sa[(e / (wp - w)) * P + w + e % (wp - w)] = from_f32<T>(0.f);
      for (int e = threadIdx.x; e < (wp - w) * kWidth; e += kThreads) sb[(w + e / kWidth) * P + e % kWidth] = from_f32<T>(0.f);
    }
  };

  typename std::conditional<kMma, MmaAcc<TM>, FmaAcc<TM>>::type acc;
  if constexpr (kMma) mma_zero<TM>(acc); else fma_zero<TM>(acc);
  fetch(0);
  cp_async_commit();
  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait<0>();
    __syncthreads();  // step q landed; every thread is done with step q - 1's stage
    if (q + 1 < n_steps) fetch(q + 1);
    cp_async_commit();
    const unsigned char* stage = smem + (q % 2) * Lay::kStage;
    const T* sa = reinterpret_cast<const T*>(stage);
    const T* sb = reinterpret_cast<const T*>(stage + Lay::kA);
    const int kdim = (width(q) + 15) / 16 * 16;
    if constexpr (kMma) {
      int gofs[MmaShape<TM>::kCH] = {};
      mma_slot<TM, P>(acc, sa, sb, kdim, gofs);
    } else {
      const int gofs[2] = {0, 0};
      fma_slot<TM, P>(acc, sa, sb, kdim, gofs);
    }
  }
  // flush: rows < rows, columns < cols
  const long long out_w = (long long)a.O * a.bn;
  T* d = static_cast<T*>(a.out) + (long long)b0 * out_w + (long long)o * a.bn + n0;
  if constexpr (kMma) {
    using S = MmaShape<TM>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
      const int c = wn * S::kWN + nt * 8 + 2 * (lane % 4);
      if (c >= cols) continue;
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * S::kWM + mt * 16 + lane / 4 + 8 * hr;
          if (r >= rows) continue;
          const float v0 = acc.v[mt][nt][2 * hr], v1 = acc.v[mt][nt][2 * hr + 1];
          if (vec) {  // bn % 8 == 0 and c even: one 4-byte store
            *reinterpret_cast<__nv_bfloat162*>(d + r * out_w + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            d[r * out_w + c] = from_f32<T>(v0);
            if (c + 1 < cols) d[r * out_w + c + 1] = from_f32<T>(v1);
          }
        }
    }
  } else {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tx * 4 + 64 * h;
      if (c >= cols) continue;
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        if (vec) {  // bn % 4 == 0 and c % 4 == 0: one 16-byte store
          *reinterpret_cast<float4*>(d + r * out_w + c) =
              make_float4(acc.v[i][h][0], acc.v[i][h][1], acc.v[i][h][2], acc.v[i][h][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < cols) d[r * out_w + c + e] = from_f32<T>(acc.v[i][h][e]);
        }
      }
    }
  }
}

template <typename T, int TM>
int run(const Args& a, void* stream) {
  static bool attr_set[64] = {};
  const int smem = Layout<T, TM>::kTotal;
  const cudaError_t e = allow_smem(bsr_matmul_kernel<T, TM>, attr_set, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.B + TM - 1) / TM, a.O * ((a.bn + kWidth - 1) / kWidth));
  bsr_matmul_kernel<T, TM><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int TM>
int resident(int* smem_bytes) {
  static bool attr_set[64] = {};
  static int cache[64][1] = {};
  *smem_bytes = Layout<T, TM>::kTotal;
  return resident_ctas(bsr_matmul_kernel<T, TM>, attr_set, cache, 0, Layout<T, TM>::kTotal, Layout<T, TM>::kTotal);
}

template <typename T>
int launch(const void* x, const void* values, const void* in_idx, void* out, int B, int in_w, int O, int K,
           int bk, int bn, int vec, int bt, void* stream) {
  const Args a{x, values, static_cast<const int*>(in_idx), out, B, in_w, O, K, bk, bn,
               (bk + kWidth - 1) / kWidth, vec};
  switch (bt) {
    case 16: return run<T, 16>(a, stream);
    case 32: return run<T, 32>(a, stream);
    case 64: return run<T, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int ctas(int bt, int* smem_bytes) {
  switch (bt) {
    case 16: return resident<T, 16>(smem_bytes);
    case 32: return resident<T, 32>(smem_bytes);
    case 64: return resident<T, 64>(smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

__global__ void noop_kernel() {}

}  // namespace
}  // namespace bsr
}  // namespace faust

extern "C" {

// vec: 1 when every row the kernel stages or stores is a whole number of
// 16-byte chunks on 16-byte-aligned addresses (kernels/bsr_matmul.py).
// Returns a cudaError_t code.  bsr_matmul_ctas_*: resident CTAs of the
// kernel at this tile, and its dynamic shared memory (negative: error).
int bsr_matmul_f32(const void* x, const void* values, const void* in_idx, void* out, int B, int in_w, int O,
                   int K, int bk, int bn, int vec, int bt, void* stream) {
  return faust::bsr::launch<float>(x, values, in_idx, out, B, in_w, O, K, bk, bn, vec, bt, stream);
}

int bsr_matmul_bf16(const void* x, const void* values, const void* in_idx, void* out, int B, int in_w, int O,
                    int K, int bk, int bn, int vec, int bt, void* stream) {
  return faust::bsr::launch<__nv_bfloat16>(x, values, in_idx, out, B, in_w, O, K, bk, bn, vec, bt, stream);
}

int bsr_matmul_ctas_f32(int bt, int* smem_bytes) { return faust::bsr::ctas<float>(bt, smem_bytes); }
int bsr_matmul_ctas_bf16(int bt, int* smem_bytes) { return faust::bsr::ctas<__nv_bfloat16>(bt, smem_bytes); }

// An empty kernel: chip_smoke.py times its launches as the per-launch
// overhead the dispatch cost model prices (t_launch_us).
int launch_noop(void* stream) {
  faust::bsr::noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
