// K3: the packed-values gradient of the FAuST chain, dvalues[s] = a_j^T g_j
// for every stored block, on Hopper (sm_90a), and K5's wgrad half: the same
// over a quantized chain (int8 / fp8 codes with f32 row scales), where the
// gradient is taken with respect to the dequantized f32 values.
//
// K3 replaces the TPU kernel repro/kernels/chain_bwd.py:433 chain_wgrad
// (body _wgrad_kernel at :355: grid (batch tiles, S_pre + S steps) in
// order; a forward recompute of factors 1..J-1 into a flat VMEM scratch,
// then a reversed cotangent walk that emits one (blk, blk) block per step
// into a per-batch-tile partial slab, the slabs summed outside).  K5's wgrad
// half replaces the same function called with scales= (the streamed block
// dequantized at chain_bwd.py:370).
//
//   x       (B, IB_1*blk)      f32 or bf16, the padded forward input
//   dy      (B, O_J*blk)       x's dtype, the cotangent of the padded output
//   values  (S, blk, blk)      x's dtype, or int8 / fp8 e4m3 / fp8 e5m2 codes
//   scales  (S, blk) or (S,)   codes only: f32 scale of each stored block row, or
//                              of each block (the recompute's; the walk takes
//                              them as rows, wscales (S, blk))
//   meta    (S_pre + S, 7)     int32 two-phase table (chain_bwd.py wgrad_meta):
//     recompute rows: in_blk, out_blk, is_k0, is_kend, ncols, act_off_in, act_off_out
//     walk rows:      dst_blk, src_blk, parity, is_j0, ncols, act_off_j, propagate
//   ptr, steps                 the transposed step table (chain_bwd.py dgrad_gather)
//   act     (B, aw)            x's dtype: the input activations of factors 2..J
//   cot     (B, aw)            x's dtype: the cotangents of those same activations
//   dvalues (S, blk, blk)      f32
//
// What bounds it.  The recompute, the walk and the emission do
// 2*B*(s_1 + ... + s_{J-1}) + 2*B*(s_2 + ... + s_J) + 2*B*s_tot operations
// (f32 FFMA at 67e12/s, or bf16 tensor cores) on the bytes of x, dy, the
// weights and dvalues.  The first version walked every step with one CTA
// per batch tile (8 CTAs at B = 128 on the gemma-2b up-projection, 64 at
// the FAuST unembedding's 64,512 steps) and emitted with one CTA per stored
// block: its time followed the walk's length, not its work.
//
// Design.  No per-batch-tile partial slabs (one (S, blk, blk) f32 slab per
// tile: 11.3 GB at the up-projection, B = 4096, bt 16): every intermediate
// goes to its own region of a workspace, then one pass emits each block
// summed over the whole batch.  Three launches, each on the card's own
// schedule:
//   1. recompute, factors 1..J-1: K1's persistent cooperative factor loop
//      (chain_fwd.cuh; items (batch tile, column group of 128/blkp output
//      blocks), a grid barrier between factors), factor j writing its
//      output to act's region of factor j + 1's input, tails >= ncols
//      zeroed.  K5 runs K4's loop: codes staged and converted per slot,
//      bf16 x with the f32 scaled activations split in two bf16 halves, so
//      the code stays exact and nothing rounds x*s (chain_matmul.cu (3)).
//   2. reversed walk, factors J..2: K2's gather schedule (chain_dgrad.cuh;
//      items (batch tile, group of input blocks, chunk of their reader
//      lists) over the transposed step table, reader lists split where
//      items are fewer than half the resident CTAs), factor j writing the
//      cotangent of its input to cot's region of it.  The walk stops before
//      factor 1: dx is K2's job.  K5 dequantizes the codes once per launch.
//   3. emission, one plain launch: dvalues[s] = A[:, in_blk]^T G[:, out_blk]
//      with A the factor's input (x for factor 1) and G its output
//      cotangent (dy for factor J), summed over the batch, columns >= ncols
//      written as 0 (masking G's columns masks dvalues' columns).  An item
//      is (column group of `group` = 128/blkp output blocks, slot k, chunk
//      of the batch): the group's G columns form one 128-wide tile and each
//      output block's slot-k input block sits beside it in the A tile, so
//      at block 16 one item computes 8 stored blocks.  Batch rows stream
//      through a 2-stage cp.async ring (rows past B zero-filled).  bf16:
//      mma.sync.m16n8k16 with the batch as the reduction dimension, A^T by
//      ldmatrix.trans from the staged rows, G by ldmatrix.trans as K1's
//      values; f32: FFMA, 4-row by 4-column runs from 128-bit shared loads.
//      Where the items are fewer than the emission's resident CTAs, the
//      batch is cut into chunks: each writes an f32 partial of its blocks,
//      and a fourth launch adds the partials in chunk order.
// Determinism: no atomics; every sum runs in one order (K1's slots, K2's
// ascending readers and chunks, the emission's batch rows and chunks), so
// repeats give the same bits.
// Numerics: f32 accumulation everywhere.  f32: act, cot and the products
// stay f32 (the plain version's numbers to summation order, 1e-5*max|dv|).
// bf16: act and cot are stored in bf16 and taken as MMA operands, as K1
// and K2 keep their intermediates in x's dtype, where the reference keeps
// them in f32 (the VMEM scratch at chain_bwd.py:507-509): within the bf16
// tolerance 3e-2*max|dv| (PERF.md gives the measured error).
#define FAUST_FWD_NS wgrad_fwd  // profiles name K3's launches apart from K1's and K2's
#define FAUST_BWD_NS wgrad_bwd
#include "chain_dgrad.cuh"
#include "chain_fwd.cuh"

namespace faust {
namespace wgrad {
namespace {

constexpr int kMaxFactors = 64;

struct EmitArgs {
  const int* meta;  // the walk rows: in_blk (column 0), ncols (column 4) of flat step s at row S-1-s
  float* out;       // dvalues (S, blk, blk), or the chunks' partials (chunks, S, blk, blk)
  int B, S, blk, blkp, group, vec, n_factors, meta_cols, chunks, chunk_rows;
  int off[kMaxFactors], nout[kMaxFactors], nk[kMaxFactors], ngroups[kMaxFactors];
  int item0[kMaxFactors + 1];  // the first item of each factor
  const void* a_src[kMaxFactors];  // factor j's input activation (x for j = 0)
  const void* g_src[kMaxFactors];  // the cotangent of factor j's output (dy for j = J-1)
  int lda[kMaxFactors], ldg[kMaxFactors];
};

// Batch rows per stage, row pitch (16 bytes of padding, as K1's tiles) and
// sizes: an A tile and a G tile per stage, two stages (f32 66 KB, bf16 68 KB).
template <typename T>
struct EmitLayout {
  static constexpr int kRows = sizeof(T) == 4 ? 32 : 64;
  static constexpr int kPitch = kWidth + 16 / (int)sizeof(T);
  static constexpr int kTile = kRows * kPitch * (int)sizeof(T);
  static constexpr int kStage = 2 * kTile;
  static constexpr int kTotal = 2 * kStage;
};

// FFMA rows of the emission tile: thread (ty, tx) owns R = MP/16 rows, as
// runs of 4 (4ty + 64u) when R >= 4, else R consecutive rows (R*ty).
template <int MP>
__device__ __forceinline__ int emit_row(int i) {
  constexpr int R = MP / 16;
  const int ty = threadIdx.x / 16;
  return R >= 4 ? 4 * ty + 64 * (i / 4) + i % 4 : R * ty + i;
}

template <typename T, int MP>
__global__ void __launch_bounds__(kThreads) wgrad_emit_kernel(const __grid_constant__ EmitArgs a) {
  using Lay = EmitLayout<T>;
  constexpr int P = Lay::kPitch, KB = Lay::kRows;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_step[kWidth / 16], s_in[kWidth / 16], s_nc[kWidth / 16];
  for (int e = threadIdx.x; e < Lay::kTotal / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);

  // the item: factor j, column group, slot k, batch chunk c
  const int it = blockIdx.x;
  int j = 0;
  while (j + 1 < a.n_factors && a.item0[j + 1] <= it) ++j;
  const int local = it - a.item0[j];
  const int c = local % a.chunks, rest = local / a.chunks;
  const int K = a.nk[j], k = rest % K, grp = rest / K;
  const int blk = a.blk, blkp = a.blkp, o0 = grp * a.group, gv = min(a.group, a.nout[j] - o0);
  const int r0 = c * a.chunk_rows, r1 = min(a.B, r0 + a.chunk_rows);
  if ((int)threadIdx.x < gv) {
    const int s = a.off[j] + (o0 + threadIdx.x) * K + k;
    const int* m = a.meta + (long long)(a.S - 1 - s) * a.meta_cols;
    s_step[threadIdx.x] = s;
    s_in[threadIdx.x] = __ldg(m);
    s_nc[threadIdx.x] = __ldg(m + 4);
  }
  __syncthreads();

  const T* A = static_cast<const T*>(a.a_src[j]);
  const T* G = static_cast<const T*>(a.g_src[j]);
  const long long lda = a.lda[j], ldg = a.ldg[j];
  const bool vec = a.vec != 0;
  const int n_sub = r1 > r0 ? (r1 - r0 + KB - 1) / KB : 0;
  auto fetch = [&](int t) {
    const int row0 = r0 + t * KB, nrows = min(KB, r1 - row0);
    T* sa = reinterpret_cast<T*>(smem + (t % 2) * Lay::kStage);
    T* sg = sa + KB * P;
    stage_rows<T>(sa, blkp, P, gv, nrows, blk, lda, vec,
                  [&](int g) { return A + (long long)row0 * lda + (long long)s_in[g] * blk; });
    stage_rows<T>(sg, blkp, P, gv, nrows, blk, ldg, vec,
                  [&](int g) { return G + (long long)row0 * ldg + (long long)(o0 + g) * blk; });
    for (int e = threadIdx.x; e < (KB - nrows) * P; e += kThreads) {  // rows past the chunk sum as 0
      sa[nrows * P + e] = from_f32<T>(0.f);
      sg[nrows * P + e] = from_f32<T>(0.f);
    }
  };

  const int live_w = a.group * blkp;
  float* out = a.out + (a.chunks > 1 ? (long long)c * a.S * blk * blk : 0);
  if (n_sub > 0) fetch(0);
  cp_async_commit();
  if constexpr (kMma) {
    using S = MmaShape<MP>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
    // A^T by ldmatrix.trans: matrix i of x4 is (rows k0 + 8*(i/2).., columns m0 + 8*(i%2)..)
    const int krow = (lane / 16) * 8 + lane % 8, mcol = ((lane / 8) % 2) * 8 + wm * S::kWM;
    const int brow = lane % 16, bcol = wn * S::kWN + (lane / 16) * 8;
    int gofs[S::kCH];
#pragma unroll
    for (int ch = 0; ch < S::kCH; ++ch) {
      const int col = wn * S::kWN + ch * 16, g = col / blkp;
      gofs[ch] = col < live_w && g < gv ? g * blkp : 0;
    }
    MmaAcc<MP> acc;
    mma_zero<MP>(acc);
    for (int t = 0; t < n_sub; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // sub-tile t landed; every thread is done with t - 1's stage
      if (t + 1 < n_sub) fetch(t + 1);
      cp_async_commit();
      const T* sa = reinterpret_cast<const T*>(smem + (t % 2) * Lay::kStage);
      const T* sg = sa + KB * P;
#pragma unroll 2
      for (int kk = 0; kk < KB; kk += 16) {
        uint32_t af[S::kMT][S::kCH][4];
#pragma unroll
        for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
          for (int ch = 0; ch < S::kCH; ++ch) {
            if (ch > 0 && gofs[ch] == gofs[ch - 1]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) af[mt][ch][e] = af[mt][ch - 1][e];
            } else {
              ldsm_x4_t(af[mt][ch], sa + (kk + krow) * P + gofs[ch] + mcol + mt * 16);
            }
          }
#pragma unroll
        for (int np = 0; np < S::kNT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, sg + (kk + brow) * P + bcol + np * 16);
#pragma unroll
          for (int mt = 0; mt < S::kMT; ++mt) {
            mma_bf16(acc.v[mt][2 * np], af[mt][np], bf[0], bf[1]);
            mma_bf16(acc.v[mt][2 * np + 1], af[mt][np], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
      const int col = wn * S::kWN + nt * 8 + 2 * (lane % 4);
      const int g = col / blkp, n = col - g * blkp;
      if (col >= live_w || g >= gv || n >= blk) continue;
      float* d = out + (long long)s_step[g] * blk * blk + n;
      const int nc = s_nc[g];
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = wm * S::kWM + mt * 16 + lane / 4 + 8 * hr;
          if (m >= blk) continue;
          d[m * blk] = n < nc ? acc.v[mt][nt][2 * hr] : 0.f;
          if (n + 1 < blk) d[m * blk + 1] = n + 1 < nc ? acc.v[mt][nt][2 * hr + 1] : 0.f;
        }
    }
  } else {
    constexpr int R = MP / 16;
    const int tx = threadIdx.x % 16;
    int gofs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 4 * tx + 64 * h, g = col / blkp;
      gofs[h] = col < live_w && g < gv ? g * blkp : 0;
    }
    float acc[R][2][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
    for (int t = 0; t < n_sub; ++t) {
      cp_async_wait<0>();
      __syncthreads();
      if (t + 1 < n_sub) fetch(t + 1);
      cp_async_commit();
      const float* sa = reinterpret_cast<const float*>(smem + (t % 2) * Lay::kStage);
      const float* sg = sa + KB * P;
#pragma unroll 4
      for (int b = 0; b < KB; ++b) {
        const float* arow = sa + b * P;
        float4 gq[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) gq[h] = *reinterpret_cast<const float4*>(sg + b * P + 4 * tx + 64 * h);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float av[R];
          if constexpr (R >= 4) {
#pragma unroll
            for (int u = 0; u < R / 4; ++u) {
              const float4 q = *reinterpret_cast<const float4*>(arow + gofs[h] + emit_row<MP>(4 * u));
              av[4 * u] = q.x, av[4 * u + 1] = q.y, av[4 * u + 2] = q.z, av[4 * u + 3] = q.w;
            }
          } else if constexpr (R == 2) {
            const float2 q = *reinterpret_cast<const float2*>(arow + gofs[h] + emit_row<MP>(0));
            av[0] = q.x, av[1] = q.y;
          } else {
            av[0] = arow[gofs[h] + emit_row<MP>(0)];
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][h][0] = fmaf(av[i], gq[h].x, acc[i][h][0]);
            acc[i][h][1] = fmaf(av[i], gq[h].y, acc[i][h][1]);
            acc[i][h][2] = fmaf(av[i], gq[h].z, acc[i][h][2]);
            acc[i][h][3] = fmaf(av[i], gq[h].w, acc[i][h][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 4 * tx + 64 * h, g = col / blkp, n = col - g * blkp;
      if (col >= live_w || g >= gv || n >= blk) continue;
      float* d = out + (long long)s_step[g] * blk * blk + n;
      const int nc = s_nc[g];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = emit_row<MP>(i);
        if (m >= blk) continue;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = n + e < nc ? acc[i][h][e] : 0.f;
        if (blk % 4 == 0) {  // n % 4 == 0: one 16-byte store
          *reinterpret_cast<float4*>(d + m * blk) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < blk) d[m * blk + e] = v[e];
        }
      }
    }
  }
}

// dvalues = the chunks' partials added in chunk order.
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(const float* __restrict__ part,
                                                                float* __restrict__ out, long long n, int chunks) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int c = 0; c < chunks; ++c) v += part[c * n + e];
    out[e] = v;
  }
}

template <typename T, int MP>
int emit_resident(int* smem_bytes) {
  static bool attr_set[64] = {};
  static int cache[64][1] = {};
  *smem_bytes = EmitLayout<T>::kTotal;
  return resident_ctas(wgrad_emit_kernel<T, MP>, attr_set, cache, 0, EmitLayout<T>::kTotal, EmitLayout<T>::kTotal);
}

template <typename T>
int emit_ctas(int blkp, int* smem_bytes) {
  if (blkp <= 16) return emit_resident<T, 16>(smem_bytes);
  if (blkp <= 32) return emit_resident<T, 32>(smem_bytes);
  if (blkp <= 64) return emit_resident<T, 64>(smem_bytes);
  return emit_resident<T, 128>(smem_bytes);
}

template <typename T, int MP>
int emit_run(const EmitArgs& a, int items, void* stream) {
  static bool attr_set[64] = {};
  const cudaError_t e = allow_smem(wgrad_emit_kernel<T, MP>, attr_set, EmitLayout<T>::kTotal);
  if (e != cudaSuccess) return (int)e;
  wgrad_emit_kernel<T, MP><<<items, kThreads, EmitLayout<T>::kTotal, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int emit(const EmitArgs& a, int items, void* stream) {
  if (a.blkp <= 16) return emit_run<T, 16>(a, items, stream);
  if (a.blkp <= 32) return emit_run<T, 32>(a, items, stream);
  if (a.blkp <= 64) return emit_run<T, 64>(a, items, stream);
  return emit_run<T, 128>(a, items, stream);
}

// ftab: host (J, 4) K1 factor table (step offset, out blocks, slots, column
// groups); dtab: host (J, 4) dgrad schedule (block base, input blocks,
// groups, chunks); actoff: host (J + 1) block offsets of each factor's
// input in the flat activation layout (factor 1's at 0).
template <typename T, typename V>
int wgrad(const void* x, const void* dy, const void* values, const float* scales, const float* wscales,
          const void* meta, const void* ptr, const void* steps, const int* ftab, const int* dtab, const int* actoff,
          void* act, void* cot, void* deq, void* part, void* epart, void* dvalues, int J, int B, int S, int s_pre,
          int blk, int blkp, int group, int aw, int vec, int row_scales, int bt, int walk_items, int chunks,
          int chunk_rows, void* stream) {
  if (J < 1 || J > kMaxFactors || chunks < 1) return (int)cudaErrorInvalidValue;
  const int ib0 = actoff[1];
  const int in_w = ib0 * blk, out_w = ftab[4 * (J - 1) + 1] * blk;
  const int* mt = static_cast<const int*>(meta);
  T* act_t = static_cast<T*>(act);
  T* cot_t = static_cast<T*>(cot);
  auto region = [&](T* base, int j) { return base + (long long)(actoff[j] - ib0) * blk; };  // factor j's input
  if (J > 1) {
    wgrad_fwd::Args fa;
    if (!wgrad_fwd::set_factors(fa, ftab, J - 1)) return (int)cudaErrorInvalidValue;
    fa.values = values;
    fa.scales = scales;
    fa.meta = mt;
    fa.meta_cols = 7;
    fa.ncols_col = 4;
    fa.row_scales = row_scales;
    fa.B = B;
    fa.blk = blk;
    fa.blkp = blkp;
    fa.group = group;
    fa.vec = vec;
    int max_groups = 0;
    for (int j = 0; j < J - 1; ++j) {
      fa.src[j] = j == 0 ? x : static_cast<const void*>(region(act_t, j));
      fa.lda[j] = j == 0 ? in_w : aw;
      fa.dst[j] = region(act_t, j + 1);
      fa.ldd[j] = aw;
      max_groups = max(max_groups, fa.ngroups[j]);
    }
    int rc = wgrad_fwd::launch<T, V>(fa, bt, ((B + bt - 1) / bt) * max_groups, stream);
    if (rc != 0) return rc;

    wgrad_bwd::Args ba;
    if (!wgrad_bwd::set_factors(ba, dtab, J)) return (int)cudaErrorInvalidValue;
    ba.values = values;
    ba.scales = wscales;
    ba.meta = mt + (long long)s_pre * 7;
    ba.ptr = static_cast<const int*>(ptr);
    ba.steps = static_cast<const int*>(steps);
    ba.deq = deq;
    ba.part = static_cast<float*>(part);
    ba.B = B;
    ba.S = S;
    ba.blk = blk;
    ba.blkp = blkp;
    ba.group = group;
    ba.vec = vec;
    ba.j_lo = 1;
    ba.meta_cols = 7;
    for (int j = 1; j < J; ++j) {
      ba.src[j] = j == J - 1 ? dy : static_cast<const void*>(region(cot_t, j + 1));
      ba.lda[j] = j == J - 1 ? out_w : aw;
      ba.dst[j] = region(cot_t, j);
      ba.ldd[j] = aw;
    }
    rc = wgrad_bwd::launch<T, V>(ba, bt, walk_items, stream);
    if (rc != 0) return rc;
  }
  EmitArgs ea;
  ea.meta = mt + (long long)s_pre * 7;
  ea.out = static_cast<float*>(chunks > 1 ? epart : dvalues);
  ea.B = B;
  ea.S = S;
  ea.blk = blk;
  ea.blkp = blkp;
  ea.group = group;
  ea.vec = vec;
  ea.n_factors = J;
  ea.meta_cols = 7;
  ea.chunks = chunks;
  ea.chunk_rows = chunk_rows;
  ea.item0[0] = 0;
  for (int j = 0; j < J; ++j) {
    ea.off[j] = ftab[4 * j];
    ea.nout[j] = ftab[4 * j + 1];
    ea.nk[j] = ftab[4 * j + 2];
    ea.ngroups[j] = ftab[4 * j + 3];
    ea.item0[j + 1] = ea.item0[j] + ea.ngroups[j] * ea.nk[j] * chunks;
    ea.a_src[j] = j == 0 ? x : static_cast<const void*>(region(act_t, j));
    ea.lda[j] = j == 0 ? in_w : aw;
    ea.g_src[j] = j == J - 1 ? dy : static_cast<const void*>(region(cot_t, j + 1));
    ea.ldg[j] = j == J - 1 ? out_w : aw;
  }
  int rc = emit<T>(ea, ea.item0[J], stream);
  if (rc != 0 || chunks == 1) return rc;
  const long long n = (long long)S * blk * blk;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  wgrad_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(epart), static_cast<float*>(dvalues), n, chunks);
  return (int)cudaGetLastError();
}

// Resident CTAs of the three launches at this block and tile: out[0..2] the
// recompute's, the walk's and the emission's, out[3..5] their dynamic
// shared memory.  Returns 0 or an error code.
template <typename T, typename V>
int ctas(int blkp, int bt, int* out) {
  out[0] = wgrad_fwd::ctas<T, V>(blkp, bt, out + 3);
  out[1] = wgrad_bwd::ctas<T, V>(blkp, bt, out + 4);
  out[2] = emit_ctas<T>(blkp, out + 5);
  for (int i = 0; i < 3; ++i)
    if (out[i] <= 0) return out[i] < 0 ? -out[i] : (int)cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace
}  // namespace wgrad
}  // namespace faust

extern "C" {

// walk_items: the most work items of the walked factors (the walk's grid
// never exceeds it); part: the walk's f32 partials (chain_dgrad.cu); epart:
// (chunks, S, blk, blk) f32 partials of the emission when chunks > 1.
// Returns a cudaError_t code.  chain_wgrad_ctas_*: out[0..2] the resident
// CTAs of the recompute, the walk and the emission, out[3..5] their dynamic
// shared memory; returns 0 or an error code.

// K3: values in x's dtype.
#define FAUST_WGRAD(suffix, T)                                                                                     \
  int chain_wgrad_##suffix(const void* x, const void* dy, const void* values, const void* meta, const void* ptr,   \
                           const void* steps, const void* ftab, const void* dtab, const void* actoff, void* act,   \
                           void* cot, void* part, void* epart, void* dvalues, int J, int B, int S, int s_pre,      \
                           int blk, int blkp, int group, int aw, int vec, int bt, int walk_items, int chunks,      \
                           int chunk_rows, void* stream) {                                                         \
    return faust::wgrad::wgrad<T, T>(x, dy, values, nullptr, nullptr, meta, ptr, steps,                            \
                                     static_cast<const int*>(ftab), static_cast<const int*>(dtab),                 \
                                     static_cast<const int*>(actoff), act, cot, nullptr, part, epart, dvalues, J,  \
                                     B, S, s_pre, blk, blkp, group, aw, vec, 0, bt, walk_items, chunks, chunk_rows, \
                                     stream);                                                                      \
  }                                                                                                                \
  int chain_wgrad_ctas_##suffix(int blkp, int bt, int* out) { return faust::wgrad::ctas<T, T>(blkp, bt, out); }

// K5 (wgrad): int8 / fp8 codes with f32 scales (S, blk), one per block row,
// when row_scales, else (S,), one per block; wscales: the same as (S, blk)
// rows for the walk; deq: (S, blk, blk) in x's dtype for the walk's
// dequantized codes.
#define FAUST_WGRAD_Q(suffix, T, V)                                                                                 \
  int chain_wgrad_q_##suffix(const void* x, const void* dy, const void* values, const void* scales,                \
                             const void* wscales, const void* meta, const void* ptr, const void* steps,            \
                             const void* ftab, const void* dtab, const void* actoff, void* act, void* cot,         \
                             void* deq, void* part, void* epart, void* dvalues, int J, int B, int S, int s_pre,    \
                             int blk, int blkp, int group, int aw, int vec, int row_scales, int bt,                \
                             int walk_items, int chunks, int chunk_rows, void* stream) {                           \
    return faust::wgrad::wgrad<T, V>(x, dy, values, static_cast<const float*>(scales),                             \
                                     static_cast<const float*>(wscales), meta, ptr, steps,                         \
                                     static_cast<const int*>(ftab), static_cast<const int*>(dtab),                 \
                                     static_cast<const int*>(actoff), act, cot, deq, part, epart, dvalues, J, B,   \
                                     S, s_pre, blk, blkp, group, aw, vec, row_scales, bt, walk_items, chunks,      \
                                     chunk_rows, stream);                                                          \
  }                                                                                                                 \
  int chain_wgrad_ctas_q_##suffix(int blkp, int bt, int* out) { return faust::wgrad::ctas<T, V>(blkp, bt, out); }

#if FAUST_IN_PART(0)
FAUST_WGRAD(f32, float)
#endif
#if FAUST_IN_PART(1)
FAUST_WGRAD(bf16, __nv_bfloat16)
#endif
#if FAUST_IN_PART(2)
FAUST_WGRAD_Q(f32_int8, float, int8_t)
#endif
#if FAUST_IN_PART(3)
FAUST_WGRAD_Q(f32_e4m3, float, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(4)
FAUST_WGRAD_Q(f32_e5m2, float, __nv_fp8_e5m2)
#endif
#if FAUST_IN_PART(5)
FAUST_WGRAD_Q(bf16_int8, __nv_bfloat16, int8_t)
#endif
#if FAUST_IN_PART(6)
FAUST_WGRAD_Q(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(7)
FAUST_WGRAD_Q(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)
#endif

}  // extern "C"
