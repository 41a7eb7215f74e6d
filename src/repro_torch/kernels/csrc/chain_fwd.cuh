// The persistent forward walk of a FAuST chain: K1 (chain_matmul.cu, y = x
// @ F_1 @ ... @ F_J in one launch), K4 (the same over int8 / fp8 codes with
// f32 row scales) and K3's forward recompute (chain_wgrad.cu: factors
// 1..J-1, every output kept).  Design notes (1)-(4) are in chain_matmul.cu.
//
// A launch walks n_factors factors; factor j reads src[j] (row stride
// lda[j]) and writes dst[j] (row stride ldd[j]): K1 gives x, a ping-pong
// workspace and y; K3 gives x and one region of its activation workspace
// per factor.  The step table `meta` has meta_cols columns per flat step:
// the input block in column 0, the flushed block's valid columns in column
// ncols_col.
#pragma once

#include <cooperative_groups.h>

#include "pipeline.cuh"

// The namespace of this walk's code: K3 (chain_wgrad.cu) names its own, so
// a profile tells its recompute from K1 by the kernel's name.
#ifndef FAUST_FWD_NS
#define FAUST_FWD_NS fwd
#endif

namespace faust {
namespace FAUST_FWD_NS {
namespace {  // internal linkage: each built library keeps its own launch state

namespace cg = cooperative_groups;

constexpr int kMaxFactors = 64;

struct Args {
  const void* values;
  const float* scales;
  const int* meta;
  int B, blk, blkp, group, vec, n_factors, meta_cols, ncols_col;
  int row_scales;  // K4: scales (S, blk), one per block row; else (S,), one per block
  int off[kMaxFactors], nout[kMaxFactors], nk[kMaxFactors], ngroups[kMaxFactors];
  const void* src[kMaxFactors];
  void* dst[kMaxFactors];
  int lda[kMaxFactors], ldd[kMaxFactors];
};

// Shared-memory layout, in bytes, for activation type T, stored type V,
// TM batch rows and padded block blkp.  Rows of a tile are kPitch elements
// apart: 16 bytes of padding, so the 8 rows an ldmatrix reads fall in
// different banks and a row stays 16-byte aligned.
// Two stages (NS): at the largest tile (bt 64, block 128) a bf16 CTA then
// needs 104 KB and two fit on an SM, so one CTA's MMA overlaps the other's
// barrier and staging; on the H100 that beat three stages at one CTA per
// SM (K1 bf16, B = 4096).  An f32 CTA needs up to 203 KB and runs alone,
// FFMA-bound.
template <typename T, typename V, int TM>
struct Layout {
  static constexpr bool kCode = is_code<V>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStages = 2;
  static constexpr int kPitch = kWidth + 16 / (int)sizeof(T);
  int a, b, sc, stage, bc, total;  // sizes (a, b, sc, stage) and the offset bc
  __host__ __device__ explicit Layout(int blkp) {
    a = TM * kPitch * (int)sizeof(T);                            // activations
    b = kCode ? kWidth * blkp : blkp * kPitch * (int)sizeof(T);  // K1 values / K4 codes (flat)
    sc = kCode ? kWidth * 4 : 0;                                 // K4 scales (row or block)
    stage = a + b + sc;
    bc = kStages * stage;  // K4: converted values
    total = bc + (kCode ? blkp * kPitch * (int)sizeof(T) : 0);
  }
};

// Position of work item `it` of a factor: batch tile and column group.
struct Item {
  int b0, rows, o0, gv;
};
template <int TM>
__device__ __forceinline__ Item item_at(int it, int n_tiles, int B, int group, int O) {
  Item m;
  const int grp = it / n_tiles;
  m.b0 = (it - grp * n_tiles) * TM;
  m.rows = min(TM, B - m.b0);
  m.o0 = grp * group;
  m.gv = min(group, O - m.o0);
  return m;
}

// Fetch slot k of item m into one ring stage.
template <typename T, typename V, int TM>
__device__ __forceinline__ void fetch(const Args& a, const Layout<T, V, TM>& L, unsigned char* stage,
                                      const T* src, long long lda, int off, int K, const Item& m,
                                      int k) {
  using Lay = Layout<T, V, TM>;
  const int blk = a.blk, blkp = a.blkp;
  const bool vec = a.vec != 0;
  const int* meta = a.meta;
  auto step = [&](int g) { return off + (m.o0 + g) * K + k; };
  stage_rows<T>(reinterpret_cast<T*>(stage), blkp, Lay::kPitch, m.gv, m.rows, blk, lda, vec,
                [&](int g) { return src + (long long)m.b0 * lda + (long long)__ldg(meta + (long long)step(g) * a.meta_cols) * blk; });
  const V* values = static_cast<const V*>(a.values);
  if constexpr (Lay::kCode) {
    // codes as flat blk*blk runs, scales as blk floats (or one) per group
    stage_rows<V>(reinterpret_cast<V*>(stage + L.a), blk * blk, 0, m.gv, 1, blk * blk, 0, vec,
                  [&](int g) { return values + (long long)step(g) * blk * blk; });
    float* sc = reinterpret_cast<float*>(stage + L.a + L.b);
    if (a.row_scales) {
      stage_rows<float>(sc, blk, 0, m.gv, 1, blk, 0, vec, [&](int g) { return a.scales + (long long)step(g) * blk; });
    } else if ((int)threadIdx.x < m.gv) {  // the stage is idle until the barrier before its compute
      sc[threadIdx.x] = __ldg(a.scales + step(threadIdx.x));
    }
  } else {
    stage_rows<V>(reinterpret_cast<V*>(stage + L.a), blkp, Lay::kPitch, m.gv, blk, blk, blk, vec,
                  [&](int g) { return values + (long long)step(g) * blk * blk; });
  }
}

// K4: codes of one stage into the compute tile.  f32 x: value = code *
// scale, the plain version's f32 product.  bf16 x: the code as bf16
// (exact); the scale applies to x (row scales, mma_slot_scaled) or to the
// MMA partial (block scales).
template <typename T, typename V, int TM>
__device__ __forceinline__ void convert(const Args& a, const Layout<T, V, TM>& L, unsigned char* smem,
                                        unsigned char* stage, const Item& m) {
  using Lay = Layout<T, V, TM>;
  constexpr int P = Lay::kPitch;
  const int blk = a.blk, blkp = a.blkp, bb = blk * blk;
  const V* codes = reinterpret_cast<const V*>(stage + L.a);
  const float* sc = reinterpret_cast<const float*>(stage + L.a + L.b);
  T* bc = reinterpret_cast<T*>(smem + L.bc);
  if (a.vec) {  // kW codes of one row per thread, one load, one 16-byte store
    // (bf16 x: blk % 8 == 0, 8 codes; f32 x: blk % 4 == 0, 4 codes)
    constexpr int kW = Lay::kMma ? 8 : 4;
    using Word = typename std::conditional<Lay::kMma, uint2, unsigned>::type;
    // thread: a fixed kW-column chunk n of the gv*blk value rows, every rpp-th row
    const int qw = blk / kW, rpp = kThreads / qw, r0 = threadIdx.x / qw, n = (threadIdx.x - r0 * qw) * kW;
    if (r0 < rpp) {
      int g = r0 / blk, kk = r0 - g * blk;
      while (g < m.gv) {
        const Word word = *reinterpret_cast<const Word*>(codes + g * bb + kk * blk + n);
        V cw[kW];
        memcpy(cw, &word, kW);
        T* d = bc + kk * P + g * blkp + n;
        if constexpr (Lay::kMma) {
          __nv_bfloat162 h[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(to_f32(cw[2 * u]), to_f32(cw[2 * u + 1]));
          uint4 out;
          memcpy(&out, h, 16);
          *reinterpret_cast<uint4*>(d) = out;
        } else {
          const float sv = a.row_scales ? sc[g * blk + kk] : sc[g];
          *reinterpret_cast<float4*>(d) =
              make_float4(to_f32(cw[0]) * sv, to_f32(cw[1]) * sv, to_f32(cw[2]) * sv, to_f32(cw[3]) * sv);
        }
        for (kk += rpp; kk >= blk; kk -= blk) ++g;
      }
    }
  } else {
    for (int e = threadIdx.x; e < m.gv * bb; e += kThreads) {
      const int g = e / bb, rem = e - g * bb, kk = rem / blk, n = rem - kk * blk;
      const float q = to_f32(codes[e]);
      if constexpr (Lay::kMma) {
        bc[kk * P + g * blkp + n] = __float2bfloat16(q);
      } else {
        bc[kk * P + g * blkp + n] = q * (a.row_scales ? sc[g * blk + kk] : sc[g]);
      }
    }
  }
}

// K4 bf16 with row scales, one slot: acc += hi @ q and part += mid @ q +
// lo @ q, where hi + mid + lo = p = x * s (the f32 product of an
// activation and its column's row scale) exactly: each part keeps the top
// 8 significant bits of what is left (truncation, so the remainders are
// exact in f32 and the last one has at most 8 bits).  The split runs in
// registers on each A fragment as ldmatrix gives it (thread lane holds
// rows lane/4 (+8) and columns 2*(lane%4) (+1, +8, +9) of a 16 x 16 tile),
// so the activation tile stays as staged.  sc: the slot's scale rows, group
// g's at sc + g*blk; a padded column (x = 0) reads a neighbour's scale.
template <int TM, int P>
__device__ __forceinline__ void mma_slot_scaled(MmaAcc<TM>& acc, MmaAcc<TM>& part, const __nv_bfloat16* sa,
                                                const __nv_bfloat16* sb, const float* sc, int kdim, int blk,
                                                int blkp, const int (&gofs)[MmaShape<TM>::kCH]) {
  using S = MmaShape<TM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int arow = wm * S::kWM + (lane % 16), acol = (lane / 16) * 8;
  const int brow = lane % 16, bcol = wn * S::kWN + (lane / 16) * 8;
  const int kq = 2 * (lane % 4);
  for (int kk = 0; kk < kdim; kk += 16) {
    uint32_t bf[S::kNT / 2][4];
#pragma unroll
    for (int np = 0; np < S::kNT / 2; ++np) ldsm_x4_t(bf[np], sb + (kk + brow) * P + bcol + np * 16);
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt) {
      uint32_t pf[3][4];  // hi, mid, lo fragments of the chunk's A tile
#pragma unroll
      for (int ch = 0; ch < S::kCH; ++ch) {
        if (ch == 0 || gofs[ch] != gofs[ch - 1]) {
          uint32_t raw[4];
          ldsm_x4(raw, sa + (arow + mt * 16) * P + gofs[ch] + kk + acol);
          const float* s = sc + (gofs[ch] / blkp) * blk + kk + kq;
          const float s4[4] = {s[0], s[1], s[8], s[9]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // register i: rows +8 when i is odd, columns +8 when i >= 2
            float r[2] = {__uint_as_float(raw[i] << 16) * s4[(i / 2) * 2],
                          __uint_as_float(raw[i] & 0xffff0000u) * s4[(i / 2) * 2 + 1]};
            uint32_t top[3][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int t = 0; t < 3; ++t) {
                top[t][e] = __float_as_uint(r[e]) & 0xffff0000u;
                r[e] -= __uint_as_float(top[t][e]);
              }
            }
#pragma unroll
            for (int t = 0; t < 3; ++t) pf[t][i] = __byte_perm(top[t][0], top[t][1], 0x7632);
          }
        }
        mma_bf16(acc.v[mt][2 * ch], pf[0], bf[ch][0], bf[ch][1]);
        mma_bf16(acc.v[mt][2 * ch + 1], pf[0], bf[ch][2], bf[ch][3]);
#pragma unroll
        for (int t = 1; t < 3; ++t) {
          mma_bf16(part.v[mt][2 * ch], pf[t], bf[ch][0], bf[ch][1]);
          mma_bf16(part.v[mt][2 * ch + 1], pf[t], bf[ch][2], bf[ch][3]);
        }
      }
    }
  }
}

// ---- the kernel ----------------------------------------------------------
template <typename T, typename V, int TM>
__global__ void __launch_bounds__(kThreads, 2) chain_fwd_kernel(const __grid_constant__ Args a) {
  using Lay = Layout<T, V, TM>;
  constexpr int P = Lay::kPitch, NS = Lay::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, V, TM> L(a.blkp);
  // zero everything once: pad columns and rows are never written again
  for (int e = threadIdx.x; e < L.total / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int B = a.B, blk = a.blk, blkp = a.blkp, group = a.group;
  const int n_tiles = (B + TM - 1) / TM;
  const int live_w = group * blkp;  // columns of the tile that belong to a group
  // per-thread group offsets of the columns it computes (dead columns read group 0)
  int gofs_f[2];
  int gofs_m[MmaShape<TM>::kCH];
  if constexpr (Lay::kMma) {
    using S = MmaShape<TM>;
    const int wn = (threadIdx.x / 32) % S::kWarpsN;
#pragma unroll
    for (int ch = 0; ch < S::kCH; ++ch) {
      const int c = wn * S::kWN + ch * 16;
      gofs_m[ch] = c < live_w ? (c / blkp) * blkp : 0;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (threadIdx.x % 16) * 4 + 64 * h;
      gofs_f[h] = c < live_w ? (c / blkp) * blkp : 0;
    }
  }
  typename std::conditional<Lay::kMma, MmaAcc<TM>, FmaAcc<TM>>::type acc, part;
  cg::grid_group grid = cg::this_grid();

  for (int j = 0; j < a.n_factors; ++j) {
    const int off = a.off[j], O = a.nout[j], K = a.nk[j];
    const int items = n_tiles * a.ngroups[j];
    const T* src = static_cast<const T*>(a.src[j]);
    const long long lda = a.lda[j];
    T* dst = static_cast<T*>(a.dst[j]);
    const long long ldd = a.ldd[j];
    const int mine = items > (int)blockIdx.x ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
    const int n_slots = mine * K;
    auto item_of = [&](int q) {
      return item_at<TM>((int)blockIdx.x + (q / K) * (int)gridDim.x, n_tiles, B, group, O);
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < n_slots) fetch<T, V, TM>(a, L, smem + q * L.stage, src, lda, off, K, item_of(q), q % K);
      cp_async_commit();
    }
    if constexpr (Lay::kMma) {
      mma_zero<TM>(acc);
      mma_zero<TM>(part);
    } else {
      fma_zero<TM>(acc);
    }
    for (int q = 0; q < n_slots; ++q) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // slot q landed; every thread is done with slot q - 1's stage
      const int qn = q + NS - 1;
      if (qn < n_slots) fetch<T, V, TM>(a, L, smem + (qn % NS) * L.stage, src, lda, off, K, item_of(qn), qn % K);
      cp_async_commit();
      const Item m = item_of(q);
      unsigned char* stage = smem + (q % NS) * L.stage;
      const T* sa = reinterpret_cast<const T*>(stage);
      const T* sb = reinterpret_cast<const T*>(stage + L.a);
      if constexpr (Lay::kCode) {
        convert<T, V, TM>(a, L, smem, stage, m);
        __syncthreads();
        sb = reinterpret_cast<const T*>(smem + L.bc);
      }
      if constexpr (Lay::kMma) {
        if constexpr (Lay::kCode) {
          if (a.row_scales) {  // hi of x*s into acc; mid and lo, 2^-8 of it, into their own sum
            mma_slot_scaled<TM, P>(acc, part, sa, sb, reinterpret_cast<const float*>(stage + L.a + L.b), blkp,
                                   blk, blkp, gofs_m);
          } else {  // x @ q exactly, then each block's columns times its scale
            using S = MmaShape<TM>;
            mma_zero<TM>(part);
            mma_slot<TM, P>(part, sa, sb, blkp, gofs_m);
            const float* sc = reinterpret_cast<const float*>(stage + L.a + L.b);
            const int wn = (threadIdx.x / 32) % S::kWarpsN;
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt) {
              const int c = wn * S::kWN + nt * 8;
              const float sv = c < live_w && c / blkp < m.gv ? sc[c / blkp] : 0.f;
#pragma unroll
              for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc.v[mt][nt][e] = fmaf(part.v[mt][nt][e], sv, acc.v[mt][nt][e]);
            }
          }
        } else {
          mma_slot<TM, P>(acc, sa, sb, blkp, gofs_m);
        }
      } else {
        fma_slot<TM, P>(acc, sa, sb, blkp, gofs_f);
      }
      if (q % K != K - 1) continue;
      // flush: columns n < blk of live groups; n >= ncols written as 0
      T* d = dst + (long long)m.b0 * ldd;
      auto ncols_of = [&](int g) {
        return __ldg(a.meta + (long long)(off + (m.o0 + g) * K) * a.meta_cols + a.ncols_col);
      };
      if constexpr (Lay::kMma) {
        using S = MmaShape<TM>;
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
        if (Lay::kCode && a.row_scales) {  // the low parts' sum joins once, in f32
#pragma unroll
          for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc.v[mt][nt][e] += part.v[mt][nt][e];
          mma_zero<TM>(part);
        }
#pragma unroll
        for (int nt = 0; nt < S::kNT; ++nt) {
          const int c = wn * S::kWN + nt * 8 + 2 * (lane % 4);
          const int g = c / blkp, n = c - g * blkp;
          if (c >= live_w || g >= m.gv || n >= blk) continue;
          const int ncols = ncols_of(g);
          T* col = d + (long long)(m.o0 + g) * blk + n;
#pragma unroll
          for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = wm * S::kWM + mt * 16 + lane / 4 + 8 * hr;
              if (r >= m.rows) continue;
              const float v0 = n < ncols ? acc.v[mt][nt][2 * hr] : 0.f;
              const float v1 = n + 1 < ncols ? acc.v[mt][nt][2 * hr + 1] : 0.f;
              if (a.vec) {  // blk % 8 == 0 and n even: one 4-byte store
                *reinterpret_cast<__nv_bfloat162*>(col + r * ldd) = __floats2bfloat162_rn(v0, v1);
              } else {
                col[r * ldd] = from_f32<T>(v0);
                if (n + 1 < blk) col[r * ldd + 1] = from_f32<T>(v1);
              }
            }
        }
        mma_zero<TM>(acc);
      } else {
        const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = tx * 4 + 64 * h;
          const int g = c / blkp, n = c - g * blkp;
          if (c >= live_w || g >= m.gv || n >= blk) continue;
          const int ncols = ncols_of(g);
          T* col = d + (long long)(m.o0 + g) * blk + n;
#pragma unroll
          for (int i = 0; i < TM / 16; ++i) {
            const int r = ty + 16 * i;
            if (r >= m.rows) continue;
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = n + e < ncols ? acc.v[i][h][e] : 0.f;
            if (a.vec) {  // blk % 4 == 0 and n % 4 == 0: one 16-byte store
              *reinterpret_cast<float4*>(col + r * ldd) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (n + e < blk) col[r * ldd + e] = from_f32<T>(v[e]);
            }
          }
        }
        fma_zero<TM>(acc);
      }
    }
    cp_async_wait<0>();
    if (j + 1 < a.n_factors) grid.sync();  // factor j's flushes before factor j + 1's reads
  }
}

// Resident CTAs of one instantiation at this block: occupancy x SM count.
template <typename T, typename V, int TM>
int resident(int blkp, int* smem_bytes) {
  static bool attr_set[64] = {};  // per instantiation and device: allow the largest layout (blkp 128)
  static int cache[64][kWidth / 16 + 1] = {};  // by device and blkp / 16
  const int smem = Layout<T, V, TM>(blkp).total;
  const int ctas = resident_ctas(chain_fwd_kernel<T, V, TM>, attr_set, cache, blkp / 16, Layout<T, V, TM>(kWidth).total, smem);
  if (smem_bytes) *smem_bytes = smem;
  return ctas;
}

template <typename T, typename V, int TM>
int run(Args& a, int max_items, void* stream) {
  int smem = 0;
  const int ctas = resident<T, V, TM>(a.blkp, &smem);
  if (ctas <= 0) return ctas < 0 ? -ctas : (int)cudaErrorInvalidConfiguration;
  const int grid = max(1, min(ctas, max_items));
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)chain_fwd_kernel<T, V, TM>, dim3(grid), dim3(kThreads),
                                          params, smem, static_cast<cudaStream_t>(stream));
}

// Fill the per-factor table from a host (n_factors, 4) array: step offset,
// out blocks, slots, column groups.  False if it does not fit.
inline bool set_factors(Args& a, const int* factors, int n_factors) {
  if (n_factors < 1 || n_factors > kMaxFactors) return false;
  a.n_factors = n_factors;
  for (int j = 0; j < n_factors; ++j) {
    a.off[j] = factors[4 * j];
    a.nout[j] = factors[4 * j + 1];
    a.nk[j] = factors[4 * j + 2];
    a.ngroups[j] = factors[4 * j + 3];
  }
  return true;
}

template <typename T, typename V>
int launch(Args& a, int bt, int max_items, void* stream) {
  switch (bt) {
    case 16: return run<T, V, 16>(a, max_items, stream);
    case 32: return run<T, V, 32>(a, max_items, stream);
    case 64: return run<T, V, 64>(a, max_items, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename V>
int ctas(int blkp, int bt, int* smem_bytes) {
  switch (bt) {
    case 16: return resident<T, V, 16>(blkp, smem_bytes);
    case 32: return resident<T, V, 32>(blkp, smem_bytes);
    case 64: return resident<T, V, 64>(blkp, smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace FAUST_FWD_NS
}  // namespace faust
