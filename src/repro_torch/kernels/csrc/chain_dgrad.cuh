// The persistent reversed walk of a FAuST chain: K2 (chain_dgrad.cu, dx =
// dy @ F_J^T @ ... @ F_1^T in one launch), K5's dgrad half (the same over
// int8 / fp8 codes with f32 row scales) and K3's reversed walk
// (chain_wgrad.cu: factors J..2, every cotangent kept).  Design notes
// (1)-(6) are in chain_dgrad.cu.
//
// A launch walks factors n_factors-1 down to j_lo; factor j reads the
// cotangent of its output from src[j] (row stride lda[j]) and writes that of
// its input to dst[j] (row stride ldd[j]): K2 gives dy, a ping-pong
// workspace and dx; K3 gives dy and one region of its cotangent workspace
// per factor.  The reversed step table `meta` has meta_cols columns; the
// kernel reads the source block (column 1) and its valid columns (column
// 4) of flat step s at row S-1-s.
#pragma once

#include <cooperative_groups.h>

#include "pipeline.cuh"

// The namespace of this walk's code: K3 (chain_wgrad.cu) names its own, so
// a profile tells its walk from K2 by the kernel's name.
#ifndef FAUST_BWD_NS
#define FAUST_BWD_NS bwd
#endif

namespace faust {
namespace FAUST_BWD_NS {
namespace {  // internal linkage: each built library keeps its own launch state

namespace cg = cooperative_groups;

constexpr int kMaxFactors = 64;
constexpr int kMaxGroup = kWidth / 16;  // input blocks of an item at blkp 16

struct Args {
  const void* values;
  const float* scales;
  const int* meta;
  const int* ptr;
  const int* steps;
  void* deq;    // K5: the codes dequantized once per launch, (S, blk, blk) in dy's dtype
  float* part;  // (chunks, B, IB_j*blk) f32 partial sums of a split factor
  int B, S, blk, blkp, group, vec, n_factors, j_lo, meta_cols;
  int pbase[kMaxFactors], nin[kMaxFactors], ngroups[kMaxFactors], nchunk[kMaxFactors];  // by factor j
  const void* src[kMaxFactors];  // by factor j: the cotangent of its output (dy for factor J)
  void* dst[kMaxFactors];        // the cotangent of its input (dx for factor 1)
  int lda[kMaxFactors], ldd[kMaxFactors];
};

// Shared-memory layout, in bytes, for activation type T, stored type V, TM
// batch rows and padded block blkp.  A (the cotangent tile, the item's
// blocks side by side) has rows kPitch elements apart; B (the value blocks
// as stored, block g at rows g*blkp..) has rows pitch_b = blkp + 16 bytes
// apart.  Both keep rows 16-byte aligned and put the 8 rows an ldmatrix (or
// 8 lanes of a 128-bit load) reads in different banks.  Sizes as K1's: a
// bf16 CTA needs at most 105 KB at bt 64 (two per SM), an f32 CTA 203 KB.
template <typename T, typename V, int TM>
struct Layout {
  static constexpr bool kCode = is_code<V>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStages = 2;
  static constexpr int kPitch = kWidth + 16 / (int)sizeof(T);
  int pitch_b, a, b, sc, stage, total;
  __host__ __device__ explicit Layout(int blkp) {
    pitch_b = blkp + 16 / (int)sizeof(T);
    a = TM * kPitch * (int)sizeof(T);          // cotangent tile
    b = kWidth * pitch_b * (int)sizeof(T);     // value blocks (K5: dequantized)
    sc = kCode && kMma ? kWidth * 4 : 0;       // K5 on bf16 dy: the steps' row scales
    stage = a + b + sc;
    total = kStages * stage;
  }
};

// Work item `it` of a factor: batch tile, group of input blocks and chunk
// of their reader lists.
struct Item {
  int b0, rows, i0, gv, chunk;
};
template <int TM>
__device__ __forceinline__ Item item_at(int it, int n_tiles, int B, int group, int nin, int ngroups) {
  Item m;
  const int rest = it / n_tiles, grp = rest % ngroups;
  m.b0 = (it - rest * n_tiles) * TM;
  m.rows = min(TM, B - m.b0);
  m.i0 = grp * group;
  m.gv = min(group, nin - m.i0);
  m.chunk = rest / ngroups;
  return m;
}

// A CTA's position in its sequence of rounds within one factor: item `it`,
// and round r0 + round of its blocks' reader lists.
struct Cursor {
  int it, r0, round, rounds;
  Item m;
};

template <int TM>
__device__ __forceinline__ void cursor_at(Cursor& c, const Args& a, int it, int items, int n_tiles, int j) {
  c.it = it;
  c.round = 0;
  if (it >= items) return;
  c.m = item_at<TM>(it, n_tiles, a.B, a.group, a.nin[j], a.ngroups[j]);
  const int* p = a.ptr + a.pbase[j] + c.m.i0;
  int n = 1;  // a block no step reads still gets its round: its zeros are flushed
  for (int g = 0; g < c.m.gv; ++g) n = max(n, __ldg(p + g + 1) - __ldg(p + g));
  // chunk k of C takes rounds [k*R, (k+1)*R), R = ceil(n / C); an empty one
  // runs one round in which every block sits out, and flushes zeros
  const int per = (n + a.nchunk[j] - 1) / a.nchunk[j];
  c.r0 = c.m.chunk * per;
  c.rounds = max(1, min(per, n - c.r0));
}

template <int TM>
__device__ __forceinline__ void cursor_next(Cursor& c, const Args& a, int items, int n_tiles, int j) {
  if (c.it < items && ++c.round == c.rounds) cursor_at<TM>(c, a, c.it + (int)gridDim.x, items, n_tiles, j);
}

// A round's descriptor, in shared memory: per block g of the item, the step
// it reads (-1: it sits the round out), that step's source block o(s) and
// the source block's valid columns.  Written two rounds ahead of the round's
// compute (one ahead of its fetch), after the CTA's own compute, so the
// dependent global loads (ptr -> steps -> meta) overlap the fetch in flight
// instead of stalling the fetch that needs them.
struct Desc {
  int step[kMaxGroup], src[kMaxGroup], ncols[kMaxGroup];
};

__device__ __forceinline__ void describe(const Args& a, const Cursor& c, int pb, Desc& d) {
  const int g = threadIdx.x;
  if (g >= c.m.gv) return;
  const int* p = a.ptr + pb + c.m.i0 + g;
  const int lo = __ldg(p), r = c.r0 + c.round;
  const int s = r < __ldg(p + 1) - lo ? __ldg(a.steps + lo + r) : -1;
  d.step[g] = s;
  if (s >= 0) {
    const int* m = a.meta + (long long)(a.S - 1 - s) * a.meta_cols;
    d.src[g] = __ldg(m + 1);
    d.ncols[g] = __ldg(m + 4);
  }
}

// Fetch the cursor's round, described by d, into one ring stage.
template <typename T, typename V, int TM>
__device__ __forceinline__ void fetch(const Args& a, const Layout<T, V, TM>& L, unsigned char* stage,
                                      const Desc& d, const T* src, long long lda, const Cursor& c) {
  using Lay = Layout<T, V, TM>;
  const int blk = a.blk, blkp = a.blkp;
  const bool vec = a.vec != 0;
  const T* rows = src + (long long)c.m.b0 * lda;
  stage_rows<T>(reinterpret_cast<T*>(stage), blkp, Lay::kPitch, c.m.gv, c.m.rows, blk, lda, vec,
                [&](int g) -> const T* { return d.step[g] < 0 ? nullptr : rows + (long long)d.src[g] * blk; });
  const T* values = static_cast<const T*>(Lay::kCode ? a.deq : a.values);
  stage_rows<T>(reinterpret_cast<T*>(stage + L.a), blkp * L.pitch_b, L.pitch_b, c.m.gv, blk, blk, blk, vec,
                [&](int g) -> const T* {
                  return d.step[g] < 0 ? nullptr : values + (long long)d.step[g] * blk * blk;
                });
  if constexpr (Lay::kCode && Lay::kMma) {  // one scale row (blk floats) per block
    stage_rows<float>(reinterpret_cast<float*>(stage + L.a + L.b), blk, 0, c.m.gv, 1, blk, 0, vec,
                      [&](int g) -> const float* {
                        return d.step[g] < 0 ? nullptr : a.scales + (long long)d.step[g] * blk;
                      });
  }
}

// K5, before the walk: every code of the chain dequantized once into deq by
// the whole grid (f32 dy: code * scale, the plain version's f32 product;
// bf16 dy: the code as bf16, exact, its scale applied after the MMA).  With
// `vec` (blk % 4 == 0, blk*blk % 16 == 0, 16-byte aligned tensors) 16 codes
// at a time, one 16-byte load: the pass is latency-bound, so the fewer
// dependent load-store trips a thread makes, the sooner the walk starts.
template <typename T, typename V>
__device__ __forceinline__ void dequantize(const Args& a) {
  const V* codes = static_cast<const V*>(a.values);
  T* out = static_cast<T*>(a.deq);
  const long long n = (long long)a.S * a.blk * a.blk, stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (a.vec) {
    for (long long i = first; i < n / 16; i += stride) {
      const uint4 word = __ldg(reinterpret_cast<const uint4*>(codes) + i);
      V c[16];
      memcpy(c, &word, 16);
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // 4 codes of one row (blk % 4 == 0)
          const float sv = __ldg(a.scales + (16 * i + 4 * u) / a.blk);
          reinterpret_cast<float4*>(out)[4 * i + u] = make_float4(
              to_f32(c[4 * u]) * sv, to_f32(c[4 * u + 1]) * sv, to_f32(c[4 * u + 2]) * sv, to_f32(c[4 * u + 3]) * sv);
        }
      } else {
        __nv_bfloat162 h[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) h[u] = __floats2bfloat162_rn(to_f32(c[2 * u]), to_f32(c[2 * u + 1]));
        uint4 w[2];
        memcpy(w, h, 32);
        reinterpret_cast<uint4*>(out)[2 * i] = w[0];
        reinterpret_cast<uint4*>(out)[2 * i + 1] = w[1];
      }
    }
    return;
  }
  for (long long i = first; i < n; i += stride) {
    const float q = to_f32(codes[i]);
    if constexpr (std::is_same<T, float>::value) {
      out[i] = q * __ldg(a.scales + i / a.blk);
    } else {
      out[i] = __float2bfloat16(q);
    }
  }
}

// Before a round computes: zero the masked source columns (>= ncols) of
// each block's cotangent tile and, for the FFMA path, both tiles of a block
// that sits the round out.  Returns whether it wrote anything (then the
// caller synchronizes).
template <typename T, typename V, int TM>
__device__ __forceinline__ bool prepare(const Args& a, const Layout<T, V, TM>& L, unsigned char* stage,
                                        const Desc& d, int gv) {
  using Lay = Layout<T, V, TM>;
  constexpr int P = Lay::kPitch;
  const int blk = a.blk, blkp = a.blkp;
  bool wrote = false;
  T* sa = reinterpret_cast<T*>(stage);
  T* sb = reinterpret_cast<T*>(stage + L.a);
  for (int g = 0; g < gv; ++g) {
    if (d.step[g] < 0) {
      if constexpr (!Lay::kMma) {  // FFMA runs every block: zero the one that sits out
        for (int e = threadIdx.x; e < TM * blk; e += kThreads) sa[(e / blk) * P + g * blkp + e % blk] = 0.f;
        for (int e = threadIdx.x; e < blk * blk; e += kThreads) sb[(g * blkp + e / blk) * L.pitch_b + e % blk] = 0.f;
        wrote = true;
      }
      continue;
    }
    const int nc = d.ncols[g];
    if (nc >= blk) continue;
    const int w = blk - nc;
    for (int e = threadIdx.x; e < TM * w; e += kThreads) {
      const int r = e / w;
      sa[r * P + g * blkp + nc + (e - r * w)] = from_f32<T>(0.f);
    }
    wrote = true;
  }
  return wrote;
}

// ---- f32: FFMA -----------------------------------------------------------
// Thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns tx + 16 e.
// Column c lies in block c / blkp = 16 e / blkp of the item, the same for
// every thread (blkp is a multiple of 16): aoff[e] is that block's column
// offset in the cotangent tile.  The loop has no branches, so each 4-deep
// k step issues all its shared loads before its FMAs: a block that sits a
// round out has zeroed tiles (prepare), and dead columns compute on
// whatever the tiles hold and are never flushed.  kOneBlock (block 128,
// one block per item): every column reads the same activations, loaded
// once per k step; otherwise each column loads its own.
template <int TM>
struct FmaAcc {
  float v[TM / 16][8];
};

template <int TM>
__device__ __forceinline__ void fma_zero(FmaAcc<TM>& acc) {
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc.v[i][e] = 0.f;
}

template <int TM, int P, bool kOneBlock>
__device__ __forceinline__ void fma_round(FmaAcc<TM>& acc, const float* sa, const float* sb, int blkp, int ldb,
                                          const int (&aoff)[8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kk = 0; kk < blkp; kk += 4) {
    float4 bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[e] = *reinterpret_cast<const float4*>(sb + (tx + 16 * e) * ldb + kk);
#pragma unroll
    for (int i = 0; i < TM / 16; ++i) {
      const float* arow = sa + (ty + 16 * i) * P + kk;
      float4 av = *reinterpret_cast<const float4*>(arow);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (!kOneBlock) av = *reinterpret_cast<const float4*>(arow + aoff[e]);
        float s = acc.v[i][e];
        s = fmaf(av.x, bv[e].x, s);
        s = fmaf(av.y, bv[e].y, s);
        s = fmaf(av.z, bv[e].z, s);
        s = fmaf(av.w, bv[e].w, s);
        acc.v[i][e] = s;
      }
    }
  }
}

// ---- bf16: mma.sync.m16n8k16 ----------------------------------------------
// Warp (wm, wn) computes rows wm*WM.. and columns wn*WN..; chunk ch (16
// columns) lies in one block of the item; `live` says whether that block
// reads a step this round.  A from the cotangent tile (rows, k), B from the
// value tile (n, k) by a non-transposing ldmatrix: matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) are the b0b1 / b2b3
// registers of two n8 tiles.
template <int TM, int P>
__device__ __forceinline__ void mma_round(MmaAcc<TM>& acc, const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                          int blkp, int ldb, const int (&gofs)[MmaShape<TM>::kCH],
                                          const bool (&live)[MmaShape<TM>::kCH]) {
  using S = MmaShape<TM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int arow = wm * S::kWM + (lane % 16), acol = (lane / 16) * 8;
  const int brow = wn * S::kWN + (lane % 8) + (lane / 16) * 8, bcol = ((lane / 8) % 2) * 8;
  for (int kk = 0; kk < blkp; kk += 16) {
#pragma unroll
    for (int ch = 0; ch < S::kCH; ++ch) {
      if (!live[ch]) continue;
      uint32_t bf[4];
      ldsm_x4(bf, sb + (brow + ch * 16) * ldb + kk + bcol);
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, sa + (arow + mt * 16) * P + gofs[ch] + kk + acol);
        mma_bf16(acc.v[mt][2 * ch], af, bf[0], bf[1]);
        mma_bf16(acc.v[mt][2 * ch + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// ---- flush ---------------------------------------------------------------
// Write an item's accumulator: columns n < blk of its blocks, rows < rows,
// to d (row stride ld; block g at column g*blk), in OutT: dy's dtype into
// ws or dx, or f32 into a split factor's partial sums.
template <typename OutT, int TM>
__device__ __forceinline__ void flush_mma(const MmaAcc<TM>& acc, OutT* d, long long ld, const Item& m, int blk,
                                          int blkp, int live_w, bool vec) {
  using S = MmaShape<TM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt) {
    const int c = wn * S::kWN + nt * 8 + 2 * (lane % 4);
    const int g = c / blkp, n = c - g * blkp;
    if (c >= live_w || g >= m.gv || n >= blk) continue;
    OutT* col = d + (long long)g * blk + n;
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wm * S::kWM + mt * 16 + lane / 4 + 8 * hr;
        if (row >= m.rows) continue;
        const float v0 = acc.v[mt][nt][2 * hr], v1 = acc.v[mt][nt][2 * hr + 1];
        if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
          if (vec) {  // blk % 8 == 0 and n even: one 4-byte store
            *reinterpret_cast<__nv_bfloat162*>(col + row * ld) = __floats2bfloat162_rn(v0, v1);
            continue;
          }
        }
        col[row * ld] = from_f32<OutT>(v0);
        if (n + 1 < blk) col[row * ld + 1] = from_f32<OutT>(v1);
      }
  }
}

template <int TM>
__device__ __forceinline__ void flush_fma(const FmaAcc<TM>& acc, float* d, long long ld, const Item& m, int blk,
                                          int blkp, const int (&gcol)[8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = gcol[e], n = tx + 16 * e - g * blkp;
    if (g < 0 || g >= m.gv || n >= blk) continue;
#pragma unroll
    for (int i = 0; i < TM / 16; ++i) {
      const int row = ty + 16 * i;
      if (row < m.rows) d[row * ld + (long long)g * blk + n] = acc.v[i][e];
    }
  }
}

// ---- the kernel ----------------------------------------------------------
template <typename T, typename V, int TM>
__global__ void __launch_bounds__(kThreads, 2) chain_dgrad_kernel(const __grid_constant__ Args a) {
  using Lay = Layout<T, V, TM>;
  constexpr int P = Lay::kPitch, NS = Lay::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Desc desc[3];  // round q's descriptor in desc[q % 3]
  const Layout<T, V, TM> L(a.blkp);
  // zero everything once: pad rows and columns are never written again
  for (int e = threadIdx.x; e < L.total / 16; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int B = a.B, blk = a.blk, blkp = a.blkp, group = a.group, ldb = L.pitch_b;
  const int n_tiles = (B + TM - 1) / TM;
  const int live_w = group * blkp;  // columns of the tile that belong to a block
  // the item-relative block of each column a thread computes (-1: dead column)
  int gcol_f[8], aoff[8];  // FFMA: aoff, the cotangent-tile column offset of the block
  int gcol_m[MmaShape<TM>::kCH];
  if constexpr (Lay::kMma) {
    using S = MmaShape<TM>;
    const int wn = (threadIdx.x / 32) % S::kWarpsN;
#pragma unroll
    for (int ch = 0; ch < S::kCH; ++ch) {
      const int c = wn * S::kWN + ch * 16;
      gcol_m[ch] = c < live_w ? c / blkp : -1;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gcol_f[e] = 16 * e < live_w ? 16 * e / blkp : -1;
      aoff[e] = max(gcol_f[e], 0) * blkp;
    }
  }
  typename std::conditional<Lay::kMma, MmaAcc<TM>, FmaAcc<TM>>::type acc, part;
  cg::grid_group grid = cg::this_grid();
  if constexpr (Lay::kCode) {
    dequantize<T, V>(a);
    grid.sync();  // every block dequantized before any CTA stages one
  }

  for (int j = a.n_factors - 1; j >= a.j_lo; --j) {  // reversed: factor J first
    const int pb = a.pbase[j], chunks = a.nchunk[j];
    const int items = n_tiles * a.ngroups[j] * chunks;
    const long long pw = (long long)a.nin[j] * blk;  // columns of this factor's input cotangent
    const T* src = static_cast<const T*>(a.src[j]);
    const long long lda = a.lda[j];
    T* dst = static_cast<T*>(a.dst[j]);
    const long long ldd = a.ldd[j];
    // cur: the round computed; nxt: the round fetched; ahd: the round described
    Cursor cur, nxt, ahd;
    cursor_at<TM>(cur, a, (int)blockIdx.x, items, n_tiles, j);
    nxt = cur;
    cursor_next<TM>(nxt, a, items, n_tiles, j);
    ahd = nxt;
    cursor_next<TM>(ahd, a, items, n_tiles, j);
    if (cur.it < items) describe(a, cur, pb, desc[0]);
    if (nxt.it < items) describe(a, nxt, pb, desc[1]);
    __syncthreads();
    if (cur.it < items) fetch<T, V, TM>(a, L, smem, desc[0], src, lda, cur);
    cp_async_commit();
    if constexpr (Lay::kMma) mma_zero<TM>(acc); else fma_zero<TM>(acc);
    for (int q = 0; cur.it < items; ++q) {
      cp_async_wait<0>();
      __syncthreads();  // round q landed, q + 1 described; every thread is done with round q - 1
      if (nxt.it < items) fetch<T, V, TM>(a, L, smem + ((q + 1) % NS) * L.stage, desc[(q + 1) % 3], src, lda, nxt);
      cp_async_commit();
      const Item m = cur.m;
      unsigned char* stage = smem + (q % NS) * L.stage;
      const Desc& dq = desc[q % 3];
      if (prepare<T, V, TM>(a, L, stage, dq, m.gv)) __syncthreads();
      const T* sa = reinterpret_cast<const T*>(stage);
      const T* sb = reinterpret_cast<const T*>(stage + L.a);
      if constexpr (Lay::kMma) {
        using S = MmaShape<TM>;
        int gofs[S::kCH];
        bool live[S::kCH];
#pragma unroll
        for (int ch = 0; ch < S::kCH; ++ch) {
          const int g = gcol_m[ch];
          live[ch] = g >= 0 && g < m.gv && dq.step[g] >= 0;
          gofs[ch] = g >= 0 ? g * blkp : 0;
        }
        if constexpr (Lay::kCode) {
          // K5 bf16: the round's partial, scaled columnwise by its step's row scales
          mma_zero<TM>(part);
          mma_round<TM, P>(part, sa, sb, blkp, ldb, gofs, live);
          const float* sc = reinterpret_cast<const float*>(stage + L.a + L.b);
          const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % S::kWarpsN;
#pragma unroll
          for (int nt = 0; nt < S::kNT; ++nt) {
            if (!live[nt / 2]) continue;
            const int c = wn * S::kWN + nt * 8 + 2 * (lane % 4);
            const int g = c / blkp, n = c - g * blkp;
            const float s0 = n < blk ? sc[g * blk + n] : 0.f;
            const float s1 = n + 1 < blk ? sc[g * blk + n + 1] : 0.f;
#pragma unroll
            for (int mt = 0; mt < S::kMT; ++mt) {
              acc.v[mt][nt][0] = fmaf(part.v[mt][nt][0], s0, acc.v[mt][nt][0]);
              acc.v[mt][nt][1] = fmaf(part.v[mt][nt][1], s1, acc.v[mt][nt][1]);
              acc.v[mt][nt][2] = fmaf(part.v[mt][nt][2], s0, acc.v[mt][nt][2]);
              acc.v[mt][nt][3] = fmaf(part.v[mt][nt][3], s1, acc.v[mt][nt][3]);
            }
          }
        } else {
          mma_round<TM, P>(acc, sa, sb, blkp, ldb, gofs, live);
        }
      } else if (group == 1) {
        fma_round<TM, P, true>(acc, sa, sb, blkp, ldb, aoff);
      } else {
        fma_round<TM, P, false>(acc, sa, sb, blkp, ldb, aoff);
      }
      const bool last = cur.round == cur.rounds - 1;
      // describe round q + 2 into the slot round q - 1 used (no thread reads it after this
      // iteration's barrier; the fetch reads it after the next one)
      if (ahd.it < items) describe(a, ahd, pb, desc[(q + 2) % 3]);
      cur = nxt;
      nxt = ahd;
      cursor_next<TM>(ahd, a, items, n_tiles, j);
      if (!last) continue;
      // flush: into the destination, or a split factor's partial sums
      T* d = dst + (long long)m.b0 * ldd + (long long)m.i0 * blk;
      float* pd = chunks > 1 ? a.part + ((long long)m.chunk * B + m.b0) * pw + (long long)m.i0 * blk : nullptr;
      if constexpr (Lay::kMma) {
        if (chunks > 1) {
          flush_mma<float, TM>(acc, pd, pw, m, blk, blkp, live_w, false);
        } else {
          flush_mma<T, TM>(acc, d, ldd, m, blk, blkp, live_w, a.vec != 0);
        }
        mma_zero<TM>(acc);
      } else {
        if (chunks > 1) {
          flush_fma<TM>(acc, pd, pw, m, blk, blkp, gcol_f);
        } else {
          flush_fma<TM>(acc, d, ldd, m, blk, blkp, gcol_f);
        }
        fma_zero<TM>(acc);
      }
    }
    cp_async_wait<0>();
    if (chunks > 1) {
      // a split factor: sum its chunks' partials in chunk order (the same
      // bits run to run) once every chunk is flushed
      grid.sync();
      const long long n = (long long)B * pw, stride = (long long)gridDim.x * kThreads;
      for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
        float v = 0.f;
        for (int k = 0; k < chunks; ++k) v += __ldcg(a.part + k * n + e);
        const long long b = e / pw;
        dst[b * ldd + (e - b * pw)] = from_f32<T>(v);
      }
    }
    if (j > a.j_lo) grid.sync();  // factor j's flushes before factor j - 1's reads
  }
}

// Resident CTAs of one instantiation at this block: occupancy x SM count.
template <typename T, typename V, int TM>
int resident(int blkp, int* smem_bytes) {
  static bool attr_set[64] = {};  // per instantiation and device: allow the largest layout (blkp 128)
  static int cache[64][kWidth / 16 + 1] = {};  // by device and blkp / 16
  const int smem = Layout<T, V, TM>(blkp).total;
  const int ctas = resident_ctas(chain_dgrad_kernel<T, V, TM>, attr_set, cache, blkp / 16, Layout<T, V, TM>(kWidth).total, smem);
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
  return (int)cudaLaunchCooperativeKernel((const void*)chain_dgrad_kernel<T, V, TM>, dim3(grid), dim3(kThreads),
                                          params, smem, static_cast<cudaStream_t>(stream));
}

// Fill the per-factor table from a host (n_factors, 4) array: the first
// entry in the transposed table's block axis, input blocks, groups, chunks.
inline bool set_factors(Args& a, const int* factors, int n_factors) {
  if (n_factors < 1 || n_factors > kMaxFactors) return false;
  a.n_factors = n_factors;
  for (int j = 0; j < n_factors; ++j) {
    a.pbase[j] = factors[4 * j];
    a.nin[j] = factors[4 * j + 1];
    a.ngroups[j] = factors[4 * j + 2];
    a.nchunk[j] = factors[4 * j + 3];
    if (a.nchunk[j] < 1) return false;
  }
  return true;
}

template <typename T, typename V>
int launch(Args& a, int bt, int max_items, void* stream) {
  if (a.group < 1 || a.group > kMaxGroup) return (int)cudaErrorInvalidValue;
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
}  // namespace FAUST_BWD_NS
}  // namespace faust
