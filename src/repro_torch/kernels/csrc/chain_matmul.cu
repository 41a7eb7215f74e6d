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
//   meta    (S, 7)             int32 step table (repro_torch/kernels/ops.py chain_meta);
//                              the kernel reads in_blk (column 0) and ncols (column 6)
//   factors                    per factor j: step offset, out blocks O_j, slots K_j,
//                              column groups ceil(O_j / group) (chain.py chain_schedule)
//   ws      (2, B, ws_w)       workspace for the intermediate activations (J > 1)
//   y       (B, O_J*blk)       x.dtype, ragged tail columns already zeroed
//
// What bounds it.  The chain does 2*B*s_tot operations on s_tot weights; at
// serving batches it is bound by bytes (each weight read once), at prefill
// batches by operations (bf16 tensor cores, or f32 FFMA: 67e12/s, no TF32).
// The first version ran one CTA per batch tile through all S steps in
// order, loading each step synchronously: 8 CTAs on 132 SMs at B = 128, and
// a time that followed the length of the walk (672 steps on the gemma-2b
// up-projection, 64,512 on the FAuST unembedding), not its work.
//
// Design.
// (1) Persistent schedule.  About one CTA per SM (occupancy x SM count,
//     resident by cooperative launch) walks the chain factor by factor.
//     Within factor j a work item is (batch tile of TM rows, column group
//     of `group` consecutive output blocks): group = 128 / blkp (blkp: the
//     block rounded up to 16), so at block 16 one item fills a 128-column
//     tile with 8 output blocks, each reading its own K_j input blocks.
//     Item i of factor j is batch tile i % n_tiles of column group
//     i / n_tiles; CTA c takes items c, c + grid, ...  Items of one group
//     run side by side, so a value block is fetched from memory once and
//     served from L2 to the other batch tiles.  Each item accumulates its
//     K_j slots in registers and flushes once.  Factor 1 reads x, factor J
//     writes y, the others ping-pong through ws (factor j reads buffer
//     j % 2 and writes the other).  One grid-wide barrier separates
//     factors: cooperative_groups::this_grid().sync(), which needs the
//     cooperative launch below and, since CUDA 11, no -rdc (build.py
//     compiles without it).  So J - 1 barriers per apply, one launch.
// (2) Asynchronous staging.  A CTA's slots in factor j form one flat
//     sequence over its items; slot q + NS - 1 is fetched with cp.async
//     into a 2-stage shared-memory ring while slot q computes (Layout says
//     why two).  Shared memory is dynamic, sized from blkp.
//     Hazard: factor j + 2 reuses the buffer factor j read, written by
//     other CTAs during this launch, so every global read of this kernel
//     is L2-only (cp.async.cg, or __ldcg where a row is not a multiple of
//     16 bytes), never through L1 or the read-only path; the grid barrier
//     orders the flushes of factor j before the reads of factor j + 1.
// (3) Tensor cores for bf16 activations (K1 bf16, K4 with bf16 x):
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands by ldmatrix
//     from the padded shared tiles.  mma.sync and not wgmma: wgmma's
//     64-row M needs bt >= 64 or swap-AB (the block's output columns as
//     M), which does not fit block 16, the FAuST unembedding's block;
//     mma.sync takes every block and batch tile (16-row tiles, 8-column
//     slices, K in 16s, ragged K zero-padded in shared memory); the MMA
//     rate is not what limits this kernel, the walk's staging is.
//     K4 on bf16 x: int8, e4m3 and e5m2 codes convert to bf16 exactly, so
//     the code is the B operand as it is; row r's scale multiplies input
//     column r of the activation tile, folded into the staged activation
//     as bf16(x[:, r] * s[r]) (f32 product, then rounded).  That is one
//     extra bf16 rounding per term against the plain version's f32
//     dequantized q*s; it stays within the bf16 tolerance 3e-2*max|y|.
// (4) f32 stays full-f32 FFMA (K1 f32, K4 with f32 x): no TF32, so it
//     matches the plain version to f32 summation order (1e-5*max|y|).
//     K4 f32 dequantizes each staged code with the plain version's f32
//     product q*s.  Each thread owns 4-column runs and reads 4 K values
//     of a row at once (128-bit shared loads).
//
// Numerics as the reference: f32 accumulation, intermediates stored in
// x.dtype (bf16 rounds between factors), tail columns >= ncols zeroed at
// each flush.  lambda and the feature/batch slicing stay in the caller.
#include <cooperative_groups.h>

#include <cstring>

#include "tile.cuh"

namespace faust {
namespace fwd {
namespace {  // internal linkage: each built library keeps its own launch state

namespace cg = cooperative_groups;

constexpr int kMetaCols = 7;
constexpr int kWidth = 128;       // columns of an item's tile; most K rows of a slot
constexpr int kMaxFactors = 64;

struct Args {
  const void* x;
  const void* values;
  const float* scales;
  const int* meta;
  void* ws;
  void* out;
  int B, blk, blkp, group, in_w, ws_w, out_w, vec, n_factors;
  int off[kMaxFactors], nout[kMaxFactors], nk[kMaxFactors], ngroups[kMaxFactors];
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
    a = TM * kPitch * (int)sizeof(T);                            // activations (K4 bf16: scaled in place)
    b = kCode ? kWidth * blkp : blkp * kPitch * (int)sizeof(T);  // K1 values / K4 codes (flat)
    sc = kCode ? kWidth * 4 : 0;                                 // K4 row scales
    stage = a + b + sc;
    bc = kStages * stage;  // K4: converted values
    total = bc + (kCode ? blkp * kPitch * (int)sizeof(T) : 0);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element through L2 only (the fallback when rows are not 16-byte
// multiples): the same bits as a plain load, never an L1 line.
template <typename E>
__device__ __forceinline__ E ld_l2(const E* p) {
  static_assert(sizeof(E) == 1 || sizeof(E) == 2 || sizeof(E) == 4, "element size");
  E out;
  if constexpr (sizeof(E) == 4) {
    const unsigned v = __ldcg(reinterpret_cast<const unsigned*>(p));
    memcpy(&out, &v, 4);
  } else if constexpr (sizeof(E) == 2) {
    const unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&out, &v, 2);
  } else {
    const unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(p));
    memcpy(&out, &v, 1);
  }
  return out;
}

// Copy `n` rows of `len` elements (row strides ld_src / ld_dst) for each of
// `gv` groups; group g's source is src_of(g), its destination dst + g *
// dst_g.  16-byte cp.async when `vec`, else one L2 load per element.
// Threads map to (group, row, chunk) once per call: a group of fewer chunks
// than threads shares the CTA with the next groups, a larger one is walked
// group by group.
template <typename E, typename SrcOf>
__device__ __forceinline__ void stage_rows(E* dst, int dst_g, long long ld_dst, int gv, int n, int len,
                                           long long ld_src, bool vec, SrcOf src_of) {
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(E);
    const int cpr = len / kPer, per_g = n * cpr;
    if (per_g < kThreads) {
      const int gpp = kThreads / per_g, gi = threadIdx.x / per_g, rem = threadIdx.x - gi * per_g;
      const int r = rem / cpr, c = (rem - r * cpr) * kPer;
      if (gi >= gpp) return;
      for (int g = gi; g < gv; g += gpp) cp_async16(dst + g * dst_g + r * ld_dst + c, src_of(g) + r * ld_src + c);
      return;
    }
    for (int g = 0; g < gv; ++g) {
      const E* s = src_of(g);
      E* d = dst + g * dst_g;
      if (n == 1) {  // one long run
        for (int e = threadIdx.x; e < cpr; e += kThreads) cp_async16(d + e * kPer, s + e * kPer);
      } else {  // cpr <= 32 here: every thread keeps one chunk column
        const int rpp = kThreads / cpr, r0 = threadIdx.x / cpr, c = (threadIdx.x - r0 * cpr) * kPer;
        if (r0 < rpp)
          for (int r = r0; r < n; r += rpp) cp_async16(d + r * ld_dst + c, s + r * ld_src + c);
      }
    }
  } else {
    for (int g = 0; g < gv; ++g) {
      const E* s = src_of(g);
      E* d = dst + g * dst_g;
      for (int e = threadIdx.x; e < n * len; e += kThreads) {
        const int r = e / len, c = e - r * len;
        d[r * ld_dst + c] = ld_l2(s + r * ld_src + c);
      }
    }
  }
}

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
                [&](int g) { return src + (long long)m.b0 * lda + (long long)__ldg(meta + (long long)step(g) * kMetaCols) * blk; });
  const V* values = static_cast<const V*>(a.values);
  if constexpr (Lay::kCode) {
    // codes as flat blk*blk runs, scales as blk floats: one row each per group
    stage_rows<V>(reinterpret_cast<V*>(stage + L.a), blk * blk, 0, m.gv, 1, blk * blk, 0, vec,
                  [&](int g) { return values + (long long)step(g) * blk * blk; });
    stage_rows<float>(reinterpret_cast<float*>(stage + L.a + L.b), blk, 0, m.gv, 1, blk, 0, vec,
                      [&](int g) { return a.scales + (long long)step(g) * blk; });
  } else {
    stage_rows<V>(reinterpret_cast<V*>(stage + L.a), blkp, Lay::kPitch, m.gv, blk, blk, blk, vec,
                  [&](int g) { return values + (long long)step(g) * blk * blk; });
  }
}

// K4: codes (and, for bf16 x, the activations, in place) of one stage into
// the compute tiles.  f32 x: value = code * scale, the plain version's f32
// product.  bf16 x: the code as bf16 (exact) and bf16(x * scale).
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
          const float sv = sc[g * blk + kk];
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
        bc[kk * P + g * blkp + n] = q * sc[g * blk + kk];
      }
    }
  }
  if constexpr (Lay::kMma) {  // in place: each element is read and written by one thread
    T* ac = reinterpret_cast<T*>(stage);
    const T* araw = ac;
    if (a.vec) {  // blk % 8 == 0: 8 activations and their 8 scales at once
      // thread: a fixed 8-column chunk (g, kk) of a row (gv*blk <= 128 columns), every rpp-th row
      const int q8 = blk / 8, per_r = m.gv * q8, rpp = kThreads / per_r, r0 = threadIdx.x / per_r;
      const int ci = threadIdx.x - r0 * per_r, g = ci / q8, kk = (ci - g * q8) * 8;
      if (r0 < rpp) {
        const float4 s_lo = *reinterpret_cast<const float4*>(sc + g * blk + kk);
        const float4 s_hi = *reinterpret_cast<const float4*>(sc + g * blk + kk + 4);
        const float s8[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
        for (int r = r0; r < m.rows; r += rpp) {
          const int at = r * P + g * blkp + kk;
          __nv_bfloat162 h[4];
          const uint4 raw = *reinterpret_cast<const uint4*>(araw + at);
          memcpy(h, &raw, 16);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = __bfloat1622float2(h[u]);
            h[u] = __floats2bfloat162_rn(f.x * s8[2 * u], f.y * s8[2 * u + 1]);
          }
          uint4 out;
          memcpy(&out, h, 16);
          *reinterpret_cast<uint4*>(ac + at) = out;
        }
      }
    } else {
      const int per_r = m.gv * blk;
      for (int e = threadIdx.x; e < m.rows * per_r; e += kThreads) {
        const int r = e / per_r, rem = e - r * per_r, g = rem / blk, kk = rem - g * blk;
        const int at = r * P + g * blkp + kk;
        ac[at] = __float2bfloat16(__bfloat162float(araw[at]) * sc[g * blk + kk]);
      }
    }
  }
}

// ---- f32: FFMA -----------------------------------------------------------
// Thread (ty, tx) of 16 x 16 owns rows ty + 16 i and the 4-column runs
// starting at tx * 4 and 64 + tx * 4; a run never crosses a group (groups
// are 16-column multiples), so each run reads one group's activations.
template <int TM>
struct FmaAcc {
  float v[TM / 16][2][4];
};

template <int TM>
__device__ __forceinline__ void fma_zero(FmaAcc<TM>& acc) {
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][h][e] = 0.f;
}

template <int TM, int P>
__device__ __forceinline__ void fma_slot(FmaAcc<TM>& acc, const float* sa, const float* sb, int blkp,
                                         const int (&gofs)[2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kk = 0; kk < blkp; kk += 4) {
    float4 b[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[u][h] = *reinterpret_cast<const float4*>(sb + (kk + u) * P + tx * 4 + 64 * h);
#pragma unroll
    for (int i = 0; i < TM / 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 av = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * P + gofs[h] + kk);
        const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc.v[i][h][0] = fmaf(am[u], b[u][h].x, acc.v[i][h][0]);
          acc.v[i][h][1] = fmaf(am[u], b[u][h].y, acc.v[i][h][1]);
          acc.v[i][h][2] = fmaf(am[u], b[u][h].z, acc.v[i][h][2]);
          acc.v[i][h][3] = fmaf(am[u], b[u][h].w, acc.v[i][h][3]);
        }
      }
    }
  }
}

// ---- bf16: mma.sync.m16n8k16 ----------------------------------------------
// 8 warps as WARPS_M x WARPS_N; a warp owns WM x WN of the TM x 128 tile:
// MT m16 tiles by NT n8 tiles.  A 16-column chunk of a warp lies in one group.
template <int TM>
struct MmaShape {
  static constexpr int kWarpsM = TM >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = TM / kWarpsM, kWN = kWidth / kWarpsN;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8, kCH = kWN / 16;
};

template <int TM>
struct MmaAcc {
  float v[MmaShape<TM>::kMT][MmaShape<TM>::kNT][4];
};

template <int TM>
__device__ __forceinline__ void mma_zero(MmaAcc<TM>& acc) {
  using S = MmaShape<TM>;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TM, int P>
__device__ __forceinline__ void mma_slot(MmaAcc<TM>& acc, const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                         int blkp, const int (&gofs)[MmaShape<TM>::kCH]) {
  using S = MmaShape<TM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int arow = wm * S::kWM + (lane % 16), acol = (lane / 16) * 8;
  const int brow = lane % 16, bcol = wn * S::kWN + (lane / 16) * 8;
  for (int kk = 0; kk < blkp; kk += 16) {
    uint32_t af[S::kMT][S::kCH][4];
#pragma unroll
    for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
      for (int ch = 0; ch < S::kCH; ++ch) {
        if (ch > 0 && gofs[ch] == gofs[ch - 1]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[mt][ch][e] = af[mt][ch - 1][e];
        } else {
          ldsm_x4(af[mt][ch], sa + (arow + mt * 16) * P + gofs[ch] + kk + acol);
        }
      }
#pragma unroll
    for (int np = 0; np < S::kNT / 2; ++np) {  // two n8 tiles per ldmatrix.x4.trans
      uint32_t bf[4];
      ldsm_x4_t(bf, sb + (kk + brow) * P + bcol + np * 16);
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt) {
        mma_bf16(acc.v[mt][2 * np], af[mt][np], bf[0], bf[1]);
        mma_bf16(acc.v[mt][2 * np + 1], af[mt][np], bf[2], bf[3]);
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
  const long long buf = (long long)B * a.ws_w;
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
  typename std::conditional<Lay::kMma, MmaAcc<TM>, FmaAcc<TM>>::type acc;
  cg::grid_group grid = cg::this_grid();

  for (int j = 0; j < a.n_factors; ++j) {
    const int off = a.off[j], O = a.nout[j], K = a.nk[j];
    const int items = n_tiles * a.ngroups[j];
    const T* src = j == 0 ? static_cast<const T*>(a.x) : static_cast<const T*>(a.ws) + (j % 2) * buf;
    const long long lda = j == 0 ? a.in_w : a.ws_w;
    T* dst = j == a.n_factors - 1 ? static_cast<T*>(a.out) : static_cast<T*>(a.ws) + ((j + 1) % 2) * buf;
    const long long ldd = j == a.n_factors - 1 ? a.out_w : a.ws_w;
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
    if constexpr (Lay::kMma) mma_zero<TM>(acc); else fma_zero<TM>(acc);
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
        mma_slot<TM, P>(acc, sa, sb, blkp, gofs_m);
      } else {
        fma_slot<TM, P>(acc, sa, sb, blkp, gofs_f);
      }
      if (q % K != K - 1) continue;
      // flush: columns n < blk of live groups; n >= ncols written as 0
      T* d = dst + (long long)m.b0 * ldd;
      auto ncols_of = [&](int g) { return __ldg(a.meta + (long long)(off + (m.o0 + g) * K) * kMetaCols + 6); };
      if constexpr (Lay::kMma) {
        using S = MmaShape<TM>;
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
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
  auto kernel = chain_fwd_kernel<T, V, TM>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return -(int)(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  static bool attr_set[64] = {};  // per instantiation and device: allow the largest layout (blkp 128)
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T, V, TM>(kWidth).total);
    if (e != cudaSuccess) return -(int)e;
    attr_set[dev] = true;
  }
  const int smem = Layout<T, V, TM>(blkp).total;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  if (smem_bytes) *smem_bytes = smem;
  return per_sm * sms;
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

template <typename T, typename V>
int launch(const void* x, const void* values, const float* scales, const void* meta, const int* factors,
           int n_factors, void* ws, void* out, int B, int blk, int blkp, int group, int in_w, int ws_w,
           int out_w, int vec, int bt, int max_items, void* stream) {
  if (n_factors < 1 || n_factors > kMaxFactors) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.values = values;
  a.scales = scales;
  a.meta = static_cast<const int*>(meta);
  a.ws = ws;
  a.out = out;
  a.B = B;
  a.blk = blk;
  a.blkp = blkp;
  a.group = group;
  a.in_w = in_w;
  a.ws_w = ws_w;
  a.out_w = out_w;
  a.vec = vec;
  a.n_factors = n_factors;
  for (int j = 0; j < n_factors; ++j) {
    a.off[j] = factors[4 * j];
    a.nout[j] = factors[4 * j + 1];
    a.nk[j] = factors[4 * j + 2];
    a.ngroups[j] = factors[4 * j + 3];
  }
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
}  // namespace fwd
}  // namespace faust

extern "C" {

// factors: host int32 (n_factors, 4) table; max_items: the most items of
// any factor (the grid never exceeds it).  Returns a cudaError_t code.
// chain_matmul_ctas_*: resident CTAs at this padded block and tile, and the
// dynamic shared memory of one CTA (negative: error).

// K1: values in x's dtype.
#define FAUST_CHAIN_K1(suffix, T)                                                                   \
  int chain_matmul_##suffix(const void* x, const void* values, const void* meta, const void* factors, \
                            void* ws, void* out, int n_factors, int B, int blk, int blkp, int group,  \
                            int in_w, int ws_w, int out_w, int vec, int bt, int max_items,           \
                            void* stream) {                                                          \
    return faust::fwd::launch<T, T>(x, values, nullptr, meta, static_cast<const int*>(factors),      \
                                    n_factors, ws, out, B, blk, blkp, group, in_w, ws_w, out_w, vec, \
                                    bt, max_items, stream);                                          \
  }                                                                                                  \
  int chain_matmul_ctas_##suffix(int blkp, int bt, int* smem_bytes) {                             \
    return faust::fwd::ctas<T, T>(blkp, bt, smem_bytes);                                             \
  }

// K4: int8 / fp8 codes with (S, blk) f32 row scales.
#define FAUST_CHAIN_K4(suffix, T, V)                                                                \
  int chain_matmul_q_##suffix(const void* x, const void* values, const void* scales,                \
                              const void* meta, const void* factors, void* ws, void* out,            \
                              int n_factors, int B, int blk, int blkp, int group, int in_w,          \
                              int ws_w, int out_w, int vec, int bt, int max_items, void* stream) {   \
    return faust::fwd::launch<T, V>(x, values, static_cast<const float*>(scales), meta,              \
                                    static_cast<const int*>(factors), n_factors, ws, out, B, blk,    \
                                    blkp, group, in_w, ws_w, out_w, vec, bt, max_items, stream);     \
  }                                                                                                  \
  int chain_matmul_ctas_q_##suffix(int blkp, int bt, int* smem_bytes) {                           \
    return faust::fwd::ctas<T, V>(blkp, bt, smem_bytes);                                             \
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
