// Staging and tensor-core helpers of the persistent chain kernels
// (chain_matmul.cu: K1/K4, chain_dgrad.cu: K2/K5 dgrad).
//
// Both kernels stage tiles with cp.async into a 2-stage shared-memory ring
// and read every global tile through L2 only (cp.async.cg, or __ldcg where
// a row is not a multiple of 16 bytes): their workspace is rewritten by
// other CTAs during the launch, so no read may be served from L1 or the
// read-only path.  bf16 tiles go through mma.sync.m16n8k16 (bf16 in, f32
// accumulate) with operands loaded by ldmatrix from padded shared tiles.
#pragma once

#include <cstring>

#include "tile.cuh"

namespace faust {

constexpr int kWidth = 128;  // columns of a persistent kernel's work item

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
// `gv` groups; group g's source is src_of(g) (nullptr: skip the group), its
// destination dst + g * dst_g.  16-byte cp.async when `vec`, else one L2
// load per element.  Threads map to (group, row, chunk) once per call: a
// group of fewer chunks than threads shares the CTA with the next groups, a
// larger one is walked group by group.
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
      for (int g = gi; g < gv; g += gpp) {
        const E* s = src_of(g);
        if (s) cp_async16(dst + g * dst_g + r * ld_dst + c, s + r * ld_src + c);
      }
      return;
    }
    for (int g = 0; g < gv; ++g) {
      const E* s = src_of(g);
      if (!s) continue;
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
      if (!s) continue;
      E* d = dst + g * dst_g;
      for (int e = threadIdx.x; e < n * len; e += kThreads) {
        const int r = e / len, c = e - r * len;
        d[r * ld_dst + c] = ld_l2(s + r * ld_src + c);
      }
    }
  }
}

// ---- bf16: mma.sync.m16n8k16 ----------------------------------------------
// 8 warps as WARPS_M x WARPS_N; a warp owns WM x WN of the TM x 128 tile:
// MT m16 tiles by NT n8 tiles, CH 16-column chunks.
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

}  // namespace faust
