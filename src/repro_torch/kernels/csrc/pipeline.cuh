// Building blocks of the hand-written kernels: element types, asynchronous
// staging and the tensor-core and FFMA tile products.
//
// Users: chain_fwd.cuh (K1/K4, and K3's forward recompute), chain_dgrad.cuh
// (K2/K5 dgrad, and K3's reversed walk), chain_wgrad.cu (K3's emission) and
// bsr_matmul.cu (K6).
//
// Tiles are staged with cp.async into a 2-stage shared-memory ring; every
// global tile is read through L2 only (cp.async.cg, or __ldcg where a row is
// not a multiple of 16 bytes): the persistent kernels' workspaces are
// rewritten by other CTAs during a launch, so no read may be served from L1
// or the read-only path.  bf16 tiles go through mma.sync.m16n8k16 (bf16 in,
// f32 accumulate) with operands loaded by ldmatrix from padded shared tiles;
// f32 tiles through FFMA with 128-bit shared loads (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

// A source may be compiled in parts, one nvcc each, all started together,
// and linked into its one library (kernels/build.py, PARTS): part
// FAUST_PART of FAUST_PARTS defines the entry points i with i % FAUST_PARTS
// == FAUST_PART, so it instantiates only their kernels.  Without the flags
// a source is one part.
#ifndef FAUST_PARTS
#define FAUST_PARTS 1
#define FAUST_PART 0
#endif
#define FAUST_IN_PART(i) ((i) % FAUST_PARTS == FAUST_PART)

namespace faust {

constexpr int kThreads = 256;  // every kernel runs 8 warps a CTA
constexpr int kWidth = 128;    // columns of a work item's output tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Stored value types that are codes with row scales (not plain values).
template <typename V>
struct is_code : std::false_type {};
template <>
struct is_code<int8_t> : std::true_type {};
template <>
struct is_code<__nv_fp8_e4m3> : std::true_type {};
template <>
struct is_code<__nv_fp8_e5m2> : std::true_type {};

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

// acc (TM x 128) += A @ B on tensor cores: A is the activation tile (TM
// rows, pitch P; the block that feeds output chunk ch starts at column
// gofs[ch]), B the value tile (kdim rows of 128 columns, pitch P, k-major as
// stored, loaded by ldmatrix.trans).  kdim is a multiple of 16.
template <int TM, int P>
__device__ __forceinline__ void mma_slot(MmaAcc<TM>& acc, const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                         int kdim, const int (&gofs)[MmaShape<TM>::kCH]) {
  using S = MmaShape<TM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int arow = wm * S::kWM + (lane % 16), acol = (lane / 16) * 8;
  const int brow = lane % 16, bcol = wn * S::kWN + (lane / 16) * 8;
  for (int kk = 0; kk < kdim; kk += 16) {
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

// ---- f32: FFMA -------------------------------------------------------------
// Thread (ty, tx) of 16 x 16 owns rows ty + 16 i and the 4-column runs
// starting at tx * 4 and 64 + tx * 4; a run never crosses a block (blocks
// are 16-column multiples), so each run reads one block's activations,
// starting at column gofs[h] of the activation tile.
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

// acc (TM x 128) += A @ B in f32: A (TM rows, pitch P), B (kdim rows of 128
// columns, pitch P); kdim is a multiple of 4.
template <int TM, int P>
__device__ __forceinline__ void fma_slot(FmaAcc<TM>& acc, const float* sa, const float* sb, int kdim,
                                         const int (&gofs)[2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kk = 0; kk < kdim; kk += 4) {
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

// Raise `kernel`'s dynamic shared memory limit to `smem_max` once per
// device (the first call on each).
template <typename K>
cudaError_t allow_smem(K kernel, bool (&attr_set)[64], int smem_max) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  return cudaSuccess;
}

// Resident CTAs of `kernel` at `smem` bytes of dynamic shared memory:
// occupancy x SM count (negative: an error code).  Asked once per device
// and `slot` (the caller's index of its layouts) and kept in `cache` (the
// count + 1; 0: not asked yet): a persistent kernel sizes its grid from it
// at every launch, and the query costs microseconds of host time.
template <typename K, int N>
int resident_ctas(K kernel, bool (&attr_set)[64], int (&cache)[64][N], int slot, int smem_max, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64 || slot < 0 || slot >= N)) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return -(int)e;
  if (cache[dev][slot] > 0) return cache[dev][slot] - 1;
  e = allow_smem(kernel, attr_set, smem_max);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  cache[dev][slot] = per_sm * sms + 1;
  return per_sm * sms;
}

}  // namespace faust
