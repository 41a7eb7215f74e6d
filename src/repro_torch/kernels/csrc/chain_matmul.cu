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
//   scales  (S, blk) or (S,)   K4 only: f32 scale of each block row, or of each
//                              block (per_block); value = code * scale
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
//     column r of the activation tile.  The reference dequantizes in f32
//     before the dot (chain.py:104); the kernel keeps that product's
//     precision in one of two ways, by the scales the caller passes:
//     - per block (S,): the scale is constant over the block's rows, so
//       the slot's MMA runs on the staged x and the exact code, and its
//       f32 partial is multiplied by the block's scale: no conversion of x
//       at all.
//     - per row (S, blk): the scaled activation p = x*s is formed in f32
//       on each A fragment as ldmatrix gives it, and split in registers
//       in three bf16 parts, each the top 8 significant bits of what is
//       left (truncation: the remainders are exact, hi + mid + lo == p);
//       three MMAs on the exact code: hi @ q goes into the accumulator,
//       mid @ q + lo @ q (2^-8 of it) into a second one that joins at the
//       flush, so the tensor cores' accumulation does not round the small
//       parts three times a slot into the large sum.  The staged tiles are
//       the per-block mode's: two CTAs an SM at bt 64 and block 128 (split
//       in shared memory instead, two more activation tiles held one).
//     (Rounding x*s to bf16 once instead leaves 2^-9 of a term: several
//     times the error of the plain version against itself in another
//     summation order; PERF.md.)
// (4) f32 stays full-f32 FFMA (K1 f32, K4 with f32 x): no TF32, so it
//     matches the plain version to f32 summation order (1e-5*max|y|).
//     K4 f32 dequantizes each staged code with the plain version's f32
//     product q*s.  Each thread owns 4-column runs and reads 4 K values
//     of a row at once (128-bit shared loads).
//
// Numerics as the reference: f32 accumulation, intermediates stored in
// x.dtype (bf16 rounds between factors), tail columns >= ncols zeroed at
// each flush.  lambda and the feature/batch slicing stay in the caller.
#include "chain_fwd.cuh"

namespace faust {
namespace fwd {
namespace {

// K1/K4: factor 1 reads x, factor J writes y, the others ping-pong through
// ws (factor j reads buffer j % 2 and writes the other).
template <typename T, typename V>
int chain(const void* x, const void* values, const float* scales, const void* meta, const int* factors,
          int n_factors, void* ws, void* out, int B, int blk, int blkp, int group, int in_w, int ws_w,
          int out_w, int vec, int row_scales, int bt, int max_items, void* stream) {
  Args a;
  if (!set_factors(a, factors, n_factors)) return (int)cudaErrorInvalidValue;
  a.values = values;
  a.scales = scales;
  a.meta = static_cast<const int*>(meta);
  a.B = B;
  a.blk = blk;
  a.blkp = blkp;
  a.group = group;
  a.vec = vec;
  a.meta_cols = 7;  // kernels/ops.py chain_meta: in_blk in column 0, ncols in column 6
  a.ncols_col = 6;
  a.row_scales = row_scales;
  T* buf = static_cast<T*>(ws);
  const long long half = (long long)B * ws_w;
  for (int j = 0; j < n_factors; ++j) {
    a.src[j] = j == 0 ? x : static_cast<const void*>(buf + (j % 2) * half);
    a.lda[j] = j == 0 ? in_w : ws_w;
    a.dst[j] = j == n_factors - 1 ? out : static_cast<void*>(buf + ((j + 1) % 2) * half);
    a.ldd[j] = j == n_factors - 1 ? out_w : ws_w;
  }
  return launch<T, V>(a, bt, max_items, stream);
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
    return faust::fwd::chain<T, T>(x, values, nullptr, meta, static_cast<const int*>(factors),      \
                                    n_factors, ws, out, B, blk, blkp, group, in_w, ws_w, out_w, vec, \
                                    0, bt, max_items, stream);                                       \
  }                                                                                                  \
  int chain_matmul_ctas_##suffix(int blkp, int bt, int* smem_bytes) {                             \
    return faust::fwd::ctas<T, T>(blkp, bt, smem_bytes);                                             \
  }

// K4: int8 / fp8 codes with f32 scales: (S, blk), one per block row, when
// row_scales, else (S,), one per block.
#define FAUST_CHAIN_K4(suffix, T, V)                                                                \
  int chain_matmul_q_##suffix(const void* x, const void* values, const void* scales,                \
                              const void* meta, const void* factors, void* ws, void* out,            \
                              int n_factors, int B, int blk, int blkp, int group, int in_w,          \
                              int ws_w, int out_w, int vec, int row_scales, int bt, int max_items,   \
                              void* stream) {                                                        \
    return faust::fwd::chain<T, V>(x, values, static_cast<const float*>(scales), meta,              \
                                    static_cast<const int*>(factors), n_factors, ws, out, B, blk,    \
                                    blkp, group, in_w, ws_w, out_w, vec, row_scales, bt, max_items,  \
                                    stream);                                                         \
  }                                                                                                  \
  int chain_matmul_ctas_q_##suffix(int blkp, int bt, int* smem_bytes) {                           \
    return faust::fwd::ctas<T, V>(blkp, bt, smem_bytes);                                             \
  }

#if FAUST_IN_PART(0)
FAUST_CHAIN_K1(f32, float)
#endif
#if FAUST_IN_PART(1)
FAUST_CHAIN_K1(bf16, __nv_bfloat16)
#endif
#if FAUST_IN_PART(2)
FAUST_CHAIN_K4(f32_int8, float, int8_t)
#endif
#if FAUST_IN_PART(3)
FAUST_CHAIN_K4(f32_e4m3, float, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(4)
FAUST_CHAIN_K4(f32_e5m2, float, __nv_fp8_e5m2)
#endif
#if FAUST_IN_PART(5)
FAUST_CHAIN_K4(bf16_int8, __nv_bfloat16, int8_t)
#endif
#if FAUST_IN_PART(6)
FAUST_CHAIN_K4(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(7)
FAUST_CHAIN_K4(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)
#endif

}  // extern "C"
