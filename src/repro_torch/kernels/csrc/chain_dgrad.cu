// K2: the input gradient of the FAuST chain, dx = dy @ F_J^T @ ... @ F_1^T,
// in one launch on Hopper (sm_90a), and K5's dgrad half: the same walk over
// a quantized chain (int8 / fp8 codes with f32 row scales).
//
// K2 replaces the TPU kernel repro/kernels/chain_bwd.py:283 chain_dgrad
// (body _dgrad_kernel at :231: grid (batch tiles, S reversed steps) running
// in order, dy staged into a (2, max_blocks, bt, blk) f32 VMEM ping-pong,
// each step scatter-accumulating g @ F[s]^T into the other buffer).  K5's
// dgrad half replaces the same function called with scales= (dequant of
// the streamed block at chain_bwd.py:262-263).
//
//   dy      (B, O_J*blk)       f32 or bf16, the cotangent of the padded output
//   values  (S, blk, blk)      dy's dtype, or int8 / fp8 e4m3 / fp8 e5m2 codes
//   scales  (S, blk)           codes only: f32 scale of each stored block row
//   meta    (S, 5)             int32 reversed step table (chain_bwd.py dgrad_meta);
//                              the kernel reads src_blk (column 1) and ncols (column 4)
//                              of flat step s at row S-1-s
//   ptr     (sum_j IB_j + 1)   int32 transposed step table (chain_bwd.py dgrad_gather):
//   steps   (S,)               the steps that read input block i of factor j are
//                              steps[ptr[pbase_j + i] .. ptr[pbase_j + i + 1]), ascending
//   factors                    per factor j: pbase_j, input blocks IB_j, groups
//                              ceil(IB_j / group), chunks of the reader lists
//                              (chain_bwd.py dgrad_schedule)
//   ws      (2, B, ws_w)       dy's dtype: the intermediate cotangents (J > 1)
//   dx      (B, IB_1*blk)      dy's dtype
//   part    (C_j, B, IB_j*blk) f32 partial sums of the factors split in C_j > 1 chunks
//
// What bounds it.  The same 2*B*s_tot operations on the same s_tot weights
// as the forward (K1): bytes at serving batches, operations (bf16 tensor
// cores, or f32 FFMA at 67e12/s) at prefill batches.  The first version ran
// one CTA per batch tile through all S reversed steps in order, zeroing
// each destination factor and scatter-adding every step under a
// __syncthreads(): 8 CTAs on 132 SMs at B = 128, and a time that followed
// the walk's length (672 steps on the gemma-2b up-projection, 64,512 on the
// FAuST unembedding), not its work.
//
// Design (K1's, chain_matmul.cu, turned into a gather).
// (1) Persistent schedule.  About one CTA per SM (occupancy x SM count,
//     resident by cooperative launch) walks the factors in reverse, one
//     cooperative_groups grid barrier between them: J - 1 barriers, one
//     launch.  Within factor j a work item is (batch tile of TM rows, group
//     of `group` = 128 / blkp consecutive *input* blocks of F_j, chunk of
//     their reader lists), item i being batch tile i % n_tiles of group
//     (i / n_tiles) % groups, chunk i / (n_tiles * groups); CTA c takes
//     items c, c + grid, ...  So at block 16 an item fills a 128-column tile with
//     8 input blocks, and the batch tiles of one group run side by side
//     and share its value blocks through L2.
// (2) Items own their destination: no atomics, no zeroing pass.  The item
//     gathers sum_s g[:, o(s)] @ F[s]^T over the steps s that read its
//     input blocks (the transposed table), in rounds: round r takes the
//     r-th reader of each of its blocks (a block with fewer readers sits
//     the round out), accumulates in registers and flushes once after its
//     last round.  A block no step reads is flushed as zeros (an item
//     always runs at least one round).  Readers are summed in ascending
//     step order: the result is the same bits run to run.
//     Split lists.  Where a factor has fewer items than resident CTAs (the
//     serving batch: the up-projection's reversed F_3 has 16 input blocks
//     of about 32 readers each, 32 items at B = 128 and bt 64), the host
//     cuts each item's rounds into `chunks` pieces (chain_bwd.py
//     dgrad_schedule); each piece flushes an f32 partial sum, and after a
//     grid barrier the grid adds the pieces in chunk order and writes the
//     destination: deterministic too, one more barrier for that factor.
// (3) Asynchronous staging.  A CTA's rounds in factor j form one sequence
//     over its items; round q + 1 is fetched with cp.async into a 2-stage
//     shared-memory ring while round q computes, and round q + 2 is
//     described (its steps and source blocks, read from the tables) into
//     shared memory, so no fetch waits on a chain of table loads (paid at
//     every fetch, that chain made rounds on the H100 about 1.4x slower at
//     the unembedding; PERF.md).  The cotangent of factor
//     j + 1 lies in ws, written by other CTAs in this launch, so every
//     global read is L2-only (pipeline.cuh); the grid barrier orders the
//     flushes of one factor before the reads of the next.  The source
//     columns >= ncols of a step's output block (the forward zeroed them)
//     are zeroed in shared memory before the round computes.
// (4) bf16 on tensor cores (K2 bf16, K5 with bf16 dy): mma.sync.m16n8k16,
//     operands by ldmatrix.  The value block is read transposed, g @ F^T:
//     the stored block is (n rows, k columns), which is the MMA's "col"
//     B operand as it lies, so B is staged as stored (row g*blkp + n of the
//     B tile) and loaded by a non-transposing ldmatrix (K1 transposes).
//     K5 on bf16 dy: codes convert to bf16 exactly; scaling a block's rows
//     commutes with the transposed read, g @ (diag(s) Q)^T = (g @ Q^T)
//     diag(s), so each round's MMA partial is multiplied columnwise by its
//     step's f32 scale row and added to the accumulator: no rounding of
//     g*s as K4 has.
//     Numerics: the intermediate cotangents are stored in dy's dtype, so
//     in bf16 they round to bf16 between factors where the reference keeps
//     them in f32 (cot_ref, chain_bwd.py:255); the MMA takes them as bf16
//     operands.  Within the bf16 tolerance of 3e-2*max|dx|.
// (5) f32 stays full-f32 FFMA (K2 f32, K5 with f32 dy): no TF32.  Thread
//     (ty, tx) owns rows ty + 16 i and columns tx + 16 e (e < 8); the B
//     tile lies as stored, (n, k), so a thread reads 4 k of one column and
//     4 k of one activation row with 128-bit shared loads.
// (6) K5 dequantizes once per launch.  Before the walk the whole grid
//     writes every code dequantized into deq (dy's dtype; f32: the plain
//     version's f32 product q*s; bf16: the code, exact, its scale applied
//     after the MMA as in (4)), then one grid barrier; the walk stages deq
//     as K2 stages values.  Converting codes per round in shared memory
//     instead (K4's way) costs a pass and a barrier per round: K5 bf16 ran
//     1.7x K2 at B = 4096 on the H100 that way (PERF.md).
//
// Accumulation is f32; dx and the intermediates are written in dy's dtype.
#include "chain_dgrad.cuh"

namespace faust {
namespace bwd {
namespace {

// K2/K5-dgrad: factor J reads dy, factor 1 writes dx, the others ping-pong
// through ws (the factor r-th from the end writes buffer r % 2).
template <typename T, typename V>
int dgrad(const void* dy, const void* values, const float* scales, const void* meta, const void* ptr,
          const void* steps, const int* factors, void* ws, void* dx, void* deq, void* part, int n_factors, int B,
          int S, int blk, int blkp, int group, int out_w, int ws_w, int in_w, int vec, int bt, int max_items,
          void* stream) {
  Args a;
  if (!set_factors(a, factors, n_factors)) return (int)cudaErrorInvalidValue;
  a.values = values;
  a.scales = scales;
  a.meta = static_cast<const int*>(meta);
  a.ptr = static_cast<const int*>(ptr);
  a.steps = static_cast<const int*>(steps);
  a.deq = deq;
  a.part = static_cast<float*>(part);
  a.B = B;
  a.S = S;
  a.blk = blk;
  a.blkp = blkp;
  a.group = group;
  a.vec = vec;
  a.j_lo = 0;
  a.meta_cols = 5;  // kernels/chain_bwd.py dgrad_meta
  T* buf = static_cast<T*>(ws);
  const long long half = (long long)B * ws_w;
  for (int j = 0; j < n_factors; ++j) {
    const int r = n_factors - 1 - j;
    a.src[j] = r == 0 ? dy : static_cast<const void*>(buf + ((r + 1) % 2) * half);
    a.lda[j] = r == 0 ? out_w : ws_w;
    a.dst[j] = j == 0 ? dx : static_cast<void*>(buf + (r % 2) * half);
    a.ldd[j] = j == 0 ? in_w : ws_w;
  }
  return launch<T, V>(a, bt, max_items, stream);
}

}  // namespace
}  // namespace bwd
}  // namespace faust

extern "C" {

// factors: host int32 (n_factors, 4) table; deq (K5): (S, blk, blk) in dy's
// dtype for the dequantized codes; part: f32 partial sums of the split
// factors (chunks > 1), max over them of chunks * B * IB_j * blk floats;
// max_items: the most items of any factor (the grid never exceeds it).
// Returns a cudaError_t code.  chain_dgrad_ctas_*: resident CTAs at this
// padded block and tile, and the dynamic shared memory of one CTA
// (negative: error).

// K2: values in dy's dtype.
#define FAUST_DGRAD(suffix, T)                                                                           \
  int chain_dgrad_##suffix(const void* dy, const void* values, const void* meta, const void* ptr,        \
                           const void* steps, const void* factors, void* ws, void* dx, void* part,       \
                           int n_factors, int B, int S, int blk, int blkp, int group, int out_w,         \
                           int ws_w, int in_w, int vec, int bt, int max_items, void* stream) {           \
    return faust::bwd::dgrad<T, T>(dy, values, nullptr, meta, ptr, steps,                               \
                                    static_cast<const int*>(factors), ws, dx, nullptr, part, n_factors,  \
                                    B, S, blk, blkp, group, out_w, ws_w, in_w, vec, bt, max_items,       \
                                    stream);                                                             \
  }                                                                                                      \
  int chain_dgrad_ctas_##suffix(int blkp, int bt, int* smem_bytes) {                                    \
    return faust::bwd::ctas<T, T>(blkp, bt, smem_bytes);                                                 \
  }

// K5 (dgrad): int8 / fp8 codes with (S, blk) f32 row scales.
#define FAUST_DGRAD_Q(suffix, T, V)                                                                      \
  int chain_dgrad_q_##suffix(const void* dy, const void* values, const void* scales, const void* meta,  \
                             const void* ptr, const void* steps, const void* factors, void* ws,          \
                             void* dx, void* deq, void* part, int n_factors, int B, int S, int blk,      \
                             int blkp, int group, int out_w, int ws_w, int in_w, int vec, int bt,        \
                             int max_items, void* stream) {                                              \
    return faust::bwd::dgrad<T, V>(dy, values, static_cast<const float*>(scales), meta, ptr, steps,    \
                                    static_cast<const int*>(factors), ws, dx, deq, part, n_factors, B,   \
                                    S, blk, blkp, group, out_w, ws_w, in_w, vec, bt, max_items, stream); \
  }                                                                                                      \
  int chain_dgrad_ctas_q_##suffix(int blkp, int bt, int* smem_bytes) {                                  \
    return faust::bwd::ctas<T, V>(blkp, bt, smem_bytes);                                                 \
  }

#if FAUST_IN_PART(0)
FAUST_DGRAD(f32, float)
#endif
#if FAUST_IN_PART(1)
FAUST_DGRAD(bf16, __nv_bfloat16)
#endif
#if FAUST_IN_PART(2)
FAUST_DGRAD_Q(f32_int8, float, int8_t)
#endif
#if FAUST_IN_PART(3)
FAUST_DGRAD_Q(f32_e4m3, float, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(4)
FAUST_DGRAD_Q(f32_e5m2, float, __nv_fp8_e5m2)
#endif
#if FAUST_IN_PART(5)
FAUST_DGRAD_Q(bf16_int8, __nv_bfloat16, int8_t)
#endif
#if FAUST_IN_PART(6)
FAUST_DGRAD_Q(bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
#endif
#if FAUST_IN_PART(7)
FAUST_DGRAD_Q(bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)
#endif

}  // extern "C"
