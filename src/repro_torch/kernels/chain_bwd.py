"""K2 ``chain_dgrad`` and K3 ``chain_wgrad``: the fused FAµST chain's
backward, and K5: both on int8/fp8 codes with f32 row scales — the
wrappers of the CUDA kernels ``csrc/chain_dgrad.cu`` and
``csrc/chain_wgrad.cu``, their step tables, and their plain PyTorch
versions.  Counterpart of :mod:`repro.kernels.chain_bwd`.

Replaces ``repro/kernels/chain_bwd.py:283 chain_dgrad`` and ``:433
chain_wgrad`` (Pallas, TPU); K5 those functions called with ``scales=``.

* **dgrad** ``dx = dy @ F_Jᵀ ⋯ F_1ᵀ``: a persistent grid walks the factors
  in reverse, one grid barrier between them.  Within factor j a work item
  is (batch tile, group of consecutive input blocks) and *gathers* the
  steps that read its blocks, listed by the transposed step table
  (:func:`dgrad_gather`); it flushes each block once, so no atomics and
  no zeroing.  :func:`dgrad_schedule` is the kernel's work split.
* **wgrad** ``dvalues[s] = a_jᵀ g_j``: the forward recompute of every
  intermediate activation (K1's persistent factor loop over factors
  1..J-1), the reversed walk of every intermediate cotangent (K2's gather
  schedule over factors J..2), each into its own workspace region, then an
  emission whose items are (column group of output blocks, slot, chunk of
  the batch) and sum over the batch.  No per-batch-tile partial slabs
  exist: ``csrc/chain_wgrad.cu`` says why.  :func:`wgrad_schedule` is its
  work split.  Output f32; for a quantized chain the gradient is with
  respect to the dequantized f32 values.

The step tables equal the reference's: the static columns from the plan
(uploaded once per plan and device), the runtime ``in_idx`` in column 0.
The dgrad and wgrad tables and their transposed form are built once per
state of ``in_idx`` (data pointer and version counter) and reused.

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version (``chain_dgrad_plain``/``chain_wgrad_plain``: the reference's
``chain_bwd_ref`` walk in f32), through the operators
``repro_torch::chain_dgrad``/``chain_wgrad`` while a dispatch mode counts
or fakes the call (:mod:`repro_torch.kernels.library`).  ``chain_dgrad.launches`` /
``chain_dgrad.q_launches`` count K2 / K5 dgrad calls,
``chain_wgrad.launches`` / ``chain_wgrad.q_launches`` K3 / K5 wgrad calls
(one count per call; a wgrad call of a chain with J > 1 launches its
recompute, its walk and its emission, and a fourth kernel where the
emission's batch is cut into chunks).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.compress import ChainPlan
from repro_torch.kernels import build, library
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chain import (
    DGRAD_BT,
    DTYPES,
    MAX_BLOCK,
    MAX_FACTORS,
    QDTYPES,
    SUPPORTED_BT,
    TILE_W,
    WGRAD_BT,
    _factor_array,
    _factor_table,
    _vec,
    padded_block,
)

# dgrad table, one row per *reversed* step t (flat step s = S-1-t):
#   0 dst_blk  input block the step scatter-adds into (runtime in_idx)
#   1 src_blk  output block of the cotangent this step reads
#   2 parity   ping-pong buffer holding this factor's cotangent ((J-1-j) % 2)
#   3 is_j0    first reversed step of a factor
#   4 ncols    valid columns of the source block (the rest are masked)
# The dgrad kernel reads columns 1 and 4; its walk order comes from the
# transposed table (dgrad_gather).
DGRAD_META_COLS = 5
# wgrad table: S_pre forward-recompute rows (factors 1..J-1), then S
# reversed rows:
#   recompute: 0 in_blk (runtime) 1 out_blk 2 is_k0 3 is_kend 4 ncols
#              5 act_off_in 6 act_off_out
#   walk:      0 dst_blk (runtime) 1 src_blk 2 parity 3 is_j0 4 ncols
#              5 act_off_j 6 propagate (0 on factor 1)
WGRAD_META_COLS = 7


def _ncols(plan: ChainPlan, j: int, o: np.ndarray) -> np.ndarray:
    return np.minimum(plan.block, plan.out_feats[j] - o * plan.block)


@functools.lru_cache(maxsize=64)
def _dgrad_meta_static(plan: ChainPlan) -> np.ndarray:
    """Static dgrad columns (1..4), rows already in reversed step order."""
    rows = []
    for j in range(plan.n_factors):
        o_count, k_count = plan.out_blocks[j], plan.k_blocks[j]
        o = np.repeat(np.arange(o_count), k_count)
        cols = np.empty((o_count * k_count, DGRAD_META_COLS - 1), dtype=np.int32)
        cols[:, 0] = o  # src_blk
        cols[:, 1] = (plan.n_factors - 1 - j) % 2  # parity
        start = np.zeros(o_count * k_count, dtype=np.int32)
        start[-1] = 1  # the factor's last flat step is its first reversed one
        cols[:, 2] = start
        cols[:, 3] = _ncols(plan, j, o)
        rows.append(cols)
    return np.concatenate(rows, axis=0)[::-1].copy()


def _act_offsets(plan: ChainPlan) -> tuple[int, ...]:
    """Block offset of each factor's *input* activation in the flat layout
    (factor 1's input, x, at 0)."""
    offs = [0]
    for ib in plan.in_blocks:
        offs.append(offs[-1] + ib)
    return tuple(offs)


@functools.lru_cache(maxsize=64)
def _wgrad_meta_static(plan: ChainPlan) -> np.ndarray:
    """Static wgrad columns (1..6): ``S_pre`` recompute rows for factors
    1..J-1, then ``S`` reversed walk rows."""
    actoff = _act_offsets(plan)
    fwd = []
    for j in range(plan.n_factors - 1):  # the last factor's output is not needed
        o_count, k_count = plan.out_blocks[j], plan.k_blocks[j]
        o = np.repeat(np.arange(o_count), k_count)
        k = np.tile(np.arange(k_count), o_count)
        cols = np.empty((o_count * k_count, WGRAD_META_COLS - 1), dtype=np.int32)
        cols[:, 0] = o  # out_blk
        cols[:, 1] = k == 0  # is_k0
        cols[:, 2] = k == k_count - 1  # is_kend
        cols[:, 3] = _ncols(plan, j, o)
        cols[:, 4] = actoff[j]  # act_off_in
        cols[:, 5] = actoff[j + 1]  # act_off_out
        fwd.append(cols)
    bwd = []
    for j in range(plan.n_factors):
        o_count, k_count = plan.out_blocks[j], plan.k_blocks[j]
        o = np.repeat(np.arange(o_count), k_count)
        cols = np.empty((o_count * k_count, WGRAD_META_COLS - 1), dtype=np.int32)
        cols[:, 0] = o  # src_blk
        cols[:, 1] = (plan.n_factors - 1 - j) % 2  # parity
        start = np.zeros(o_count * k_count, dtype=np.int32)
        start[-1] = 1
        cols[:, 2] = start  # is_j0
        cols[:, 3] = _ncols(plan, j, o)
        cols[:, 4] = actoff[j]  # act_off_j
        cols[:, 5] = int(j > 0)  # propagate
        bwd.append(cols)
    return np.concatenate(fwd + [np.concatenate(bwd, axis=0)[::-1]], axis=0).copy()


@functools.lru_cache(maxsize=64)
def _block_base(plan: ChainPlan) -> np.ndarray:
    """Per flat step: the first entry of its factor in the transposed
    table's block axis (the input blocks of the earlier factors)."""
    return np.repeat(_act_offsets(plan)[:-1], np.diff(plan.offsets)).astype(np.int64)


def _static_table(plan: ChainPlan, device: torch.device, kind: str) -> torch.Tensor:
    table = {"dgrad": _dgrad_meta_static, "wgrad": _wgrad_meta_static, "block_base": _block_base}[kind]
    return torch.from_numpy(table(plan)).to(device)


_static_cached = functools.lru_cache(maxsize=64)(_static_table)


def _static_on(plan: ChainPlan, device: torch.device, kind: str) -> torch.Tensor:
    """A static table on ``device``, uploaded once per plan (every time on
    fake tensors: the cache holds no fake tensor)."""
    return (_static_table if library.faking() else _static_cached)(plan, device, kind)


_MEMO_MAX = 16
_META_MEMO: collections.OrderedDict = collections.OrderedDict()
_WMETA_MEMO: collections.OrderedDict = collections.OrderedDict()
_GATHER_MEMO: collections.OrderedDict = collections.OrderedDict()


def _memo(memo: collections.OrderedDict, plan: ChainPlan, t: torch.Tensor, build):
    """``build()`` once per plan and state of ``t``: keyed by its data
    pointer, layout and version counter (an in-place update rebuilds); the
    entry holds ``t``, so its memory is not reused while the entry lives."""
    if library.faking():  # a fake tensor has no data pointer to key on
        return build()
    key = (plan, t.device, t.data_ptr(), tuple(t.shape), t.stride(), t._version)
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = (t, build())
        if len(memo) > _MEMO_MAX:
            memo.popitem(last=False)
    else:
        memo.move_to_end(key)
    return hit[1]


def dgrad_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S, DGRAD_META_COLS)`` reversed step table on ``in_idx``'s
    device: the reversed ``in_idx`` in column 0, the static columns after.
    Built once per state of ``in_idx``."""

    def build():
        static = _static_on(plan, in_idx.device, "dgrad")
        return torch.cat([in_idx.flip(0).reshape(-1, 1).to(torch.int32), static], dim=1)

    return _memo(_META_MEMO, plan, in_idx, build)


def dgrad_gather(plan: ChainPlan, in_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The transposed step table, ``(ptr, steps)`` int32 on ``in_idx``'s
    device: the flat steps that read input block ``i`` of factor ``j`` are
    ``steps[ptr[b] : ptr[b + 1]]``, ascending, with ``b = Σ_{j'<j} IB_j' + i``.
    A stable sort of the steps by (factor, input block); the offsets count
    the sorted keys below each block (``searchsorted``, which, unlike a
    bincount, needs no host sync to size its output)."""
    key = in_idx.to(torch.int64) + _static_on(plan, in_idx.device, "block_base")
    sorted_key, order = torch.sort(key, stable=True)
    blocks = torch.arange(sum(plan.in_blocks) + 1, device=in_idx.device)
    ptr = torch.searchsorted(sorted_key, blocks, out_int32=True)
    return ptr, order.to(torch.int32)


def _gather_for(plan: ChainPlan, meta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dgrad_gather` of the ``in_idx`` a dgrad table carries, once
    per state of the table (:func:`dgrad_meta` returns one table per state
    of ``in_idx``, so a training step finds it built)."""
    return _memo(_GATHER_MEMO, plan, meta, lambda: dgrad_gather(plan, meta[:, 0].flip(0)))


def wgrad_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S_pre + S, WGRAD_META_COLS)`` two-phase table: the recompute
    rows carry the forward ``in_idx``, the walk rows the reversed one.
    Built once per state of ``in_idx``."""

    def build():
        static = _static_on(plan, in_idx.device, "wgrad")
        s_pre = plan.offsets[plan.n_factors - 1]
        idx = torch.cat([in_idx[:s_pre], in_idx.flip(0)]).reshape(-1, 1).to(torch.int32)
        return torch.cat([idx, static], dim=1)

    return _memo(_WMETA_MEMO, plan, in_idx, build)


def _wgather_for(plan: ChainPlan, meta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dgrad_gather` of the ``in_idx`` a wgrad table's walk rows
    carry, once per state of the table."""
    s_pre = plan.offsets[plan.n_factors - 1]
    return _memo(_GATHER_MEMO, plan, meta, lambda: dgrad_gather(plan, meta[s_pre:, 0].flip(0)))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _recompute(x, values, in_idx, plan) -> list[torch.Tensor]:
    """Every factor's input activation (x, then factor outputs, tails zeroed)."""
    acts = [x]
    for j in range(plan.n_factors - 1):
        vj, ij = _ref.factor_slices(values, in_idx, plan, j)
        acts.append(_ref._mask_tail(_ref.bsr_matmul_ref(acts[-1], vj, ij), plan.out_feats[j]))
    return acts


def _walk(values, in_idx, dy, plan, acts=None):
    """The reversed walk: ``(dx, dvalues or None)``."""
    blk = plan.block
    g, dvals = dy, []
    for j in reversed(range(plan.n_factors)):
        vj, ij = _ref.factor_slices(values, in_idx, plan, j)
        g = _ref._mask_tail(g, plan.out_feats[j])  # the forward zeroed the tail
        if acts is not None:
            dvals.append(_ref.bsr_matmul_dvalues(acts[j], g, ij, (blk, blk)).reshape(-1, blk, blk))
        g = _ref.bsr_matmul_dx(g, vj, ij, plan.in_blocks[j] * blk)
    return g, (torch.cat(dvals[::-1]) if acts is not None else None)


def chain_bwd_ref(
    x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor, dy: torch.Tensor, *, plan: ChainPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dvalues)`` by the reference's rematerializing walk (the
    autodiff of ``ref.packed_chain_ref``), in the caller's dtypes; any
    leading batch dims."""
    return _walk(values, in_idx, dy, plan, _recompute(x, values, in_idx, plan))


_ROWS_MEMO: collections.OrderedDict = collections.OrderedDict()


def _row_scales_for(plan: ChainPlan, scales: torch.Tensor) -> torch.Tensor:
    """Scales as ``(S, blk)`` rows (one per block broadcast to its rows), as
    the dgrad kernel takes them; built once per state of ``scales`` (a
    training step updates them in place, which rebuilds)."""
    if scales.ndim == 2:
        return scales
    return _memo(_ROWS_MEMO, plan, scales,
                 lambda: scales.detach()[:, None].expand(-1, plan.block).contiguous())


def _f32_values(values: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    return values.float() if scales is None else _ref.dequant_values(values, scales)


def chain_dgrad_plain(
    dy: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *, plan: ChainPlan,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2's (and K5's) plain version: the reference walk in f32 (codes
    dequantized first), dx cast to dy's dtype."""
    in_idx = meta[:, 0].flip(0)
    dx, _ = _walk(_f32_values(values, scales), in_idx, dy.float(), plan)
    return dx.to(dy.dtype)


def chain_wgrad_plain(
    x: torch.Tensor, dy: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *,
    plan: ChainPlan, scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3's (and K5's) plain version: recompute and walk in f32, f32
    ``(S, blk, blk)`` dvalues (wrt the dequantized values for codes)."""
    s_pre = plan.offsets[plan.n_factors - 1]
    in_idx = meta[s_pre:, 0].flip(0)
    v = _f32_values(values, scales)
    _, dv = _walk(v, in_idx, dy.float(), plan, _recompute(x.float(), v, in_idx, plan))
    return dv


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


# A factor with at most half as many work items as resident CTAs has its
# reader lists cut into chunks (partial sums, reduced after a grid barrier),
# as many as fit the CTAs but no more than keep about this many readers a
# chunk.  A split adds a barrier and a reduction: splitting a factor whose
# items nearly fill the CTAs (the unembedding's 256 on 264) lost time on the
# H100, and 2 readers a chunk beat 8 at the up-projection's B = 128 in f32
# (PERF.md; dgrad_probe.py measures both).
CHUNK_READERS = 2


@dataclasses.dataclass(frozen=True)
class DgradSchedule:
    """K2/K5-dgrad's work split of one plan at one batch and batch tile.
    The kernel walks the factors in reverse (j = J-1 … 0); within factor
    j, item i is batch tile ``i % n_tiles`` of input-block group
    ``(i // n_tiles) % groups``, chunk ``i // (n_tiles · groups)`` of the
    blocks' reader lists, and CTA c takes items c, c + grid, …"""

    block: int
    blkp: int  # the block padded to a multiple of the MMA depth
    group: int  # input blocks per work item: TILE_W // blkp
    bt: int
    batch: int
    # per factor j: (first entry in the transposed table's block axis,
    # input blocks IB_j, input-block groups, chunks)
    factors: tuple[tuple[int, int, int, int], ...]

    @property
    def n_tiles(self) -> int:
        return -(-self.batch // self.bt)

    @property
    def items(self) -> tuple[int, ...]:
        """Work items per factor (indexed by factor j)."""
        return tuple(self.n_tiles * f[2] * f[3] for f in self.factors)

    def item(self, j: int, i: int, ptr, steps) -> tuple[range, range, int, list[list[int]]]:
        """Work item ``i`` of factor ``j`` as the kernel decodes it, given
        the transposed table ``(ptr, steps)``: its batch rows, its input
        blocks, its chunk and its rounds, round r holding reader
        ``r0 + r`` of each block (-1 when the block has fewer).  Chunk k of
        C takes readers ``[k·R, (k+1)·R)``, R = ⌈n / C⌉ for the block's
        longest list n; an item runs at least one round, so a block no step
        reads (or an empty chunk) is flushed as zeros."""
        ptr, steps = np.asarray(ptr), np.asarray(steps)
        base, n_in, n_groups, n_chunks = self.factors[j]
        rest, tile = divmod(i, self.n_tiles)
        chunk, grp = divmod(rest, n_groups)
        b0, i0 = tile * self.bt, grp * self.group
        blocks = range(i0, min(i0 + self.group, n_in))
        readers = [steps[ptr[base + b]:ptr[base + b + 1]].tolist() for b in blocks]
        longest = max(1, *(len(r) for r in readers))
        per = -(-longest // n_chunks)
        r0 = chunk * per
        n_rounds = max(1, min(per, longest - r0))
        rounds = [[r[r0 + k] if r0 + k < len(r) else -1 for r in readers] for k in range(n_rounds)]
        return range(b0, min(b0 + self.bt, self.batch)), blocks, chunk, rounds


@functools.lru_cache(maxsize=256)
def dgrad_schedule(plan: ChainPlan, batch: int, bt: int, ctas: int | None = None) -> DgradSchedule:
    """The work split at ``batch`` and tile ``bt``; ``ctas`` (the launch's
    resident CTAs) decides the chunks: a factor with at most half as many
    items is split into up to ``⌊ctas / items⌋`` chunks, at least
    ``CHUNK_READERS`` readers a chunk on average.  ``None``: no split.
    Cached (the wrapper asks at every launch): after changing
    ``CHUNK_READERS``, call ``dgrad_schedule.cache_clear()``."""
    blkp = padded_block(plan.block)
    group = TILE_W // blkp
    n_tiles = -(-batch // bt)
    base = _act_offsets(plan)
    factors = []
    for j in range(plan.n_factors):
        n_in = plan.in_blocks[j]
        n_groups = -(-n_in // group)
        items = n_tiles * n_groups
        readers = plan.out_blocks[j] * plan.k_blocks[j] // n_in  # per input block, on average
        chunks = 1 if ctas is None else max(1, min(ctas // items, readers // CHUNK_READERS))
        factors.append((base[j], n_in, n_groups, chunks))
    return DgradSchedule(plan.block, blkp, group, bt, batch, tuple(factors))


@functools.lru_cache(maxsize=256)
def _dgrad_factor_array(factors: tuple[tuple[int, int, int, int], ...]):
    flat = [v for row in factors for v in row]
    return (ctypes.c_int * len(flat))(*flat)


def _suffix(dtype: torch.dtype, qdtype: torch.dtype | None) -> str:
    return DTYPES[dtype] if qdtype is None else f"q_{DTYPES[dtype]}_{QDTYPES[qdtype]}"


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The kernel library, its functions' argument types set."""
    lib = build.load(name)
    dgrad = name == "chain_dgrad"
    n_ptr, n_int = (9, 12) if dgrad else (14, 13)
    for dtype in DTYPES:
        for qdtype in (None, *QDTYPES):
            suffix = _suffix(dtype, qdtype)
            fn = getattr(lib, f"{name}_{suffix}")
            # K5 also takes the scales and the walk's dequantization workspace; its
            # wgrad the scales as rows for the walk and whether they are per row
            n_q, n_qi = (0, 0) if qdtype is None else ((2, 0) if dgrad else (3, 1))
            fn.argtypes = [ctypes.c_void_p] * (n_ptr + n_q) + [ctypes.c_int] * (n_int + n_qi) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"{name}_ctas_{suffix}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
    return lib


def launch_config(dtype: torch.dtype, block: int, bt: int, qdtype: torch.dtype | None = None) -> dict:
    """The resident CTAs (occupancy × SMs) of the current card and one
    CTA's dynamic shared memory, for K2 (``qdtype=None``) or K5-dgrad at
    this block and tile; a launch's grid is ``min(ctas, max(items))``."""
    ctas, smem = _resident(torch.cuda.current_device(), _suffix(dtype, qdtype), padded_block(block), bt)
    return {"ctas": ctas, "smem_bytes": smem}


@functools.lru_cache(maxsize=256)
def _resident(device: int, suffix: str, blkp: int, bt: int) -> tuple[int, int]:
    """Cached per device: the wrapper asks at every launch (the chunks follow it)."""
    smem = ctypes.c_int(0)
    ctas = getattr(_lib("chain_dgrad"), f"chain_dgrad_ctas_{suffix}")(blkp, bt, ctypes.byref(smem))
    if ctas <= 0:
        raise RuntimeError(f"chain_dgrad occupancy query failed: CUDA error {-ctas}")
    return ctas, smem.value


# K3's emission streams the batch through shared memory this many rows a
# stage (chain_wgrad.cu EmitLayout).
EMIT_ROWS = {torch.float32: 32, torch.bfloat16: 64}


@dataclasses.dataclass(frozen=True)
class WgradSchedule:
    """K3/K5-wgrad's work split of one plan at one batch and batch tile:
    the recompute (K1's items over factors 1..J-1, ``fwd_items``), the
    walk (``walk``, K2's schedule; factors J..2 run) and the emission.
    Emission item i of factor j is column group ``(i // chunks) // K_j``
    (``group`` output blocks), slot ``(i // chunks) % K_j`` and batch chunk
    ``i % chunks`` of ``chunk_rows`` rows; its blocks are the slot-k steps
    of the group's output blocks."""

    block: int
    blkp: int
    group: int
    bt: int
    batch: int
    fwd_items: tuple[int, ...]
    walk: DgradSchedule
    rows: int  # the emission's batch rows per stage
    chunks: int
    chunk_rows: int
    # per factor: (step offset, out blocks O_j, slots K_j, column groups)
    factors: tuple[tuple[int, int, int, int], ...]

    @property
    def walk_items(self) -> int:
        """The most work items of a walked factor (J..2)."""
        return max(self.walk.items[1:], default=1)

    @property
    def emit_items(self) -> tuple[int, ...]:
        """Emission items per factor."""
        return tuple(f[3] * f[2] * self.chunks for f in self.factors)

    def emit_item(self, j: int, i: int) -> tuple[range, int, list[int], range, int]:
        """Emission item ``i`` of factor ``j`` as the kernel decodes it:
        its output blocks, its slot, the flat step of each block, its batch
        rows and its chunk."""
        off, n_out, n_k, _ = self.factors[j]
        rest, chunk = divmod(i, self.chunks)
        grp, k = divmod(rest, n_k)
        blocks = range(grp * self.group, min(grp * self.group + self.group, n_out))
        r0 = chunk * self.chunk_rows
        rows = range(r0, min(self.batch, r0 + self.chunk_rows))
        return blocks, k, [off + o * n_k + k for o in blocks], rows, chunk


@functools.lru_cache(maxsize=256)
def wgrad_schedule(plan: ChainPlan, batch: int, bt: int, rows: int,
                   ctas: tuple[int, int, int] | None = None) -> WgradSchedule:
    """The work split at ``batch``, tile ``bt`` and ``rows`` emission rows a
    stage; ``ctas`` (the recompute's, the walk's and the emission's
    resident CTAs) decides the chunks: the walk's as :func:`dgrad_schedule`
    does, and the emission's batch is cut into up to ``⌊ctas / items⌋``
    chunks of whole stages when its items are fewer than its CTAs.
    ``None``: no split."""
    blkp = padded_block(plan.block)
    factors = _factor_table(plan)
    n_tiles = -(-batch // bt)
    walk = dgrad_schedule(plan, batch, bt, None if ctas is None else ctas[1])
    base = sum(f[3] * f[2] for f in factors)
    chunks = 1 if ctas is None or base >= ctas[2] else max(1, min(ctas[2] // base, -(-batch // rows)))
    chunk_rows = -(-(-(-batch // chunks)) // rows) * rows
    chunks = -(-batch // chunk_rows)  # no empty chunk
    return WgradSchedule(plan.block, blkp, TILE_W // blkp, bt, batch,
                         tuple(n_tiles * f[3] for f in factors[:-1]), walk, rows, chunks, chunk_rows, factors)


def wgrad_launch_config(dtype: torch.dtype, block: int, bt: int, qdtype: torch.dtype | None = None) -> dict:
    """The resident CTAs of the current card and one CTA's dynamic shared
    memory for each of K3's launches (``qdtype=None``) or K5-wgrad's at this
    block and tile: the recompute and the walk are cooperative grids of
    ``min(ctas, max(items))``, the emission one CTA per item."""
    cfg = _wgrad_resident(torch.cuda.current_device(), _suffix(dtype, qdtype), padded_block(block), bt)
    return {name: {"ctas": cfg[i], "smem_bytes": cfg[3 + i]} for i, name in enumerate(("recompute", "walk", "emit"))}


@functools.lru_cache(maxsize=256)
def _wgrad_resident(device: int, suffix: str, blkp: int, bt: int) -> tuple[int, ...]:
    out = (ctypes.c_int * 6)()
    rc = getattr(_lib("chain_wgrad"), f"chain_wgrad_ctas_{suffix}")(blkp, bt, out)
    if rc != 0:
        raise RuntimeError(f"chain_wgrad occupancy query failed: CUDA error {rc}")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _act_offset_array(plan: ChainPlan):
    offs = _act_offsets(plan)
    return (ctypes.c_int * len(offs))(*offs)


def _check_device(name, tensors) -> None:
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")


def _check(name, edges, values, meta, plan, bt, scales, meta_rows, meta_cols):
    """Dtypes, shapes, contiguity and tile of a backward launch; the device
    is checked apart."""
    tensors = (*edges, values, meta) + (() if scales is None else (scales,))
    dtype = edges[0].dtype
    if dtype not in DTYPES or any(e.dtype != dtype for e in edges):
        raise TypeError(f"{name} takes f32 or bf16 activations of one dtype; got {[e.dtype for e in edges]}")
    if scales is None:
        if values.dtype != dtype:
            raise TypeError(f"{name}: values must be {dtype}; got {values.dtype}")
    else:
        if values.dtype not in QDTYPES or scales.dtype != torch.float32:
            raise TypeError(f"{name}(scales=) takes int8/fp8 codes and f32 scales; got {values.dtype}, {scales.dtype}")
        if tuple(scales.shape) not in ((plan.n_steps, plan.block), (plan.n_steps,)) or not scales.is_contiguous():
            raise ValueError(
                f"{name}: scales must be contiguous ({plan.n_steps}, {plan.block}) or ({plan.n_steps},); "
                f"got {tuple(scales.shape)}"
            )
    blk, s = plan.block, plan.n_steps
    if blk > MAX_BLOCK:
        raise ValueError(f"{name}: block {blk} exceeds the kernel's {MAX_BLOCK}")
    if meta.dtype != torch.int32 or tuple(meta.shape) != (meta_rows, meta_cols):
        raise ValueError(f"{name}: meta must be int32 ({meta_rows}, {meta_cols}); got {meta.dtype} {tuple(meta.shape)}")
    if tuple(values.shape) != (s, blk, blk):
        raise ValueError(f"{name}: values {tuple(values.shape)} do not fit the plan")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if bt not in SUPPORTED_BT:
        raise ValueError(f"{name}: bt must be one of {SUPPORTED_BT}; got {bt}")


def _check_gather(plan: ChainPlan, ptr: torch.Tensor, steps: torch.Tensor) -> None:
    """The dgrad kernel's transposed table and factor table (a kernel argument)."""
    if plan.n_factors > MAX_FACTORS:
        raise ValueError(f"chain_dgrad: at most {MAX_FACTORS} factors; got {plan.n_factors}")
    n_ptr, s = sum(plan.in_blocks) + 1, plan.n_steps
    if ptr.dtype != torch.int32 or steps.dtype != torch.int32 or ptr.shape != (n_ptr,) or steps.shape != (s,):
        raise ValueError(
            f"chain_dgrad: the transposed table must be int32 ptr ({n_ptr},) and steps ({s},); "
            f"got {ptr.dtype} {tuple(ptr.shape)}, {steps.dtype} {tuple(steps.shape)}"
        )


def _fn(name: str, dtype: torch.dtype, values: torch.Tensor, scales):
    return getattr(_lib(name), f"{name}_{_suffix(dtype, None if scales is None else values.dtype)}")


def _edges(plan: ChainPlan, x: torch.Tensor | None, dy: torch.Tensor) -> None:
    in_w, out_w = plan.in_blocks[0] * plan.block, plan.out_blocks[-1] * plan.block
    if dy.ndim != 2 or dy.shape[1] != out_w or (
        x is not None and (x.ndim != 2 or x.shape != (dy.shape[0], in_w))
    ):
        raise ValueError(
            f"chain backward: dy must be (B, {out_w}) and x (B, {in_w}); got dy {tuple(dy.shape)}"
            + ("" if x is None else f", x {tuple(x.shape)}")
        )


def chain_dgrad(
    dy: torch.Tensor,
    values: torch.Tensor,
    meta: torch.Tensor,
    *,
    plan: ChainPlan,
    bt: int = DGRAD_BT,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """``dx = dy @ F_Jᵀ ⋯ F_1ᵀ``: ``dy (B, O_J·blk)`` (the cotangent of the
    padded output), ``values (S, blk, blk)``, ``meta`` the
    :func:`dgrad_meta` table.  Returns ``(B, IB_1·blk)`` in dy's dtype.
    With ``scales (S, blk)`` f32, ``values`` are codes (K5).  One
    cooperative launch; a grid that cannot be resident raises."""
    if dy.is_cuda:
        _edges(plan, None, dy)
        _check_device("chain_dgrad", (dy, values, meta) + (() if scales is None else (scales,)))
        _check("chain_dgrad", (dy,), values, meta, plan, bt, scales, plan.n_steps, DGRAD_META_COLS)
    if library.dispatching():
        return _DGRAD(dy, values, meta, scales, library.plan_id(plan), bt)
    if dy.is_cuda:
        return _dgrad_launch(dy, values, meta, scales, plan, bt)
    return chain_dgrad_plain(dy, values, meta, plan=plan, scales=scales)


def _dgrad_launch(dy, values, meta, scales, plan, bt):
    """K2/K5-dgrad's launch (the operator's CUDA implementation)."""
    if scales is not None:
        scales = _row_scales_for(plan, scales)
    gather = _gather_for(plan, meta)
    _check_gather(plan, *gather)
    b, blk = dy.shape[0], plan.block
    in_w = plan.in_blocks[0] * blk
    dx = torch.empty((b, in_w), dtype=dy.dtype, device=dy.device)
    if b == 0:
        return dx
    ws_w = max(plan.in_blocks[1:], default=0) * blk
    ws = torch.empty((2, b, ws_w) if ws_w else (0,), dtype=dy.dtype, device=dy.device)
    # K5: the codes dequantized once per launch, staged as K2 stages values
    deq = None if scales is None else torch.empty(values.shape, dtype=dy.dtype, device=dy.device)
    vec = _vec(blk, (dy, values, ws, dx) + (() if deq is None else (deq,)), scales)
    with build.on_device(dy.device):
        sched = dgrad_schedule(plan, b, bt, launch_config(dy.dtype, blk, bt, None if deq is None else values.dtype)["ctas"])
        part_n = max((f[3] * b * f[1] * blk for f in sched.factors if f[3] > 1), default=0)
        part = torch.empty((part_n,), dtype=torch.float32, device=dy.device) if part_n else None
        ints = (plan.n_factors, b, plan.n_steps, blk, sched.blkp, sched.group, dy.shape[1], ws_w, in_w, vec, bt,
                max(sched.items))
        ptrs = (dy.data_ptr(), values.data_ptr()) + (() if scales is None else (scales.data_ptr(),))
        ptrs += (meta.data_ptr(), gather[0].data_ptr(), gather[1].data_ptr(),
                 ctypes.addressof(_dgrad_factor_array(sched.factors)), ws.data_ptr(), dx.data_ptr())
        ptrs += (() if deq is None else (deq.data_ptr(),)) + (0 if part is None else part.data_ptr(),)
        rc = _fn("chain_dgrad", dy.dtype, values, scales)(*ptrs, *ints, build.stream_of(dy.device))
    if rc != 0:
        raise RuntimeError(f"chain_dgrad kernel launch failed: CUDA error {rc}")
    if scales is None:
        chain_dgrad.launches += 1
    else:
        chain_dgrad.q_launches += 1
    return dx


def chain_wgrad(
    x: torch.Tensor,
    dy: torch.Tensor,
    values: torch.Tensor,
    meta: torch.Tensor,
    *,
    plan: ChainPlan,
    bt: int = WGRAD_BT,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """``dvalues (S, blk, blk)`` f32: ``x (B, IB_1·blk)`` the padded forward
    input, ``dy (B, O_J·blk)`` the cotangent of the padded output,
    ``meta`` the :func:`wgrad_meta` table.  With ``scales (S, blk)`` (one
    per block row) or ``(S,)`` (one per block) f32, ``values`` are codes and
    the gradient is wrt the dequantized values (K5).  ``bt`` is the
    recompute's and the walk's batch tile."""
    s_pre = plan.offsets[plan.n_factors - 1]
    if x.is_cuda:
        _edges(plan, x, dy)
        _check_device("chain_wgrad", (x, dy, values, meta) + (() if scales is None else (scales,)))
        _check("chain_wgrad", (x, dy), values, meta, plan, bt, scales, s_pre + plan.n_steps, WGRAD_META_COLS)
        if plan.n_factors > MAX_FACTORS:
            raise ValueError(f"chain_wgrad: at most {MAX_FACTORS} factors; got {plan.n_factors}")
    if library.dispatching():
        return _WGRAD(x, dy, values, meta, scales, library.plan_id(plan), bt)
    if x.is_cuda:
        return _wgrad_launch(x, dy, values, meta, scales, plan, bt)
    return chain_wgrad_plain(x, dy, values, meta, plan=plan, scales=scales)


def _wgrad_launch(x, dy, values, meta, scales, plan, bt):
    """K3/K5-wgrad's launches (the operator's CUDA implementation)."""
    s_pre = plan.offsets[plan.n_factors - 1]
    b, blk, s = x.shape[0], plan.block, plan.n_steps
    dvalues = torch.empty((s, blk, blk), dtype=torch.float32, device=x.device)
    if b == 0:
        return dvalues.zero_()
    aw = (sum(plan.in_blocks) - plan.in_blocks[0]) * blk  # intermediate widths: factors 2..J's inputs
    act = torch.empty((b, aw) if aw else (0,), dtype=x.dtype, device=x.device)
    cot = torch.empty_like(act)
    # K5: the walk's codes dequantized once per launch (chain_dgrad.cu note (6))
    deq = None if scales is None else torch.empty(values.shape, dtype=x.dtype, device=x.device)
    vec = _vec(blk, (x, dy, values, act, cot) + (() if deq is None else (deq,)), scales)
    ptr, steps = _wgather_for(plan, meta)
    with build.on_device(x.device):
        suffix = _suffix(x.dtype, None if scales is None else values.dtype)
        rows = None if scales is None else int(scales.ndim == 2)
        ctas = _wgrad_resident(torch.cuda.current_device(), suffix, padded_block(blk), bt)[:3]
        sched = wgrad_schedule(plan, b, bt, EMIT_ROWS[x.dtype], ctas)
        walked = sched.walk.factors[1:]
        part_n = max((f[3] * b * f[1] * blk for f in walked if f[3] > 1), default=0)
        part = torch.empty((part_n,), dtype=torch.float32, device=x.device) if part_n else None
        epart = torch.empty((sched.chunks, s, blk, blk), dtype=torch.float32, device=x.device) \
            if sched.chunks > 1 else None
        ptrs = (x.data_ptr(), dy.data_ptr(), values.data_ptr())
        if scales is not None:  # as given (the recompute), and as rows (the walk)
            wscales = _row_scales_for(plan, scales)
            ptrs += (scales.data_ptr(), wscales.data_ptr())
        ptrs += (meta.data_ptr(), ptr.data_ptr(), steps.data_ptr(), ctypes.addressof(_factor_array(plan)),
                 ctypes.addressof(_dgrad_factor_array(sched.walk.factors)),
                 ctypes.addressof(_act_offset_array(plan)), act.data_ptr(), cot.data_ptr())
        ptrs += (() if deq is None else (deq.data_ptr(),))
        ptrs += tuple(0 if t is None else t.data_ptr() for t in (part, epart)) + (dvalues.data_ptr(),)
        ints = (plan.n_factors, b, s, s_pre, blk, sched.blkp, sched.group, aw, vec) + (() if rows is None else (rows,))
        ints += (bt, sched.walk_items, sched.chunks, sched.chunk_rows)
        rc = _fn("chain_wgrad", x.dtype, values, scales)(*ptrs, *ints, build.stream_of(x.device))
    if rc != 0:
        raise RuntimeError(f"chain_wgrad kernel launch failed: CUDA error {rc}")
    if scales is None:
        chain_wgrad.launches += 1
    else:
        chain_wgrad.q_launches += 1
    return dvalues


def _flops(kernel: str, batch: int, values_shape) -> int:
    from repro_torch.api.dispatch import chain_flops

    return int(chain_flops(batch, math.prod(values_shape), kernel))


_DGRAD = library.define(
    "chain_dgrad", "(Tensor dy, Tensor values, Tensor meta, Tensor? scales, int plan, int bt) -> Tensor",
    kernels=("K2", "K5"), cuda=library.by_plan(_dgrad_launch),
    cpu=library.by_plan(lambda dy, values, meta, scales, plan, bt: chain_dgrad_plain(
        dy, values, meta, plan=plan, scales=scales)),
    fake=library.by_plan(lambda dy, values, meta, scales, plan, bt: dy.new_empty(
        (dy.shape[0], plan.in_blocks[0] * plan.block))),
    flops=lambda dy, values, *args, out_shape=None, **_: _flops("dgrad", dy[0], values))
_WGRAD = library.define(
    "chain_wgrad", "(Tensor x, Tensor dy, Tensor values, Tensor meta, Tensor? scales, int plan, int bt) -> Tensor",
    kernels=("K3", "K5"), cuda=library.by_plan(_wgrad_launch),
    cpu=library.by_plan(lambda x, dy, values, meta, scales, plan, bt: chain_wgrad_plain(
        x, dy, values, meta, plan=plan, scales=scales)),
    fake=lambda x, dy, values, meta, scales, pid, bt: values.new_empty(values.shape, dtype=torch.float32),
    flops=lambda x, dy, values, *args, out_shape=None, **_: _flops("wgrad", x[0], values))
chain_dgrad.launches = chain_dgrad.q_launches = 0
chain_wgrad.launches = chain_wgrad.q_launches = 0
