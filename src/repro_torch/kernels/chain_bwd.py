"""K2 ``chain_dgrad`` and K3 ``chain_wgrad``: the fused FAµST chain's
backward, and K5: both on int8/fp8 codes with f32 row scales — the
wrappers of the CUDA kernels ``csrc/chain_dgrad.cu`` and
``csrc/chain_wgrad.cu``, their step tables, and their plain PyTorch
versions.  Counterpart of :mod:`repro.kernels.chain_bwd`.

Replaces ``repro/kernels/chain_bwd.py:283 chain_dgrad`` and ``:433
chain_wgrad`` (Pallas, TPU); K5 those functions called with ``scales=``.

* **dgrad** ``dx = dy @ F_Jᵀ ⋯ F_1ᵀ``: the forward's steps reversed, each
  value block read transposed from the packed layout, scatter-added into
  an f32 cotangent ping-pong; ``dy`` is read where it lies.
* **wgrad** ``dvalues[s] = a_jᵀ g_j``: a walk (forward recompute of every
  intermediate activation, reversed walk of every intermediate cotangent,
  one CTA per batch tile) and an emission (one CTA per stored block,
  summing over the whole batch).  No per-batch-tile partial slabs exist:
  ``csrc/chain_wgrad.cu`` says why.  Output f32; for a quantized chain
  the gradient is with respect to the dequantized f32 values.

The step tables equal the reference's: the static columns from the plan
(uploaded once per plan and device), the runtime ``in_idx`` in column 0.

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version (``chain_dgrad_plain``/``chain_wgrad_plain``: the reference's
``chain_bwd_ref`` walk in f32).  ``chain_dgrad.launches`` /
``chain_dgrad.q_launches`` count K2 / K5 dgrad calls,
``chain_wgrad.launches`` / ``chain_wgrad.q_launches`` K3 / K5 wgrad calls
(one count per call; a wgrad call of a chain with J > 1 launches its walk
and its emission).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.compress import ChainPlan
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chain import DEFAULT_BT, DTYPES, MAX_BLOCK, QDTYPES, SUPPORTED_BT

# dgrad table, one row per *reversed* step t (flat step s = S-1-t):
#   0 dst_blk  input block the step scatter-adds into (runtime in_idx)
#   1 src_blk  output block of the cotangent this step reads
#   2 parity   ping-pong buffer holding this factor's cotangent ((J-1-j) % 2)
#   3 is_j0    first reversed step of a factor: zero the destination
#   4 ncols    valid columns of the source block (the rest are masked)
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
def _factor_table(plan: ChainPlan) -> np.ndarray:
    """The emission's per-factor lookup: step offsets, then act offsets."""
    return np.asarray(plan.offsets + _act_offsets(plan), dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _static_on(plan: ChainPlan, device: torch.device, kind: str) -> torch.Tensor:
    table = {"dgrad": _dgrad_meta_static, "wgrad": _wgrad_meta_static, "factors": _factor_table}[kind]
    return torch.from_numpy(table(plan)).to(device)


def dgrad_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S, DGRAD_META_COLS)`` reversed step table on ``in_idx``'s
    device: the reversed ``in_idx`` in column 0, the static columns after."""
    static = _static_on(plan, in_idx.device, "dgrad")
    return torch.cat([in_idx.flip(0).reshape(-1, 1).to(torch.int32), static], dim=1)


def wgrad_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S_pre + S, WGRAD_META_COLS)`` two-phase table: the recompute
    rows carry the forward ``in_idx``, the walk rows the reversed one."""
    static = _static_on(plan, in_idx.device, "wgrad")
    s_pre = plan.offsets[plan.n_factors - 1]
    idx = torch.cat([in_idx[:s_pre], in_idx.flip(0)]).reshape(-1, 1).to(torch.int32)
    return torch.cat([idx, static], dim=1)


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


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    n_ptr, n_int = (6, 8) if name == "chain_dgrad" else (8, 11)
    for suffix in DTYPES.values():
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for qsuffix in QDTYPES.values():
            fn = getattr(lib, f"{name}_q_{suffix}_{qsuffix}")
            fn.argtypes = [ctypes.c_void_p] * (n_ptr + 1) + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(name, edges, values, meta, plan, bt, scales, meta_rows, meta_cols):
    tensors = (*edges, values, meta) + (() if scales is None else (scales,))
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    dtype = edges[0].dtype
    if dtype not in DTYPES or any(e.dtype != dtype for e in edges):
        raise TypeError(f"{name} takes f32 or bf16 activations of one dtype; got {[e.dtype for e in edges]}")
    if scales is None:
        if values.dtype != dtype:
            raise TypeError(f"{name}: values must be {dtype}; got {values.dtype}")
    else:
        if values.dtype not in QDTYPES or scales.dtype != torch.float32:
            raise TypeError(f"{name}(scales=) takes int8/fp8 codes and f32 scales; got {values.dtype}, {scales.dtype}")
        if tuple(scales.shape) != (plan.n_steps, plan.block) or not scales.is_contiguous():
            raise ValueError(f"{name}: scales must be contiguous ({plan.n_steps}, {plan.block}); got {tuple(scales.shape)}")
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


def _fn(name: str, dtype: torch.dtype, values: torch.Tensor, scales):
    if scales is None:
        return getattr(_lib(name), f"{name}_{DTYPES[dtype]}")
    return getattr(_lib(name), f"{name}_q_{DTYPES[dtype]}_{QDTYPES[values.dtype]}")


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
    bt: int = DEFAULT_BT,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """``dx = dy @ F_Jᵀ ⋯ F_1ᵀ``: ``dy (B, O_J·blk)`` (the cotangent of the
    padded output), ``values (S, blk, blk)``, ``meta`` the
    :func:`dgrad_meta` table.  Returns ``(B, IB_1·blk)`` in dy's dtype.
    With ``scales (S, blk)`` f32, ``values`` are codes (K5)."""
    if not dy.is_cuda:
        return chain_dgrad_plain(dy, values, meta, plan=plan, scales=scales)
    _edges(plan, None, dy)
    _check("chain_dgrad", (dy,), values, meta, plan, bt, scales, plan.n_steps, DGRAD_META_COLS)
    b, blk = dy.shape[0], plan.block
    in_w = plan.in_blocks[0] * blk
    dx = torch.empty((b, in_w), dtype=dy.dtype, device=dy.device)
    if b == 0:
        return dx
    ws_w = max(plan.in_blocks[1:], default=0) * blk
    ws = torch.empty((2, b, ws_w) if ws_w else (0,), dtype=torch.float32, device=dy.device)
    dxacc = dx if dy.dtype == torch.float32 else torch.empty((b, in_w), dtype=torch.float32, device=dy.device)
    ints = (b, plan.n_steps, plan.n_factors, blk, dy.shape[1], ws_w, in_w, bt)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _fn("chain_dgrad", dy.dtype, values, scales)
        head = (dy.data_ptr(), values.data_ptr()) + (() if scales is None else (scales.data_ptr(),))
        rc = fn(*head, meta.data_ptr(), ws.data_ptr(), dxacc.data_ptr(), dx.data_ptr(), *ints, stream)
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
    bt: int = DEFAULT_BT,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """``dvalues (S, blk, blk)`` f32: ``x (B, IB_1·blk)`` the padded forward
    input, ``dy (B, O_J·blk)`` the cotangent of the padded output,
    ``meta`` the :func:`wgrad_meta` table.  With ``scales (S, blk)`` f32,
    ``values`` are codes and the gradient is wrt the dequantized values
    (K5)."""
    if not x.is_cuda:
        return chain_wgrad_plain(x, dy, values, meta, plan=plan, scales=scales)
    _edges(plan, x, dy)
    s_pre = plan.offsets[plan.n_factors - 1]
    _check("chain_wgrad", (x, dy), values, meta, plan, bt, scales, s_pre + plan.n_steps, WGRAD_META_COLS)
    b, blk, s = x.shape[0], plan.block, plan.n_steps
    dvalues = torch.empty((s, blk, blk), dtype=torch.float32, device=x.device)
    if b == 0:
        return dvalues.zero_()
    ib0 = plan.in_blocks[0]
    aw = (sum(plan.in_blocks) - ib0) * blk  # intermediate widths: factors 2..J's inputs
    act = torch.empty((b, aw) if aw else (0,), dtype=torch.float32, device=x.device)
    cot = torch.empty_like(act)
    fac = _static_on(plan, x.device, "factors")
    n_walk = s - plan.offsets[1]  # the walk stops before factor 1
    ints = (b, s, s_pre, n_walk, plan.n_factors, blk, x.shape[1], dy.shape[1], aw, ib0, bt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _fn("chain_wgrad", x.dtype, values, scales)
        head = (x.data_ptr(), dy.data_ptr(), values.data_ptr()) + (() if scales is None else (scales.data_ptr(),))
        rc = fn(*head, meta.data_ptr(), fac.data_ptr(), act.data_ptr(), cot.data_ptr(),
                dvalues.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"chain_wgrad kernel launch failed: CUDA error {rc}")
    if scales is None:
        chain_wgrad.launches += 1
    else:
        chain_wgrad.q_launches += 1
    return dvalues


chain_dgrad.launches = chain_dgrad.q_launches = 0
chain_wgrad.launches = chain_wgrad.q_launches = 0
