"""Kernel-level entry points of the block-sparse FAµST apply.
Counterpart of :mod:`repro.kernels.ops`.

``bsr_apply``          single factor, kernel or plain path, padding handled.
``blockfaust_apply``   the chain ``y = lam · x@F_1@...@F_J``, one launch per
                       factor.
``packed_chain_apply`` the whole chain in one launch on a
                       :class:`~repro_torch.core.compress.PackedChain`,
                       quantized or not.

``use_kernel=None`` follows the tensor: a CUDA tensor runs the kernels, a
CPU tensor the plain versions; ``use_kernel=True`` on a CPU tensor raises.
Every path is differentiable.  The single-factor kernel's backward is the
plain ``bsr_matmul_dx``/``_dvalues``, as the reference's custom VJP.  The
fused chain's backward is the fused kernels of
:mod:`repro_torch.kernels.chain_bwd` (K2 ``chain_dgrad`` + K3
``chain_wgrad``; K5 on a quantized chain, whose codes are frozen and
whose scales get ``Σ_c q·dv``), or their plain versions where the forward
ran plain.  ``in_idx`` gets no gradient.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.compress import (
    BlockFaust,
    BlockSparseFactor,
    ChainPlan,
    PackedChain,
)
from repro_torch.kernels import library
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bsr_matmul import bsr_matmul
from repro_torch.kernels.chain import DGRAD_BT, FORWARD_BT, META_COLS, SUPPORTED_BT, WGRAD_BT, chain_matmul
from repro_torch.kernels.chain_bwd import (
    chain_dgrad,
    chain_dgrad_plain,
    chain_wgrad,
    chain_wgrad_plain,
    dgrad_meta,
    wgrad_meta,
)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's path: a CUDA tensor, or any tensor
    of a dry run (fake tensors, ``launch/dryrun.py``), whose kernels run as
    their operators' fake implementations."""
    return x.is_cuda or library.faking()


def _want_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is None:
        return on_card(x)
    if use_kernel and not on_card(x):
        raise ValueError(
            "use_kernel=True needs a CUDA tensor: the CUDA kernels do not run "
            "on the CPU (use_kernel=None runs the plain version there)"
        )
    return use_kernel


def _pad_features(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _as_dtype(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Block values in the activation dtype (the kernels take one dtype)."""
    return v if v.dtype == dtype else v.to(dtype)


# ---------------------------------------------------------------------------
# Single factor
# ---------------------------------------------------------------------------


class _BsrKernel(torch.autograd.Function):
    """``bsr_matmul`` with the reference's backward: the plain scatter and
    gather einsums (``repro/kernels/ops.py`` ``_bsr_pallas_bwd``)."""

    @staticmethod
    def forward(ctx, x, values, in_idx):
        ctx.save_for_backward(x, values, in_idx)
        return bsr_matmul(x, values, in_idx)

    @staticmethod
    def backward(ctx, dy):
        x, values, in_idx = ctx.saved_tensors
        dx = _ref.bsr_matmul_dx(dy, values, in_idx, x.shape[-1]).to(x.dtype)
        dvalues = _ref.bsr_matmul_dvalues(x, dy, in_idx, tuple(values.shape[-2:])).to(values.dtype)
        return dx, dvalues, None


def bsr_apply(
    x: torch.Tensor,
    factor: BlockSparseFactor,
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``y = x @ F`` for any leading batch dims; pads and slices features."""
    kernel = _want_kernel(x, use_kernel)
    in_pad = factor.n_in_blocks * factor.bk
    x = _pad_features(x, in_pad)
    values = _as_dtype(factor.values, x.dtype)
    if not kernel:
        y = _ref.bsr_matmul_ref(x, values, factor.in_idx)
    else:
        batch_shape = x.shape[:-1]
        x2 = x.reshape(-1, in_pad).contiguous()
        y2 = _BsrKernel.apply(x2, values.contiguous(), factor.in_idx)
        y = y2.reshape(*batch_shape, -1)
    if y.shape[-1] != factor.out_features:
        y = y[..., : factor.out_features]
    return y


# ---------------------------------------------------------------------------
# Fused chain
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _chain_meta_static(plan: ChainPlan) -> np.ndarray:
    """Static step-table columns (everything but the runtime ``in_idx``
    column 0) — see :mod:`repro_torch.kernels.chain`."""
    blk = plan.block
    rows = []
    for j in range(plan.n_factors):
        o_count, k_count = plan.out_blocks[j], plan.k_blocks[j]
        o = np.repeat(np.arange(o_count), k_count)
        k = np.tile(np.arange(k_count), o_count)
        cols = np.empty((o_count * k_count, META_COLS - 1), dtype=np.int32)
        cols[:, 0] = o  # out_blk
        cols[:, 1] = j % 2  # parity
        cols[:, 2] = k == 0  # is_k0
        cols[:, 3] = k == k_count - 1  # is_kend
        cols[:, 4] = j == plan.n_factors - 1  # is_last
        cols[:, 5] = np.minimum(blk, plan.out_feats[j] - o * blk)  # ncols
        rows.append(cols)
    return np.concatenate(rows, axis=0)


@functools.lru_cache(maxsize=64)
def _chain_meta_static_cached(plan: ChainPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_chain_meta_static(plan)).to(device)


def _chain_meta_static_on(plan: ChainPlan, device: torch.device) -> torch.Tensor:
    """The static columns on ``device``, uploaded once per plan (every time
    on fake tensors: the cache holds no fake tensor)."""
    if library.faking():
        return torch.from_numpy(_chain_meta_static(plan)).to(device)
    return _chain_meta_static_cached(plan, device)


def chain_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S, META_COLS)`` int32 step table on ``in_idx``'s device:
    ``in_idx`` in column 0 (it stays on the card), the static columns
    after it (uploaded once per plan and device)."""
    static = _chain_meta_static_on(plan, in_idx.device)
    return torch.cat([in_idx.reshape(-1, 1).to(torch.int32), static], dim=1)


def _chain_bwd(ctx, dy, x, in_idx, values, scales, want_dx, want_dv):
    """``(dx, dv)`` of one fused apply, each only where it is wanted: the
    wrappers of K2 at ``DGRAD_BT`` and K3 at ``WGRAD_BT`` (K5 with
    ``scales``; on a CPU tensor they run their plain versions), or the
    plain versions where the caller asked for them on a CUDA tensor.
    ``dv`` is f32."""
    plan = ctx.plan
    dy = dy.contiguous()
    dx = dv = None
    if want_dx:
        meta = dgrad_meta(plan, in_idx)
        if ctx.wrappers:
            dx = chain_dgrad(dy, values, meta, plan=plan, bt=DGRAD_BT, scales=scales)
        else:
            dx = chain_dgrad_plain(dy, values, meta, plan=plan, scales=scales)
        dx = dx.to(x.dtype)
    if want_dv:
        meta = wgrad_meta(plan, in_idx)
        if ctx.wrappers:
            dv = chain_wgrad(x, dy, values, meta, plan=plan, bt=WGRAD_BT, scales=scales)
        else:
            dv = chain_wgrad_plain(x, dy, values, meta, plan=plan, scales=scales)
    return dx, dv


def _save(ctx, x, in_idx, plan, kernel, *tensors) -> bool:
    """Save for the backward; returns whether the apply goes through the
    kernel wrappers (the kernels on a CUDA tensor, the plain versions on a
    CPU one) rather than the plain versions the caller asked for."""
    ctx.save_for_backward(x, in_idx, *tensors)
    ctx.plan, ctx.wrappers = plan, kernel or not x.is_cuda
    return ctx.wrappers


class _ChainFn(torch.autograd.Function):
    """The fused chain on ``x (B, IB_1·blk)``: forward K1 at tile ``bt``,
    backward K2 + K3 at their own tiles (``repro/kernels/ops.py``
    ``_chain_pallas`` and its VJP)."""

    @staticmethod
    def forward(ctx, x, values, in_idx, plan, bt, kernel):
        if _save(ctx, x, in_idx, plan, kernel, values):
            return chain_matmul(x, values, chain_meta(plan, in_idx), plan=plan, bt=bt)
        return _ref.packed_chain_ref(x, values, in_idx, plan)

    @staticmethod
    def backward(ctx, dy):
        x, in_idx, values = ctx.saved_tensors
        want = ctx.needs_input_grad
        dx, dv = _chain_bwd(ctx, dy, x, in_idx, values, None, want[0], want[1])
        return dx, None if dv is None else dv.to(values.dtype), None, None, None, None


class _ChainQFn(torch.autograd.Function):
    """The fused chain on codes ``values`` with f32 ``scales``, ``(S, blk)``
    per block row or ``(S,)`` per block: forward K4, backward K5
    (``_chain_pallas_q`` and its VJP).  The codes are frozen; the scales
    get ``dL/ds[s, r] = Σ_c q·dv`` (``_dq_cotangent``; summed over the
    block's rows for a per-block scale), taken from K3's gradient wrt the
    dequantized values."""

    @staticmethod
    def forward(ctx, x, values, scales, in_idx, plan, bt, kernel):
        scales = scales.contiguous()
        if _save(ctx, x, in_idx, plan, kernel, values, scales):
            return chain_matmul(x, values, chain_meta(plan, in_idx), plan=plan, bt=bt, scales=scales)
        return _ref.packed_chain_q_ref(x, values, in_idx, plan, scales)

    @staticmethod
    def backward(ctx, dy):
        x, in_idx, values, scales = ctx.saved_tensors
        want = ctx.needs_input_grad
        dx, dv = _chain_bwd(ctx, dy, x, in_idx, values, scales, want[0], want[2])
        dscales = None if dv is None else torch.sum(values.float() * dv, dim=2 if scales.ndim == 2 else (1, 2))
        return dx, None, dscales, None, None, None, None


def packed_chain_apply(
    x: torch.Tensor,
    chain: PackedChain,
    *,
    use_kernel: bool | None = None,
    bt: int = FORWARD_BT,
) -> torch.Tensor:
    """The whole chain in one launch on a flat-packed chain; any leading
    batch dims, features padded and sliced, λ applied.  ``bt`` is the
    forward kernel's (K1/K4) batch tile; the backward kernels run at their
    own (K2/K5-dgrad ``DGRAD_BT``, K3/K5-wgrad ``WGRAD_BT``).
    The plain path (``ref.packed_chain_ref``) runs on the same packed
    arrays.  A quantized chain runs K4 (or ``ref.packed_chain_q_ref``) on
    its codes and scales (``(S, blk)`` per block row, or ``(S,)`` per
    block): values stay f32 after dequantization whatever ``x.dtype``.  Differentiable in ``x``, the
    values (the scales of a quantized chain) and λ."""
    if bt not in SUPPORTED_BT:
        raise ValueError(f"bt must be one of {SUPPORTED_BT}; got {bt}")
    kernel = _want_kernel(x, use_kernel)
    plan = chain.plan
    in_pad = plan.in_blocks[0] * plan.block
    x = _pad_features(x, in_pad)
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, in_pad).contiguous()
    if chain.quantized:  # codes must never be cast to the activation dtype
        scales = chain.scales.to(torch.float32)
        y2 = _ChainQFn.apply(x2, chain.values.contiguous(), scales, chain.in_idx, plan, bt, kernel)
    else:
        values = _as_dtype(chain.values, x.dtype).contiguous()
        y2 = _ChainFn.apply(x2, values, chain.in_idx, plan, bt, kernel)
    y = y2.reshape(*batch_shape, -1)
    if y.shape[-1] != plan.out_features:
        y = y[..., : plan.out_features]
    return chain.lam.to(y.dtype) * y


# ---------------------------------------------------------------------------
# Per-factor chain
# ---------------------------------------------------------------------------


def blockfaust_apply(
    x: torch.Tensor,
    bfaust: BlockFaust,
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``y = lam · x @ F_1 ··· F_J``, one single-factor apply per factor."""
    y = x
    for f in bfaust.factors:
        y = bsr_apply(y, f, use_kernel=use_kernel)
    return bfaust.lam.to(y.dtype) * y


def blockfaust_apply_t(x: torch.Tensor, bfaust: BlockFaust) -> torch.Tensor:
    """Adjoint chain apply ``y = lam · x @ (F_1···F_J)ᵀ``, by the plain
    scatter form per factor on every device (the transpose of a packed
    factor is not rectangular-packed, so no kernel serves it)."""
    y = x
    for f in reversed(bfaust.factors):
        y = _pad_features(y, f.n_out_blocks * f.bn)
        y = _ref.bsr_matmul_dx(y, _as_dtype(f.values, y.dtype), f.in_idx, f.n_in_blocks * f.bk)
        if y.shape[-1] != f.in_features:
            y = y[..., : f.in_features]
    return bfaust.lam.to(y.dtype) * y
