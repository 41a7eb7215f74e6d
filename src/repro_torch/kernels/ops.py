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
The single-factor kernel path is differentiable (its backward is the plain
``bsr_matmul_dx``/``_dvalues``, as the reference's custom VJP); the fused
path, kernel and plain version alike, is forward only until its backward
kernels (K2 ``chain_dgrad``, K3 ``chain_wgrad``, K5 for quantized chains)
are ported.
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
    expand_scales,
)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bsr_matmul import bsr_matmul
from repro_torch.kernels.chain import DEFAULT_BT, META_COLS, SUPPORTED_BT, chain_matmul


def _want_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
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
def _chain_meta_static_on(plan: ChainPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_chain_meta_static(plan)).to(device)


def chain_meta(plan: ChainPlan, in_idx: torch.Tensor) -> torch.Tensor:
    """The ``(S, META_COLS)`` int32 step table on ``in_idx``'s device:
    ``in_idx`` in column 0 (it stays on the card), the static columns
    after it (uploaded once per plan and device)."""
    static = _chain_meta_static_on(plan, in_idx.device)
    return torch.cat([in_idx.reshape(-1, 1).to(torch.int32), static], dim=1)


def packed_chain_apply(
    x: torch.Tensor,
    chain: PackedChain,
    *,
    use_kernel: bool | None = None,
    bt: int = DEFAULT_BT,
) -> torch.Tensor:
    """The whole chain in one launch on a flat-packed chain; any leading
    batch dims, features padded and sliced, λ applied, batch tile ``bt``.
    The plain path (``ref.packed_chain_ref``) runs on the same packed
    arrays.  A quantized chain runs K4 (or ``ref.packed_chain_q_ref``) on
    its codes and ``(S, blk)`` row scales: values stay f32 after
    dequantization whatever ``x.dtype``."""
    if bt not in SUPPORTED_BT:
        raise ValueError(f"bt must be one of {SUPPORTED_BT}; got {bt}")
    kernel = _want_kernel(x, use_kernel)
    plan = chain.plan
    in_pad = plan.in_blocks[0] * plan.block
    x = _pad_features(x, in_pad)
    if chain.quantized:  # codes must never be cast to the activation dtype
        values, scales = chain.values, expand_scales(chain.scales, plan.block)
    else:
        values, scales = _as_dtype(chain.values, x.dtype), None
    # forward only on every device, so the plain path never trains what
    # the kernel cannot
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, values, scales)):
        raise NotImplementedError(
            "the fused chain kernel is forward only: its backward kernels "
            "(K2 chain_dgrad, K3 chain_wgrad, and K5 for quantized chains) come "
            "with the training slice; train through backend='bsr' until then"
        )
    if not kernel:
        if scales is None:
            y = _ref.packed_chain_ref(x, values, chain.in_idx, plan)
        else:
            y = _ref.packed_chain_q_ref(x, values, chain.in_idx, plan, scales)
    else:
        batch_shape = x.shape[:-1]
        x2 = x.reshape(-1, in_pad).contiguous()
        y2 = chain_matmul(
            x2, values.contiguous(), chain_meta(plan, chain.in_idx), plan=plan, bt=bt,
            scales=None if scales is None else scales.contiguous(),
        )
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
