"""Plain PyTorch versions of the block-sparse FAµST apply and its
gradients.  Counterpart of :mod:`repro.kernels.ref`.

These are the oracles the CUDA kernels (``csrc/``) are held against, and
what the kernel wrappers run on CPU tensors.  Products accumulate in f32
and cast back to the input dtype, as the kernels do.

Layout (:class:`repro_torch.core.compress.BlockSparseFactor`)::

    y[..., o·bn:(o+1)·bn] = Σ_k  x[..., in_idx[o,k]·bk : +bk] @ values[o,k]
"""
from __future__ import annotations

import torch


def bsr_matmul_ref(x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor) -> torch.Tensor:
    """``y = x @ F`` for packed block-sparse F; ``x (..., IB·bk)`` already
    padded to a block multiple.  Returns ``(..., O·bn)`` in x.dtype."""
    o, _, bk, bn = values.shape
    batch_shape = x.shape[:-1]
    xb = x.reshape(*batch_shape, x.shape[-1] // bk, bk)
    gathered = xb[..., in_idx.long(), :]  # (..., O, K, bk)
    y = torch.einsum("...okb,okbn->...on", gathered.float(), values.float())
    return y.to(x.dtype).reshape(*batch_shape, o * bn)


def bsr_matmul_dx(
    dy: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor, in_dim: int
) -> torch.Tensor:
    """Cotangent wrt x: scatter-add of the per-block contributions."""
    o, k, bk, bn = values.shape
    batch_shape = dy.shape[:-1]
    dyb = dy.reshape(*batch_shape, o, bn).float()
    contrib = torch.einsum("...on,okbn->...okb", dyb, values.float())
    dxb = torch.zeros((*batch_shape, in_dim // bk, bk), dtype=torch.float32, device=dy.device)
    dxb.index_add_(dxb.ndim - 2, in_idx.reshape(-1).long(), contrib.reshape(*batch_shape, o * k, bk))
    return dxb.to(dy.dtype).reshape(*batch_shape, in_dim)


def bsr_matmul_dvalues(
    x: torch.Tensor, dy: torch.Tensor, in_idx: torch.Tensor, block: tuple[int, int]
) -> torch.Tensor:
    """Cotangent wrt values: per selected block, xᵀ·dy summed over the batch."""
    bk, bn = block
    o, _ = in_idx.shape
    xb = x.reshape(-1, x.shape[-1] // bk, bk)
    gathered = xb[:, in_idx.long(), :].float()  # (N, O, K, bk)
    dyb = dy.reshape(-1, o, bn).float()
    return torch.einsum("zokb,zon->okbn", gathered, dyb).to(x.dtype)


def _mask_tail(y: torch.Tensor, ncols: int) -> torch.Tensor:
    """Zero columns ≥ ncols (slice to the unpadded width, re-pad with zeros)."""
    if ncols == y.shape[-1]:
        return y
    cols = torch.arange(y.shape[-1], device=y.device)
    return torch.where(cols < ncols, y, torch.zeros((), dtype=y.dtype, device=y.device))


def factor_slices(values: torch.Tensor, in_idx: torch.Tensor, plan, j: int):
    """Factor ``j``'s ``(O, K, blk, blk)`` values and ``(O, K)`` index table,
    sliced out of the flat chain arrays."""
    blk = plan.block
    o0, o1 = plan.offsets[j], plan.offsets[j + 1]
    vj = values[o0:o1].reshape(plan.out_blocks[j], plan.k_blocks[j], blk, blk)
    ij = in_idx[o0:o1].reshape(plan.out_blocks[j], plan.k_blocks[j])
    return vj, ij


def packed_chain_ref(x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor, plan) -> torch.Tensor:
    """The fused chain kernel's step semantics: ``x (..., IB_1·blk)``
    padded, intermediate activations rounded to x.dtype between factors,
    ragged tails zeroed.  Returns ``(..., O_J·blk)``."""
    y = x
    for j in range(plan.n_factors):
        vj, ij = factor_slices(values, in_idx, plan, j)
        y = _mask_tail(bsr_matmul_ref(y, vj, ij), plan.out_feats[j])
    return y


def blockfaust_apply_ref(x: torch.Tensor, factors, lam: torch.Tensor) -> torch.Tensor:
    """``y = lam · (((x @ F_1) @ F_2) ...)`` with padding and slicing at the
    factor boundaries."""
    y = x
    for f in factors:
        pad = f.n_in_blocks * f.bk - y.shape[-1]
        if pad:
            y = torch.nn.functional.pad(y, (0, pad))
        y = bsr_matmul_ref(y, f.values, f.in_idx)
        if y.shape[-1] != f.out_features:
            y = y[..., : f.out_features]
    return lam.to(y.dtype) * y
