"""Projections onto the paper's constraint sets (Appendix A): keep the
allowed entries of largest magnitude per partition cell, zero the rest,
renormalize to unit Frobenius norm.  Counterpart of
:mod:`repro.core.projections`.

Ties: the reference selects with ``lax.top_k``, which keeps the lowest
index among equal magnitudes.  ``torch.topk`` does not (on
``[1,1,1,1,2,1]`` with k=3 it returns ``[4,3,5]``), so the port selects
with a *stable* descending sort.  Exact Hadamard factorization depends on
this.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Callable

import numpy as np
import torch

EPS = 1e-12


def _normalize(x: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.norm(x)
    return torch.where(nrm > EPS, x / torch.clamp(nrm, min=EPS), torch.zeros_like(x))


def _topk_mask(v: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """0/1 mask (dtype of ``v``) keeping, along ``dim``, the ``k`` entries
    of largest ``|v|``; ties go to the lowest index, as ``lax.top_k``."""
    k = int(k)
    if k >= v.shape[dim]:
        return torch.ones_like(v)
    order = torch.sort(v.abs(), dim=dim, descending=True, stable=True).indices
    keep = order.narrow(dim, 0, k)
    return torch.zeros_like(v).scatter_(dim, keep, 1.0)


def _topk_mask_flat(v: torch.Tensor, k: int) -> torch.Tensor:
    """Exact-k mask of a 1-D tensor (reference name, same tie rule)."""
    return _topk_mask(v, k, 0)


def proj_global_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """P onto {||S||_0 ≤ k, ||S||_F = 1} (paper §III-C1)."""
    flat = x.reshape(-1)
    out = (flat * _topk_mask_flat(flat, k)).reshape(x.shape)
    return _normalize(out) if normalize else out


def proj_col_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """k-sparse columns (Prop. A.1, partition {columns})."""
    out = x * _topk_mask(x, k, 0)
    return _normalize(out) if normalize else out


def proj_row_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """k-sparse rows (Prop. A.1, partition {rows})."""
    out = x * _topk_mask(x, k, 1)
    return _normalize(out) if normalize else out


def proj_splincol(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """Keep entries in the top-k of their row OR their column ("splincol")."""
    out = x * torch.maximum(_topk_mask(x, k, 1), _topk_mask(x, k, 0))
    return _normalize(out) if normalize else out


def proj_id(x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """No sparsity constraint."""
    return _normalize(x) if normalize else x


def _block_view(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(m, n) → (m//bm, n//bn, bm, bn)."""
    m, n = x.shape
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} is not a multiple of ({bm}, {bn})")
    return x.reshape(m // bm, bm, n // bn, bn).permute(0, 2, 1, 3)


def _block_unview(b: torch.Tensor) -> torch.Tensor:
    r, c, bm, bn = b.shape
    return b.permute(0, 2, 1, 3).reshape(r * bm, c * bn)


def _block_energy(blocks: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(blocks**2, dim=(-1, -2)) + 0.0)


def proj_blockrow_topk(
    x: torch.Tensor, bm: int, bn: int, k_per_row: int, normalize: bool = True
) -> torch.Tensor:
    """Keep the top-``k_per_row`` (bm × bn) blocks by energy in every
    block-row."""
    blocks = _block_view(x, bm, bn)
    mask = _topk_mask(_block_energy(blocks), k_per_row, 1)
    out = _block_unview(blocks * mask[:, :, None, None])
    return _normalize(out) if normalize else out


def proj_blockcol_topk(
    x: torch.Tensor, bm: int, bn: int, k_per_col: int, normalize: bool = True
) -> torch.Tensor:
    """Keep the top-``k_per_col`` blocks by energy in every block-column:
    each output block of ``y = x @ F`` then gathers from exactly k input
    blocks (the packed table the kernels read)."""
    blocks = _block_view(x, bm, bn)
    mask = _topk_mask(_block_energy(blocks), k_per_col, 0)
    out = _block_unview(blocks * mask[:, :, None, None])
    return _normalize(out) if normalize else out


_PROJ_TABLE: dict[str, Callable[..., torch.Tensor]] = {
    "global": proj_global_topk,
    "col": proj_col_topk,
    "row": proj_row_topk,
    "splincol": proj_splincol,
    "blockrow": proj_blockrow_topk,
    "blockcol": proj_blockcol_topk,
    "id": proj_id,
}


@dataclasses.dataclass(frozen=True)
class ProjSpec:
    """A projection with its sparsity parameters baked in, equal by value."""

    kind: str
    params: tuple[tuple[str, object], ...]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _PROJ_TABLE[self.kind](x, **dict(self.params))


def make_proj(kind: str, **kw) -> ProjSpec:
    if kind not in _PROJ_TABLE:
        raise ValueError(f"unknown projection kind {kind!r}")
    items = []
    for key in sorted(kw):
        v = kw[key]
        if isinstance(v, (bool, np.bool_)):
            v = bool(v)
        elif isinstance(v, numbers.Integral):
            v = int(v)
        elif isinstance(v, numbers.Real):
            v = float(v)
        else:
            raise TypeError(f"projection parameter {key}={v!r} must be a number")
        items.append((key, v))
    return ProjSpec(kind, tuple(items))
