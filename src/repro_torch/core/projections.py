"""Projections onto the paper's constraint sets (Appendix A): keep the
allowed entries of largest magnitude per partition cell, zero the rest,
renormalize to unit Frobenius norm.  Counterpart of
:mod:`repro.core.projections`.

Every projection takes ``x`` of shape ``(..., m, n)`` and projects each
matrix of the leading axes on its own (norms, top-k and cells are per
matrix), so the batched PALM solver projects a whole stack in one call.

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
    """Unit Frobenius norm per matrix of the last two axes (zero stays zero)."""
    nrm = torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
    return torch.where(nrm > EPS, x / torch.clamp(nrm, min=EPS), 0.0)


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


def _flat_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k mask over each matrix's entries taken together."""
    flat = x.reshape(*x.shape[:-2], -1)
    return _topk_mask(flat, k, -1).reshape(x.shape)


def _maybe(out: torch.Tensor, normalize: bool) -> torch.Tensor:
    return _normalize(out) if normalize else out


def proj_global_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """P onto {||S||_0 ≤ k, ||S||_F = 1} (paper §III-C1)."""
    return _maybe(x * _flat_mask(x, k), normalize)


def proj_col_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """k-sparse columns (Prop. A.1, partition {columns})."""
    return _maybe(x * _topk_mask(x, k, -2), normalize)


def proj_row_topk(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """k-sparse rows (Prop. A.1, partition {rows})."""
    return _maybe(x * _topk_mask(x, k, -1), normalize)


def proj_splincol(x: torch.Tensor, k: int, normalize: bool = True) -> torch.Tensor:
    """Keep entries in the top-k of their row OR their column ("splincol")."""
    return _maybe(x * torch.maximum(_topk_mask(x, k, -1), _topk_mask(x, k, -2)), normalize)


def proj_support(x: torch.Tensor, support: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """A prescribed support (Prop. A.1's degenerate case): the constraint of
    a layer trained from scratch, whose support is chosen once."""
    return _maybe(x * support.to(device=x.device, dtype=x.dtype), normalize)


def proj_id(x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """No sparsity constraint."""
    return _maybe(x, normalize)


def proj_triu(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Upper-triangular matrices (Prop. A.1: keep a whole cell)."""
    return _maybe(torch.triu(x), normalize)


def proj_diag(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Diagonal matrices (the main diagonal of a rectangular one)."""
    eye = torch.eye(x.shape[-2], x.shape[-1], dtype=x.dtype, device=x.device)
    return _maybe(x * eye, normalize)


def _block_view(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(..., m, n) → (..., m//bm, n//bn, bm, bn)."""
    m, n = x.shape[-2:]
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} is not a multiple of ({bm}, {bn})")
    lead = x.shape[:-2]
    b = x.reshape(*lead, m // bm, bm, n // bn, bn)
    return b.transpose(-3, -2)


def _block_unview(b: torch.Tensor) -> torch.Tensor:
    r, c, bm, bn = b.shape[-4:]
    return b.transpose(-3, -2).reshape(*b.shape[:-4], r * bm, c * bn)


def _block_energy(blocks: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(blocks**2, dim=(-1, -2)) + 0.0)


def _keep_blocks(blocks: torch.Tensor, mask: torch.Tensor, normalize: bool) -> torch.Tensor:
    return _maybe(_block_unview(blocks * mask[..., None, None]), normalize)


def proj_block_topk(
    x: torch.Tensor, bm: int, bn: int, n_blocks: int, normalize: bool = True
) -> torch.Tensor:
    """Keep the ``n_blocks`` (bm × bn) blocks of largest energy in the
    whole matrix (Prop. A.1 with the partition into aligned blocks)."""
    blocks = _block_view(x, bm, bn)
    return _keep_blocks(blocks, _flat_mask(_block_energy(blocks), n_blocks), normalize)


def proj_blockrow_topk(
    x: torch.Tensor, bm: int, bn: int, k_per_row: int, normalize: bool = True
) -> torch.Tensor:
    """Keep the top-``k_per_row`` (bm × bn) blocks by energy in every
    block-row."""
    blocks = _block_view(x, bm, bn)
    return _keep_blocks(blocks, _topk_mask(_block_energy(blocks), k_per_row, -1), normalize)


def proj_blockcol_topk(
    x: torch.Tensor, bm: int, bn: int, k_per_col: int, normalize: bool = True
) -> torch.Tensor:
    """Keep the top-``k_per_col`` blocks by energy in every block-column:
    each output block of ``y = x @ F`` then gathers from exactly k input
    blocks (the packed table the kernels read)."""
    blocks = _block_view(x, bm, bn)
    return _keep_blocks(blocks, _topk_mask(_block_energy(blocks), k_per_col, -2), normalize)


def proj_piecewise_const(
    x: torch.Tensor, cell_ids: torch.Tensor, n_cells: int, s: int, normalize: bool = True
) -> torch.Tensor:
    """Prop. A.2: matrices constant over the cells C_i with at most ``s``
    nonzero cells.  ``cell_ids`` (x's last two axes) maps each entry to a
    cell in ``[0, n_cells)``; an entry with id −1 is forced to zero.  A
    cell's score is ``|Σ_{C_i} x| / sqrt(|C_i|)``."""
    ids = cell_ids.to(device=x.device, dtype=torch.int64)
    valid = (ids >= 0).to(x.dtype)
    flat_ids = torch.clamp(ids, 0, n_cells - 1).reshape(-1)
    lead = x.shape[:-2]
    xs = (x * valid).reshape(*lead, -1)
    zeros = torch.zeros((*lead, n_cells), dtype=x.dtype, device=x.device)
    sums = zeros.index_add(-1, flat_ids, xs)
    counts = torch.zeros(n_cells, dtype=x.dtype, device=x.device).index_add(0, flat_ids, valid.reshape(-1))
    counts = torch.clamp(counts, min=1.0)
    keep = _topk_mask(torch.abs(sums) / torch.sqrt(counts), s, -1)
    per_cell = (sums / counts) * keep
    out = per_cell.index_select(-1, flat_ids).reshape(x.shape) * valid
    return _maybe(out, normalize)


# ---------------------------------------------------------------------------
# Constraint-set descriptors, equal and hashable by value: the
# hierarchical loop's solve buckets key on them (``core/hierarchical.py``)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _HashableArray:
    """An array-valued projection parameter (a prescribed support, cell
    ids), equal and hashable by content so it can ride in a
    :class:`ProjSpec`.  ``unwrap`` keeps one tensor per device."""

    data: bytes
    shape: tuple[int, ...]
    dtype: str
    _on: dict = dataclasses.field(default_factory=dict, compare=False, hash=False, repr=False)

    @classmethod
    def wrap(cls, arr) -> "_HashableArray":
        a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        return cls(a.tobytes(), tuple(a.shape), str(a.dtype))

    def unwrap(self, device=None) -> torch.Tensor:
        dev = torch.device("cpu" if device is None else device)
        t = self._on.get(dev)
        if t is None:
            a = np.frombuffer(self.data, dtype=self.dtype).reshape(self.shape)
            t = self._on[dev] = torch.as_tensor(a.copy(), device=dev)
        return t


_PROJ_TABLE: dict[str, Callable[..., torch.Tensor]] = {
    "global": proj_global_topk,
    "col": proj_col_topk,
    "row": proj_row_topk,
    "splincol": proj_splincol,
    "support": proj_support,
    "block": proj_block_topk,
    "blockrow": proj_blockrow_topk,
    "blockcol": proj_blockcol_topk,
    "id": proj_id,
    "triu": proj_triu,
    "diag": proj_diag,
    "piecewise": proj_piecewise_const,
}


@dataclasses.dataclass(frozen=True)
class ProjSpec:
    """A projection with its sparsity parameters baked in, equal by value."""

    kind: str
    params: tuple[tuple[str, object], ...]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        kw = {k: (v.unwrap(x.device) if isinstance(v, _HashableArray) else v) for k, v in self.params}
        return _PROJ_TABLE[self.kind](x, **kw)


def make_proj(kind: str, **kw) -> ProjSpec:
    if kind not in _PROJ_TABLE:
        raise ValueError(f"unknown projection kind {kind!r}")
    items = []
    for key in sorted(kw):
        v = kw[key]
        if isinstance(v, (torch.Tensor, np.ndarray)):
            v = _HashableArray.wrap(v)
        elif isinstance(v, (bool, np.bool_)):
            v = bool(v)
        elif isinstance(v, numbers.Integral):
            v = int(v)
        elif isinstance(v, numbers.Real):
            v = float(v)
        else:
            raise TypeError(f"projection parameter {key}={v!r} must be a number or an array")
        items.append((key, v))
    return ProjSpec(kind, tuple(items))
