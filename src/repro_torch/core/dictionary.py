"""Sparse coding and dense dictionary learning (paper §V, §VI).
Counterpart of :mod:`repro.core.dictionary`.

The solvers take the operator as callables (``matvec``, ``rmatvec``), so a
dense matrix or a FAµST plugs in alike: OMP (fixed sparsity k, batched
over the signals), ISTA (ℓ1), IHT (ℓ0), MOD dictionary learning (the DDL
baseline), and the patch utilities of the denoising workflow.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.projections import _topk_mask

MatVec = Callable[[torch.Tensor], torch.Tensor]


def _batched_ls(cols: torch.Tensor, y: torch.Tensor, ridge: float = 1e-8) -> torch.Tensor:
    """Least squares per signal: cols (L, m, t), y (m, L) → coefficients (L, t)."""
    gram = cols.mT @ cols
    rhs = (cols.mT @ y.T.unsqueeze(-1)).squeeze(-1)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return torch.linalg.solve(gram + ridge * eye, rhs)


def omp(y: torch.Tensor, d: torch.Tensor, k: int, rmatvec: MatVec | None = None) -> torch.Tensor:
    """Batched orthogonal matching pursuit: codes Γ (n, L) with at most k
    atoms per column of ``y (m, L)`` over the dictionary ``d (m, n)``.

    ``rmatvec`` is the adjoint apply of the selection step, the solver's
    dominant cost (pass a FAµST's adjoint for its speed-up; default
    ``d.T @ r``).  Selection normalizes by the column norms; each step
    then solves the least squares on the active support exactly.  Ties go
    to the lowest atom index, as ``jnp.argmax``: a signal whose residual is
    already zero (a training column that is an atom) selects atom 0 again
    as the reference does; the repeated column is zeroed in its least
    squares, so its coefficient is 0 and Γ holds the atom's one value.
    """
    n = d.shape[1]
    l = y.shape[1]
    rmv = rmatvec if rmatvec is not None else (lambda r: d.T @ r)
    col_norms = torch.clamp(torch.linalg.norm(d, dim=0), min=1e-12)
    cols_all = d.T  # (n, m)
    r = y
    support = torch.zeros((k, l), dtype=torch.int64, device=y.device)
    selected = torch.zeros((n, l), dtype=torch.bool, device=y.device)
    coefs = torch.zeros((k, l), dtype=y.dtype, device=y.device)
    rows = torch.arange(l, device=y.device)
    first = torch.ones((k, l), dtype=y.dtype, device=y.device)  # 0 where an atom repeats
    for t in range(k):
        corr = torch.abs(rmv(r) / col_norms[:, None])
        corr = torch.where(selected, torch.zeros_like(corr), corr)
        idx = torch.argmax(corr, dim=0)
        support[t] = idx
        selected[idx, rows] = True
        if t:
            first[t] = torch.where((support[:t] == idx).any(0), 0.0, 1.0)
        cols = cols_all[support[: t + 1]].permute(1, 2, 0) * first[: t + 1].T[:, None, :]  # (L, m, t+1)
        sol = _batched_ls(cols, y)
        coefs[: t + 1] = sol.T
        r = y - (cols @ sol.unsqueeze(-1)).squeeze(-1).T
    gamma = torch.zeros((n, l), dtype=y.dtype, device=y.device)
    return gamma.index_put_((support, rows.expand(k, l)), coefs, accumulate=True)


def soft_threshold(x: torch.Tensor, tau) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - tau, min=0.0)


def ista(y: torch.Tensor, matvec: MatVec, rmatvec: MatVec, n: int, lam: float, step: float,
         n_iter: int = 100) -> torch.Tensor:
    """ℓ1-regularized least squares by ISTA: ``y (m, L)`` → codes (n, L)."""
    x = torch.zeros((n, y.shape[1]), dtype=y.dtype, device=y.device)
    for _ in range(n_iter):
        x = soft_threshold(x - step * rmatvec(matvec(x) - y), step * lam)
    return x


def hard_threshold_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k entries of largest magnitude in every column."""
    return x * _topk_mask(x, k, 0)


def iht(y: torch.Tensor, matvec: MatVec, rmatvec: MatVec, n: int, k: int, step: float,
        n_iter: int = 100) -> torch.Tensor:
    """Iterative hard thresholding, k-sparse columns."""
    x = torch.zeros((n, y.shape[1]), dtype=y.dtype, device=y.device)
    for _ in range(n_iter):
        x = hard_threshold_topk(x + step * rmatvec(y - matvec(x)), k)
    return x


def learn_dictionary_mod(
    y: torch.Tensor,
    n_atoms: int,
    k: int,
    n_iter: int,
    init_idx: torch.Tensor,
    ridge: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MOD: alternate OMP coding and the least-squares dictionary update,
    from the training columns ``init_idx`` (``n_atoms`` of them; the
    reference draws them with ``jax.random.choice``).  Returns
    (D (m, n_atoms) with unit columns, Γ (n_atoms, L))."""
    d = y[:, init_idx.to(y.device)]
    d = d / torch.clamp(torch.linalg.norm(d, dim=0, keepdim=True), min=1e-12)
    eye = torch.eye(n_atoms, dtype=y.dtype, device=y.device)
    gamma = None
    for _ in range(n_iter):
        gamma = omp(y, d, k)
        d = y @ gamma.T @ torch.linalg.inv(gamma @ gamma.T + ridge * eye)
        d = d / torch.clamp(torch.linalg.norm(d, dim=0, keepdim=True), min=1e-12)
    return d, gamma


def extract_patches(img: torch.Tensor, patch: int, stride: int = 1) -> torch.Tensor:
    """Every (patch × patch) patch, row-major over positions → (patch², n)."""
    p = img.unfold(0, patch, stride).unfold(1, patch, stride)
    return p.reshape(-1, patch * patch).T


def reconstruct_from_patches(
    patches: torch.Tensor, img_shape: tuple[int, int], patch: int, stride: int = 1
) -> torch.Tensor:
    """Average overlapping patches back into an image."""
    kw = dict(output_size=tuple(img_shape), kernel_size=patch, stride=stride)
    acc = F.fold(patches[None], **kw)[0, 0]
    cnt = F.fold(torch.ones_like(patches)[None], **kw)[0, 0]
    return acc / torch.clamp(cnt, min=1.0)


def psnr(x: torch.Tensor, ref: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    mse = torch.mean((x - ref) ** 2)
    return 10.0 * torch.log10(peak**2 / torch.clamp(mse, min=1e-12))
