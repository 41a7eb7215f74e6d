"""Spectral norm by power iteration (paper Appendix B needs ||L||_2 and
||R||_2 for the PALM step size).  Counterpart of
:mod:`repro.core.lipschitz`: same start vector (ones), same iteration.

``a`` may carry leading batch axes ``(..., m, n)``: every matrix runs the
same iteration in lockstep as batched matrix-vector products, and the
result has the leading shape (0-d for one matrix).
"""
from __future__ import annotations

import torch


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _unit(w: torch.Tensor) -> torch.Tensor:
    return w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-30)


def spectral_norm(a: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Largest singular value of each matrix of ``a``, iterating on the
    smaller Gram matrix from the normalized ones vector."""
    m, n = a.shape[-2:]
    at = a.transpose(-2, -1)
    if n <= m:
        v = torch.ones((*a.shape[:-2], n), dtype=a.dtype, device=a.device) / (n**0.5)
        for _ in range(iters):
            v = _unit(_mv(at, _mv(a, v)))
        return torch.linalg.norm(_mv(a, v), dim=-1)
    u = torch.ones((*a.shape[:-2], m), dtype=a.dtype, device=a.device) / (m**0.5)
    for _ in range(iters):
        u = _unit(_mv(a, _mv(at, u)))
    return torch.linalg.norm(_mv(at, u), dim=-1)


def spectral_norm_sq(a: torch.Tensor, iters: int = 32) -> torch.Tensor:
    s = spectral_norm(a, iters=iters)
    return s * s


def spectral_norm_batched(a: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """``(B, m, n) → (B,)``: the largest singular value of each matrix, all
    B iterates advancing in lockstep (:func:`spectral_norm` of each slice,
    to rounding)."""
    if a.ndim != 3:
        raise ValueError(f"expected a stack (B, m, n); got {tuple(a.shape)}")
    return spectral_norm(a, iters=iters)
