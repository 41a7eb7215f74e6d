"""Spectral norm by power iteration (paper Appendix B needs ||L||_2 and
||R||_2 for the PALM step size).  Counterpart of
:mod:`repro.core.lipschitz`: same start vector (ones), same iteration."""
from __future__ import annotations

import torch


def spectral_norm(a: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Largest singular value of ``a`` (0-d tensor), iterating on the
    smaller Gram matrix from the normalized ones vector."""
    m, n = a.shape
    if n <= m:
        v = torch.ones(n, dtype=a.dtype, device=a.device) / (n**0.5)
        for _ in range(iters):
            w = a.T @ (a @ v)
            v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
        return torch.linalg.norm(a @ v)
    u = torch.ones(m, dtype=a.dtype, device=a.device) / (m**0.5)
    for _ in range(iters):
        w = a @ (a.T @ u)
        u = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.linalg.norm(a.T @ u)


def spectral_norm_sq(a: torch.Tensor, iters: int = 32) -> torch.Tensor:
    s = spectral_norm(a, iters=iters)
    return s * s
