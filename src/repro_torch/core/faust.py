"""FAµST — a linear operator ``A ≈ λ · S_J ··· S_1`` kept as a product of
sparse factors (paper eq. (1)).  Counterpart of :mod:`repro.core.faust`.

:class:`Faust` holds the factors as dense tensors with enforced zeros: the
form PALM and the hierarchical algorithm work on.  The packed block-sparse
deployment forms live in :mod:`repro_torch.core.compress`.

Conventions (paper §II): factor ``j`` has shape ``(a_{j+1}, a_j)`` with
``a_1 = n`` and ``a_{J+1} = m``; ``factors[0]`` is ``S_1``, applied first.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Faust:
    """``A ≈ lam * S_J @ ... @ S_1`` with ``factors`` in application order."""

    factors: tuple[torch.Tensor, ...]
    lam: torch.Tensor  # 0-d

    @property
    def shape(self) -> tuple[int, int]:
        return (self.factors[-1].shape[0], self.factors[0].shape[1])

    @property
    def n_factors(self) -> int:
        return len(self.factors)

    def __len__(self) -> int:
        return len(self.factors)

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def to(self, device=None, dtype=None) -> "Faust":
        return Faust(
            tuple(s.to(device=device, dtype=dtype) for s in self.factors),
            self.lam.to(device=device),
        )

    def todense(self) -> torch.Tensor:
        """Materialize ``lam * S_J ... S_1``."""
        out = self.factors[0]
        for s in self.factors[1:]:
            out = s @ out
        return self.lam * out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for ``x`` of shape ``(n,)`` or ``(n, batch)``."""
        y = x
        for s in self.factors:
            y = s @ y
        return self.lam * y

    def apply_t(self, y: torch.Tensor) -> torch.Tensor:
        """``Aᵀ @ y`` for ``y`` of shape ``(m,)`` or ``(m, batch)``."""
        x = y
        for s in reversed(self.factors):
            x = s.T @ x
        return self.lam * x

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    @property
    def T(self) -> "Faust":
        return Faust(tuple(s.T for s in reversed(self.factors)), self.lam)

    def nnz_per_factor(self) -> list[int]:
        return [int(torch.count_nonzero(s)) for s in self.factors]

    @property
    def s_tot(self) -> int:
        return int(sum(self.nnz_per_factor()))

    def rc(self, dense_nnz: int | None = None) -> float:
        """Relative Complexity (Definition II.1): s_tot / ||A||_0."""
        if dense_nnz is None:
            dense_nnz = self.shape[0] * self.shape[1]
        return self.s_tot / dense_nnz

    def rcg(self, dense_nnz: int | None = None) -> float:
        """Relative Complexity Gain = 1 / RC."""
        return 1.0 / self.rc(dense_nnz)

    def rel_error_fro(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(a - self.todense()) / torch.linalg.norm(a)


def identity_like(
    shape: tuple[int, int], *, dtype=torch.float32, device
) -> torch.Tensor:
    """Rectangular identity: ones on the main diagonal (paper §III-C3)."""
    return torch.eye(shape[0], shape[1], dtype=dtype, device=device)


def default_init(
    dims: Sequence[int], *, dtype=torch.float32, device
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Paper §III-C3: ``S_1 = 0``, ``S_j = Id`` for j ≥ 2, ``λ = 1``."""
    factors = []
    for j in range(len(dims) - 1):
        shape = (dims[j + 1], dims[j])
        if j == 0:
            factors.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            factors.append(identity_like(shape, dtype=dtype, device=device))
    return tuple(factors), torch.ones((), dtype=dtype, device=device)


def faust_flops(faust: Faust, batch: int = 1) -> int:
    """Flop count of ``apply`` on a ``batch`` of vectors: 2·s_tot·batch."""
    return 2 * faust.s_tot * batch


def dense_flops(shape: tuple[int, int], batch: int = 1) -> int:
    """Flop count of a dense ``(m, n)`` matrix on a ``batch`` of vectors."""
    return 2 * int(shape[0]) * int(shape[1]) * batch
