"""palm4MSA — PALM for Multi-layer Sparse Approximation (paper Fig. 4).
Counterpart of :mod:`repro.core.palm4msa` (sequential solver).

Minimizes ``½‖A − λ·S_J···S_1‖_F²`` over the constraint sets by projected
gradient steps on each factor (step 1/c_j, c_j = (1+α)·λ²·‖L‖₂²·‖R‖₂²,
Appendix B), then the closed-form λ = tr(AᵀÂ)/tr(ÂᵀÂ).  ``factors`` are in
application order (``factors[0]`` = S_1).  The reference's ``lax.scan``
over sweeps is a Python loop here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.lipschitz import spectral_norm_sq

Proj = Callable[[torch.Tensor], torch.Tensor]

_EPS = 1e-12


class PalmState(NamedTuple):
    factors: tuple[torch.Tensor, ...]
    lam: torch.Tensor


class PalmResult(NamedTuple):
    factors: tuple[torch.Tensor, ...]
    lam: torch.Tensor
    loss_history: torch.Tensor  # (n_iter,) data fidelity ½‖A − λ∏S‖_F²


def product(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``S_J ... S_1`` for factors in application order."""
    out = factors[0]
    for s in factors[1:]:
        out = s @ out
    return out


def data_fidelity(a: torch.Tensor, factors: Sequence[torch.Tensor], lam) -> torch.Tensor:
    r = a - lam * product(factors)
    return 0.5 * torch.sum(r * r)


def _sweep(
    a: torch.Tensor,
    factors: tuple[torch.Tensor, ...],
    lam: torch.Tensor,
    projs: tuple[Proj, ...],
    frozen: tuple[bool, ...],
    alpha: float,
    power_iters: int,
    grad_floor_rel: float = 1e-6,
) -> PalmState:
    """One PALM sweep: update S_1..S_J, then λ.

    ``grad_floor_rel``: a factor's gradient step is skipped when ‖∇‖_F is
    below ``grad_floor_rel · |λ|·‖L‖₂‖R‖₂·‖A‖_F``, the rounding-noise scale
    of the product chain; near an exact factorization dividing that noise
    by a tiny curvature would destroy the iterate.  The projection always
    applies.
    """
    n = len(factors)
    a_norm = torch.linalg.norm(a)
    one = torch.ones((), dtype=a.dtype, device=a.device)

    # suffix[j] = L_j = S_J ... S_{j+1} from the pre-sweep factors
    suffix: list[torch.Tensor | None] = [None] * n
    acc: torch.Tensor | None = None
    for j in range(n - 1, -1, -1):
        suffix[j] = acc
        acc = factors[j] if acc is None else acc @ factors[j]

    new_factors: list[torch.Tensor] = []
    prefix: torch.Tensor | None = None  # R_j = S_{j-1} ... S_1, updated factors
    lam2 = lam * lam
    for j in range(n):
        s = factors[j]
        if frozen[j]:
            s_new = s
        else:
            left, right = suffix[j], prefix
            l2 = one if left is None else spectral_norm_sq(left, iters=power_iters)
            r2 = one if right is None else spectral_norm_sq(right, iters=power_iters)
            c = (1.0 + alpha) * lam2 * l2 * r2 + _EPS
            # ∇_{S_j} H = λ Lᵀ (λ L S R − A) Rᵀ
            lsr = s if right is None else s @ right
            lsr = lsr if left is None else left @ lsr
            resid = lam * lsr - a
            g = resid if left is None else left.T @ resid
            g = g if right is None else g @ right.T
            g = lam * g
            theta = grad_floor_rel * torch.abs(lam) * torch.sqrt(l2 * r2) * a_norm
            step = torch.where(torch.linalg.norm(g) > theta, one, 0.0 * one) / c
            s_new = projs[j](s - g * step)
        new_factors.append(s_new)
        prefix = s_new if prefix is None else s_new @ prefix

    a_hat = prefix
    num = torch.sum(a * a_hat)
    den = torch.sum(a_hat * a_hat)
    return PalmState(tuple(new_factors), num / torch.clamp(den, min=_EPS))


def palm4msa(
    a: torch.Tensor,
    factors: tuple[torch.Tensor, ...],
    lam=None,
    projs: tuple[Proj, ...] = (),
    n_iter: int = 0,
    frozen: tuple[bool, ...] | None = None,
    alpha: float = 1e-3,
    power_iters: int = 24,
    keep_best: bool = True,
    init_feasible: bool = False,
) -> PalmResult:
    """Run ``n_iter`` PALM sweeps from ``factors``/``lam`` (λ defaults to 1).

    ``keep_best`` returns the iterate with the lowest data fidelity seen:
    on tied magnitudes (Hadamard) the top-k projections are set-valued and
    a support flip can destroy an exact product.  ``init_feasible`` lets
    the initial point take part in that selection (global refinements,
    whose factors all came out of projections); two-factor splits start
    from a deliberately infeasible warm init and pass False.
    """
    factors = tuple(factors)
    if frozen is None:
        frozen = (False,) * len(factors)
    if not len(projs) == len(factors) == len(frozen):
        raise ValueError(
            f"{len(factors)} factors need as many projections and frozen flags; "
            f"got {len(projs)} and {len(frozen)}"
        )
    lam = torch.as_tensor(1.0 if lam is None else lam, dtype=a.dtype, device=a.device)
    state = PalmState(factors, lam)
    best = state
    best_loss = (
        float(data_fidelity(a, factors, lam)) if init_feasible else float("inf")
    )
    losses = []
    for _ in range(n_iter):
        state = _sweep(a, state.factors, state.lam, tuple(projs), frozen, alpha, power_iters)
        loss = data_fidelity(a, state.factors, state.lam)
        losses.append(loss)
        if not keep_best:
            best = state
        elif float(loss) < best_loss:
            best, best_loss = state, float(loss)
    history = (
        torch.stack(losses) if losses else torch.zeros(0, dtype=a.dtype, device=a.device)
    )
    return PalmResult(best.factors, best.lam, history)
