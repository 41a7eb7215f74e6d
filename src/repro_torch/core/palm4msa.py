"""palm4MSA — PALM for Multi-layer Sparse Approximation (paper Fig. 4).
Counterpart of :mod:`repro.core.palm4msa`.

Minimizes ``½‖A − λ·S_J···S_1‖_F²`` over the constraint sets by projected
gradient steps on each factor (step 1/c_j, c_j = (1+α)·λ²·‖L‖₂²·‖R‖₂²,
Appendix B), then the closed-form λ = tr(AᵀÂ)/tr(ÂᵀÂ).  ``factors`` are in
application order (``factors[0]`` = S_1).

One loop serves both entry points, as the reference's shared
``_palm_scan`` does: :func:`palm4msa_batched` solves ``B`` same-shaped
problems as one stack (batched matrix products, batched power iteration
for the step sizes, projections over the leading axis, the best iterate
kept per matrix with ``torch.where``), and :func:`palm4msa` runs it with a
batch of 1.  No value leaves the device inside the loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.faust import Faust, default_init
from repro_torch.core.lipschitz import spectral_norm_sq

Proj = Callable[[torch.Tensor], torch.Tensor]

_EPS = 1e-12


class PalmState(NamedTuple):
    factors: tuple[torch.Tensor, ...]
    lam: torch.Tensor


class PalmResult(NamedTuple):
    factors: tuple[torch.Tensor, ...]
    lam: torch.Tensor
    loss_history: torch.Tensor  # (n_iter,) or (B, n_iter): data fidelity ½‖A − λ∏S‖_F²


def product(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``S_J ... S_1`` for factors in application order."""
    out = factors[0]
    for s in factors[1:]:
        out = s @ out
    return out


def _col(v: torch.Tensor) -> torch.Tensor:
    """``(B,)`` → ``(B, 1, 1)``, to scale a stack of matrices."""
    return v.reshape(v.shape + (1, 1))


def data_fidelity(a: torch.Tensor, factors: Sequence[torch.Tensor], lam) -> torch.Tensor:
    """``½‖A − λ∏S‖_F²`` per matrix of the leading axes."""
    lam = torch.as_tensor(lam, dtype=a.dtype, device=a.device)
    r = a - lam.reshape(lam.shape + (1, 1)) * product(factors)
    return 0.5 * torch.sum(r * r, dim=(-2, -1))


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
    """One PALM sweep over a stack ``a (B, m, n)``: update S_1..S_J, then λ
    ``(B,)``.

    ``grad_floor_rel``: a factor's gradient step is skipped when ‖∇‖_F is
    below ``grad_floor_rel · |λ|·‖L‖₂‖R‖₂·‖A‖_F``, the rounding-noise scale
    of the product chain; near an exact factorization dividing that noise
    by a tiny curvature would destroy the iterate.  The projection always
    applies.
    """
    n = len(factors)
    a_norm = torch.linalg.norm(a, dim=(-2, -1))
    one = torch.ones_like(lam)

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
            resid = _col(lam) * lsr - a
            g = resid if left is None else left.mT @ resid
            g = g if right is None else g @ right.mT
            g = _col(lam) * g
            theta = grad_floor_rel * torch.abs(lam) * torch.sqrt(l2 * r2) * a_norm
            step = torch.where(torch.linalg.norm(g, dim=(-2, -1)) > theta, one, 0.0 * one) / c
            s_new = projs[j](s - g * _col(step))
        new_factors.append(s_new)
        prefix = s_new if prefix is None else s_new @ prefix

    a_hat = prefix
    num = torch.sum(a * a_hat, dim=(-2, -1))
    den = torch.sum(a_hat * a_hat, dim=(-2, -1))
    return PalmState(tuple(new_factors), num / torch.clamp(den, min=_EPS))


def _palm_run(
    a: torch.Tensor,
    factors: tuple[torch.Tensor, ...],
    lam: torch.Tensor,
    projs: tuple[Proj, ...],
    frozen: tuple[bool, ...],
    alpha: float,
    power_iters: int,
    n_iter: int,
    keep_best: bool,
    init_feasible: bool,
) -> tuple[PalmState, torch.Tensor]:
    """The loop of both solvers on a stack ``a (B, m, n)``, factors
    ``(B, ·, ·)`` and λ ``(B,)``: the sweeps, then the best iterate per
    matrix (or the last).  Returns it and the ``(B, n_iter)`` history."""
    state = PalmState(tuple(factors), lam)
    best = state
    if init_feasible:
        best_loss = data_fidelity(a, factors, lam)
    else:
        best_loss = torch.full_like(lam, float("inf"))
    losses = []
    for _ in range(n_iter):
        state = _sweep(a, state.factors, state.lam, projs, frozen, alpha, power_iters)
        loss = data_fidelity(a, state.factors, state.lam)
        losses.append(loss)
        if keep_best:
            better = loss < best_loss
            best = PalmState(
                tuple(torch.where(_col(better), s, b) for s, b in zip(state.factors, best.factors)),
                torch.where(better, state.lam, best.lam),
            )
            best_loss = torch.where(better, loss, best_loss)
    history = torch.stack(losses, dim=1) if losses else lam.new_zeros((lam.shape[0], 0))
    return (best if keep_best else state), history


def _resolve_init(factors, lam, init_factors, init_lam):
    """Merge the positional init with the keyword warm-start spelling:
    exactly one of ``factors``/``init_factors``; λ defaults to 1."""
    if (factors is None) == (init_factors is None):
        raise ValueError(
            "pass exactly one of `factors` (positional) or `init_factors=` (warm start); got "
            f"factors={'set' if factors is not None else None}, "
            f"init_factors={'set' if init_factors is not None else None}"
        )
    if factors is None:
        if lam is not None:
            raise ValueError("`lam` belongs to positional init; use `init_lam=`")
        factors, lam = tuple(init_factors), init_lam
    elif init_lam is not None:
        raise ValueError("`init_lam` belongs to `init_factors=`; use `lam`")
    return tuple(factors), (1.0 if lam is None else lam)


def _check(projs, factors, frozen):
    frozen = (False,) * len(factors) if frozen is None else tuple(frozen)
    if not len(projs) == len(factors) == len(frozen):
        raise ValueError(
            f"{len(factors)} factors need as many projections and frozen flags; "
            f"got {len(projs)} and {len(frozen)}"
        )
    return frozen


def palm4msa(
    a: torch.Tensor,
    factors: tuple[torch.Tensor, ...] | None = None,
    lam=None,
    projs: tuple[Proj, ...] = (),
    n_iter: int = 0,
    frozen: tuple[bool, ...] | None = None,
    alpha: float = 1e-3,
    power_iters: int = 24,
    keep_best: bool = True,
    init_feasible: bool = False,
    *,
    init_factors: tuple[torch.Tensor, ...] | None = None,
    init_lam=None,
) -> PalmResult:
    """Run ``n_iter`` PALM sweeps on ``a (m, n)`` from ``factors``/``lam``
    (λ defaults to 1): :func:`palm4msa_batched` with a batch of 1.

    ``keep_best`` returns the iterate with the lowest data fidelity seen:
    on tied magnitudes (Hadamard) the top-k projections are set-valued and
    a support flip can destroy an exact product.  ``init_feasible`` lets
    the initial point take part in that selection (global refinements,
    whose factors all came out of projections); two-factor splits start
    from a deliberately infeasible warm init and pass False.

    ``init_factors=``/``init_lam=``: the keyword spelling of a warm start
    (a converged state to resume from); pass ``init_feasible=True`` with
    it, so a sweep from a converged state is no worse than its start.
    """
    factors, lam = _resolve_init(factors, lam, init_factors, init_lam)
    frozen = _check(projs, factors, frozen)
    lam = torch.as_tensor(lam, dtype=a.dtype, device=a.device).reshape(1)
    out, history = _palm_run(
        a[None], tuple(f[None] for f in factors), lam, tuple(projs), frozen, alpha,
        power_iters, n_iter, keep_best, init_feasible,
    )
    return PalmResult(tuple(f[0] for f in out.factors), out.lam[0], history[0])


def palm4msa_batched(
    a: torch.Tensor,
    factors: tuple[torch.Tensor, ...] | None = None,
    lam=None,
    projs: tuple[Proj, ...] = (),
    n_iter: int = 0,
    frozen: tuple[bool, ...] | None = None,
    alpha: float = 1e-3,
    power_iters: int = 24,
    keep_best: bool = True,
    init_feasible: bool = False,
    *,
    init_factors: tuple[torch.Tensor, ...] | None = None,
    init_lam=None,
) -> PalmResult:
    """:func:`palm4msa` over a leading batch axis: ``a (B, m, n)``, each
    factor ``(B, m_j, n_j)``, λ a scalar or ``(B,)``.  Every matrix runs
    the sequential computation (the same loop), the best iterate is kept
    per matrix, and the result's leaves carry the batch axis;
    ``loss_history`` is ``(B, n_iter)``."""
    factors, lam = _resolve_init(factors, lam, init_factors, init_lam)
    frozen = _check(projs, factors, frozen)
    if a.ndim != 3:
        raise ValueError(f"palm4msa_batched expects (B, m, n); got {tuple(a.shape)}")
    lam = torch.as_tensor(lam, dtype=a.dtype, device=a.device).expand(a.shape[0])
    out, history = _palm_run(
        a, tuple(factors), lam, tuple(projs), frozen, alpha, power_iters, n_iter, keep_best,
        init_feasible,
    )
    return PalmResult(out.factors, out.lam, history)


def palm4msa_faust(
    a: torch.Tensor, dims: Sequence[int], projs: tuple[Proj, ...], n_iter: int, **kw
) -> tuple[Faust, torch.Tensor]:
    """Default init (§III-C3), then :func:`palm4msa`, as a :class:`Faust`."""
    factors, lam = default_init(dims, dtype=a.dtype, device=a.device)
    res = palm4msa(a, factors, lam, projs, n_iter, **kw)
    return Faust(res.factors, res.lam), res.loss_history
