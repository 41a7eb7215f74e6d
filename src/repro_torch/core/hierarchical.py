"""Hierarchical factorization (paper Fig. 5), sequential.  Counterpart of
:mod:`repro.core.hierarchical`.

The residual T_{ℓ-1} is split into (T_ℓ, S_ℓ) by a two-factor palm4MSA,
then every factor found so far is refined by a global palm4MSA.  The
reference's jit trace cache has no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.faust import Faust, default_init, identity_like
from repro_torch.core.palm4msa import Proj, palm4msa


@dataclasses.dataclass
class HierarchicalInfo:
    """``global_losses``: final global-refinement fidelity per split step.
    ``sweeps``: PALM sweeps run in all (Σ n_iter over solves)."""

    global_losses: list
    sweeps: int = 0


@dataclasses.dataclass(frozen=True)
class HierarchicalSpec:
    """Constraint schedule: ``factor_projs[ℓ-1]`` is E_ℓ (for S_ℓ),
    ``resid_projs[ℓ-1]`` is Ẽ_ℓ (for T_ℓ), ``inner_dims[ℓ-1]`` is a_{ℓ+1}.

    ``init="warm"`` starts each split with a product equal to the current
    residual (needed for exact Hadamard under deterministic tie-breaking);
    ``"paper_default"`` is §III-C3 strict (S = 0, T = Id).
    """

    factor_projs: tuple[Proj, ...]
    resid_projs: tuple[Proj, ...]
    inner_dims: tuple[int, ...]
    n_iter_two: int = 50
    n_iter_global: int = 50
    alpha: float = 1e-3
    power_iters: int = 24
    init: str = "warm"

    @property
    def n_factors(self) -> int:
        return len(self.factor_projs) + 1


def _two_factor_init(t: torch.Tensor, d: int, init: str):
    """Initial (S, T_new) for splitting ``t (m, n)`` → T_new (m, d) · S (d, n)."""
    m, n = t.shape
    kw = dict(dtype=t.dtype, device=t.device)
    if init == "paper_default":
        return default_init((n, d, m), **kw)
    # warm: the product equals t.  Carry t in the residual slot where the
    # shapes allow (exact on Hadamard), else in the factor slot.
    if (m, d) == tuple(t.shape):
        s0, t0 = identity_like((d, n), **kw), t
    elif (d, n) == tuple(t.shape):
        s0, t0 = t, identity_like((m, d), **kw)
    else:
        s0, t0 = identity_like((d, n), **kw), identity_like((m, d), **kw)
    return (s0, t0), torch.ones((), **kw)


def hierarchical_factorization(
    a: torch.Tensor, spec: HierarchicalSpec
) -> tuple[Faust, HierarchicalInfo]:
    """Paper Fig. 5: the J-factor FAµST of ``a (m, n)`` and its run record.

    Every factor stays unit-norm and the scale rides in the global λ (the
    reference's conditioning variant of line 4)."""
    if a.ndim != 2:
        raise ValueError(f"expected (m, n); got {tuple(a.shape)}")
    n_splits = len(spec.factor_projs)
    if not len(spec.resid_projs) == len(spec.inner_dims) == n_splits:
        raise ValueError("factor_projs, resid_projs and inner_dims differ in length")

    t = a
    s_factors: list[torch.Tensor] = []
    lam = torch.ones((), dtype=a.dtype, device=a.device)
    info = HierarchicalInfo([])
    for ell in range(1, n_splits + 1):
        init_factors, init_lam = _two_factor_init(t, spec.inner_dims[ell - 1], spec.init)
        two = palm4msa(
            t, init_factors, init_lam,
            (spec.factor_projs[ell - 1], spec.resid_projs[ell - 1]),
            spec.n_iter_two, alpha=spec.alpha, power_iters=spec.power_iters,
        )
        s_ell, t = two.factors
        lam = lam * two.lam
        s_factors.append(s_ell)

        projs = tuple(spec.factor_projs[:ell]) + (spec.resid_projs[ell - 1],)
        glob = palm4msa(
            a, tuple(s_factors) + (t,), lam, projs, spec.n_iter_global,
            alpha=spec.alpha, power_iters=spec.power_iters,
            init_feasible=True,  # every factor came out of a projection
        )
        s_factors = list(glob.factors[:-1])
        t = glob.factors[-1]
        lam = glob.lam
        info.global_losses.append(float(glob.loss_history[-1]))
        info.sweeps += spec.n_iter_two + spec.n_iter_global
    return Faust(tuple(s_factors) + (t,), lam), info


def hadamard_spec(
    n: int,
    n_iter_two: int = 50,
    n_iter_global: int = 50,
    constraints: str = "splincol",
    init: str = "warm",
) -> HierarchicalSpec:
    """Paper §IV-C: J = log2(n) factors of 2n nonzeros; ``"splincol"``
    spreads the budget per row and column, ``"global"`` is the literal
    total-count variant."""
    from repro_torch.core import projections as P

    n_factors = int(n).bit_length() - 1
    if 2**n_factors != n:
        raise ValueError(f"Hadamard needs n = 2^N; got {n}")
    if constraints == "splincol":
        factor_projs = tuple(P.make_proj("splincol", k=2) for _ in range(n_factors - 1))
        resid_projs = tuple(
            P.make_proj("splincol", k=max(n // (2**ell), 2)) for ell in range(1, n_factors)
        )
    elif constraints == "global":
        factor_projs = tuple(P.make_proj("global", k=2 * n) for _ in range(n_factors - 1))
        resid_projs = tuple(
            P.make_proj("global", k=max(n * n // (2**ell), 2 * n))
            for ell in range(1, n_factors)
        )
    else:
        raise ValueError(constraints)
    return HierarchicalSpec(
        factor_projs, resid_projs, (n,) * (n_factors - 1),
        n_iter_two=n_iter_two, n_iter_global=n_iter_global, init=init,
    )


def hadamard_matrix(n: int, *, dtype=torch.float32, device) -> torch.Tensor:
    """Dense Sylvester Hadamard matrix, n = 2^N."""
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h
