"""Hierarchical factorization (paper Fig. 5) and its dictionary-learning
variant (Fig. 11).  Counterpart of :mod:`repro.core.hierarchical`.

The residual T_{ℓ-1} is split into (T_ℓ, S_ℓ) by a two-factor palm4MSA,
then every factor found so far is refined by a global palm4MSA.  One
ℓ-loop serves one matrix and a stack of same-shaped ones: a stack runs
every solve through :func:`~repro_torch.core.palm4msa.palm4msa_batched`,
one matrix as a stack of 1, so the two agree by construction.

The reference buckets its solves to reuse jit traces; PyTorch runs
eagerly and has no trace to reuse, but the bucket accounting is kept
(:class:`CacheStats`): a *miss* is the first solve of a ``(shapes,
projection specs, hyperparameters)`` bucket in the process, a *hit* a
later one, and ``sweeps`` counts the PALM sweeps run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.faust import Faust, default_init, identity_like
from repro_torch.core.palm4msa import Proj, palm4msa_batched, product


@dataclasses.dataclass
class CacheStats:
    """Solve-bucket counters of one run (or of the process)."""

    hits: int = 0
    misses: int = 0
    sweeps: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses


@dataclasses.dataclass
class HierarchicalInfo:
    """``global_losses``: final global-refinement fidelity per split step
    (floats, or ``(B,)`` arrays for a stack); ``cache``: this run's
    :class:`CacheStats`."""

    global_losses: list
    cache: CacheStats

    @property
    def n_sweeps(self) -> int:
        """PALM sweeps this run paid (Σ n_iter over solves)."""
        return self.cache.sweeps


_SEEN_BUCKETS: set = set()
_GLOBAL_STATS = CacheStats()


def trace_cache_stats() -> CacheStats:
    """Cumulative process-wide bucket counters."""
    return dataclasses.replace(_GLOBAL_STATS)


def reset_trace_cache() -> None:
    """Forget every bucket and zero the process-wide counters."""
    _SEEN_BUCKETS.clear()
    _GLOBAL_STATS.hits = _GLOBAL_STATS.misses = _GLOBAL_STATS.sweeps = 0


def _run_palm(stats: CacheStats, a, factors, lam, projs, n_iter, *, frozen=None, alpha,
              power_iters, init_feasible=False, batched=False):
    """One solve on a stack, counted in its bucket (the reference's key)."""
    bucket = (
        batched, tuple(a.shape[1:]) if not batched else tuple(a.shape), str(a.dtype),
        tuple(tuple(f.shape[1:]) if not batched else tuple(f.shape) for f in factors),
        projs, n_iter, frozen, alpha, power_iters, init_feasible,
    )
    hit = bucket in _SEEN_BUCKETS
    _SEEN_BUCKETS.add(bucket)
    for s in (stats, _GLOBAL_STATS):
        s.hits += hit
        s.misses += not hit
        s.sweeps += n_iter
    return palm4msa_batched(
        a, factors, lam, projs, n_iter, frozen=frozen, alpha=alpha, power_iters=power_iters,
        init_feasible=init_feasible,
    )


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


def _two_factor_init_batched(t: torch.Tensor, d: int, init: str):
    """Initial (S, T_new) for splitting each ``t (B, m, n)`` → T_new (m, d)
    · S (d, n): identity slots are broadcast views over the stack, a
    warm-carried residual stays the stack itself."""
    bsz, m, n = t.shape
    kw = dict(dtype=t.dtype, device=t.device)

    def tile(x: torch.Tensor) -> torch.Tensor:
        return x.expand((bsz,) + tuple(x.shape))

    if init == "paper_default":
        (s0, t0), _ = default_init((n, d, m), **kw)
        return (tile(s0), tile(t0)), torch.ones(bsz, **kw)
    if d == n:  # carry t in the residual slot (exact on Hadamard)
        s0, t0 = tile(identity_like((d, n), **kw)), t
    elif d == m:  # rectangular first split, MEG-style: carry it in the factor
        s0, t0 = t, tile(identity_like((m, d), **kw))
    else:  # no shape-compatible carry
        s0, t0 = tile(identity_like((d, n), **kw)), tile(identity_like((m, d), **kw))
    return (s0, t0), torch.ones(bsz, **kw)


def _hierarchical_loop(a: torch.Tensor, spec: HierarchicalSpec, batched: bool):
    """The Fig. 5 ℓ-loop on a stack ``a (B, m, n)``.  Every factor stays
    unit-norm and the scale rides in the global λ (the reference's
    conditioning variant of line 4).  Returns (chain, λ (B,), info);
    ``batched`` only sets how solves are bucketed and losses reported."""
    n_splits = len(spec.factor_projs)
    if not len(spec.resid_projs) == len(spec.inner_dims) == n_splits:
        raise ValueError("factor_projs, resid_projs and inner_dims differ in length")
    t = a
    s_factors: list[torch.Tensor] = []
    lam = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    losses: list = []
    stats = CacheStats()
    kw = dict(alpha=spec.alpha, power_iters=spec.power_iters, batched=batched)
    for ell in range(1, n_splits + 1):
        init_factors, init_lam = _two_factor_init_batched(t, spec.inner_dims[ell - 1], spec.init)
        two = _run_palm(
            stats, t, init_factors, init_lam,
            (spec.factor_projs[ell - 1], spec.resid_projs[ell - 1]), spec.n_iter_two, **kw,
        )
        s_ell, t = two.factors
        lam = lam * two.lam
        s_factors.append(s_ell)

        projs = tuple(spec.factor_projs[:ell]) + (spec.resid_projs[ell - 1],)
        glob = _run_palm(
            stats, a, tuple(s_factors) + (t,), lam, projs, spec.n_iter_global,
            init_feasible=True,  # every factor came out of a projection
            **kw,
        )
        s_factors, t, lam = list(glob.factors[:-1]), glob.factors[-1], glob.lam
        last = glob.loss_history[:, -1].cpu().numpy()
        losses.append(last if batched else float(last[0]))
    return tuple(s_factors) + (t,), lam, HierarchicalInfo(losses, stats)


def hierarchical_factorization(
    a: torch.Tensor, spec: HierarchicalSpec
) -> tuple[Faust, HierarchicalInfo]:
    """Paper Fig. 5: the J-factor FAµST of ``a (m, n)`` and its run record."""
    if a.ndim != 2:
        raise ValueError(f"expected (m, n); got {tuple(a.shape)}")
    chain, lam, info = _hierarchical_loop(a[None], spec, batched=False)
    return Faust(tuple(f[0] for f in chain), lam[0]), info


def hierarchical_factorization_batched(
    a: torch.Tensor, spec: HierarchicalSpec
) -> tuple[list[Faust], HierarchicalInfo]:
    """Paper Fig. 5 over a stack ``a (B, m, n)`` of same-shaped matrices:
    one solve per (split, refine) step for the whole stack.  Returns one
    :class:`Faust` per matrix; ``info.global_losses`` holds ``(B,)``
    arrays."""
    if a.ndim != 3:
        raise ValueError(f"expected (B, m, n); got {tuple(a.shape)}")
    chain, lam, info = _hierarchical_loop(a, spec, batched=True)
    return [Faust(tuple(f[i] for f in chain), lam[i]) for i in range(a.shape[0])], info


def hierarchical_dictionary(
    y: torch.Tensor,
    d0: torch.Tensor,
    gamma0: torch.Tensor,
    spec: HierarchicalSpec,
    sparse_coding: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> tuple[Faust, torch.Tensor, HierarchicalInfo]:
    """Paper Fig. 11: hierarchical factorization of a dictionary.

    ``y`` data (m, L); ``d0`` initial dictionary (m, n); ``gamma0`` initial
    coefficients (n, L); ``sparse_coding(y, d) → Γ``.  The global
    refinement runs on Y with Γ as a frozen rightmost factor; Γ is then
    re-estimated by sparse coding against the current FAµST dictionary.
    """
    from repro_torch.core import projections as P

    t, gamma = d0[None], gamma0
    s_factors: list[torch.Tensor] = []
    lam = torch.ones(1, dtype=y.dtype, device=y.device)
    losses: list[float] = []
    stats = CacheStats()
    id_proj = P.make_proj("id")  # Γ is frozen: its projection is never applied
    kw = dict(alpha=spec.alpha, power_iters=spec.power_iters)
    for ell in range(1, len(spec.factor_projs) + 1):
        init_factors, init_lam = _two_factor_init_batched(t, spec.inner_dims[ell - 1], spec.init)
        two = _run_palm(
            stats, t, init_factors, init_lam,
            (spec.factor_projs[ell - 1], spec.resid_projs[ell - 1]), spec.n_iter_two, **kw,
        )
        s_ell, t = two.factors
        lam = lam * two.lam
        s_factors.append(s_ell)

        projs = (id_proj, *spec.factor_projs[:ell], spec.resid_projs[ell - 1])
        glob = _run_palm(
            stats, y[None], (gamma[None], *s_factors, t), lam, projs, spec.n_iter_global,
            frozen=(True,) + (False,) * (ell + 1), init_feasible=True, **kw,
        )
        s_factors, t, lam = list(glob.factors[1:-1]), glob.factors[-1], glob.lam
        losses.append(float(glob.loss_history[0, -1]))
        dict_now = lam[0] * product([f[0] for f in s_factors] + [t[0]])
        gamma = sparse_coding(y, dict_now)
    faust = Faust(tuple(f[0] for f in s_factors) + (t[0],), lam[0])
    return faust, gamma, HierarchicalInfo(losses, stats)


def meg_style_spec(
    m: int,
    n: int,
    n_factors: int,
    k: int,
    s: int,
    rho: float = 0.8,
    big_p: float | None = None,
    n_iter_two: int = 50,
    n_iter_global: int = 50,
    rightmost_col_sparse: bool = True,
) -> HierarchicalSpec:
    """The paper's MEG setting (§V-A, Fig. 7): S_1 (m × n) with k-sparse
    columns (or k·n entries in all), S_j (m × m) with s entries, the
    residual T_ℓ (m × m) with P·ρ^{ℓ-1} entries (P = 1.4·m² by default)."""
    from repro_torch.core import projections as P

    if big_p is None:
        big_p = 1.4 * m * m
    factor_projs, resid_projs = [], []
    for ell in range(1, n_factors):
        if ell > 1:
            factor_projs.append(P.make_proj("global", k=s))
        elif rightmost_col_sparse:
            factor_projs.append(P.make_proj("col", k=k))
        else:
            factor_projs.append(P.make_proj("global", k=k * n))
        resid_projs.append(P.make_proj("global", k=int(min(big_p * (rho ** (ell - 1)), m * m))))
    return HierarchicalSpec(
        tuple(factor_projs), tuple(resid_projs), (m,) * (n_factors - 1),
        n_iter_two=n_iter_two, n_iter_global=n_iter_global,
    )


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
