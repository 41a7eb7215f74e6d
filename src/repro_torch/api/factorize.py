"""``factorize(A, spec)`` — the front door to the solvers.  Counterpart of
:mod:`repro.api.factorize` (sequential solves).

    op, info = factorize(w, FactorizeSpec(strategy="hierarchical",
                                          n_factors=3, block=128))

Strategies:

``"hierarchical"``  paper Fig. 5.  An explicit ``spec.hier`` wins; else the
                    block-granular §V-A schedule from ``block``/``k_first``/
                    ``k_mid``/``k_resid`` (the deployment route: packed
                    :class:`~repro_torch.core.compress.BlockFaust` chains
                    ready for the kernels).
``"hadamard"``      §IV-C preset (exact reverse-engineering schedule).

The solve runs on ``device`` (default: the CUDA card; raises without one).
Batched stacks, the flat ``palm4msa`` route and the ``meg``/``dictionary``
presets come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.api.operator import FaustOp
from repro_torch.core.compress import (
    BlockFaust,
    _compress_spec,
    _faust_to_blockfaust,
    _pad_to_multiple,
)
from repro_torch.core.faust import Faust
from repro_torch.core.hierarchical import (
    HierarchicalInfo,
    HierarchicalSpec,
    hadamard_spec,
    hierarchical_factorization,
)
from repro_torch.device import resolve_device

STRATEGIES = ("hierarchical", "hadamard")


@dataclasses.dataclass(frozen=True)
class FactorizeSpec:
    """Declarative factorization request; only the chosen route's fields
    are read."""

    strategy: str = "hierarchical"
    n_factors: int = 2
    # block-granular route (deployment chains)
    block: int | None = None
    k_first: int = 4
    k_mid: int = 4
    k_resid: Sequence[int] | None = None
    # explicit schedule (wins over the block route)
    hier: HierarchicalSpec | None = None
    # hadamard preset
    constraints: str = "splincol"
    init: str = "warm"
    # solver
    n_iter_two: int = 40
    n_iter_global: int = 40


@dataclasses.dataclass
class FactorizeInfo:
    """What a ``factorize`` run learned beyond the operator."""

    strategy: str
    ops: list[FaustOp]
    fausts: list[Faust]
    blockfausts: list[BlockFaust] | None = None
    hierarchical: HierarchicalInfo | None = None
    hier_spec: HierarchicalSpec | None = None
    transpose: bool = False  # block route: solved A = Wᵀ (out < in)
    n_sweeps: int = 0


def _as_target(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.to(device)
        return t if t.is_floating_point() and t.dtype != torch.float64 else t.float()
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def factorize(a, spec: FactorizeSpec, *, device=None) -> tuple[FaustOp, FactorizeInfo]:
    """Factorize a 2-D ``a`` (numpy or tensor) into a FAµST operator on
    ``device``."""
    if spec.strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}; got {spec.strategy!r}")
    dev = resolve_device(device)
    a = _as_target(a, dev)
    if a.ndim != 2:
        raise ValueError(f"expected (m, n); got {tuple(a.shape)}")

    if spec.strategy == "hadamard":
        hier = hadamard_spec(
            a.shape[-1], spec.n_iter_two, spec.n_iter_global,
            constraints=spec.constraints, init=spec.init,
        )
    else:
        hier = spec.hier
        if hier is None:
            if spec.block is None:
                raise ValueError(
                    "strategy='hierarchical' needs spec.hier (an explicit "
                    "HierarchicalSpec) or spec.block (the block-granular route)"
                )
            return _route_block(a, spec)
    faust, info = hierarchical_factorization(a, hier)
    op = FaustOp(faust)
    return op, FactorizeInfo(
        spec.strategy, [op], [faust], hierarchical=info, hier_spec=hier, n_sweeps=info.sweeps
    )


def _route_block(w: torch.Tensor, spec: FactorizeSpec) -> tuple[FaustOp, FactorizeInfo]:
    """Dense ``W (in, out)`` → deployment BlockFaust.  ``out < in``
    factorizes A := Wᵀ with per-block-row budgets (chain F_i = S_iᵀ), else
    A := W with per-block-column budgets, so the square residuals sit on
    the small side (the paper's MEG setting)."""
    bk = spec.block
    in_f, out_f = w.shape
    wp = _pad_to_multiple(w, bk, bk)
    transpose = wp.shape[1] < wp.shape[0]
    a = wp.T if transpose else wp
    hier = _compress_spec(
        tuple(a.shape), transpose, spec.n_factors, bk, bk, spec.k_first, spec.k_mid,
        spec.k_resid, spec.n_iter_two, spec.n_iter_global,
    )
    faust, info = hierarchical_factorization(a, hier)
    bfaust = _faust_to_blockfaust(faust, transpose, bk, bk, in_f, out_f)
    op = FaustOp(bfaust)
    return op, FactorizeInfo(
        spec.strategy, [op], [faust], blockfausts=[bfaust], hierarchical=info,
        hier_spec=hier, transpose=transpose, n_sweeps=info.sweeps,
    )
