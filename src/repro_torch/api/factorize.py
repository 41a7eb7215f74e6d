"""``factorize(A, spec)`` — the front door to the solvers.  Counterpart of
:mod:`repro.api.factorize`.

    op, info = factorize(w, FactorizeSpec(strategy="hierarchical",
                                          n_factors=3, block=128))

``op`` is a :class:`~repro_torch.api.operator.FaustOp` with
``op.todense() ≈ a``; for a 3-D stack ``(B, m, n)`` it is the
``block_diag`` of the per-matrix operators, which ``info.ops`` lists.

Strategies:

``"hierarchical"``  paper Fig. 5.  An explicit ``spec.hier`` wins; else the
                    block-granular §V-A schedule from ``block``/``k_first``/
                    ``k_mid``/``k_resid`` (the deployment route: packed
                    :class:`~repro_torch.core.compress.BlockFaust` chains
                    ready for the kernels).
``"palm4msa"``      one flat PALM solve (Fig. 4): needs ``spec.projs`` and
                    ``spec.dims``.
``"hadamard"``      §IV-C preset (exact reverse-engineering schedule).
``"meg"``           §V-A preset (the MEG schedule, ``k``/``s``/``rho``).
``"dictionary"``    Fig. 11: ``a`` is the initial dictionary; needs
                    ``spec.hier``, ``dict_y``, ``dict_gamma0`` and
                    ``dict_sparse_coding``; the learned codes land in
                    ``info.gamma``.

A 3-D input takes the batched route: every solve runs once for the whole
stack.  ``spec.batched`` only validates (``True`` asserts a stack;
``False`` on a stack is refused).  The solve runs on ``device`` (default:
the CUDA card; raises without one).

``spec.mesh`` (a :class:`repro_torch.distributed.Mesh`; every rank calls
``factorize`` with the same target and spec): global rank 0 solves, its
result is broadcast, and every rank's operators come out placed
(:func:`repro_torch.kernels.chain_sharded.place_blockfaust`) and carrying
their :class:`~repro_torch.api.operator.ShardSpec`, so ``apply("auto")``
prices and runs ``fused_sharded`` at once.  Every rank holds rank 0's
chain bit for bit, as the reference's one global computation gives one
chain: solves on several ranks need not repeat each other's
floating-point order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.api.operator import FaustOp, ShardSpec, block_diag
from repro_torch.core.compress import (
    BlockFaust,
    _compress_spec,
    _faust_to_blockfaust,
)
from repro_torch.core.faust import Faust, default_init
from repro_torch.core.hierarchical import (
    HierarchicalInfo,
    HierarchicalSpec,
    hadamard_spec,
    hierarchical_dictionary,
    hierarchical_factorization,
    hierarchical_factorization_batched,
    meg_style_spec,
)
from repro_torch.core.palm4msa import palm4msa, palm4msa_batched
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import Mesh, broadcast

STRATEGIES = ("hierarchical", "palm4msa", "hadamard", "meg", "dictionary")


def _shard_of(spec: "FactorizeSpec") -> ShardSpec | None:
    if spec.mesh is None:
        return None
    return ShardSpec(spec.mesh, spec.data_axis, spec.model_axis)


@dataclasses.dataclass(frozen=True)
class FactorizeSpec:
    """Declarative factorization request; only the chosen route's fields
    are read.  ``n_iter`` is the flat ``palm4msa`` route's sweep count and
    ``keep_best`` its acceptance rule."""

    strategy: str = "hierarchical"
    n_factors: int = 2
    # block-granular route (deployment chains)
    block: int | None = None
    k_first: int = 4
    k_mid: int = 4
    k_resid: Sequence[int] | None = None
    # explicit schedules (win over the block route)
    hier: HierarchicalSpec | None = None
    projs: tuple | None = None  # palm4msa route: one projection per factor
    dims: tuple[int, ...] | None = None  # palm4msa route: (a_1, …, a_{J+1})
    # presets
    k: int = 8  # meg: per-column sparsity of S_1
    s: int | None = None  # meg: entries of each middle factor (default 4m)
    rho: float = 0.8  # meg: residual decay
    constraints: str = "splincol"  # hadamard: "splincol" | "global"
    init: str = "warm"
    # solver
    n_iter: int = 40
    n_iter_two: int = 40
    n_iter_global: int = 40
    keep_best: bool = True
    batched: bool | None = None  # None: by a.ndim
    # mesh placement: operators come out placed on every rank of the mesh
    # (repro_torch.distributed.Mesh) and carry a ShardSpec
    mesh: Any = None
    data_axis: str = "data"
    model_axis: str = "model"
    # dictionary route
    dict_y: Any = None
    dict_gamma0: Any = None
    dict_sparse_coding: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None


@dataclasses.dataclass(frozen=True)
class TargetPrep:
    """How the target was prepared before the solve: the block route pads
    W's (in, out) axes to the block grid and may transpose it; the other
    routes use it as given.  A re-solve against a new target with the same
    spec applies the same prep."""

    transpose: bool = False
    pad_in: int = 0
    pad_out: int = 0

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        if self.pad_in or self.pad_out:
            w = torch.nn.functional.pad(w, (0, self.pad_out, 0, self.pad_in))
        return w.mT if self.transpose else w


@dataclasses.dataclass
class FactorizeInfo:
    """What a ``factorize`` run learned beyond the operator."""

    strategy: str
    batched: bool
    ops: list[FaustOp]  # one per matrix
    fausts: list[Faust]
    blockfausts: list[BlockFaust] | None = None  # block route
    hierarchical: HierarchicalInfo | None = None
    loss_history: torch.Tensor | None = None  # palm4msa route
    gamma: torch.Tensor | None = None  # dictionary route
    hier_spec: HierarchicalSpec | None = None
    prep: TargetPrep = TargetPrep()
    n_sweeps: int = 0

    @property
    def transpose(self) -> bool:
        """Block route: whether A = Wᵀ was solved (out < in)."""
        return self.prep.transpose


def _finish(strategy, batched, fausts, *, blockfausts=None, hierarchical=None, loss_history=None,
            gamma=None, hier_spec=None, prep=None, n_sweeps=None, shard=None) -> tuple[FaustOp, FactorizeInfo]:
    if shard is not None:  # every rank holds rank 0's chain, on its device
        from repro_torch.kernels.chain_sharded import place_blockfaust

        fausts = [_placed_faust(f, shard.mesh) for f in fausts]
        if blockfausts is not None:
            blockfausts = [place_blockfaust(bf, shard.mesh, shard.model_axis) for bf in blockfausts]
    ops = [FaustOp(r, shard=shard) for r in (blockfausts if blockfausts is not None else fausts)]
    if n_sweeps is None:
        n_sweeps = hierarchical.n_sweeps if hierarchical is not None else 0
    info = FactorizeInfo(
        strategy, batched, ops, fausts, blockfausts=blockfausts, hierarchical=hierarchical,
        loss_history=loss_history, gamma=gamma, hier_spec=hier_spec,
        prep=prep if prep is not None else TargetPrep(), n_sweeps=n_sweeps,
    )
    return (ops[0] if len(ops) == 1 else block_diag(ops)), info


def _placed_faust(f: Faust, mesh) -> Faust:
    """``f`` with rank 0's bits on every rank of ``mesh``, on its device."""
    if not isinstance(mesh, Mesh):
        return f
    put = lambda t: broadcast(t.detach().to(mesh.device), 0)  # noqa: E731
    return Faust(tuple(put(s) for s in f.factors), put(f.lam))


def _moved(obj, device):
    """``obj`` with every tensor in it (through dataclasses, lists, tuples
    and dicts) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_moved(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    return obj


def _on_mesh(a, spec: "FactorizeSpec", dev: torch.device) -> tuple[FaustOp, FactorizeInfo]:
    """``factorize`` on a mesh: rank 0 solves and broadcasts its result,
    which every rank moves to its device and shards (module docstring)."""
    import torch.distributed as dist

    payload = [None]
    if dist.get_rank() == 0:
        _, info = factorize(a, dataclasses.replace(spec, mesh=None), device=dev)
        payload = [_moved(dataclasses.replace(info, ops=[]), "cpu")]
    dist.broadcast_object_list(payload, src=0, device=spec.mesh.device if spec.mesh.backend == "nccl" else None)
    info = _moved(payload[0], dev)  # rank 0's bits on every rank: placed
    shard = _shard_of(spec)
    info.ops = [FaustOp(r, shard=shard) for r in (info.blockfausts if info.blockfausts is not None else info.fausts)]
    return (info.ops[0] if len(info.ops) == 1 else block_diag(info.ops)), info


def _as_target(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.to(device)
        return t if t.is_floating_point() and t.dtype != torch.float64 else t.float()
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def factorize(a, spec: FactorizeSpec, *, device=None) -> tuple[FaustOp, FactorizeInfo]:
    """Factorize ``a`` (numpy or tensor; 2-D, or a 3-D stack) into a FAµST
    operator on ``device``."""
    if spec.strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}; got {spec.strategy!r}")
    dev = resolve_device(device)
    if isinstance(spec.mesh, Mesh):
        return _on_mesh(a, spec, dev)
    a = _as_target(a, dev)
    if a.ndim not in (2, 3):
        raise ValueError(f"expected (m, n) or (B, m, n); got {tuple(a.shape)}")
    batched = a.ndim == 3 if spec.batched is None else spec.batched
    if batched and a.ndim != 3:
        raise ValueError(f"batched=True expects (B, m, n); got {tuple(a.shape)}")
    if not batched and a.ndim == 3:
        raise ValueError(
            "batched=False cannot solve a 3-D stack in one call; loop factorize over the "
            f"matrices instead (or drop batched=False: a {tuple(a.shape)} stack batches by itself)"
        )

    if spec.strategy == "palm4msa":
        return _route_palm(a, spec, batched)
    if spec.strategy == "dictionary":
        if batched:
            raise ValueError(
                f"strategy='dictionary' takes one 2-D initial dictionary; got {tuple(a.shape)} "
                "(the dictionary route has no batched solver)"
            )
        return _route_dictionary(a, spec)
    if spec.strategy == "hadamard":
        hier = hadamard_spec(
            a.shape[-1], spec.n_iter_two, spec.n_iter_global,
            constraints=spec.constraints, init=spec.init,
        )
    elif spec.strategy == "meg":
        m, n = a.shape[-2:]
        hier = meg_style_spec(
            m, n, spec.n_factors, spec.k, spec.s if spec.s is not None else 4 * m,
            rho=spec.rho, n_iter_two=spec.n_iter_two, n_iter_global=spec.n_iter_global,
        )
    else:
        hier = spec.hier
        if hier is None:
            if spec.block is None:
                raise ValueError(
                    "strategy='hierarchical' needs spec.hier (an explicit "
                    "HierarchicalSpec) or spec.block (the block-granular route)"
                )
            return _route_block(a, spec, batched)
    if batched:
        fausts, info = hierarchical_factorization_batched(a, hier)
    else:
        faust, info = hierarchical_factorization(a, hier)
        fausts = [faust]
    return _finish(spec.strategy, batched, fausts, hierarchical=info, hier_spec=hier, shard=_shard_of(spec))


def _block_target(ws: torch.Tensor, n_factors: int, bk: int, bn: int, k_first: int, k_mid: int,
                  k_resid: Sequence[int] | None, n_iter_two: int, n_iter_global: int):
    """The block route's target and schedule for a stack ``ws (B, in, out)``:
    pad to the block grid; ``out < in`` factorizes A := Wᵀ with per-block-row
    budgets (chain F_i = S_iᵀ), else A := W with per-block-column budgets, so
    the square residuals sit on the small side (the paper's MEG setting).
    Returns (A, spec, prep)."""
    if bk != bn:
        raise ValueError("the block route needs square blocks")
    in_f, out_f = ws.shape[1:]
    prep = TargetPrep(False, (-in_f) % bk, (-out_f) % bn)
    wp = prep.apply(ws)
    prep = dataclasses.replace(prep, transpose=wp.shape[2] < wp.shape[1])
    a = wp.mT if prep.transpose else wp
    hier = _compress_spec(
        tuple(a.shape[1:]), prep.transpose, n_factors, bk, bn, k_first, k_mid, k_resid,
        n_iter_two, n_iter_global,
    )
    return a, hier, prep


def _factorize_block_batched(ws: torch.Tensor, n_factors: int, bk: int, bn: int, k_first: int,
                             k_mid: int, k_resid: Sequence[int] | None = None, n_iter_two: int = 40,
                             n_iter_global: int = 40):
    """The block route over a stack ``ws (B, in, out)``: every (split,
    refine) step is one solve for the whole stack.  Returns (BlockFausts,
    Fausts, info, spec, prep)."""
    a, hier, prep = _block_target(ws, n_factors, bk, bn, k_first, k_mid, k_resid, n_iter_two,
                                  n_iter_global)
    fausts, info = hierarchical_factorization_batched(a, hier)
    in_f, out_f = ws.shape[1:]
    bfausts = [_faust_to_blockfaust(f, prep.transpose, bk, bn, in_f, out_f) for f in fausts]
    return bfausts, fausts, info, hier, prep


def _route_block(a: torch.Tensor, spec: FactorizeSpec, batched: bool):
    kw = dict(n_factors=spec.n_factors, bk=spec.block, bn=spec.block, k_first=spec.k_first,
              k_mid=spec.k_mid, k_resid=spec.k_resid, n_iter_two=spec.n_iter_two,
              n_iter_global=spec.n_iter_global)
    if batched:
        bfs, fausts, info, hier, prep = _factorize_block_batched(a, **kw)
    else:
        target, hier, prep = _block_target(a[None], **kw)
        faust, info = hierarchical_factorization(target[0], hier)
        fausts = [faust]
        bfs = [_faust_to_blockfaust(faust, prep.transpose, spec.block, spec.block, *a.shape)]
    return _finish(spec.strategy, batched, fausts, blockfausts=bfs, hierarchical=info,
                   hier_spec=hier, prep=prep, shard=_shard_of(spec))


def _route_palm(a: torch.Tensor, spec: FactorizeSpec, batched: bool):
    if spec.projs is None or spec.dims is None:
        raise ValueError("strategy='palm4msa' needs spec.projs and spec.dims")
    factors, lam = default_init(spec.dims, dtype=a.dtype, device=a.device)
    if batched:
        b = a.shape[0]
        res = palm4msa_batched(
            a, tuple(f.expand((b,) + tuple(f.shape)) for f in factors), lam, spec.projs,
            spec.n_iter, keep_best=spec.keep_best,
        )
        fausts = [Faust(tuple(f[i] for f in res.factors), res.lam[i]) for i in range(b)]
    else:
        res = palm4msa(a, factors, lam, spec.projs, spec.n_iter, keep_best=spec.keep_best)
        fausts = [Faust(res.factors, res.lam)]
    return _finish(spec.strategy, batched, fausts, loss_history=res.loss_history, n_sweeps=spec.n_iter,
                   shard=_shard_of(spec))


def _route_dictionary(a: torch.Tensor, spec: FactorizeSpec):
    if spec.hier is None or spec.dict_y is None or spec.dict_gamma0 is None or spec.dict_sparse_coding is None:
        raise ValueError(
            "strategy='dictionary' needs spec.hier, dict_y, dict_gamma0 and dict_sparse_coding"
        )
    y = _as_target(spec.dict_y, a.device)
    gamma0 = _as_target(spec.dict_gamma0, a.device)
    faust, gamma, info = hierarchical_dictionary(y, a, gamma0, spec.hier, spec.dict_sparse_coding)
    return _finish(spec.strategy, False, [faust], hierarchical=info, gamma=gamma, hier_spec=spec.hier,
                   shard=_shard_of(spec))
