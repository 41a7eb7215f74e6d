"""FaustOp — one operator object over the FAµST representations.
Counterpart of :mod:`repro.api.operator`.

A leaf :class:`FaustOp` wraps a :class:`~repro_torch.core.faust.Faust`,
:class:`~repro_torch.core.compress.BlockFaust` or
:class:`~repro_torch.core.compress.PackedChain`; composites (``"compose"``,
``"block_diag"``, ``"vstack"``, ``"hstack"``) hold children and
materialize nothing until applied:

* ``op.apply(x)`` computes ``x @ op.todense()`` for ``x (..., shape[0])``
  on the backend ``"dense"``, ``"bsr"`` (per-factor chain), ``"fused"``
  (whole chain in one launch) or ``"auto"`` (measured table, else cost
  model: :mod:`repro_torch.api.autotune`, :mod:`repro_torch.api.dispatch`);
* a quantized :class:`PackedChain` runs ``fused`` on its codes (K4) and
  ``dense``/``bsr`` on its exact f32 dequantized values;
* every backend is differentiable: under autograd ``apply`` prices
  forward and backward together (``grad``) and packs or unpacks from the
  live tensors on every call, so gradients reach them and an operator
  held across optimizer steps never applies stale values;
* ``x @ op`` is ``op.apply(x)``; ``op @ x`` is the matrix product
  ``op.todense() @ x`` for ``x (n,)`` or ``(n, b)``; ``op2 @ op1`` composes;
* ``op.T`` / ``op.H`` — the (conjugate) adjoint, pushed down to the
  leaves; an adjoint leaf is applied by the scatter form;
* ``block_diag`` / ``vstack`` / ``hstack`` — stacked operators; a
  composite applies each leaf through that leaf's own dispatch, so a
  fusable leaf runs K1 on the card;
* ``op.with_sharding(ShardSpec(mesh))`` — mesh placement: the batch is
  split over ``"data"``, every factor's out-blocks over ``"model"``, and
  ``apply`` gains the ``"fused_sharded"`` backend
  (:mod:`repro_torch.kernels.chain_sharded`; ``auto`` prices it with the
  plan that would run);
* ``op.to("faust" | "block" | "packed")`` — conversions;
* ``op.s_tot`` / ``op.rcg`` — the paper's complexity accounting.

Device rule: ``apply`` runs on ``device`` (default: the CUDA card; raises
without one; ``x @ op`` and ``op @ x`` run where ``x`` lies).  On a CUDA
device the structured backends run the CUDA kernels, on the CPU their
plain versions.  A kernel that fails raises, under ``auto`` too: the
port has no degraded ladder (the reference demotes a raising ``auto``
apply fused → bsr → dense), so no fallback hides a kernel.  On a mesh
every rank applies the operator to the same ``x`` (SPMD) and gets the
whole result.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.compress import (
    BlockFaust,
    PackedChain,
    _faust_to_blockfaust,
    expand_scales,
    pack_chain,
    unpack_chain,
)
from repro_torch.core.faust import Faust
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import on_card

_LEAF_REPS = (Faust, BlockFaust, PackedChain)
_FORMATS = ("faust", "block", "packed")
BACKENDS = ("auto", "dense", "bsr", "fused", "fused_sharded")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a FaustOp lives on a device mesh: ``data_axis`` splits the
    apply batch, ``model_axis`` every factor's out-blocks (boundary
    all-gathers only where the support crosses ranks; see
    :mod:`repro_torch.kernels.chain_sharded`).  ``mesh`` is a
    :class:`repro_torch.distributed.Mesh`.  Hashable (a mesh hashes by
    identity).  Attach with :meth:`FaustOp.with_sharding`."""

    mesh: object
    data_axis: str = "data"
    model_axis: str = "model"


def _conj_rep(rep):
    """``rep`` with every complex tensor conjugated (real ones as they are)."""
    c = lambda t: t.conj() if t.is_complex() else t  # noqa: E731
    if isinstance(rep, Faust):
        return Faust(tuple(c(s) for s in rep.factors), c(rep.lam))
    if isinstance(rep, BlockFaust):
        return BlockFaust(
            tuple(dataclasses.replace(f, values=c(f.values)) for f in rep.factors), c(rep.lam)
        )
    return dataclasses.replace(rep, values=c(rep.values), lam=c(rep.lam))


def _fusable(bf: BlockFaust) -> bool:
    """Whether :func:`pack_chain` would accept this chain."""
    blk = bf.factors[0].bk
    if any(f.bk != blk or f.bn != blk for f in bf.factors):
        return False
    return all(
        a.out_features == b.in_features and a.n_out_blocks == b.n_in_blocks
        for a, b in zip(bf.factors[:-1], bf.factors[1:])
    )


def _rep_shape(rep) -> tuple[int, int]:
    """Shape of ``rep.todense()``."""
    if isinstance(rep, Faust):
        return rep.shape
    if isinstance(rep, BlockFaust):
        return (rep.in_features, rep.out_features)
    return (rep.plan.in_features, rep.plan.out_features)


def batch_of(x: torch.Tensor) -> int:
    """Row count of a leading-batch input."""
    return math.prod(x.shape[:-1])


@dataclasses.dataclass(frozen=True, eq=False)
class FaustOp:
    """A lazy linear operator.  ``kind`` ``"leaf"`` wraps ``rep``; the
    composites ``"compose"``, ``"block_diag"``, ``"vstack"`` and
    ``"hstack"`` wrap ``children`` (``compose`` in application order:
    ``apply(x)`` folds ``x @ M_1 @ M_2 @ …``).  ``adjoint``/``conj`` live
    on leaves only: ``.T``/``.H`` push them down, touching no factor.
    Build composites with ``@``, :func:`block_diag`, :func:`vstack` and
    :func:`hstack`, which check shapes."""

    rep: Faust | BlockFaust | PackedChain | None
    adjoint: bool = False
    conj: bool = False
    kind: str = "leaf"
    children: tuple["FaustOp", ...] = ()
    shard: ShardSpec | None = None

    # numpy defers ``ndarray @ op`` to :meth:`__rmatmul__`
    __array_ufunc__ = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def wrap(cls, obj, device=None) -> "FaustOp":
        """Lift a representation (moved to ``device``) or a leaf op into a FaustOp."""
        if isinstance(obj, cls):
            if device is None:
                return obj
            if obj.kind != "leaf":
                raise ValueError("FaustOp.wrap(device=) moves a leaf; move a composite's leaves")
            return dataclasses.replace(obj, rep=obj.rep.to(resolve_device(device)))
        if isinstance(obj, _LEAF_REPS):
            return cls(obj.to(resolve_device(device)))
        raise TypeError(
            f"FaustOp.wrap expects Faust | BlockFaust | PackedChain | FaustOp, got {type(obj).__name__}"
        )

    @classmethod
    def from_faust(cls, f: Faust, device=None) -> "FaustOp":
        return cls.wrap(f, device)

    @classmethod
    def from_blockfaust(cls, bf: BlockFaust, device=None) -> "FaustOp":
        return cls.wrap(bf, device)

    @classmethod
    def from_packed(cls, pc: PackedChain, device=None) -> "FaustOp":
        return cls.wrap(pc, device)

    def leaves(self) -> tuple["FaustOp", ...]:
        """The leaf operators, left to right."""
        if self.kind == "leaf":
            return (self,)
        return tuple(leaf for c in self.children for leaf in c.leaves())

    # -- shapes and accounting ----------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        """``todense().shape``: ``apply`` maps ``(..., shape[0]) → (..., shape[1])``."""
        if self.kind == "leaf":
            m, n = _rep_shape(self.rep)
            return (n, m) if self.adjoint else (m, n)
        shapes = [c.shape for c in self.children]
        if self.kind == "compose":
            return (shapes[0][0], shapes[-1][1])
        if self.kind == "block_diag":
            return (sum(s[0] for s in shapes), sum(s[1] for s in shapes))
        if self.kind == "vstack":
            return (sum(s[0] for s in shapes), shapes[0][1])
        return (shapes[0][0], sum(s[1] for s in shapes))  # hstack

    @property
    def device(self) -> torch.device:
        return self.leaves()[0].rep.device

    @property
    def s_tot(self) -> int:
        """Stored nonzeros over every leaf: stored block values for packed
        forms, actual nonzeros for a Faust."""
        if self.kind != "leaf":
            return sum(c.s_tot for c in self.children)
        if isinstance(self.rep, PackedChain):
            return self.rep.values.numel()
        return self.rep.s_tot

    @property
    def rcg(self) -> float:
        """Relative Complexity Gain (Definition II.1): dense nnz / s_tot."""
        m, n = self.shape
        return m * n / self.s_tot

    @property
    def n_factors(self) -> int:
        if self.kind != "leaf":
            return sum(c.n_factors for c in self.children)
        if isinstance(self.rep, PackedChain):
            return self.rep.plan.n_factors
        return len(self.rep.factors)

    def inner_dims(self) -> tuple[int, ...]:
        """Intermediate activation widths along a leaf's chain."""
        rep = self._leaf_rep()
        if isinstance(rep, Faust):
            dims = [s.shape[1] for s in rep.factors[1:]]
        elif isinstance(rep, BlockFaust):
            dims = [f.out_features for f in rep.factors[:-1]]
        else:
            dims = list(rep.plan.out_feats[:-1])
        return tuple(reversed(dims)) if self.adjoint else tuple(dims)

    def _leaf_rep(self):
        if self.kind != "leaf":
            raise ValueError(f"a {self.kind!r} operator has no single representation; ask its leaves")
        return self.rep

    # -- algebra -------------------------------------------------------------
    def _adj(self, conj: bool) -> "FaustOp":
        if self.kind == "leaf":
            return FaustOp(self.rep, not self.adjoint, self.conj ^ conj, shard=self.shard)
        kids = tuple(c._adj(conj) for c in self.children)
        if self.kind == "compose":
            return FaustOp(None, kind="compose", children=tuple(reversed(kids)))
        kind = {"vstack": "hstack", "hstack": "vstack"}.get(self.kind, self.kind)
        return FaustOp(None, kind=kind, children=kids)

    def with_sharding(self, shard: ShardSpec | None) -> "FaustOp":
        """Attach (or clear, with ``None``) a :class:`ShardSpec`, pushed
        down to every leaf so a composite dispatches each leaf on the mesh.
        Moves no tensor: pair it with
        :func:`repro_torch.kernels.chain_sharded.place_blockfaust` or
        ``FactorizeSpec.mesh``."""
        if self.kind == "leaf":
            return dataclasses.replace(self, shard=shard)
        return dataclasses.replace(self, children=tuple(c.with_sharding(shard) for c in self.children))

    @property
    def T(self) -> "FaustOp":
        return self._adj(conj=False)

    @property
    def H(self) -> "FaustOp":
        """Conjugate transpose (``.T`` on real operators)."""
        return self._adj(conj=True)

    def __matmul__(self, other):
        """``op2 @ op1``: lazy composition (``todense`` is their product);
        ``op @ x``: ``todense() @ x`` for ``x (n,)`` or ``(n, b)``, on x's
        device."""
        if isinstance(other, FaustOp):
            if self.shape[1] != other.shape[0]:
                raise ValueError(f"compose shape mismatch: {self.shape} @ {other.shape}")
            kids = self.children if self.kind == "compose" else (self,)
            kids += other.children if other.kind == "compose" else (other,)
            return FaustOp(None, kind="compose", children=kids)
        x = torch.as_tensor(other)
        if x.ndim == 1:
            return self.T.apply(x, device=x.device)
        if x.ndim == 2:
            return self.T.apply(x.T, device=x.device).T
        raise ValueError(
            f"op @ x expects x of shape (n,) or (n, b); got {tuple(x.shape)} "
            "(use op.apply(x) for leading-batch row semantics)"
        )

    def __rmatmul__(self, x):
        """``x @ op``: :meth:`apply` on x's device."""
        x = torch.as_tensor(x)
        return self.apply(x, device=x.device)

    def todense(self) -> torch.Tensor:
        if self.kind == "leaf":
            rep = self.rep
            if isinstance(rep, PackedChain):
                rep = self._unpacked_for(self._live_grad())
            d = (_conj_rep(rep) if self.conj else rep).todense()
            return d.T if self.adjoint else d
        denses = [c.todense() for c in self.children]
        if self.kind == "compose":
            out = denses[0]
            for d in denses[1:]:
                out = out @ d
            return out
        if self.kind == "vstack":
            return torch.cat(denses, dim=0)
        if self.kind == "hstack":
            return torch.cat(denses, dim=1)
        return torch.block_diag(*denses)

    # -- application -----------------------------------------------------------
    def apply(
        self,
        x: torch.Tensor,
        backend: str = "auto",
        *,
        use_kernel: bool | None = None,
        device=None,
        bt: int | None = None,
        autotune: bool | None = None,
        grad: bool | None = None,
    ) -> torch.Tensor:
        """``y = x @ todense()`` for ``x (..., shape[0])`` on ``device``
        (default: the CUDA card).  ``x`` and the operator must already lie
        there.  ``use_kernel=None`` runs the CUDA kernels on a CUDA device
        and the plain versions on the CPU; ``use_kernel=False`` forces the
        plain versions (for comparisons); ``use_kernel=True`` on the CPU
        raises.  A composite applies each leaf through the leaf's own
        dispatch (a forced ``backend`` must suit every leaf).

        ``bt`` is the fused forward kernel's (K1/K4) batch tile; ``None``
        takes the measured table's winner, else ``FORWARD_BT``.  The fused
        backward kernels run at their own tiles (``kernels/ops.py``).
        ``autotune=None`` follows ``REPRO_AUTOTUNE`` (``1``: an ``auto``
        apply measures a key the table lacks); ``True`` measures, ``False``
        does not; table hits steer ``auto`` either way unless
        ``REPRO_AUTOTUNE=off`` (:mod:`repro_torch.api.autotune`).

        ``grad=None`` detects a training apply: grad mode on and ``x`` or a
        tensor of the operator requiring grad.  Dispatch then prices and
        measures forward and backward together, keyed by ``grad``."""
        from repro_torch.api import autotune as _autotune

        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
        dev = resolve_device(device)
        where = {leaf.device for leaf in self.leaves()}
        if x.device != dev or where != {dev}:
            raise ValueError(
                f"apply on {dev}: x is on {x.device} and the operator on {sorted(map(str, where))}; "
                "move them with .to() / FaustOp.wrap(..., device=)"
            )
        if use_kernel is None:
            use_kernel = on_card(x)
        elif use_kernel and not on_card(x):
            raise ValueError("use_kernel=True needs a CUDA device")
        if x.shape[-1] != self.shape[0]:
            raise ValueError(f"apply expects x (..., {self.shape[0]}); got {tuple(x.shape)}")
        if grad is None:
            grad = torch.is_grad_enabled() and (x.requires_grad or self._live_grad())
        if autotune is None:
            autotune = _autotune.autotune_mode() == "measure"
        return self._apply(x, backend, use_kernel, bt, autotune, grad)

    def _apply(self, x, backend, use_kernel, bt, autotune, grad) -> torch.Tensor:
        if self.kind == "leaf":
            return self._leaf_apply(x, backend, use_kernel, bt, autotune, grad)
        args = (backend, use_kernel, bt, autotune, grad)
        if self.kind == "compose":
            for c in self.children:
                x = c._apply(x, *args)
            return x
        if self.kind == "hstack":
            return torch.cat([c._apply(x, *args) for c in self.children], dim=-1)
        parts = torch.split(x, [c.shape[0] for c in self.children], dim=-1)
        ys = [c._apply(p, *args) for c, p in zip(self.children, parts)]
        if self.kind == "vstack":
            return sum(ys[1:], ys[0])
        return torch.cat(ys, dim=-1)  # block_diag

    def _leaf_apply(self, x, backend, use_kernel, bt, autotune, grad) -> torch.Tensor:
        from repro_torch.api import autotune as _autotune
        from repro_torch.api import dispatch as _dispatch

        if backend != "auto" and backend not in self.feasible_backends():
            raise ValueError(
                f"backend {backend!r} is not feasible for this operator "
                f"(feasible: {self.feasible_backends()})"
            )
        # the mesh plan first, so dispatch prices the plan that would run
        # (cached: the apply reads the same); only where the sharded path
        # can be chosen
        summary = None
        if backend in ("auto", "fused_sharded") and "fused_sharded" in self.feasible_backends():
            summary = self._shard_plan().summary()
        if autotune and backend == "auto":
            _autotune.ensure_measured(
                self, x, batch=batch_of(x), dtype=x.dtype, grad=grad, use_kernel=use_kernel,
                mesh_shape=summary["mesh_shape"] if summary else None,
            )
        report = _dispatch.dispatch(
            self, batch_of(x), x.dtype, requested=backend, device=str(x.device), bt=bt, grad=grad,
            shard=summary,
        )
        return self._run_backend(x, report.backend, use_kernel, report.bt)

    def _tensors(self) -> tuple[torch.Tensor, ...]:
        """Every tensor of the leaves' representations (values, scales, λ, indices)."""
        if self.kind != "leaf":
            return tuple(t for c in self.children for t in c._tensors())
        rep = self.rep
        if isinstance(rep, Faust):
            return (*rep.factors, rep.lam)
        if isinstance(rep, BlockFaust):
            return (*(t for f in rep.factors for t in (f.values, f.in_idx)), rep.lam)
        return tuple(t for t in (rep.values, rep.in_idx, rep.scales, rep.lam) if t is not None)

    def _live_grad(self) -> bool:
        """Whether autograd would record an apply: grad mode is on and a
        tensor of the operator requires grad."""
        return torch.is_grad_enabled() and any(t.requires_grad for t in self._tensors())

    def _cached(self, name: str, build, live: bool):
        """``build()`` once per state of the operator's tensors: the cache
        is keyed by their version counters, so an in-place update (an
        optimizer step) rebuilds it.  Under autograd (``live``) it builds
        anew from the live tensors, so the result is in the graph."""
        if live:
            return build()
        stamp = tuple((id(t), t._version) for t in self._tensors())
        hit = self.__dict__.get(name)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, build())
            self.__dict__[name] = hit  # a frozen dataclass still owns its __dict__
        return hit[1]

    def _packed_for(self, live: bool) -> PackedChain:
        """The fused layout of a leaf."""
        rep = self._leaf_rep()
        if isinstance(rep, PackedChain):
            return rep
        return self._cached("_pack_cache", lambda: pack_chain(rep), live)

    def _unpacked_for(self, live: bool) -> BlockFaust:
        """A packed leaf's per-factor form: for a quantized chain the exact
        f32 values, dequantized once per state of the codes and scales."""
        return self._cached("_unpack_cache", lambda: unpack_chain(self._leaf_rep()), live)

    def _shard_view(self, live: bool):
        """The leaf as the sharded apply takes it: a :class:`BlockFaust`
        and, for a quantized chain, its codes with each factor's f32 scale
        rows ``(O_j, K_j, blk)`` beside them (``None`` otherwise)."""
        from repro_torch.kernels.chain_sharded import split_scales

        def build():
            rep = self.rep
            if isinstance(rep, BlockFaust):
                view = rep, None
            elif rep.quantized:
                bf = unpack_chain(rep, dequantize=False)
                view = bf, split_scales(expand_scales(rep.scales, rep.plan.block), bf)
            else:
                view = unpack_chain(rep), None
            return (_conj_rep(view[0]), view[1]) if self.conj else view

        return self._cached("_shard_view_cache", build, live)

    def _shard_plan(self):
        """The :class:`~repro_torch.kernels.chain_sharded.ShardPlan` of this
        leaf on its mesh."""
        from repro_torch.kernels.chain_sharded import plan_shard

        bf, _ = self._shard_view(self._live_grad())
        return plan_shard(bf, self.shard.mesh, self.shard.data_axis, self.shard.model_axis)

    @property
    def _packed(self) -> PackedChain:
        return self._packed_for(self._live_grad())

    @property
    def _unpacked(self) -> BlockFaust:
        return self._unpacked_for(self._live_grad())

    def _run_backend(self, x, backend, use_kernel, bt) -> torch.Tensor:
        from repro_torch.kernels.ops import blockfaust_apply, blockfaust_apply_t, packed_chain_apply

        rep = self.rep
        live = self._live_grad()
        if backend == "fused_sharded":
            from repro_torch.kernels.chain_sharded import sharded_chain_apply

            bf, scales = self._shard_view(live)
            sh = self.shard
            return sharded_chain_apply(x, bf, sh.mesh, sh.data_axis, sh.model_axis, plan=self._shard_plan(),
                                       use_kernel=use_kernel, bt=bt, scales=scales)
        if backend == "dense":
            return x @ self.todense().to(x.dtype)
        if self.conj:
            rep = _conj_rep(rep)
        if isinstance(rep, Faust):  # "bsr" = the per-factor chain
            y = x
            if self.adjoint:  # x @ Aᵀ = x @ S_1ᵀ @ … @ S_Jᵀ
                for s in rep.factors:
                    y = y @ s.T.to(x.dtype)
            else:  # x @ A = x @ S_J @ … @ S_1
                for s in reversed(rep.factors):
                    y = y @ s.to(x.dtype)
            return rep.lam.to(y.dtype) * y
        if backend == "fused":
            return packed_chain_apply(x, self._packed_for(live), use_kernel=use_kernel, bt=bt)
        bf = self._unpacked_for(live) if isinstance(rep, PackedChain) else rep
        if self.adjoint:
            return blockfaust_apply_t(x, bf)
        return blockfaust_apply(x, bf, use_kernel=use_kernel)

    def quant_info(self) -> tuple[str | None, int]:
        """``(values_dtype, scales_bytes)`` of a quantized packed leaf for
        the dispatch byte model; ``(None, 0)`` otherwise."""
        rep = self.rep
        if self.kind == "leaf" and isinstance(rep, PackedChain) and rep.quantized:
            return rep.values_dtype, rep.scales.numel() * 4
        return None, 0

    def bsr_gather(self) -> int:
        """Input elements per batch row that the bsr backward gathers,
        ``Σ_j s_j / bn_j`` over block-sparse factors (the dispatch model's
        bsr backward intermediates); 0 for a chain of dense factors."""
        rep = self._leaf_rep()
        if isinstance(rep, PackedChain):
            return self.s_tot // rep.plan.block
        if isinstance(rep, BlockFaust):
            return sum(f.values[..., 0].numel() for f in rep.factors)
        return 0

    def feasible_backends(self) -> tuple[str, ...]:
        """Backends this leaf can run: adjoints and Faust leaves have no
        fused kernel; a BlockFaust needs a packable chain for ``fused``;
        ``fused_sharded`` needs a :class:`ShardSpec` (any chain: one that
        does not pack runs replicated, per factor)."""
        rep = self._leaf_rep()
        if isinstance(rep, Faust) or self.adjoint:
            return ("dense", "bsr")
        sharded = ("fused_sharded",) if self.shard is not None else ()
        if isinstance(rep, PackedChain) or _fusable(rep):
            return ("dense", "bsr", "fused") + sharded
        return ("dense", "bsr") + sharded

    def dispatch_for(self, batch: int, dtype=torch.float32, grad: bool = False):
        """The decision ``apply(backend="auto")`` would make at ``batch``
        (``grad``: for a training apply), without applying and without
        touching ``last_report``; a composite answers its last leaf's."""
        from repro_torch.api import dispatch as _dispatch

        if self.kind != "leaf":
            return self.leaves()[-1].dispatch_for(batch, dtype, grad)
        plan = self._shard_plan() if "fused_sharded" in self.feasible_backends() else None
        return _dispatch.dispatch(
            self, batch, dtype, requested="auto", device=str(self.device), record=False, grad=grad,
            shard=plan.summary() if plan is not None else None,
        )

    # -- conversions -------------------------------------------------------------
    def _as_faust(self) -> Faust:
        """One optimization-side chain: a leaf, or a composition of leaves
        (stacked operators have none)."""
        if self.kind == "compose":
            fausts = [c._as_faust() for c in self.children]
            # x @ M_1 @ … @ M_k: the first-applied factor is M_k's first
            factors = [s for f in reversed(fausts) for s in f.factors]
            lam = fausts[0].lam
            for f in fausts[1:]:
                lam = lam * f.lam
            return Faust(tuple(factors), lam)
        if self.kind != "leaf":
            raise ValueError(
                f"cannot collapse a {self.kind!r} operator into one chain; convert its children"
            )
        rep = self._unpacked if isinstance(self.rep, PackedChain) else self.rep
        if isinstance(rep, BlockFaust):
            # todense = lam·F_1···F_J = lam·S_J···S_1 with S_i = F_{J+1-i}
            rep = Faust(tuple(f.todense() for f in reversed(rep.factors)), rep.lam)
        if self.conj:
            rep = _conj_rep(rep)
        return rep.T if self.adjoint else rep

    def _own_block(self) -> int | None:
        for leaf in self.leaves():
            if isinstance(leaf.rep, BlockFaust):
                return leaf.rep.factors[0].bk
            if isinstance(leaf.rep, PackedChain):
                return leaf.rep.plan.block
        return None

    def to(self, fmt: str, block: int | None = None) -> "FaustOp":
        """Convert to ``fmt`` ∈ {"faust", "block", "packed"}, preserving
        ``todense()``; ``block`` is the square block side of the packed
        forms (default: the block of a block-structured leaf)."""
        if fmt not in _FORMATS:
            raise ValueError(f"fmt must be one of {_FORMATS}; got {fmt!r}")
        if fmt == "faust":
            return FaustOp(self._as_faust())
        own_block = self._own_block()
        rep = self.rep
        if self.kind == "leaf" and not self.adjoint and not self.conj and own_block is not None \
                and block in (None, own_block):
            if fmt == "block":
                return self if isinstance(rep, BlockFaust) else FaustOp(self._unpacked)
            if isinstance(rep, PackedChain):
                return self
            if _fusable(rep):
                return FaustOp(pack_chain(rep))
        blk = block if block is not None else own_block
        if blk is None:
            raise ValueError("to('block'/'packed') from a dense-factor chain needs block=")
        faust = self._as_faust()
        m, n = faust.shape
        bf = _faust_to_blockfaust(faust, False, blk, blk, m, n)
        return FaustOp(bf if fmt == "block" else pack_chain(bf))

    def rel_error_fro(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(a - self.todense()) / torch.linalg.norm(a)

    def rel_error_spec(self, a: torch.Tensor) -> torch.Tensor:
        """Relative operator-norm error (paper eq. (6))."""
        from repro_torch.core.lipschitz import spectral_norm

        return spectral_norm(a - self.todense()) / (spectral_norm(a) + 1e-30)

    def __repr__(self) -> str:
        if self.kind != "leaf":
            return f"FaustOp<{self.kind}({len(self.children)}) {self.shape} on {self.device}>"
        tag = ("ᵀ" if self.adjoint else "") + ("*" if self.conj else "")
        return f"FaustOp<{type(self.rep).__name__}{tag} {self.shape} on {self.device}>"


def _wrap_all(ops: Sequence) -> tuple[FaustOp, ...]:
    if not ops:
        raise ValueError("need at least one operator")
    return tuple(FaustOp.wrap(o) for o in ops)


def block_diag(ops: Sequence) -> FaustOp:
    """``diag(M_1, …, M_k)``: ``apply`` splits the input's features per
    child and concatenates the outputs."""
    return FaustOp(None, kind="block_diag", children=_wrap_all(ops))


def vstack(ops: Sequence) -> FaustOp:
    """``[M_1; …; M_k]`` (rows stacked; equal output dims): ``apply``
    splits the input and sums the children's outputs."""
    kids = _wrap_all(ops)
    outs = {c.shape[1] for c in kids}
    if len(outs) > 1:
        raise ValueError(f"vstack needs equal output dims; got {outs}")
    return FaustOp(None, kind="vstack", children=kids)


def hstack(ops: Sequence) -> FaustOp:
    """``[M_1 … M_k]`` (columns stacked; equal input dims): ``apply`` feeds
    every child the input and concatenates the outputs."""
    kids = _wrap_all(ops)
    ins = {c.shape[0] for c in kids}
    if len(ins) > 1:
        raise ValueError(f"hstack needs equal input dims; got {ins}")
    return FaustOp(None, kind="hstack", children=kids)
