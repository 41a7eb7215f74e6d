"""FaustOp — one operator object over the FAµST representations.
Counterpart of :mod:`repro.api.operator` (leaf operators).

A :class:`FaustOp` wraps a :class:`~repro_torch.core.faust.Faust`,
:class:`~repro_torch.core.compress.BlockFaust` or
:class:`~repro_torch.core.compress.PackedChain`:

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
* ``op.T`` / ``op.H`` — the adjoint, applied by the scatter form;
* ``op.to("faust" | "block" | "packed")`` — conversions;
* ``op.s_tot`` / ``op.rcg`` — the paper's complexity accounting.

Device rule: ``apply`` runs on ``device`` (default: the CUDA card; raises
without one).  On a CUDA device the structured backends run the CUDA
kernels, on the CPU their plain versions.  A kernel that fails raises.
Composition, stacking and sharding come with later slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.compress import (
    BlockFaust,
    PackedChain,
    _faust_to_blockfaust,
    pack_chain,
    unpack_chain,
)
from repro_torch.core.faust import Faust
from repro_torch.device import resolve_device

_LEAF_REPS = (Faust, BlockFaust, PackedChain)
_FORMATS = ("faust", "block", "packed")
BACKENDS = ("auto", "dense", "bsr", "fused")


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
    """A leaf linear operator over one FAµST representation; ``adjoint``
    flips it to its transpose without touching a factor."""

    rep: Faust | BlockFaust | PackedChain
    adjoint: bool = False

    # -- constructors ------------------------------------------------------
    @classmethod
    def wrap(cls, obj, device=None) -> "FaustOp":
        """Lift a representation (moved to ``device``) or an op into a FaustOp."""
        if isinstance(obj, cls):
            return obj if device is None else cls(obj.rep.to(resolve_device(device)), obj.adjoint)
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

    # -- shapes and accounting ----------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        """``todense().shape``: ``apply`` maps ``(..., shape[0]) → (..., shape[1])``."""
        m, n = _rep_shape(self.rep)
        return (n, m) if self.adjoint else (m, n)

    @property
    def device(self) -> torch.device:
        return self.rep.device

    @property
    def s_tot(self) -> int:
        """Stored nonzeros: stored block values for packed forms, actual
        nonzeros for a Faust."""
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
        if isinstance(self.rep, PackedChain):
            return self.rep.plan.n_factors
        return len(self.rep.factors)

    def inner_dims(self) -> tuple[int, ...]:
        """Intermediate activation widths along the chain."""
        rep = self.rep
        if isinstance(rep, Faust):
            dims = [s.shape[1] for s in rep.factors[1:]]
        elif isinstance(rep, BlockFaust):
            dims = [f.out_features for f in rep.factors[:-1]]
        else:
            dims = list(rep.plan.out_feats[:-1])
        return tuple(reversed(dims)) if self.adjoint else tuple(dims)

    # -- algebra -------------------------------------------------------------
    @property
    def T(self) -> "FaustOp":
        return FaustOp(self.rep, not self.adjoint)

    @property
    def H(self) -> "FaustOp":
        """Conjugate transpose; the port's operators are real, so ``.T``."""
        return self.T

    def todense(self) -> torch.Tensor:
        rep = self._unpacked_for(self._live_grad()) if isinstance(self.rep, PackedChain) else self.rep
        d = rep.todense()
        return d.T if self.adjoint else d

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
        raises.

        ``bt`` is the fused forward kernel's (K1/K4) batch tile; ``None``
        takes the measured table's winner, else ``FORWARD_BT``.  The fused
        backward kernels run at their own tiles (``kernels/ops.py``).  ``autotune=None``
        follows ``REPRO_AUTOTUNE`` (``1``: an ``auto`` apply measures a
        key the table lacks); ``True`` measures, ``False`` does not;
        table hits steer ``auto`` either way unless ``REPRO_AUTOTUNE=off``
        (:mod:`repro_torch.api.autotune`).

        ``grad=None`` detects a training apply: grad mode on and ``x`` or a
        tensor of the operator requiring grad.  Dispatch then prices
        forward and backward together and keys the table by ``grad``; only
        forward keys are measured."""
        from repro_torch.api import autotune as _autotune
        from repro_torch.api import dispatch as _dispatch

        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
        dev = resolve_device(device)
        if x.device != dev or self.device != dev:
            raise ValueError(
                f"apply on {dev}: x is on {x.device} and the operator on {self.device}; "
                "move them with .to() / FaustOp.wrap(..., device=)"
            )
        if use_kernel is None:
            use_kernel = dev.type == "cuda"
        elif use_kernel and dev.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device")
        if x.shape[-1] != self.shape[0]:
            raise ValueError(f"apply expects x (..., {self.shape[0]}); got {tuple(x.shape)}")
        if backend != "auto" and backend not in self.feasible_backends():
            raise ValueError(
                f"backend {backend!r} is not feasible for this operator "
                f"(feasible: {self.feasible_backends()})"
            )
        if grad is None:
            grad = torch.is_grad_enabled() and (x.requires_grad or self._live_grad())
        if autotune is None:
            autotune = _autotune.autotune_mode() == "measure"
        if autotune and backend == "auto" and not grad:
            _autotune.ensure_measured(self, x, batch=batch_of(x), dtype=x.dtype, use_kernel=use_kernel)
        report = _dispatch.dispatch(
            self, batch_of(x), x.dtype, requested=backend, device=str(dev), bt=bt, grad=grad
        )
        return self._run_backend(x, report.backend, use_kernel, report.bt)

    def _tensors(self) -> tuple[torch.Tensor, ...]:
        """Every tensor of the representation (values, scales, λ, indices)."""
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
        """The fused layout of the operator."""
        if isinstance(self.rep, PackedChain):
            return self.rep
        return self._cached("_pack_cache", lambda: pack_chain(self.rep), live)

    def _unpacked_for(self, live: bool) -> BlockFaust:
        """A packed leaf's per-factor form: for a quantized chain the exact
        f32 values, dequantized once per state of the codes and scales."""
        return self._cached("_unpack_cache", lambda: unpack_chain(self.rep), live)

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
        if backend == "dense":
            dense = (self._unpacked_for(live) if isinstance(rep, PackedChain) else rep).todense()
            return x @ (dense.T if self.adjoint else dense).to(x.dtype)
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
        if isinstance(rep, PackedChain) and rep.quantized:
            return rep.values_dtype, rep.scales.numel() * 4
        return None, 0

    def feasible_backends(self) -> tuple[str, ...]:
        """Backends this operator can run: adjoints and Faust leaves have no
        fused kernel; a BlockFaust needs a packable chain."""
        if isinstance(self.rep, Faust) or self.adjoint:
            return ("dense", "bsr")
        if isinstance(self.rep, PackedChain) or _fusable(self.rep):
            return ("dense", "bsr", "fused")
        return ("dense", "bsr")

    def dispatch_for(self, batch: int, dtype=torch.float32, grad: bool = False):
        """The decision ``apply(backend="auto")`` would make at ``batch``
        (``grad``: for a training apply), without applying and without
        touching ``last_report``."""
        from repro_torch.api import dispatch as _dispatch

        return _dispatch.dispatch(
            self, batch, dtype, requested="auto", device=str(self.device), record=False, grad=grad
        )

    # -- conversions -------------------------------------------------------------
    def _as_faust(self) -> Faust:
        rep = self._unpacked if isinstance(self.rep, PackedChain) else self.rep
        if isinstance(rep, BlockFaust):
            # todense = lam·F_1···F_J = lam·S_J···S_1 with S_i = F_{J+1-i}
            rep = Faust(tuple(f.todense() for f in reversed(rep.factors)), rep.lam)
        return rep.T if self.adjoint else rep

    def to(self, fmt: str, block: int | None = None) -> "FaustOp":
        """Convert to ``fmt`` ∈ {"faust", "block", "packed"}, preserving
        ``todense()``; ``block`` is the square block side of the packed
        forms (default: the block of a block-structured operator)."""
        if fmt not in _FORMATS:
            raise ValueError(f"fmt must be one of {_FORMATS}; got {fmt!r}")
        if fmt == "faust":
            return FaustOp(self._as_faust())
        rep = self.rep
        own_block = (
            rep.factors[0].bk if isinstance(rep, BlockFaust)
            else rep.plan.block if isinstance(rep, PackedChain) else None
        )
        if not self.adjoint and own_block is not None and block in (None, own_block):
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

    def __repr__(self) -> str:
        tag = "ᵀ" if self.adjoint else ""
        return f"FaustOp<{type(self.rep).__name__}{tag} {self.shape} on {self.device}>"
