"""FaustOp — one operator object over the FAµST representations.
Counterpart of :mod:`repro.api.operator` (leaf operators).

A :class:`FaustOp` wraps a :class:`~repro_torch.core.faust.Faust`,
:class:`~repro_torch.core.compress.BlockFaust` or
:class:`~repro_torch.core.compress.PackedChain`:

* ``op.apply(x)`` computes ``x @ op.todense()`` for ``x (..., shape[0])``
  on the backend ``"dense"``, ``"bsr"`` (per-factor chain), ``"fused"``
  (whole chain in one launch) or ``"auto"`` (cost model,
  :mod:`repro_torch.api.dispatch`);
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
import functools
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
        rep = unpack_chain(self.rep) if isinstance(self.rep, PackedChain) else self.rep
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
    ) -> torch.Tensor:
        """``y = x @ todense()`` for ``x (..., shape[0])`` on ``device``
        (default: the CUDA card).  ``x`` and the operator must already lie
        there.  ``use_kernel=None`` runs the CUDA kernels on a CUDA device
        and the plain versions on the CPU; ``use_kernel=False`` forces the
        plain versions (for comparisons); ``use_kernel=True`` on the CPU
        raises."""
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
        report = _dispatch.dispatch(self, batch_of(x), x.dtype, requested=backend, device=str(dev))
        return self._run_backend(x, report.backend, use_kernel)

    def _run_backend(self, x, backend, use_kernel) -> torch.Tensor:
        from repro_torch.kernels.ops import blockfaust_apply, blockfaust_apply_t, packed_chain_apply

        rep = self.rep
        if backend == "dense":
            return x @ self.todense().to(x.dtype)
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
            return packed_chain_apply(x, self._packed, use_kernel=use_kernel)
        bf = unpack_chain(rep) if isinstance(rep, PackedChain) else rep
        if self.adjoint:
            return blockfaust_apply_t(x, bf)
        return blockfaust_apply(x, bf, use_kernel=use_kernel)

    @functools.cached_property
    def _packed(self) -> PackedChain:
        """The fused layout, packed once per operator."""
        return self.rep if isinstance(self.rep, PackedChain) else pack_chain(self.rep)

    def feasible_backends(self) -> tuple[str, ...]:
        """Backends this operator can run: adjoints and Faust leaves have no
        fused kernel; a BlockFaust needs a packable chain."""
        if isinstance(self.rep, Faust) or self.adjoint:
            return ("dense", "bsr")
        if isinstance(self.rep, PackedChain) or _fusable(self.rep):
            return ("dense", "bsr", "fused")
        return ("dense", "bsr")

    def dispatch_for(self, batch: int, dtype=torch.float32):
        """The decision ``apply(backend="auto")`` would make at ``batch``,
        without applying and without touching ``last_report``."""
        from repro_torch.api import dispatch as _dispatch

        return _dispatch.dispatch(
            self, batch, dtype, requested="auto", device=str(self.device), record=False
        )

    # -- conversions -------------------------------------------------------------
    def _as_faust(self) -> Faust:
        rep = unpack_chain(self.rep) if isinstance(self.rep, PackedChain) else self.rep
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
                return self if isinstance(rep, BlockFaust) else FaustOp(unpack_chain(rep))
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
