"""Operator hot-swap for the serving runtime.  Counterpart of
:mod:`repro.streaming.swap`.

A serving process applies a FAµST unembedding chain in every step
(:class:`repro_torch.runtime.engine.LMExecutor`).  The streaming tracker
(:mod:`repro_torch.streaming.online`) periodically produces a refreshed
chain for the same projection; :func:`hot_swap` publishes it into a live
:class:`~repro_torch.runtime.engine.Engine`, ``Server`` or executor
*between* decode steps, without breaking in-flight requests:

* **values-only swap** — the refreshed chain keeps the old support (same
  shapes, same ``in_idx``, so the same ``ChainPlan``): measured autotune
  entries stay valid (a key holds no values) and requests decoded after
  the swap see the new values from their next step on;
* **staged re-pack** — the support moved.  The next apply packs the new
  support (every apply builds its operator from the live tensors), and
  the measured entries of the *old* signature are dropped with
  :func:`repro_torch.api.autotune.invalidate`: when the swap keeps
  ``s_tot`` the key would not move by itself.

The engine is host-driven (``Engine.step()``), so a call between steps is
atomic: no step sees a half-published chain.

**Guarded swaps.**  ``hot_swap`` / ``quantized_swap`` take a sketched
relative-error guard (:func:`sketched_swap_err`: ``‖X·new − X·old‖ /
‖X·old‖`` over Gaussian probe rows, O(s_tot·probes), never dense): a
candidate whose RE against the incumbent exceeds the threshold, or is not
finite, is **rejected before publication** — the incumbent keeps serving,
the report says why (``accepted=False``, ``rel_err``, ``reject_reason``)
and ``EngineStats.swap_rejects`` counts it.  The guard is off by default
(``guard=None`` with ``REPRO_SWAP_GUARD`` unset): ``REPRO_SWAP_GUARD=1``
enables the default 0.5, a float sets its own, and an explicit ``guard=``
always wins.  The probes come from a ``torch.Generator`` seeded with
``seed``, so they are not the reference's numbers: the sketch agrees with
the reference's within its spread, and the decisions agree where the
margin is clear.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.compress import BlockFaust, PackedChain, pack_chain, quantize_chain

VALUES_ONLY, REPACK = "values_only", "repack"


@dataclasses.dataclass(frozen=True)
class SwapReport:
    """What one :func:`hot_swap` / :func:`quantized_swap` publication did."""

    kind: str  # "values_only" | "repack"
    s_tot_before: int
    s_tot_after: int
    retrace: bool  # does the next step run a new layout (values shapes changed)?
    invalidated: int  # autotune entries explicitly dropped (repack only)
    # Quantized swaps only:
    requantized: bool = False  # new values re-quantized to the old layout
    # A values-only f32 swap is token-exact for post-swap requests by
    # construction; a quantized one only when requantization reproduced
    # the serving chain's scales bit for bit.
    token_exact: bool = True
    # Guard outcome: accepted=False means the candidate was never
    # published.  rel_err is the sketched RE vs the incumbent whenever the
    # guard ran; None when it was off.
    accepted: bool = True
    rel_err: float | None = None
    reject_reason: str | None = None


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.detach().cpu(), b.detach().cpu()))


def classify_swap(old: BlockFaust, new: BlockFaust) -> str:
    """``"values_only"`` when the refreshed chain keeps the old support
    (same shapes, same ``in_idx``: the same ``ChainPlan``), else
    ``"repack"``.  Raises when the chains cannot stand behind one serving
    config (chain length and feature dims are fixed by its ``FaustSpec``)."""
    if len(old.factors) != len(new.factors):
        raise ValueError(
            f"hot-swap cannot change chain length ({len(old.factors)} → "
            f"{len(new.factors)}): the serving FaustSpec is static config"
        )
    if (old.in_features, old.out_features) != (new.in_features, new.out_features):
        raise ValueError(
            "hot-swap cannot change operator shape: "
            f"{(old.in_features, old.out_features)} → {(new.in_features, new.out_features)}"
        )
    for fo, fn in zip(old.factors, new.factors):
        if (fo.in_features, fo.out_features) != (fn.in_features, fn.out_features):
            raise ValueError(
                "hot-swap cannot change per-factor feature dims "
                f"({(fo.in_features, fo.out_features)} → {(fn.in_features, fn.out_features)})"
            )
        if fo.in_idx.shape != fn.in_idx.shape or fo.values.shape != fn.values.shape:
            return REPACK  # different k: support (and s_tot) changed
        if not _same(fo.in_idx, fn.in_idx):
            return REPACK  # same budget, moved support
    return VALUES_ONLY


def _guard_threshold(guard) -> float | None:
    """The acceptance threshold: an explicit ``guard`` number wins;
    ``None`` defers to ``REPRO_SWAP_GUARD`` (unset/``0``/``off`` → guard
    disabled, ``1``/``on`` → the default 0.5, a float → itself); ``False``
    disables outright."""
    if guard is False:
        return None
    if guard is not None:
        return float(guard)
    v = os.environ.get("REPRO_SWAP_GUARD", "").strip().lower()
    if v in ("", "0", "off", "false", "no"):
        return None
    if v in ("1", "on", "true", "yes"):
        return 0.5
    return float(v)


def _probe_op(chain):
    """A FaustOp over either deployment representation (a quantized chain
    applies its exact dequantized values on ``bsr``)."""
    from repro_torch.api.operator import FaustOp

    return FaustOp(chain)  # where the chain lies


def sketched_swap_err(old, new, *, n_probes: int = 8, seed: int = 0) -> float:
    """Sketched relative error of a candidate chain vs the incumbent:
    ``‖X·new − X·old‖_F / ‖X·old‖_F`` over ``n_probes`` Gaussian probe
    rows (f32, from a ``torch.Generator`` seeded with ``seed``) applied on
    ``bsr`` on the incumbent's device.  NaN/Inf anywhere in the
    candidate's image gives a non-finite RE, which the guard rejects."""
    op_old, op_new = _probe_op(old), _probe_op(new)
    dev = op_old.device
    x = torch.randn((n_probes, op_old.shape[0]), generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        y_old = op_old.apply(x, backend="bsr", device=dev)
        y_new = op_new.apply(x, backend="bsr", device=dev)
        denom = torch.clamp(torch.linalg.norm(y_old), min=1e-12)
        return float(torch.linalg.norm(y_new - y_old) / denom)


def _guard_check(old, candidate, guard, n_probes, seed):
    """``(rel_err, reject_reason)``; the reason is None when the swap may
    publish.  ``guard`` is the resolved threshold (None: guard off)."""
    if guard is None:
        return None, None
    rel_err = sketched_swap_err(old, candidate, n_probes=n_probes, seed=seed)
    if not np.isfinite(rel_err):
        return rel_err, "non-finite candidate (NaN/Inf in probe image)"
    if rel_err > guard:
        return rel_err, f"sketched RE {rel_err:.4g} vs incumbent exceeds guard threshold {guard:.4g}"
    return rel_err, None


def _count_reject(target) -> None:
    stats = getattr(target, "stats", None)
    if stats is not None and hasattr(stats, "swap_rejects"):
        stats.swap_rejects += 1


def _executor_of(target):
    """Accept an Engine, a Server, or a bare executor."""
    ex = getattr(target, "executor", None)  # Engine
    if ex is not None:
        return ex
    if hasattr(target, "swap_unembed"):  # LMExecutor / Server
        return target
    raise TypeError(f"cannot hot-swap into {type(target).__name__}")


def hot_swap(target, new: BlockFaust, *, guard: float | bool | None = None, n_probes: int = 8,
             seed: int = 0) -> SwapReport:
    """Publish ``new`` as the serving unembedding chain of ``target`` (an
    :class:`~repro_torch.runtime.engine.Engine`,
    :class:`~repro_torch.runtime.server.Server` or
    :class:`~repro_torch.runtime.engine.LMExecutor`), between engine steps
    or ``generate()`` calls.  Bumps ``EngineStats.swaps`` when the target
    is an engine.

    ``guard`` arms the sketched acceptance check (module docstring): a
    rejected candidate is never published, ``EngineStats.swap_rejects`` is
    bumped and the report carries ``accepted=False`` and the reason."""
    from repro_torch.api import autotune
    from repro_torch.api.operator import FaustOp

    ex = _executor_of(target)
    old = ex.unembed_blockfaust()
    if old is None:
        raise ValueError("target serves no FAµST unembedding chain")
    kind = classify_swap(old, new)
    rel_err, reject = _guard_check(old, new, _guard_threshold(guard), n_probes, seed)
    if reject is not None:
        _count_reject(target)
        return SwapReport(kind=kind, s_tot_before=int(old.s_tot), s_tot_after=int(new.s_tot), retrace=False,
                          invalidated=0, accepted=False, rel_err=rel_err, reject_reason=reject)
    invalidated = 0
    if kind == REPACK:
        # old-signature timings are stale: an s_tot change moves the key,
        # a same-s_tot support move needs the explicit drop
        invalidated = autotune.invalidate(autotune.op_key_prefix(FaustOp(old)))
    ex.swap_unembed(new)
    stats = getattr(target, "stats", None)  # Engine-level accounting
    if stats is not None and hasattr(stats, "swaps"):
        stats.swaps += 1
    return SwapReport(
        kind=kind,
        s_tot_before=int(old.s_tot),
        s_tot_after=int(new.s_tot),
        retrace=kind == REPACK and any(fo.values.shape != fn.values.shape
                                       for fo, fn in zip(old.factors, new.factors)),
        invalidated=invalidated,
        rel_err=rel_err,
    )


def requantize_like(old: PackedChain, new) -> PackedChain:
    """Quantize a refreshed chain (a :class:`PackedChain` or a
    :class:`BlockFaust`, packed first) in the serving chain's layout (its
    ``qscheme``: code dtype and scale scheme).  Raises when ``old`` is not
    quantized or ``new`` already is."""
    if old.qscheme is None:
        raise ValueError("requantize_like: serving chain is not quantized")
    pc = pack_chain(new) if isinstance(new, BlockFaust) else new
    if pc.qscheme is not None:
        raise ValueError(
            "requantize_like: refreshed chain is already quantized; "
            "hand the f32 chain and let the swap pick the layout"
        )
    dtype, scheme = old.qscheme.split(":")
    return quantize_chain(pc, dtype, scheme)


def quantized_swap(old: PackedChain, new, *, guard: float | bool | None = None, n_probes: int = 8,
                   seed: int = 0) -> tuple[PackedChain, SwapReport]:
    """Swap for a *quantized* serving chain: re-quantize ``new`` in
    ``old``'s layout and classify it — ``values_only`` when the plan and
    ``in_idx`` survived, ``repack`` otherwise (the old signature's
    autotune entries are dropped, as :func:`hot_swap` does).
    ``token_exact`` holds only when the scales came back bit for bit.
    Returns the quantized replacement and the report; publishing it is the
    caller's step.  A guarded rejection returns ``(old, report)``, so
    publishing the returned chain is always safe."""
    from repro_torch.api import autotune
    from repro_torch.api.operator import FaustOp

    new_q = requantize_like(old, new)
    rel_err, reject = _guard_check(old, new_q, _guard_threshold(guard), n_probes, seed)
    s_old = int(old.values.numel())
    if reject is not None:
        return old, SwapReport(kind=VALUES_ONLY, s_tot_before=s_old, s_tot_after=s_old, retrace=False,
                               invalidated=0, requantized=True, token_exact=True, accepted=False,
                               rel_err=rel_err, reject_reason=reject)
    if old.plan == new_q.plan and _same(old.in_idx, new_q.in_idx):
        kind, invalidated = VALUES_ONLY, 0
    else:
        kind = REPACK
        invalidated = autotune.invalidate(autotune.op_key_prefix(FaustOp(old)))
    token_exact = kind == VALUES_ONLY and _same(old.scales, new_q.scales)
    return new_q, SwapReport(kind=kind, s_tot_before=s_old, s_tot_after=int(new_q.values.numel()),
                             retrace=kind == REPACK, invalidated=invalidated, requantized=True,
                             token_exact=token_exact, rel_err=rel_err)


def refreshed_chain(streaming, like: BlockFaust) -> BlockFaust:
    """A :class:`~repro_torch.streaming.online.StreamingFaust`'s published
    chain in a serving chain's values and λ dtypes, on its device (the
    tracker optimizes in f32; serving may run bf16 values).  Raises when
    the tracker's op is not a deployment ``BlockFaust`` (track with a
    block-route ``FactorizeSpec`` to feed a serving swap)."""
    bf = streaming.blockfaust
    if bf is None:
        raise ValueError(
            "StreamingFaust op is not a deployment BlockFaust; track with "
            "a block-route FactorizeSpec to feed a serving swap"
        )
    dev = like.lam.device
    factors = tuple(
        dataclasses.replace(f, values=f.values.to(dev, lf.values.dtype), in_idx=f.in_idx.to(dev))
        for f, lf in zip(bf.factors, like.factors)
    )
    return BlockFaust(factors, torch.as_tensor(bf.lam).to(dev, like.lam.dtype))
