"""Deterministic fault injection for the serving engine.  Counterpart of
:mod:`repro.runtime.faults`, ported whole.

The supervision layer in :mod:`repro_torch.runtime.engine` (retry with backoff,
NaN quarantine, deadlines, load shedding) is only trustworthy if every
fault path is *provable* the same way the scheduler itself is: scripted
traces through the deterministic sim harness (``tests/engine_sim.py``)
with token-exact differential parity against fault-free oracles.  This
module provides the fault source: :class:`FaultInjector` wraps any
:class:`~repro_torch.runtime.engine.Executor` and injects scripted failures —

* ``step_error``  — raise :class:`InjectedFault` from ``decode_forward``
  / ``prefill_forward`` *before* the wrapped executor runs (a failed
  kernel launch never mutates the cache pool — which is also why the
  engine's retry path re-prefills instead of trusting the row);
  transient (fires ``count`` times) or persistent (``count=None``).
* ``nan_logits``  — corrupt one stream's logits row with NaN *after* the
  real forward (the batch's other rows are untouched — exactly the
  divergence mode PALM4MSA drift can produce in a FAµST unembedding).
* ``slow_step``   — inject ``delay_s`` of clock time around a forward
  (``FakeClock.advance`` under sim, ``time.sleep`` live), which is how
  deadline/TTL expiry is driven deterministically.

Faults are keyed by **op-call index** (per-op counters, not wall time)
and optionally by **request id**; the injector learns slot→rid ownership
from the engine's ``on_admit`` hook.  Zero torch dependency: everything is
numpy + stdlib, so the sim harness drives the whole fault matrix with no
device.  With an empty fault list the wrapper is *transparent* — every
call forwards to the inner executor and returns its objects unchanged,
so a zero-fault run is byte-identical to running without the injector
(pinned by ``tests/test_torch_engine.py`` beside the reference).

:func:`regressed_chain` manufactures the fourth fault class — a swap
regression (corrupted/diverged refresh chain) — for the guarded-swap
path in :mod:`repro_torch.streaming.swap`; it lazily imports torch and is
the only thing here that touches it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

__all__ = ["InjectedFault", "FaultSpec", "FaultInjector", "regressed_chain"]


class InjectedFault(RuntimeError):
    """The exception :class:`FaultInjector` raises for ``step_error``."""


FAULT_KINDS = ("step_error", "nan_logits", "slow_step")


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault.

    ``step`` is the index in the injector's per-op call counter at (and
    after) which the fault is armed; ``count`` bounds how many times it
    fires (``None`` or ``<= 0`` ⇒ persistent — every matching call).  A
    transient step failure is simply ``count=1``: it fires once and the
    engine's retried call passes.  ``rid`` targets one stream:
    ``nan_logits`` corrupts that stream's row only, and a ``step_error``
    with a rid fires only on calls whose batch contains it.
    """

    kind: str  # "step_error" | "nan_logits" | "slow_step"
    step: int = 0
    op: str = "decode"  # "decode" | "prefill"
    rid: str | None = None
    count: int | None = 1
    delay_s: float = 0.0  # slow_step only
    message: str = "injected fault"
    fired: int = 0  # runtime state (injector-owned copy)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}; got {self.kind!r}")
        if self.op not in ("decode", "prefill"):
            raise ValueError(f"op must be 'decode' or 'prefill'; got {self.op!r}")

    def exhausted(self) -> bool:
        return self.count is not None and self.count > 0 and self.fired >= self.count


class FaultInjector:
    """Executor wrapper that injects scripted faults deterministically.

    Wrap any executor (``SimExecutor``, :class:`~repro_torch.runtime.engine
    .LMExecutor`) and hand the wrapper to the engine::

        inj = FaultInjector(SimExecutor(2, 64), faults=[
            FaultSpec("step_error", step=3),           # transient, once
            FaultSpec("nan_logits", step=5, rid="r1"),  # kill one stream
        ], clock=clock)
        engine = Engine(inj, clock=clock)

    ``clock`` is the engine's clock when it supports ``advance`` (the sim
    :class:`~tests.engine_sim.FakeClock`); ``slow_step`` faults then
    advance fake time instead of sleeping.  Every attribute the wrapper
    does not intercept (``sample``, ``free``, ``dispatch_for``,
    ``swap_unembed``, sim internals like ``mix``/``calls``) delegates to
    the inner executor, so the wrapper composes with hot-swap and the
    sim's hygiene assertions unchanged.
    """

    def __init__(self, executor, faults: Sequence[FaultSpec] = (), clock=None):
        self.inner = executor
        # private mutable copies: one injector owns its fire counters
        self.faults = [dataclasses.replace(f, fired=0) for f in faults]
        self.clock = clock
        self.owners: dict[int, str] = {}  # slot -> rid (via on_admit)
        self.n_prefill = 0
        self.n_decode = 0
        self.fired_log: list[tuple] = []  # (kind, op, call_idx, rid)

    @property
    def n_slots(self) -> int:
        return self.inner.n_slots

    def __getattr__(self, name):
        # transparent passthrough for everything not intercepted
        return getattr(self.inner, name)

    # -- engine hooks --------------------------------------------------------
    def on_admit(self, rid: str, slot: int) -> None:
        """Engine notification: ``rid`` was admitted into ``slot`` (called
        before the prefill).  Keeps slot→rid current so rid-targeted
        faults hit the right batch row."""
        self.owners[slot] = rid
        hook = getattr(self.inner, "on_admit", None)
        if hook is not None:
            hook(rid, slot)

    # -- fault machinery -----------------------------------------------------
    def _matching(self, kind: str, op: str, idx: int, rids) -> list[FaultSpec]:
        out = []
        for f in self.faults:
            if f.kind != kind or f.op != op or idx < f.step or f.exhausted():
                continue
            if f.rid is not None and f.rid not in rids:
                continue
            out.append(f)
        return out

    def _fire(self, f: FaultSpec, op: str, idx: int, rid=None) -> None:
        f.fired += 1
        self.fired_log.append((f.kind, op, idx, rid if rid is not None else f.rid))

    def _advance(self, dt: float) -> None:
        if dt <= 0:
            return
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(dt)
        else:
            time.sleep(dt)

    def _nan_rows(self, logits, rows: list[int]):
        out = np.array(logits, np.float32, copy=True)
        out[rows] = np.nan
        return out

    # -- Executor interface (intercepted) ------------------------------------
    def prefill_forward(self, slot: int, prompt: np.ndarray, extras: dict):
        idx = self.n_prefill
        self.n_prefill += 1
        rid = self.owners.get(slot)
        rids = {rid}
        for f in self._matching("slow_step", "prefill", idx, rids):
            self._fire(f, "prefill", idx, rid)
            self._advance(f.delay_s)
        for f in self._matching("step_error", "prefill", idx, rids):
            self._fire(f, "prefill", idx, rid)
            raise InjectedFault(f"{f.message} (prefill #{idx}, rid={rid})")
        logits = self.inner.prefill_forward(slot, prompt, extras)
        for f in self._matching("nan_logits", "prefill", idx, rids):
            self._fire(f, "prefill", idx, rid)
            logits = self._nan_rows(logits, [0])
        return logits

    def decode_forward(self, slots, tokens):
        idx = self.n_decode
        self.n_decode += 1
        slot_rids = [self.owners.get(int(s)) for s in slots]
        rids = set(slot_rids)
        for f in self._matching("slow_step", "decode", idx, rids):
            self._fire(f, "decode", idx)
            self._advance(f.delay_s)
        for f in self._matching("step_error", "decode", idx, rids):
            self._fire(f, "decode", idx)
            raise InjectedFault(f"{f.message} (decode #{idx}, rids={sorted(map(str, rids))})")
        logits = self.inner.decode_forward(slots, tokens)
        nan_faults = self._matching("nan_logits", "decode", idx, rids)
        if nan_faults:
            rows = []
            for f in nan_faults:
                self._fire(f, "decode", idx)
                if f.rid is None:
                    rows.extend(range(len(slot_rids)))
                else:
                    rows.extend(i for i, r in enumerate(slot_rids) if r == f.rid)
            logits = self._nan_rows(logits, sorted(set(rows)))
        return logits


def regressed_chain(bf, *, scale: float = 25.0, nan: bool = False, seed: int = 0):
    """A values-only *corrupted* variant of a ``BlockFaust`` — what a
    diverged streaming tracker might publish into ``hot_swap``.  Same
    support (so it classifies ``values_only`` and would silently serve
    garbage without the swap guard); values blown up by ``scale`` plus
    noise from a ``torch.Generator`` seeded with ``seed``, or NaN-poisoned
    with ``nan=True``.  Lazily imports torch (the one torch touch in this
    module) so the sim-only fault suite never pays for it."""
    import torch  # local: keep module import torch-free

    gen = torch.Generator().manual_seed(seed)
    factors = []
    for f in bf.factors:
        v = f.values.detach().to("cpu", torch.float32).clone()
        if nan:
            v.view(-1)[0] = float("nan")
        else:
            v = v * scale + torch.randn(v.shape, generator=gen)
        factors.append(dataclasses.replace(f, values=v.to(f.values.device, f.values.dtype)))
    return type(bf)(tuple(factors), bf.lam)
