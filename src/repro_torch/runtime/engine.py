"""Continuous-batching FAµST serving engine.  Counterpart of
:mod:`repro.runtime.engine`: the scheduler (:class:`Request`,
:class:`SlotAllocator`, :class:`EngineStats`, :class:`Executor`,
:class:`Engine`) is the reference's, with its defaults, environment
variables and clock-free fast paths; :class:`LMExecutor` runs the port's
:class:`~repro_torch.models.lm.LM`.

The paper's premise is that multi-layer sparse factorizations make
*applying* an operator cheap — and serving is where apply cost dominates:
many concurrent streams of uneven length, decoded one token at a time.

* :class:`Request` — one stream: its own prompt length, token budget and
  arrival time.
* :class:`SlotAllocator` — a fixed pool of KV-cache *slots* (rows of one
  ``lm.make_caches(cfg, n_slots, max_len)``).  Deterministic
  lowest-free-slot assignment on admit, returned on finish — the
  allocation schedule is a pure function of the arrival/finish sequence,
  which the simulation tests rely on.
* :class:`Engine` — the scheduler.  Each :meth:`Engine.step` admits
  queued requests while slots are free (per-request prefill written into
  the slot's pool row), then runs **one** decode step over the live
  batch.  Requests that hit their budget complete and free their slot
  immediately — the batch *breathes*, the small-batch regime the fused
  chain kernel was built for.
* :class:`EngineStats` — queue depth and batch-occupancy per step,
  admitted/completed/evicted counts, per-request TTFT/TPOT, and the
  per-step FAµST dispatch decision.

**Slots.** The cache pool keeps the slot dim at ``n_slots``; a decode
step gathers the live slots' rows (``lm.gather_cache_slots``) into a
``(B_live, …)`` cache, steps it, and scatters the rows back.  Per-row
positions (``KVCache.pos``) replace left-padding: a reused slot restarts
its row's positions, and stale entries beyond the new occupant's ``pos``
are masked by position.  A mamba layer's row (``MambaCache``: conv
history, recurrent state, ``pos``) is overwritten whole by the prefill.

**Live-batch dispatch.** Each decode step consults the dispatch layer at
the *live* batch size (:meth:`repro_torch.api.FaustOp.dispatch_for`,
``record=False``) so the backend choice — and the measured ``bt`` tile —
follows the batch as it breathes; the per-step
:class:`~repro_torch.api.dispatch.DispatchReport` (including its
``source``) is recorded on :class:`EngineStats`.

**Eviction.** ``Engine.evict(rid)`` preempts a live request: its slot is
freed (and may be reused immediately), the request returns to the *front*
of the queue, and re-admission prefills ``prompt + generated`` — greedy
decode recomputes the same stream token-exactly, so preemption is
invisible in the output.  Eviction is starvation-proof: re-queued
preemptees are age-ordered (oldest arrival first) and a request that has
been evicted ``max_evictions`` times is pinned to its slot (``evict``
returns False).

**Supervision.** One NaN logit, one failing kernel launch, or one stuck
request must not take the engine down:

* *Retry with backoff* — a forward that raises preempts the affected
  requests through the eviction path (re-prefill of ``prompt +
  generated`` keeps retried streams token-exact), charges each a retry
  against ``retry_budget`` and delays re-admission by an exponential
  backoff; over-budget requests turn terminal ``FAILED``.
* *NaN quarantine* — non-finite logits rows (divergence — e.g. a
  regressed FAµST unembedding) fail exactly the affected stream, never
  the batch.
* *Deadlines* — ``submit(..., ttl=...)`` sets a wall deadline; expiry
  frees the slot (or sheds the queued request) with terminal state
  ``TIMED_OUT``.
* *Admission control* — ``max_queue`` sheds submissions at the door
  (terminal ``REJECTED``) instead of queueing unboundedly.

Terminal states and counters live on :class:`Request` /
:class:`EngineStats`; :class:`repro_torch.runtime.faults.FaultInjector`
drives every fault path deterministically.  A zero-fault injector run is
byte-identical to no injector at all, and a zero-fault run makes no clock
reads beyond those of the plain scheduler.  The port has no degraded
dispatch ladder: a failing kernel raises into the retry path above, and
``EngineStats.demotions`` stays 0.

The model side lives behind the small :class:`Executor` interface so the
scheduler itself is testable with a pure-numpy deterministic model
(``tests/engine_sim.py``) — zero torch, zero wall-clock.
:class:`LMExecutor` is the real torch implementation;
:class:`repro_torch.runtime.server.Server` is a thin shim over
``Engine`` + ``LMExecutor``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import os
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Protocol, Sequence

import numpy as np

__all__ = [
    "Request",
    "SlotAllocator",
    "EngineStats",
    "Executor",
    "LMExecutor",
    "Engine",
    "swap_unembed",
    "unembed_blockfaust",
]


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


QUEUED, RUNNING, DONE = "queued", "running", "done"
# terminal non-success states (supervision; see module docstring)
REJECTED, TIMED_OUT, FAILED = "rejected", "timed_out", "failed"


@dataclasses.dataclass
class Request:
    """One generation stream.

    ``prompt`` is a single row — ``(S,)`` int32, or ``(K, S)`` for
    multi-codebook archs.  ``extras`` carries per-request side inputs
    (e.g. a ``vision_embeds`` row for VLM archs), batched up by the
    executor.  Runtime fields are engine-owned.
    """

    rid: str
    prompt: np.ndarray
    max_new_tokens: int
    extras: dict = dataclasses.field(default_factory=dict)
    arrival: float = 0.0
    # --- engine-owned runtime state ---
    state: str = QUEUED
    slot: int | None = None
    generated: list = dataclasses.field(default_factory=list)
    last_token: np.ndarray | None = None
    first_token_t: float | None = None
    done_t: float | None = None
    n_evictions: int = 0
    n_retries: int = 0
    deadline: float | None = None  # absolute clock time (arrival + ttl)
    not_before: float = 0.0  # retry backoff: earliest re-admission time
    error: str | None = None  # why state is REJECTED/TIMED_OUT/FAILED

    def prompt_full(self) -> np.ndarray:
        """Prompt plus everything generated so far — what a re-admission
        prefills, so greedy decode resumes the stream token-exactly."""
        if not self.generated:
            return self.prompt
        gen = np.concatenate(self.generated, axis=-1).astype(self.prompt.dtype)
        return np.concatenate([self.prompt, gen], axis=-1)

    def output(self) -> np.ndarray:
        """Generated tokens: ``(n,)`` or ``(K, n)`` multi-codebook."""
        if not self.generated:
            k = self.prompt.shape[0] if self.prompt.ndim == 2 else None
            return np.zeros((k, 0) if k else (0,), np.int32)
        return np.concatenate(self.generated, axis=-1)


# ---------------------------------------------------------------------------
# Slot allocator
# ---------------------------------------------------------------------------


class SlotAllocator:
    """Fixed pool of cache slots with deterministic assignment.

    ``alloc`` always hands out the lowest free slot index (a min-heap),
    so the slot schedule is a pure function of the admission/finish
    sequence — the property the simulation tests pin.  Double-alloc and
    double-free are hard errors, not corruptions.
    """

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive; got {n_slots}")
        self.n_slots = n_slots
        self._free: list[int] = list(range(n_slots))  # already a valid heap
        self._owner: dict[int, str] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def owner_of(self, slot: int) -> str | None:
        return self._owner.get(slot)

    def alloc(self, rid: str) -> int:
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        slot = heapq.heappop(self._free)
        assert slot not in self._owner, f"slot {slot} double-assigned"
        self._owner[slot] = rid
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not allocated (double free?)")
        del self._owner[slot]
        heapq.heappush(self._free, slot)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineStats:
    """Scheduler-level accounting.

    ``tokens_decoded`` counts **every** sampled token, including the one
    sampled from the prefill logits — the accounting fix over the old
    ``ServeStats`` (which counted ``b·(n_new−1)``, excluding the
    prefill-sampled token from both the count and ``decode_s``).  The
    decode timer here starts after the prefill forward and *before* the
    first sample, so ``tokens_per_s = tokens_decoded / decode_s`` is
    consistent: every counted token's sampling time is inside
    ``decode_s``.
    """

    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_decoded: int = 0
    steps: int = 0  # decode steps executed (batch of any size counts 1)
    admitted: int = 0  # prefills run (re-admissions count again)
    completed: int = 0
    evicted: int = 0
    swaps: int = 0  # operator hot-swaps published (streaming.swap)
    # supervision counters (terminal states + recovery actions)
    rejected: int = 0  # shed at submit (queue over max_queue)
    timed_out: int = 0  # deadline/TTL expiry (running or queued)
    failed: int = 0  # retry budget exhausted or quarantined
    retries: int = 0  # re-queues after a raised forward
    quarantined: int = 0  # streams killed by the non-finite-logits guard
    demotions: int = 0  # always 0: the port has no ladder; kept for field parity with the reference
    swap_rejects: int = 0  # guarded hot-swaps rolled back (streaming.swap)
    # per-decode-step observability
    queue_depth: list = dataclasses.field(default_factory=list)
    occupancy: dict = dataclasses.field(default_factory=dict)  # B_live -> steps
    dispatch_per_step: list = dataclasses.field(default_factory=list)
    # per-request latency (seconds, under the engine's clock)
    ttft_s: dict = dataclasses.field(default_factory=dict)
    tpot_s: dict = dataclasses.field(default_factory=dict)
    # parity with the old ServeStats surface
    faust_dispatch: Any = None  # last decision a forward recorded
    mesh_axes: dict | None = None  # the executor's mesh, {axis: size} (None off a mesh)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_decoded / self.decode_s if self.decode_s else 0.0

    def backend_counts(self) -> dict:
        """Histogram of per-step dispatch decisions: backend -> steps."""
        counts: dict[str, int] = {}
        for rep in self.dispatch_per_step:
            if rep is not None:
                counts[rep.backend] = counts.get(rep.backend, 0) + 1
        return counts


# ---------------------------------------------------------------------------
# Executor interface + the real torch implementation
# ---------------------------------------------------------------------------


class Executor(Protocol):
    """What the scheduler needs from a model.

    The engine times ``prefill_forward`` into ``prefill_s`` and
    ``decode_forward`` + ``sample`` into ``decode_s``; implementations
    should block on device results inside these calls so the timings are
    honest.  ``tests/engine_sim.py`` provides a pure-numpy deterministic
    implementation with slot-hygiene assertions.
    """

    n_slots: int

    def prefill_forward(self, slot: int, prompt: np.ndarray, extras: dict):
        """Run the prompt through the model into cache slot ``slot``;
        return the last position's logits ``(1, 1, V)`` / ``(1, 1, K, V)``."""
        ...

    def decode_forward(self, slots: Sequence[int], tokens: np.ndarray):
        """One decode step for the live rows ``slots`` feeding ``tokens``
        ``(B, 1)`` / ``(B, K, 1)``; returns logits ``(B, 1, V[, K…])``."""
        ...

    def sample(self, logits) -> np.ndarray:
        """Greedy tokens from one step's logits: ``(B, 1)`` / ``(B, K, 1)``."""
        ...

    def free(self, slot: int) -> None:
        """Slot released — hygiene hook (the sim poisons the row)."""
        ...

    def dispatch_for(self, batch: int):
        """Advisory FAµST dispatch report at live batch ``batch`` (None
        when the model has no FAµST projections)."""
        ...


def _faust_head(model):
    """The LM's FAµST unembedding (a FaustLinear, or a StackedFaustLinear of
    per-codebook heads), or None."""
    head = getattr(model, "unembed", None)
    return None if model.cfg.faust_unembed is None or head is None else getattr(head, "faust", None)


def _single_head(model, what: str):
    """:func:`_faust_head`, refusing stacked per-codebook heads for ``what``."""
    from repro_torch.layers.faust_linear import StackedFaustLinear

    head = _faust_head(model)
    if isinstance(head, StackedFaustLinear):
        raise NotImplementedError(f"{what} of stacked per-codebook heads")
    return head


def unembed_blockfaust(model):
    """The model's published unembedding chain as a
    :class:`~repro_torch.core.compress.BlockFaust` on detached views of the
    live parameters (None for a dense or tied head) — what
    :func:`repro_torch.streaming.swap.hot_swap` classifies a refresh
    against.  Stacked per-codebook heads (musicgen) raise
    ``NotImplementedError``, as their hot-swap does."""
    head = _single_head(model, "the published chain")
    if head is None:
        return None
    bf = head.blockfaust()
    return type(bf)(
        tuple(dataclasses.replace(f, values=f.values.detach()) for f in bf.factors), bf.lam.detach()
    )


def swap_unembed(model, bf) -> None:
    """Publish ``bf`` as the model's unembedding.  Every factor's values,
    support and λ become *new* tensors on the model's device in the head's
    dtype; the old ones are not written, so a chain taken before the swap
    keeps its values.  The next apply builds its operator (and packs the
    fused layout) from the new tensors, whether the support moved or not.
    Stacked per-codebook heads raise ``NotImplementedError``, as the
    reference's swap does."""
    from repro_torch.layers.faust_linear import FaustLinear

    head = _single_head(model, "hot-swap")
    if head is None:
        raise ValueError("model has no FAµST unembedding to swap")
    if len(bf.factors) != len(head.factors):
        raise ValueError(f"swap_unembed: {len(bf.factors)} factors for a {len(head.factors)}-factor head")
    new = FaustLinear.from_blockfaust(bf, dtype=head.lam.dtype, device=head.lam.device)
    for old, f in zip(head.factors, new.factors):
        f.values.requires_grad_(old.values.requires_grad)
    new.lam.requires_grad_(head.lam.requires_grad)
    head.factors, head.lam = new.factors, new.lam


class RowLogits:
    """One decode step's logits on a mesh whose decode policy splits the
    slot pool's rows or the vocabulary: this rank's rows ``local`` ``(b, 1,
    V)`` / ``(b, 1, K, V)``, at the positions ``rows`` (a ``(b,)`` tensor)
    of the step's ``n`` live rows; where ``plan`` (a
    :class:`~repro_torch.models.lm.SplitPlan`) splits the head, ``V`` is
    this rank's vocabulary block.  :meth:`picks` picks each row's greedy
    token over the split vocabulary (``lm.greedy_token``: the max and the
    lowest index holding it, over the split) and its finite flag, then
    gathers them over ``group`` (the rows' axes, None where whole) once,
    never the logits: one all-reduce of ``n·(K + 1)`` int32
    (:func:`repro_torch.distributed.layout.reduce_over`, purpose
    ``"row_gather"``)."""

    def __init__(self, local, rows, n: int, group, plan=None):
        self.local, self.rows, self.n, self.group, self.plan = local, rows, n, group, plan
        self._picks = None

    def picks(self) -> tuple[np.ndarray, np.ndarray]:
        """Every live row's greedy tokens ``(n,)`` / ``(n, K)`` (int32) and
        finite flag ``(n,)`` (bool), the same on every rank."""
        if self._picks is None:
            buf = self.gathered().cpu().numpy()
            shape = tuple(self.local.shape[2:-1])  # () or (K,)
            k = buf.shape[1] - 1
            self._picks = (buf[:, :k].reshape((self.n,) + shape), buf[:, k].astype(bool))
        return self._picks

    def gathered(self):
        """The device side of :meth:`picks`: ``(n, K + 1)`` int32, every
        row's tokens and finite flag, summed over the rows' group."""
        import torch

        from repro_torch.distributed.layout import reduce_over
        from repro_torch.models.lm import greedy_token

        step = self.local[:, -1]
        # the ranks that split this rank's vocabulary hold its rows, so they idle with it: no pick to make
        split = self.plan if step.shape[0] else None
        tok = greedy_token(step, split)  # (b,) or (b, K)
        k = 1 if tok.ndim == 1 else tok.shape[1]
        finite = torch.isfinite(step.float()).flatten(1).all(dim=-1).to(torch.int32)
        if split is not None and split.head:  # every block of the row finite: the least flag
            finite = -reduce_over(-finite, self.plan.tp.group, "max", "vocab_pick")
        buf = torch.zeros((self.n, k + 1), dtype=torch.int32, device=step.device)
        buf[self.rows, :k] = tok.reshape(-1, k)
        buf[self.rows, k] = finite
        return buf if self.group is None else reduce_over(buf, self.group, "sum", "row_gather")


def _split_axes(ax, n: int, mesh) -> tuple[str, ...]:
    """The mesh axes of more than one rank that split a dimension of ``n``
    under a policy's ``ax`` (:func:`~repro_torch.distributed.sharding.
    _fit_axes`: absent axes dropped, whole where they do not divide it)."""
    from repro_torch.distributed.sharding import _fit_axes, axes_tuple

    return tuple(a for a in axes_tuple(_fit_axes(ax, n, mesh)) if mesh.shape[a] > 1)


class LMExecutor:
    """The real model behind the engine: a slot-paged cache pool plus
    prefill and decode over :class:`repro_torch.models.lm.LM`.

    * :meth:`prefill_forward` prefills a fresh one-row cache and writes it
      into pool row ``slot`` in place (the reference's
      ``dynamic_update_slice`` along the slot axis);
    * :meth:`decode_forward` gathers the live rows, steps them, and
      scatters them back.

    ``model`` is a :class:`~repro_torch.models.lm.LM` (it stands where the
    reference takes ``cfg`` and ``params``).  The pool is one
    ``make_caches(model.cfg, n_slots, max_len)`` on the model's device, in
    the model's dtype (a :class:`KVCache` or :class:`MambaCache` per
    layer).  A prompt is prefilled up to :func:`lm.prefill_length` and its
    rest replayed through the decode step.  Every forward runs under
    ``torch.no_grad`` and synchronizes the device before it returns, so the
    engine's ``prefill_s``/``decode_s`` time the device's work.  In eager
    PyTorch every FAµST apply records its dispatch decision
    (:func:`repro_torch.api.dispatch.last_report`); the last one a forward
    recorded (the unembedding's, applied last) lands on
    ``faust_dispatch``.  :meth:`dispatch_for` answers the engine's
    advisory per-step query from the unembedding chain, the projection
    every decode step pays (head 0 of per-codebook heads, as the
    reference).  A prefill passes the request's ``extras`` (a vision
    model's ``vision_embeds`` row, ``(nv, d)``) to :meth:`LM.prefill` as
    ``(1, nv, d)`` tensors on the device, on a first admission and on a
    re-prefill alike; every image position falls in the prefix it
    prefills whole (:func:`lm.prefill_length`).

    ``mesh`` (a :class:`repro_torch.distributed.Mesh`): every rank of it
    runs the same engine on the same requests (SPMD), so the scheduler is
    the same on every rank.  A FAµST head whose spec carries a
    ``ShardSpec`` (it must be on ``mesh``) applies through
    ``fused_sharded``.  A model that :meth:`LM.shard_` split (on ``mesh``;
    another mesh raises ``ValueError``) is served under the config's
    decode policy (``use_rules(mesh, cfg.decode_policy())``), as the
    reference's executor, and placed by it as the reference's
    ``launch/steps.py`` ``cache_shardings`` places a decode step's state:

    * each module's weights stay in their blocks and are gathered whole
      just before it runs (:meth:`LM._call`);
    * the pool's rows split over the policy's ``batch`` axes where they
      divide ``n_slots`` (:data:`rows`; else whole, ``_fit_axes``'s rule):
      a rank holds slots ``[r·n/nd, (r+1)·n/nd)`` of its index ``r`` over
      them.  A prefill (one row, replicated) runs on every rank and only
      the owner writes its row; a decode step computes the live rows a
      rank owns, and :class:`RowLogits` gathers their tokens and finite
      flags.  A rank with no live row in a step runs one idle row (a blank
      cache of its own), so it joins every collective of the step, and
      drops its result.  A sharded head then splits out-blocks over its
      model axis only, its batch being the rank's rows already;
    * where the decode policy computes modules in blocks
      (:meth:`LM.split_plan` with ``serving``: the MLP's hidden columns and
      the vocabulary under ``DECODE_POLICY``, a mamba block's heads over
      the axes the reference places a ``MambaCache``'s heads on, and a MoE
      layer's experts or each expert's columns over ``experts_act`` or
      ``mlp_act``, its rows routed whole on every rank), each rank keeps
      those blocks; the logits of a split vocabulary stay split, and
      every step's logits come back as :class:`RowLogits`, which picks the
      greedy token over the split;
    * every global-attention cache (:data:`lm.SPLIT_KV_KINDS`) keeps only
      the rank's block of the ``max_len`` positions over the policy's
      ``kv_seq`` axes (:data:`kv`), and decode attention merges the blocks
      over them (``layers/attention.py``); a split mamba block's
      :class:`MambaCache` keeps the rank's heads' state and conv channels
      (the plan's ``ssm``).  A sliding-window ring stays whole on every
      rank of its rows (ROADMAP caveat R11).

    An unsharded model on a mesh runs every layer whole on every rank
    with the whole pool; only a sharded head splits.
    """

    def __init__(self, model, max_len: int, n_slots: int, mesh=None):
        import math

        import torch

        from repro_torch.distributed.layout import seq_split
        from repro_torch.distributed.sharding import use_rules
        from repro_torch.models import lm

        self.cfg, self.model, self.mesh = model.cfg, model, mesh
        self.max_len, self.n_slots = max_len, n_slots
        head = _faust_head(model)
        shard = None if head is None else head.spec.shard
        if shard is not None and shard.mesh is not mesh:
            raise ValueError("the FAµST head is sharded on another mesh than the executor's: pass that mesh")
        if model.blocks is not None and model.mesh is not mesh:
            raise ValueError("the model is sharded on another mesh than the executor's: pass that mesh")
        self._torch, self._lm = torch, lm
        self.device = model.embed.table.device
        self._act_dtype = lm.DTYPES[self.cfg.dtype]
        # the placement of a sharded model (class docstring); none otherwise
        self.policy = None if model.blocks is None else self.cfg.decode_policy()
        self.rows: tuple[str, ...] = ()  # the mesh axes the pool's rows split over
        self.kv = None  # this rank's block of the global caches' positions (a SeqSplit)
        self._lo, self.n_local = 0, n_slots
        self._head_shard = None  # the head's placement while the rows are split
        if self.policy is not None:
            self.rows = _split_axes(self.policy.batch, n_slots, mesh)
            kv_axes = _split_axes(self.policy.kv_seq, max_len, mesh)
            if set(self.rows) & set(kv_axes):
                raise ValueError(f"the decode policy splits rows over {self.rows} and positions over {kv_axes}")
            self.kv = seq_split(mesh, kv_axes, max_len)
            if self.rows:
                self.n_local = n_slots // math.prod(mesh.shape[a] for a in self.rows)
                self._lo = mesh.index(self.rows) * self.n_local
                if shard is not None and shard.data_axis in self.rows:
                    self._head_shard = dataclasses.replace(shard, data_axis=None)
        self.plan = None  # what the decode policy computes in blocks (LM.split_plan)
        if self.policy is not None:
            with use_rules(mesh, self.policy):
                self.plan = model.split_plan(serving=True)
        # the caches' placement: global-attention positions over kv, mamba heads as the plan splits them
        self._caches = dict(dtype=self._act_dtype, device=self.device, kv=self.kv,
                            ssm=None if self.plan is None else self.plan.ssm)
        self.pool = lm.make_caches(self.cfg, self.n_local, max_len, **self._caches)
        self._idle = lm.make_caches(self.cfg, 1, max_len, **self._caches) if self.rows else None
        self.idle_steps = 0  # decode steps in which this rank had no live row
        self.faust_dispatch = None  # last decision a forward recorded
        self._faust_op = self._build_faust_op()

    # -- FAµST plumbing -----------------------------------------------------
    def _build_faust_op(self):
        """The unembedding FaustOp (decode's per-step projection) for
        advisory live-batch dispatch queries; None for dense models."""
        from repro_torch.api.operator import FaustOp
        from repro_torch.layers.faust_linear import StackedFaustLinear

        head = _faust_head(self.model)
        if head is None:
            return None
        # per-codebook heads: query head 0
        bf = head.blockfaust(0) if isinstance(head, StackedFaustLinear) else self.unembed_blockfaust()
        return FaustOp(bf, shard=head.spec.shard)

    def dispatch_for(self, batch: int):
        if self._faust_op is None:
            return None
        return self._faust_op.dispatch_for(batch, self._act_dtype)

    def unembed_blockfaust(self):
        """The currently-published unembedding chain (None for dense
        models), see :func:`unembed_blockfaust`."""
        return unembed_blockfaust(self.model)

    def swap_unembed(self, bf) -> None:
        """Publish a refreshed unembedding chain between engine steps
        (:func:`swap_unembed`) and rebuild the advisory operator.  Policy
        (classification, autotune invalidation, stats) lives in
        :mod:`repro_torch.streaming.swap` — this is only the publication
        primitive."""
        swap_unembed(self.model, bf)
        self._faust_op = self._build_faust_op()

    # -- Executor interface -------------------------------------------------
    def _tokens(self, a):
        return self._torch.as_tensor(np.asarray(a), dtype=self._torch.int64, device=self.device)

    def _capture_dispatch(self, mark) -> None:
        from repro_torch.api import dispatch as _dispatch

        if _dispatch.last_report() is not mark:  # a FAµST layer dispatched
            self.faust_dispatch = _dispatch.last_report()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _forward(self):
        """A forward: no autograd; for a sharded model the decode policy's
        rules, and a sharded head's batch split off while the rows are."""
        from repro_torch.distributed.sharding import use_rules

        head = _faust_head(self.model)
        spec = None if head is None else head.spec
        with self._torch.no_grad(), use_rules(self.mesh if self.policy is not None else None, self.policy):
            if self._head_shard is not None:
                head.spec = dataclasses.replace(spec, shard=self._head_shard)
            try:
                yield
            finally:
                if self._head_shard is not None:
                    head.spec = spec

    def prefill_forward(self, slot: int, prompt: np.ndarray, extras: dict):
        from repro_torch.api import dispatch as _dispatch

        torch, lm = self._torch, self._lm
        prompt = np.asarray(prompt)
        # Chunked prefill takes a sequence longer than a chunk only as a
        # multiple of it.  Prompts and the re-prefills of prompt+generated
        # (the retry and evict re-admission paths) arrive at ragged
        # lengths, so prefill the longest prefix every chunked path takes
        # (lm.prefill_length: attention's attn_chunk, and the SSD's chunk,
        # which the reference leaves out) and replay the remainder through
        # the decode step: the final replayed token's logits are the full
        # prompt's prefill logits (token-exact by construction).
        aligned = lm.prefill_length(self.cfg, prompt.shape[-1])
        head, tail = prompt[..., :aligned], prompt[..., aligned:]
        side = {k: torch.as_tensor(np.asarray(v), device=self.device)[None] for k, v in extras.items()}
        mark = _dispatch.last_report()
        with self._forward():
            caches = lm.make_caches(self.cfg, 1, self.max_len, **self._caches)
            logits, caches = self.model.prefill(self._tokens(head)[None], caches, kv=self.kv, **side)
            row = slot - self._lo
            if 0 <= row < self.n_local:  # the rank that holds the slot's row keeps it
                for p, c in zip(self.pool, caches):
                    for dst, src in zip(p, c):
                        dst[row:row + 1] = src
            if self._split_head():
                logits = RowLogits(logits, torch.zeros((1,), dtype=torch.int64, device=self.device), 1, None,
                                   self.plan)
            for i in range(tail.shape[-1]):
                logits = self._decode([slot], tail[None, ..., i:i + 1])
        self._sync()
        self._capture_dispatch(mark)
        return logits

    def _decode(self, slots: list[int], tokens: np.ndarray):
        """One decode step of the live ``slots`` (global) fed ``tokens``:
        the logits, or this rank's rows of them (:class:`RowLogits`)."""
        torch, lm = self._torch, self._lm
        mine = [i for i, s in enumerate(slots) if 0 <= s - self._lo < self.n_local]
        if mine:
            slot_idx = torch.as_tensor([slots[i] - self._lo for i in mine], device=self.device)
            caches = lm.gather_cache_slots(self.pool, slot_idx)
            logits, caches = self.model.decode_step(self._tokens(tokens[mine]), caches, kv=self.kv)
            lm.scatter_cache_slots(self.pool, caches, slot_idx)
        else:  # no live row here: an idle row joins the step's collectives
            self.idle_steps += 1
            logits = self.model.decode_step(self._tokens(np.zeros_like(tokens[:1])), self._idle, kv=self.kv)[0][:0]
        if not self.rows and not self._split_head():
            return logits
        rows = torch.as_tensor(mine, dtype=torch.int64, device=self.device)
        return RowLogits(logits, rows, len(slots), self.mesh.group(self.rows) if self.rows else None, self.plan)

    def _split_head(self) -> bool:
        return self.plan is not None and self.plan.head

    def decode_forward(self, slots: Sequence[int], tokens: np.ndarray):
        """One decode step of the live ``slots``: the logits ``(B, 1, V)`` /
        ``(B, 1, K, V)``, or this rank's rows of them (:class:`RowLogits`)
        where the pool's rows or the vocabulary are split; :meth:`sample` and
        :meth:`row_finite` take either."""
        from repro_torch.api import dispatch as _dispatch

        mark = _dispatch.last_report()
        with self._forward():
            logits = self._decode([int(s) for s in slots], np.asarray(tokens))
        self._sync()
        self._capture_dispatch(mark)  # the decode step's: the steady-state path
        return logits

    def sample(self, logits) -> np.ndarray:
        """Greedy argmax of the last position — same slicing contract as
        ``Server._sample`` (the sequence axis is axis 1): ``(B, 1)``, or
        ``(B, K, 1)`` for K codebooks; every live row's on every rank."""
        if isinstance(logits, RowLogits):
            tok = logits.picks()[0]
            return tok.reshape(*tok.shape, 1)
        tok = self._lm.greedy_token(logits[:, -1])  # (B,) or (B, K)
        return tok.reshape(*tok.shape, 1).cpu().numpy()

    def row_finite(self, logits) -> np.ndarray:
        """Per-row all-finite mask of the last position, ``(B,)`` bool —
        the engine's NaN guard.  Reduced on the device so the guard moves B
        bools per step instead of the ``(B, V)`` logits."""
        if isinstance(logits, RowLogits):
            return logits.picks()[1]
        step = logits[:, -1].float()
        return self._torch.isfinite(step).reshape(step.shape[0], -1).all(dim=-1).cpu().numpy()

    def free(self, slot: int) -> None:
        # Cache rows are never read unless their slot is gathered live,
        # and a reuse prefill overwrites pos — nothing to scrub.
        return None


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class Engine:
    """Continuous-batching scheduler over an :class:`Executor`.

    ``clock`` is injectable (``tests/engine_sim.FakeClock``) so the whole
    scheduler — admission order, slot schedule, stats — is deterministic
    under test with zero wall-clock dependence.

    Supervision policy (all keyword-only; ``None`` ⇒ env default):

    * ``retry_budget`` / ``backoff_s`` — a raised forward preempts the
      affected requests through the eviction path; each gets at most
      ``retry_budget`` retries (env ``REPRO_RETRY_BUDGET``, default 2)
      with exponential backoff ``backoff_s · 2^(n_retries−1)`` (env
      ``REPRO_RETRY_BACKOFF``, default 0.05 s) before terminal FAILED.
    * ``max_evictions`` — starvation guard: a request evicted this many
      times is pinned to its slot (env ``REPRO_MAX_EVICTIONS``, default
      8; ``<= 0`` disables the cap).
    * ``max_queue`` — admission control: submissions beyond this queue
      depth are shed as terminal REJECTED (default unbounded).
    * ``default_ttl`` — deadline applied to every submit that does not
      pass its own ``ttl`` (default none).
    * ``nan_guard`` — per-stream quarantine of non-finite logits rows
      (default on; costs one finiteness reduction per step).
    * ``sleep`` — how the engine waits out retry backoff when nothing is
      live (default: ``clock.advance`` when the clock has one — the sim
      FakeClock — else ``time.sleep``).
    """

    def __init__(
        self,
        executor: Executor,
        clock: Callable[[], float] = time.monotonic,
        *,
        retry_budget: int | None = None,
        backoff_s: float | None = None,
        max_queue: int | None = None,
        default_ttl: float | None = None,
        max_evictions: int | None = None,
        nan_guard: bool = True,
        sleep: Callable[[float], None] | None = None,
    ):
        self.executor = executor
        self.clock = clock
        self.allocator = SlotAllocator(executor.n_slots)
        self.queue: deque[Request] = deque()
        self.running: "OrderedDict[str, Request]" = OrderedDict()
        self.done: dict[str, Request] = {}
        self.stats = EngineStats()
        mesh = getattr(executor, "mesh", None)  # LMExecutor(mesh=): the serving mesh's {axis: size}
        if mesh is not None:
            self.stats.mesh_axes = dict(mesh.shape)
        self._n = 0
        # -- supervision policy --
        if retry_budget is None:
            retry_budget = int(os.environ.get("REPRO_RETRY_BUDGET", "2"))
        if backoff_s is None:
            backoff_s = float(os.environ.get("REPRO_RETRY_BACKOFF", "0.05"))
        if max_evictions is None:
            max_evictions = int(os.environ.get("REPRO_MAX_EVICTIONS", "8"))
        self.retry_budget = retry_budget
        self.backoff_s = backoff_s
        self.max_evictions = max_evictions if max_evictions > 0 else None
        self.max_queue = max_queue
        self.default_ttl = default_ttl
        self.nan_guard = nan_guard
        if sleep is None:
            sleep = getattr(clock, "advance", None) or time.sleep
        self._sleep = sleep
        # Fast-path guards: a zero-fault, zero-deadline run must make
        # exactly the same clock() calls as the pre-supervision engine
        # (byte-identical stats under FakeClock) — so deadline sweeps and
        # backoff scans only run when something armed them.
        self._n_deadlines = 0  # non-terminal requests carrying a deadline
        self._maybe_blocked = False  # a queued request may be in backoff

    # -- submission / results ----------------------------------------------
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        extras: dict | None = None,
        rid: str | None = None,
        *,
        ttl: float | None = None,
    ) -> str:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if rid is None:
            rid = f"r{self._n}"
        self._n += 1
        if rid in self.done or rid in self.running or any(
            r.rid == rid for r in self.queue
        ):
            raise ValueError(f"duplicate rid {rid!r}")
        arrival = self.clock()
        req = Request(
            rid=rid,
            prompt=np.asarray(prompt),
            max_new_tokens=int(max_new_tokens),
            extras=dict(extras or {}),
            arrival=arrival,
        )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # load shedding at the door: terminal REJECTED, never queued —
            # result() raises and the caller decides whether to resubmit
            req.state = REJECTED
            req.error = (
                f"queue depth {len(self.queue)} >= max_queue {self.max_queue}"
            )
            req.done_t = arrival
            self.done[rid] = req
            self.stats.rejected += 1
            return rid
        if ttl is None:
            ttl = self.default_ttl
        if ttl is not None:
            req.deadline = arrival + float(ttl)
            self._n_deadlines += 1
        self.queue.append(req)
        return rid

    def result(self, rid: str) -> np.ndarray:
        req = self.done.get(rid)
        if req is None:
            raise KeyError(f"request {rid!r} is not finished")
        if req.state != DONE:
            raise RuntimeError(f"request {rid!r} {req.state}: {req.error}")
        return req.output()

    def status(self, rid: str) -> str:
        """Current lifecycle state of ``rid`` (see module constants)."""
        if rid in self.done:
            return self.done[rid].state
        if rid in self.running:
            return RUNNING
        if any(r.rid == rid for r in self.queue):
            return QUEUED
        raise KeyError(f"unknown request {rid!r}")

    @property
    def n_pending(self) -> int:
        return len(self.queue) + len(self.running)

    # -- scheduling ---------------------------------------------------------
    def step(self) -> list[str]:
        """One scheduler tick: admit while slots are free, then one decode
        step over the live batch.  Returns rids finished this tick."""
        finished: list[str] = []
        if self._n_deadlines:
            self._expire(finished)
        self._admit(finished)
        live = self._live_by_slot()
        if live:
            self._decode(live, finished)
        elif self.queue and self._maybe_blocked:
            # nothing live and every queued request is in retry backoff:
            # wait out the earliest not_before so run() cannot spin
            now = self.clock()
            wait = min(r.not_before for r in self.queue) - now
            if wait > 0:
                self._sleep(wait)
        return finished

    def run(self, max_steps: int | None = None) -> list[str]:
        """Step until every submitted request has finished."""
        finished: list[str] = []
        steps = 0
        while self.n_pending:
            finished.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return finished

    def evict(self, rid: str, force: bool = False) -> bool:
        """Preempt a live request: free its slot and put it back near the
        *front* of the queue.  Re-admission prefills prompt+generated, so
        the greedy stream continues token-exactly.

        Starvation guard: once a request has been evicted
        ``max_evictions`` times it is pinned — ``evict`` refuses and
        returns False (``force=True`` overrides), so a short stream under
        constant preemption pressure still finishes.  Re-queued
        preemptees are age-ordered (see :meth:`_requeue`)."""
        req = self.running.get(rid)
        if req is None:
            raise KeyError(f"request {rid!r} is not running")
        if (
            not force
            and self.max_evictions is not None
            and req.n_evictions >= self.max_evictions
        ):
            return False
        self.running.pop(rid)
        self.allocator.free(req.slot)
        self.executor.free(req.slot)
        req.slot = None
        req.state = QUEUED
        req.n_evictions += 1
        self._requeue(req)
        self.stats.evicted += 1
        return True

    # -- internals ----------------------------------------------------------
    def _live_by_slot(self) -> list[Request]:
        # Batch rows ordered by slot index: with the lowest-free-slot
        # allocator this makes row order a deterministic function of the
        # schedule (and independent of dict iteration history).
        return sorted(self.running.values(), key=lambda r: r.slot)

    def _admit(self, finished: list[str]) -> None:
        while self.queue and self.allocator.n_free:
            req = self._pop_admissible()
            if req is None:  # every queued request is in retry backoff
                return
            req.slot = self.allocator.alloc(req.rid)
            notify = getattr(self.executor, "on_admit", None)
            if notify is not None:  # e.g. FaultInjector slot→rid tracking
                notify(req.rid, req.slot)
            self.stats.admitted += 1
            t0 = self.clock()
            try:
                logits = self.executor.prefill_forward(
                    req.slot, req.prompt_full(), req.extras
                )
            except Exception as exc:  # noqa: BLE001 — supervision boundary
                t1 = self.clock()
                self.stats.prefill_s += t1 - t0
                # ran=False: the fault fired before the executor touched
                # the row, so only the allocator slot is reclaimed
                self._step_failure([req], exc, t1, finished, ran=False)
                return  # let the backoff elapse before re-admitting
            t1 = self.clock()
            self.stats.prefill_s += t1 - t0
            tok = self.executor.sample(logits)  # (1, 1) / (1, K, 1)
            t2 = self.clock()
            # the prefill-sampled token is a decoded token: count it and
            # its sampling time (the old ServeStats excluded both)
            self.stats.decode_s += t2 - t1
            if self.nan_guard:
                bad = self._bad_rows(logits)
                if bad is not None and bad[0]:
                    self.stats.quarantined += 1
                    self._finish_terminal(
                        req, FAILED,
                        "non-finite prefill logits (stream quarantined)",
                        t2, finished,
                    )
                    continue
            self._append_token(req, np.asarray(tok[0]))
            if req.first_token_t is None:
                req.first_token_t = t2
                self.stats.ttft_s[req.rid] = t2 - req.arrival
            req.state = RUNNING
            self.running[req.rid] = req
            if len(req.generated) >= req.max_new_tokens:
                self._complete(req, t2, finished)

    def _decode(self, live: list[Request], finished: list[str]) -> None:
        slots = [r.slot for r in live]
        tokens = np.stack([r.last_token for r in live])  # (B,1)/(B,K,1)
        b = len(live)
        self.stats.steps += 1
        self.stats.queue_depth.append(len(self.queue))
        self.stats.occupancy[b] = self.stats.occupancy.get(b, 0) + 1
        self.stats.dispatch_per_step.append(self.executor.dispatch_for(b))
        t0 = self.clock()
        try:
            logits = self.executor.decode_forward(slots, tokens)
            toks = self.executor.sample(logits)  # (B,1)/(B,K,1)
        except Exception as exc:  # noqa: BLE001 — supervision boundary
            t1 = self.clock()
            self.stats.decode_s += t1 - t0
            self._step_failure(live, exc, t1, finished, ran=True)
            return
        t1 = self.clock()
        self.stats.decode_s += t1 - t0
        bad = self._bad_rows(logits) if self.nan_guard else None
        for i, req in enumerate(live):
            if bad is not None and bad[i]:
                # divergence quarantine: fail this stream, not the batch
                self.stats.quarantined += 1
                self._finish_terminal(
                    req, FAILED,
                    "non-finite logits (stream quarantined)", t1, finished,
                )
                continue
            self._append_token(req, np.asarray(toks[i]))
            if len(req.generated) >= req.max_new_tokens:
                self._complete(req, t1, finished)
        self._note_dispatch()

    # -- supervision internals ----------------------------------------------
    def _note_dispatch(self) -> None:
        """Keep the executor's last recorded dispatch on the stats.  The
        port has no degraded ladder (a failing kernel raises, and the
        supervision above retries it), so ``demotions`` stays 0."""
        rep = getattr(self.executor, "faust_dispatch", None)
        if rep is not None:
            self.stats.faust_dispatch = rep

    def _bad_rows(self, logits) -> np.ndarray | None:
        """Non-finite mask over the batch rows of one step's logits, or
        None when every row is finite (the overwhelmingly common case).
        Executors may provide ``row_finite`` (device-side reduction)."""
        fn = getattr(self.executor, "row_finite", None)
        if fn is not None:
            finite = np.asarray(fn(logits))
        else:
            step = np.asarray(logits[:, -1], dtype=np.float32)
            finite = np.isfinite(step).reshape(step.shape[0], -1).all(axis=-1)
        bad = ~finite
        return bad if bad.any() else None

    def _pop_admissible(self) -> Request | None:
        """Next queued request whose retry backoff (``not_before``) has
        elapsed; None when all are still blocked.  The fast path — no
        request ever retried — pops the head with no clock read."""
        if not self._maybe_blocked:
            return self.queue.popleft()
        now = self.clock()
        self._maybe_blocked = any(r.not_before > now for r in self.queue)
        for i, req in enumerate(self.queue):
            if req.not_before <= now:
                del self.queue[i]
                return req
        return None

    def _requeue(self, req: Request) -> None:
        """Return a preempted/retried request near the front of the
        queue, age-ordered among the other preemptees already there
        (oldest arrival first) — so one unlucky stream cannot be starved
        behind a churn of younger evictees.  A single evictee into a
        fresh queue degenerates to ``appendleft``."""
        i = 0
        while (
            i < len(self.queue)
            and (self.queue[i].n_evictions or self.queue[i].n_retries)
            and self.queue[i].arrival <= req.arrival
        ):
            i += 1
        self.queue.insert(i, req)

    def _step_failure(
        self,
        reqs: list[Request],
        exc: Exception,
        now: float,
        finished: list[str],
        *,
        ran: bool,
    ) -> None:
        """A forward raised: preempt every affected request through the
        eviction path (re-prefill of prompt+generated keeps retried
        streams token-exact), with exponential backoff and a per-request
        retry budget; over-budget requests turn terminal FAILED.
        ``ran=False`` ⇒ the executor never touched the rows (fault fired
        pre-launch), so only the allocator slots are reclaimed."""
        for req in reqs:
            self.running.pop(req.rid, None)
            if req.slot is not None:
                self.allocator.free(req.slot)
                if ran:
                    self.executor.free(req.slot)
                req.slot = None
            if req.n_retries < self.retry_budget:
                req.n_retries += 1
                self.stats.retries += 1
                req.state = QUEUED
                req.not_before = now + self.backoff_s * (
                    2 ** (req.n_retries - 1)
                )
                self._maybe_blocked = True
                self._requeue(req)
            else:
                self._finish_terminal(
                    req, FAILED,
                    f"{type(exc).__name__}: {exc} "
                    f"(retry budget {self.retry_budget} exhausted)",
                    now, finished,
                )

    def _expire(self, finished: list[str]) -> None:
        """Sweep deadlines: expired running requests free their slot,
        expired queued requests are shed — both terminal TIMED_OUT.
        Only called when ``_n_deadlines`` is non-zero (one clock read)."""
        now = self.clock()
        expired = [
            r for r in self.running.values()
            if r.deadline is not None and now > r.deadline
        ]
        for req in expired:
            self._finish_terminal(
                req, TIMED_OUT,
                f"deadline exceeded after {now - req.arrival:.4g}s",
                now, finished,
            )
        if any(r.deadline is not None and now > r.deadline for r in self.queue):
            keep: deque[Request] = deque()
            for req in self.queue:
                if req.deadline is not None and now > req.deadline:
                    self._finish_terminal(
                        req, TIMED_OUT,
                        f"shed from queue after {now - req.arrival:.4g}s",
                        now, finished,
                    )
                else:
                    keep.append(req)
            self.queue = keep

    def _finish_terminal(
        self,
        req: Request,
        state: str,
        error: str,
        now: float,
        finished: list[str],
    ) -> None:
        """Move a request to a terminal non-DONE state, releasing its
        slot if it holds one.  ``result()`` for it raises RuntimeError."""
        if req.slot is not None:
            self.allocator.free(req.slot)
            self.executor.free(req.slot)
            req.slot = None
        self.running.pop(req.rid, None)
        req.state = state
        req.error = error
        req.done_t = now
        if req.deadline is not None:
            self._n_deadlines -= 1
            req.deadline = None
        self.done[req.rid] = req
        if state == FAILED:
            self.stats.failed += 1
        elif state == TIMED_OUT:
            self.stats.timed_out += 1
        finished.append(req.rid)

    def _append_token(self, req: Request, tok: np.ndarray) -> None:
        req.generated.append(tok)
        req.last_token = tok
        self.stats.tokens_decoded += 1

    def _complete(self, req: Request, now: float, finished: list[str]) -> None:
        self.allocator.free(req.slot)
        self.executor.free(req.slot)
        req.slot = None
        req.state = DONE
        req.done_t = now
        if req.deadline is not None:
            self._n_deadlines -= 1
            req.deadline = None
        self.running.pop(req.rid, None)
        self.done[req.rid] = req
        self.stats.completed += 1
        n = len(req.generated)
        if n > 1:
            self.stats.tpot_s[req.rid] = (now - req.first_token_t) / (n - 1)
        else:
            self.stats.tpot_s[req.rid] = 0.0
        finished.append(req.rid)
