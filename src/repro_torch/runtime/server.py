"""Batched serving runtime — a thin shim over the engine.  Counterpart of
:mod:`repro.runtime.server` (``ServeStats``, ``Server``).

``Server.generate`` takes a batch of prompts of one length, submits one
:class:`~repro_torch.runtime.engine.Request` per row to a fresh
:class:`~repro_torch.runtime.engine.Engine` whose slot pool is exactly the
batch, runs it to completion and re-stacks the rows: greedy tokens of
every row, ``(B, n)`` or ``(B, K, n)`` for K codebooks.  Every batch key
but ``tokens`` (a vision model's ``vision_embeds``) is a side input: each
row's slice rides on its request as ``extras``.  Streams of uneven length
should use the engine directly.

FAµST projections run through ``FaustOp.apply(backend="auto")`` in every
forward; the last decision a forward recorded (the unembedding's) is kept
on :class:`ServeStats` (``faust_dispatch``).  ``tokens_decoded`` counts
every sampled token, ``b · n_new_tokens``, including the token sampled
from the prefill logits, and ``decode_s`` covers every sample.

``Server(model, max_len, mesh=mesh)`` serves on a mesh: every rank of it
builds the same model (same config and seed) and calls ``generate`` with
the same batch, every rank generates the same tokens, and
``ServeStats.mesh_axes`` is the mesh's ``{axis: size}``.  A model split by
``model.shard_(mesh)`` is served under its config's decode policy (the
batch's rows over the policy's batch axes where they divide it, each
global-attention cache's positions over ``kv_seq``, each module's weights
gathered just before it runs: :class:`LMExecutor`); a FAµST head whose
spec carries a ``ShardSpec`` on ``mesh`` applies through
``fused_sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.runtime import engine as _engine
from repro_torch.runtime.engine import Engine, LMExecutor


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_decoded: int = 0
    # last FAµST backend decision a forward recorded (None when the model
    # has no FAµST projections)
    faust_dispatch: Any = None
    # supervision outcomes surfaced from EngineStats: retried forwards and
    # terminally failed/quarantined streams
    retries: int = 0
    failed: int = 0
    demotions: int = 0  # always 0: the port has no ladder; kept for field parity with the reference
    # the serving mesh's {axis: size} (None off a mesh)
    mesh_axes: dict | None = None

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_decoded / self.decode_s if self.decode_s else 0.0


class Server:
    """Greedy generation for a batch of equal-length prompts on ``model``
    (a :class:`repro_torch.models.lm.LM`, standing where the reference
    takes ``cfg`` and ``params``), caches of ``max_len`` tokens, on the
    model's device."""

    def __init__(self, model, max_len: int, mesh=None):
        self.cfg, self.model, self.max_len, self.mesh = model.cfg, model, max_len, mesh
        self._faust_dispatch = None  # kept across generate() calls
        self._executor: LMExecutor | None = None  # reused across generate()s

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy next-token pick from one step's logits ``(B, S, V)`` (or
        ``(B, S, K, V)`` for K codebooks): the last position is sliced here,
        once.  Returns ``(B, 1)`` (``(B, K, 1)``) int32, the shape
        ``decode_step`` takes."""
        tok = lm.greedy_token(logits[:, -1])  # (B,) or (B, K)
        return tok.reshape(*tok.shape, 1)

    def _executor_for(self, b: int) -> LMExecutor:
        ex = self._executor
        if ex is None or ex.n_slots != b:
            ex = LMExecutor(self.model, self.max_len, n_slots=b, mesh=self.mesh)
            self._executor = ex
        return ex

    def unembed_blockfaust(self):
        """Currently-published unembedding chain (None for dense models)."""
        return _engine.unembed_blockfaust(self.model)

    def swap_unembed(self, bf) -> None:
        """Publish a refreshed unembedding chain between ``generate()``
        calls: the model's head takes the new tensors, so the cached
        executor and any later one serve them (same contract as
        :meth:`LMExecutor.swap_unembed`)."""
        if self._executor is not None:
            self._executor.swap_unembed(bf)
        else:
            _engine.swap_unembed(self.model, bf)

    def generate(self, batch: dict, n_new_tokens: int) -> tuple[np.ndarray, ServeStats]:
        arrays = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
        tokens = arrays.pop("tokens")
        b = tokens.shape[0]
        ex = self._executor_for(b)
        engine = Engine(ex)
        rids = [engine.submit(tokens[i], n_new_tokens, extras={k: v[i] for k, v in arrays.items()})
                for i in range(b)]
        engine.run()
        gen = np.stack([engine.result(r) for r in rids], axis=0)
        es = engine.stats
        stats = ServeStats(
            prefill_s=es.prefill_s,
            decode_s=es.decode_s,
            tokens_decoded=es.tokens_decoded,  # == b * n_new_tokens
            retries=es.retries,
            failed=es.failed,
            demotions=es.demotions,
        )
        if ex.faust_dispatch is not None:
            self._faust_dispatch = ex.faust_dispatch
        stats.faust_dispatch = self._faust_dispatch
        if self.mesh is not None:
            stats.mesh_axes = dict(self.mesh.shape)
        return gen, stats
