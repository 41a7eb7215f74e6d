"""The fault-tolerant training loop.  Counterpart of
:mod:`repro.runtime.trainer` (``TrainConfig``, ``make_train_step``,
``Trainer``).

Kept from the reference:

* microbatch gradient accumulation (f32 sums), every batch leaf
  (``tokens``, a vision model's ``vision_embeds``) split along its rows;
* **EF top-k gradient compression** (``tcfg.compression``): the gradients
  are compressed before the update, and the new residual is guarded like
  the parameters;
* the **NaN/Inf guard**: a non-finite loss skips the update and leaves the
  parameters, the optimizer state and the EF residual as they were,
  decided on the device (the reference's ``jnp.where``), so the step never
  waits for the host;
* **checkpoints** every ``checkpoint_every`` steps, written in the
  background with the data iterator's state (:mod:`repro_torch.checkpoint`),
  and ``run(resume=True)`` restoring the newest intact one in place;
* **preemption**: SIGTERM/SIGINT make the loop save and stop after the
  step it is in;
* **in-training recompression** (``recompress_every``): the weights the
  reference would select are tracked by a
  :class:`~repro_torch.streaming.online.StreamingFaust`, the RE trace goes
  to the metrics and the heartbeat;
* the per-step wall-time EWMA that flags stragglers, the heartbeat file,
  and ``Trainer.faust_dispatch``: the FAµST backend decision of the first
  step, when it was priced for training (``DispatchReport.grad``).

**On a mesh** (``Trainer(mesh=)``, ``make_train_step(..., mesh)``): the
model keeps only each rank's block of every parameter as ``cfg.policy``
places it (:meth:`~repro_torch.models.lm.LM.shard_`), and so do the AdamW
moments and the EF residual; the step counter and the FAµST supports are
whole on every rank (the reference's ``_state_shardings``).  Each rank
computes its rows and, under a sequence split, its positions
(``LM._mesh_train_loss``), gathering each layer's parameters whole just
before it runs; the gradients come back summed over the mesh, as blocks.
Then, with the blocks: AdamW (elementwise); clipping by the norm of the
whole gradients (squares summed over the mesh, a replicated leaf once);
EF top-k selecting over each whole leaf
(:func:`~repro_torch.optim.compression.topk_mask_sharded`); the NaN guard on
the loss summed over the mesh, so every rank skips together.  A SIGTERM on
any rank stops every rank after the same step (the flag is summed over the
mesh once a step), and checkpoints are sharded (each rank writes its
blocks: :mod:`repro_torch.checkpoint.manager`).  :attr:`Trainer.state_bytes`
reports the train state a rank holds beside the whole.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import signal
import time
from typing import Any

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.distributed.layout import gather_param, sum_over
from repro_torch.distributed.sharding import Block, use_rules
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.optim.compression import EFState, TopKConfig, ef_topk_compress, ef_topk_init, n_kept, topk_mask_sharded

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    heartbeat_path: str | None = None
    compression: TopKConfig | None = None
    seed: int = 0
    # in-training recompression: every `recompress_every` steps each dense
    # 2-D float weight whose reference path (slash-joined, "embed/table")
    # contains a selector is tracked by a StreamingFaust (cold, then warm
    # updates); 0 disables
    recompress_every: int = 0
    recompress_targets: tuple = ("unembed", "embed/table")
    recompress_spec: Any = None  # FactorizeSpec override
    recompress_cfg: Any = None  # StreamingConfig override


def make_train_step(model: LM, opt_cfg: AdamWConfig, tcfg: TrainConfig, mesh=None):
    """``step(batch, state, ef=None) -> metrics``: loss and gradients
    (accumulated in f32 over ``tcfg.microbatches``), EF top-k compression
    when ``ef`` is given, then :func:`guarded_update`.  ``batch`` holds
    ``tokens`` and any side input (``vision_embeds``); microbatches split
    every leaf along its rows, as the reference's.  The metrics are device
    tensors.  With ``mesh`` the model must be sharded on it
    (:meth:`LM.shard_`): ``batch`` is the whole batch on every rank, and
    the loss is summed over the mesh (module docstring)."""
    params = {k: p for k, p in model.named_parameters()}
    if mesh is not None and model.mesh is not mesh:
        raise ValueError("make_train_step(mesh=): shard the model on that mesh first (LM.shard_)")

    def grads_of(batch: dict):
        n = tcfg.microbatches
        tokens = batch["tokens"]
        if n > 1:
            if tokens.shape[0] % n:
                raise ValueError(f"batch {tokens.shape[0]} does not split into {n} microbatches")
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            split = {k: v.chunk(n) for k, v in batch.items()}
            for i in range(n):
                for p in params.values():
                    p.grad = None
                mb_loss, _ = model.train_loss({k: v[i] for k, v in split.items()})
                mb_loss.backward()
                for k, p in params.items():
                    acc[k] += p.grad.float()
                loss = loss + mb_loss.detach()
            return {k: a / n for k, a in acc.items()}, loss / n
        for p in params.values():
            p.grad = None
        loss, _ = model.train_loss(batch)
        loss.backward()
        return {k: p.grad for k, p in params.items()}, loss.detach()

    def step(batch: dict, state: AdamWState, ef: EFState | None = None) -> dict:
        with use_rules(mesh, model.cfg.policy):
            grads, loss = grads_of(batch)
        for p in params.values():
            p.grad = None
        metrics, select = {}, None
        if mesh is not None:
            loss = sum_over(loss, mesh)  # every rank decides the NaN guard on the same loss
            select = (lambda name, flat: topk_mask_sharded(
                flat, n_kept(math.prod(model.blocks[name].global_shape), tcfg.compression.ratio),
                model.blocks[name], mesh))
        if ef is not None:
            grads, _, cm = ef_topk_compress(tcfg.compression, grads, ef, ok=torch.isfinite(loss), select=select)
            if mesh is not None:
                cm = {"ef_residual_norm": mesh_norm(ef.residual, model.blocks, mesh)}
            metrics.update(cm)
        gnorm = None if mesh is None else mesh_norm(grads, model.blocks, mesh)
        return {**metrics, **guarded_update(opt_cfg, params, grads, state, loss, grad_norm=gnorm)}

    return step


def mesh_norm(tensors: dict, blocks: dict, mesh) -> torch.Tensor:
    """The global 2-norm of whole tensors of which ``tensors`` holds this
    rank's ``blocks``: squares summed over the mesh, each block divided by
    the number of ranks that hold it (a replicated leaf counts once)."""
    sq = torch.zeros((), dtype=torch.float32, device=next(iter(tensors.values())).device)
    for k, t in tensors.items():
        reps = mesh.size // math.prod(mesh.shape[a] for a in blocks[k].axes)
        sq = sq + torch.sum(torch.square(t.float())) / reps
    return torch.sqrt(sum_over(sq, mesh))


def guarded_update(opt_cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState,
                   loss: torch.Tensor, grad_norm: torch.Tensor | None = None) -> dict:
    """AdamW where ``loss`` is finite, nothing where it is not, decided on
    the device (no host sync).  Returns the metrics as device tensors,
    ``skipped`` 1.0 for a skipped update."""
    ok = torch.isfinite(loss)
    metrics = {"loss": loss, **adamw.apply_updates(opt_cfg, params, grads, state, ok=ok, grad_norm=grad_norm)}
    metrics["skipped"] = (~ok).to(torch.float32)
    return metrics


def state_tree(model: LM, opt: AdamWState, ef: EFState | None) -> dict:
    """The tree a checkpoint holds, in the live tensors: ``params/<state
    dict key>`` (parameters and the FAµST supports), ``opt/mu/...``,
    ``opt/nu/...``, ``opt/step`` and, with compression, ``ef/...``."""
    tree = {"params": model.state_dict(keep_vars=True),
            "opt": {"mu": opt.mu, "nu": opt.nu, "step": opt.step}}
    if ef is not None:
        tree["ef"] = ef.residual
    return tree


def _whole(t: torch.Tensor) -> Block:
    return Block((), tuple(t.shape), (0,) * t.ndim, tuple(t.shape))


def state_shardings(model: LM, opt: AdamWState, ef: EFState | None) -> dict | None:
    """:func:`state_tree`'s structure with each leaf's
    :class:`~repro_torch.distributed.sharding.Block` on the model's mesh:
    a parameter's, its moments' and its residual's the parameter's block;
    the FAµST supports and the step count whole (the reference's
    ``_state_shardings``).  None for a model that is not sharded."""
    if model.blocks is None:
        return None
    sd = model.state_dict(keep_vars=True)
    blocks = {k: model.blocks.get(k) or _whole(t) for k, t in sd.items()}
    tree = {"params": blocks, "opt": {"mu": {k: blocks[k] for k in opt.mu}, "nu": {k: blocks[k] for k in opt.nu},
                                      "step": _whole(opt.step)}}
    if ef is not None:
        tree["ef"] = {k: blocks[k] for k in ef.residual}
    return tree


def state_bytes(model: LM, opt: AdamWState, ef: EFState | None) -> dict:
    """Bytes of the train state this rank holds, and of the whole state
    (every leaf at its global shape)."""
    from repro_torch.checkpoint.manager import _leaves

    leaves = [t for _, t in _leaves(state_tree(model, opt, ef))]
    blocks = state_shardings(model, opt, ef)
    rank = sum(t.numel() * t.element_size() for t in leaves)
    if blocks is None:
        return {"rank": rank, "whole": rank}
    whole = sum(math.prod(b.global_shape) * t.element_size() for t, (_, b) in zip(leaves, _leaves(blocks)))
    return {"rank": rank, "whole": whole}


def reference_name(key: str) -> str | None:
    """The reference's slash-joined tree path of the port's parameter
    ``key`` (``embed.table`` → ``embed/table``; zamba2's shared block,
    ``shared.attn.wq`` → ``shared/attn/wq``, is top-level in both), or None
    for a layer's: the reference stacks each stage's layers, so its
    per-layer weights are never 2-D and never recompressed.  musicgen's
    per-codebook tables and heads are stacked in both (``embed/table (K,
    V, d)``, ``unembed/w (K, d, V)``): never 2-D either."""
    return None if key.startswith("layers.") else key.replace(".", "/")


class Trainer:
    """Trains ``LM(cfg)`` on the synthetic stream of ``data_cfg`` on
    ``device`` (default: the CUDA card), on ``mesh`` when given (every
    rank of its group runs the same trainer: module docstring)."""

    def __init__(
        self,
        cfg: ArchConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig = AdamWConfig(),
        tcfg: TrainConfig = TrainConfig(),
        mesh=None,
        device=None,
    ):
        self.cfg, self.data_cfg, self.opt_cfg, self.tcfg = cfg, data_cfg, opt_cfg, tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints, mesh=mesh)
        self.state_bytes: dict | None = None
        self._preempted = False
        self.history: list[dict] = []
        # the FAµST backend decision of the first step, when it was priced
        # for training (repro_torch.api.dispatch, grad=True)
        self.faust_dispatch = None
        # streaming trackers by the reference's path of their weight
        self.streaming: dict = {}
        self._recompress_log: dict | None = None
        # what the checkpoints cost: one record per save, and the restore
        self.saves: list[dict] = []
        self.resumed: dict | None = None

    # -- fault-tolerance hooks -------------------------------------------------
    def _install_signal_handlers(self) -> dict:
        """SIGTERM/SIGINT set the preemption flag; returns the handlers they
        replaced (none off the main thread, where signals cannot be set)."""
        def handler(signum, frame):
            log.warning("signal %s received: checkpoint and clean exit", signum)
            self._preempted = True

        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread
        return old

    def _heartbeat(self, step: int) -> None:
        if self.tcfg.heartbeat_path:
            payload: dict = {"step": step, "t": time.time()}
            if self._recompress_log is not None:
                payload["recompress"] = self._recompress_log
            with open(self.tcfg.heartbeat_path, "w") as f:
                f.write(json.dumps(payload))

    # -- in-training recompression ---------------------------------------------
    def _recompress_weights(self, model: LM) -> dict:
        """Dense 2-D float parameters whose reference path contains a
        selector, by that path (on a mesh each gathered whole)."""
        out = {}
        for key, p in model.named_parameters():
            name = reference_name(key)
            if name is None or p.ndim != 2 or not p.is_floating_point():
                continue
            if any(sub in name for sub in self.tcfg.recompress_targets):
                out[name] = p if model.blocks is None else gather_param(p.detach(), model.blocks[key], model.mesh)
        return out

    def _recompress(self, model: LM, step_idx: int) -> dict:
        """One recompression tick: start or warm-update the tracker of every
        selected weight; returns ``{name: {"action", "re", "sweeps",
        "seconds"}}`` and keeps it for the heartbeat."""
        from repro_torch.api.factorize import FactorizeSpec
        from repro_torch.streaming.online import StreamingConfig, StreamingFaust

        records: dict = {}
        for name, w in self._recompress_weights(model).items():
            t0 = time.perf_counter()
            w32 = w.detach().float()
            sf = self.streaming.get(name)
            if sf is None:
                spec = self.tcfg.recompress_spec or FactorizeSpec(
                    strategy="hierarchical", n_factors=2, block=8,
                    k_first=4, k_mid=4, n_iter_two=8, n_iter_global=8,
                )
                if self.mesh is not None:  # rank 0 refreshes, every rank holds the chain placed
                    spec = dataclasses.replace(spec, mesh=self.mesh)
                sf = StreamingFaust.track(w32, spec, self.tcfg.recompress_cfg or StreamingConfig(n_iter_update=4),
                                          device=self.device)
                self.streaming[name] = sf
                rec = {"action": "init", "re": sf.estimate_drift(w32), "sweeps": sf.cold_sweeps}
            else:
                up = sf.update(w32)
                rec = {"action": up.action, "re": up.re_est, "sweeps": up.sweeps}
            records[name] = {**rec, "seconds": time.perf_counter() - t0}
        self._recompress_log = {"step": step_idx, "weights": records}
        return records

    # -- main loop ---------------------------------------------------------------
    def run(self, resume: bool = True, model: LM | None = None) -> dict:
        """Train up to ``tcfg.steps`` steps; ``model`` (on this trainer's
        device) is trained in place, else one is made from ``tcfg.seed``.
        With ``resume`` the newest intact checkpoint of ``checkpoint_dir``
        is restored into it first (one of another model raises).  Returns
        ``{"model", "opt", "ef", "history"}``."""
        old_handlers = self._install_signal_handlers()
        try:
            if model is None:
                model = LM(self.cfg, seed=self.tcfg.seed, device=self.device)
            if self.mesh is not None and model.mesh is None:
                model.shard_(self.mesh)
            step_fn = make_train_step(model, self.opt_cfg, self.tcfg, self.mesh)
            params = dict(model.named_parameters())
            state = adamw.init_state(params)
            ef = ef_topk_init(params) if self.tcfg.compression is not None else None
            self.state_bytes = state_bytes(model, state, ef)
            data = DataIterator(self.data_cfg)
            start_step = 0
            if resume:
                t0 = time.perf_counter()
                _, extra, latest = self.ckpt.restore_latest(state_tree(model, state, ef),
                                                            state_shardings(model, state, ef))
                if latest is not None:
                    data.restore_state(extra["data"])
                    start_step = latest
                    self.resumed = {"step": latest, "restore_s": time.perf_counter() - t0}
                    log.info("resumed from checkpoint step %d", latest)
            self._loop(model, step_fn, state, ef, data, start_step)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        self.ckpt.wait()
        return {"model": model, "opt": state, "ef": ef, "history": self.history}

    def _loop(self, model: LM, step_fn, state: AdamWState, ef: EFState | None, data: DataIterator,
              start_step: int) -> None:
        from repro_torch.api import last_report

        ewma = None
        for step_idx in range(start_step, self.tcfg.steps):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(data).items()}
            capture = step_idx == start_step and self.faust_dispatch is None
            pre_step = last_report() if capture else None
            t0 = time.monotonic()
            metrics = step_fn(batch, state, ef)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            dt = time.monotonic() - t0
            if capture:
                rep = last_report()
                if rep is not None and rep is not pre_step and rep.grad:
                    self.faust_dispatch = rep
                    log.info("faust training dispatch: %s", rep.reason)
            if ewma is None:
                ewma = dt
            elif dt > self.tcfg.straggler_factor * ewma and step_idx > start_step + 2:
                log.warning("straggler: step %d took %.3fs (EWMA %.3fs)", step_idx, dt, ewma)
                metrics["straggler"] = 1.0
            ewma = 0.9 * ewma + 0.1 * dt
            if self.tcfg.recompress_every and (step_idx + 1) % self.tcfg.recompress_every == 0:
                recs = self._recompress(model, step_idx)
                if recs:
                    metrics["recompress_re"] = max(r["re"] for r in recs.values())
                    log.info("recompress @ step %d: %s", step_idx, {n: round(r["re"], 4) for n, r in recs.items()})
            metrics.update(step=step_idx, step_time_s=dt)
            if not math.isfinite(metrics["loss"]):
                log.warning("step %d: non-finite loss, update skipped", step_idx)
            self.history.append(metrics)
            self._heartbeat(step_idx)
            if (step_idx + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step_idx, metrics["loss"], dt * 1e3)
            if self.mesh is not None:  # a signal on any rank stops every rank after this step
                self._preempted = bool(sum_over(torch.tensor(float(self._preempted), device=self.device), self.mesh))
            if (step_idx + 1) % self.tcfg.checkpoint_every == 0 or self._preempted:
                cost = self.ckpt.save_async(step_idx + 1, state_tree(model, state, ef),
                                            extra={"data": data.checkpoint_state()},
                                            shardings=state_shardings(model, state, ef))
                self.saves.append({"step": step_idx + 1, **cost})
            if self._preempted:
                break
