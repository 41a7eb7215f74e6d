"""The fault-tolerant training loop.  Counterpart of
:mod:`repro.runtime.trainer` (``TrainConfig``, ``make_train_step``,
``Trainer``).

Kept from the reference:

* microbatch gradient accumulation (f32 sums);
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

Meshes come with the multi-GPU slice and raise.
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
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.optim.compression import EFState, TopKConfig, ef_topk_compress, ef_topk_init

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


def make_train_step(model: LM, opt_cfg: AdamWConfig, tcfg: TrainConfig):
    """``step(batch, state, ef=None) -> metrics``: loss and gradients
    (accumulated in f32 over ``tcfg.microbatches``), EF top-k compression
    when ``ef`` is given, then :func:`guarded_update`.  The metrics are
    device tensors."""
    params = {k: p for k, p in model.named_parameters()}

    def step(batch: dict, state: AdamWState, ef: EFState | None = None) -> dict:
        n = tcfg.microbatches
        tokens = batch["tokens"]
        if n > 1:
            if tokens.shape[0] % n:
                raise ValueError(f"batch {tokens.shape[0]} does not split into {n} microbatches")
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for mb in tokens.chunk(n):
                for p in params.values():
                    p.grad = None
                mb_loss, _ = model.train_loss({"tokens": mb})
                mb_loss.backward()
                for k, p in params.items():
                    acc[k] += p.grad.float()
                loss = loss + mb_loss.detach()
            grads, loss = {k: a / n for k, a in acc.items()}, loss / n
        else:
            for p in params.values():
                p.grad = None
            loss, _ = model.train_loss({"tokens": tokens})
            loss.backward()
            loss = loss.detach()
            grads = {k: p.grad for k, p in params.items()}
        for p in params.values():
            p.grad = None
        metrics = {}
        if ef is not None:
            grads, _, cm = ef_topk_compress(tcfg.compression, grads, ef, ok=torch.isfinite(loss))
            metrics.update(cm)
        return {**metrics, **guarded_update(opt_cfg, params, grads, state, loss)}

    return step


def guarded_update(opt_cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState,
                   loss: torch.Tensor) -> dict:
    """AdamW where ``loss`` is finite, nothing where it is not, decided on
    the device (no host sync).  Returns the metrics as device tensors,
    ``skipped`` 1.0 for a skipped update."""
    ok = torch.isfinite(loss)
    metrics = {"loss": loss, **adamw.apply_updates(opt_cfg, params, grads, state, ok=ok)}
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


def reference_name(key: str) -> str | None:
    """The reference's slash-joined tree path of the port's parameter
    ``key`` (``embed.table`` → ``embed/table``), or None for a layer's: the
    reference stacks each stage's layers, so its per-layer weights are
    never 2-D and never recompressed."""
    return None if key.startswith("layers.") else key.replace(".", "/")


class Trainer:
    """Trains ``LM(cfg)`` on the synthetic stream of ``data_cfg`` on
    ``device`` (default: the CUDA card)."""

    def __init__(
        self,
        cfg: ArchConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig = AdamWConfig(),
        tcfg: TrainConfig = TrainConfig(),
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError("training on a mesh comes with the multi-GPU slice of the port")
        self.cfg, self.data_cfg, self.opt_cfg, self.tcfg = cfg, data_cfg, opt_cfg, tcfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
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
        selector, by that path."""
        out = {}
        for key, p in model.named_parameters():
            name = reference_name(key)
            if name is None or p.ndim != 2 or not p.is_floating_point():
                continue
            if any(sub in name for sub in self.tcfg.recompress_targets):
                out[name] = p
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
            step_fn = make_train_step(model, self.opt_cfg, self.tcfg)
            params = dict(model.named_parameters())
            state = adamw.init_state(params)
            ef = ef_topk_init(params) if self.tcfg.compression is not None else None
            data = DataIterator(self.data_cfg)
            start_step = 0
            if resume:
                t0 = time.perf_counter()
                _, extra, latest = self.ckpt.restore_latest(state_tree(model, state, ef))
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
            if (step_idx + 1) % self.tcfg.checkpoint_every == 0 or self._preempted:
                cost = self.ckpt.save_async(step_idx + 1, state_tree(model, state, ef),
                                            extra={"data": data.checkpoint_state()})
                self.saves.append({"step": step_idx + 1, **cost})
            if self._preempted:
                break
