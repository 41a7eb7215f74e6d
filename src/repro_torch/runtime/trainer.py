"""The training loop.  Counterpart of :mod:`repro.runtime.trainer`
(``TrainConfig``, ``make_train_step``, ``Trainer``).

Kept from the reference: microbatch gradient accumulation (f32 sums), the
NaN/Inf guard (a non-finite loss skips the update and leaves the
optimizer state as it was; decided on the device, as the reference's
``jnp.where``, so the step never waits for the host), the per-step
wall-time EWMA that flags
stragglers, the heartbeat file, and ``Trainer.faust_dispatch``: the FAµST
backend decision the first step made, captured when it was priced for
training (``DispatchReport.grad``).

Later slices: checkpointing (``checkpoint/manager.py``), error-feedback
gradient compression (``optim/compression.py``), in-training
recompression (``recompress_every``) and meshes.  A config that asks for
one raises ``NotImplementedError`` naming it; ``checkpoint_every`` larger
than ``steps`` never reaches a save and is accepted.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState

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
    compression: Any = None
    seed: int = 0
    recompress_every: int = 0
    recompress_targets: tuple = ("unembed", "embed/table")
    recompress_spec: Any = None
    recompress_cfg: Any = None


def check_train_config(tcfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if tcfg.checkpoint_every <= tcfg.steps:
        raise NotImplementedError(
            f"checkpoint_every={tcfg.checkpoint_every} would save within {tcfg.steps} steps: "
            "checkpointing (checkpoint/manager.py) comes with a later slice of the port"
        )
    if tcfg.compression is not None:
        raise NotImplementedError("error-feedback gradient compression (optim/compression.py) comes with a later slice")
    if tcfg.recompress_every:
        raise NotImplementedError("in-training recompression (recompress_every, streaming) comes with a later slice")


def make_train_step(model: LM, opt_cfg: AdamWConfig, tcfg: TrainConfig):
    """``step(batch, state) -> metrics``: loss and gradients (accumulated
    in f32 over ``tcfg.microbatches``), then :func:`guarded_update`.  The
    metrics are device tensors."""
    params = {k: p for k, p in model.named_parameters()}

    def step(batch: dict, state: AdamWState) -> dict:
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
        return guarded_update(opt_cfg, params, grads, state, loss)

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
        check_train_config(tcfg)
        self.cfg, self.data_cfg, self.opt_cfg, self.tcfg = cfg, data_cfg, opt_cfg, tcfg
        self.device = resolve_device(device)
        self.history: list[dict] = []
        # the FAµST backend decision of the first step, when it was priced
        # for training (repro_torch.api.dispatch, grad=True)
        self.faust_dispatch = None

    def _heartbeat(self, step: int) -> None:
        if self.tcfg.heartbeat_path:
            with open(self.tcfg.heartbeat_path, "w") as f:
                f.write(json.dumps({"step": step, "t": time.time()}))

    def run(self, resume: bool = False, model: LM | None = None) -> dict:
        """Train for ``tcfg.steps`` steps; ``model`` (on this trainer's
        device) is trained in place, else one is made from ``tcfg.seed``.
        Returns ``{"model", "opt", "history"}``."""
        from repro_torch.api import last_report

        if resume:
            raise NotImplementedError("resuming needs checkpointing, which comes with a later slice of the port")
        if model is None:
            model = LM(self.cfg, seed=self.tcfg.seed, device=self.device)
        step_fn = make_train_step(model, self.opt_cfg, self.tcfg)
        state = adamw.init_state(dict(model.named_parameters()))
        data = DataIterator(self.data_cfg)
        ewma = None
        for step_idx in range(self.tcfg.steps):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(data).items()}
            capture = step_idx == 0 and self.faust_dispatch is None
            pre_step = last_report() if capture else None
            t0 = time.monotonic()
            metrics = step_fn(batch, state)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            dt = time.monotonic() - t0
            if capture:
                rep = last_report()
                if rep is not None and rep is not pre_step and rep.grad:
                    self.faust_dispatch = rep
                    log.info("faust training dispatch: %s", rep.reason)
            if ewma is None:
                ewma = dt
            elif dt > self.tcfg.straggler_factor * ewma and step_idx > 2:
                log.warning("straggler: step %d took %.3fs (EWMA %.3fs)", step_idx, dt, ewma)
                metrics["straggler"] = 1.0
            ewma = 0.9 * ewma + 0.1 * dt
            metrics.update(step=step_idx, step_time_s=dt)
            if not math.isfinite(metrics["loss"]):
                log.warning("step %d: non-finite loss, update skipped", step_idx)
            self.history.append(metrics)
            self._heartbeat(step_idx)
            if (step_idx + 1) % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step_idx, metrics["loss"], dt * 1e3)
        return {"model": model, "opt": state, "history": self.history}
