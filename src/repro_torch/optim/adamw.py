"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule.  Counterpart of :mod:`repro.optim.adamw`.

The reference's update rule written on tensors (not ``torch.optim.AdamW``,
whose decay and epsilon placement differ): moments are f32 whatever the
parameter dtype, ``delta = m̂ / (sqrt(v̂) + eps) + wd · p``, and
``p ← p − lr · delta`` computed in f32 and cast back.  Parameters are a
``{name: tensor}`` dict; only floating tensors are updated (a FaustLinear's
``in_idx`` buffers are not parameters).  Updates are in place, under
``no_grad``, so the version counters of the parameters move (a cached
packed chain sees the step).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    step: int = 0


def init_state(params: dict) -> AdamWState:
    """f32 zero moments for every floating parameter."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    floats = {k: p for k, p in params.items() if p.is_floating_point()}
    return AdamWState({k: z(p) for k, p in floats.items()}, {k: z(p) for k, p in floats.items()}, 0)


def schedule(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (f32)."""
    s = torch.tensor(step, dtype=torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState) -> dict:
    """One step in place on ``params`` and ``state``; returns
    ``{"grad_norm", "lr"}``.  ``grads`` holds a gradient for every key of
    ``state.mu``."""
    grads, gnorm = clip_by_global_norm({k: grads[k] for k in state.mu}, cfg.grad_clip)
    state.step += 1
    step = torch.tensor(state.step, dtype=torch.float32)
    lr = schedule(cfg, state.step)
    b1c = 1 - cfg.b1**step
    b2c = 1 - cfg.b2**step
    for k, g in grads.items():
        p, mu, nu = params[k], state.mu[k], state.nu[k]
        g32 = g.float()
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        delta = (mu / b1c.to(mu.device)) / (torch.sqrt(nu / b2c.to(nu.device)) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr.to(p.device) * delta).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
