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

Nothing leaves the device: the step count lives on the parameters'
device, and the schedule and bias corrections are computed there once
per step.  ``apply_updates(ok=)`` is the NaN guard as the reference writes
it (``jnp.where``): where ``ok`` is false the parameters, the moments and
the step count keep their values, with no host sync.

The update is elementwise, so it runs on each parameter in flat slices of
``UPDATE_SLICE`` elements, one clipped gradient at a time: the same bits as
one pass, with f32 temporaries of one slice rather than of the largest
parameter (a 1.41 G-entry embedding would otherwise need ≈ 28 GB of them
on top of the optimizer state).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch

UPDATE_SLICE = 1 << 26  # elements of a parameter updated at once


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
    step: torch.Tensor  # int32, 0-d, on the parameters' device


def init_state(params: dict) -> AdamWState:
    """f32 zero moments for every floating parameter, step 0."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    floats = {k: p for k, p in params.items() if p.is_floating_point()}
    dev = next(iter(floats.values())).device if floats else torch.device("cpu")
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return AdamWState({k: z(p) for k, p in floats.items()}, {k: z(p) for k, p in floats.items()}, step)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (f32, on
    ``step``'s device when it is a tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(grads: dict) -> torch.Tensor:
    """The f32 norm of every floating tensor of ``grads`` together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values() if g.is_floating_point()))


class _Scaled(Mapping):
    """``grads`` with each floating tensor times ``scale``, multiplied when
    it is read: one clipped gradient is alive at a time."""

    def __init__(self, grads: dict, scale: torch.Tensor):
        self._grads, self._scale = grads, scale

    def __getitem__(self, key):
        g = self._grads[key]
        return g * self._scale.to(g.dtype) if g.is_floating_point() else g

    def __iter__(self):
        return iter(self._grads)

    def __len__(self) -> int:
        return len(self._grads)


def clip_by_global_norm(grads: dict, max_norm: float, norm: torch.Tensor | None = None) -> tuple[Mapping, torch.Tensor]:
    """``(grads · min(1, max_norm / ‖grads‖), ‖grads‖)``: non-floating
    tensors pass through untouched.  ``norm`` is the global norm to clip by
    (default: :func:`global_norm` of ``grads``).  The clipped gradients are
    a read-only mapping that scales each tensor as it is read."""
    norm = global_norm(grads) if norm is None else norm
    return _Scaled(grads, torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState, ok=None,
                  grad_norm: torch.Tensor | None = None) -> dict:
    """One step in place on ``params`` and ``state``; returns
    ``{"grad_norm", "lr"}``.  ``grads`` holds a gradient for every key of
    ``state.mu``.  ``ok`` (a 0-d bool tensor on the parameters' device,
    default true) applies the step only where it holds: otherwise the
    moments decay by 1 and take no gradient, the parameters move by 0 and
    the step count stays, so every tensor keeps its bits.  ``grad_norm``
    is the global norm to clip by (default: :func:`global_norm` of
    ``grads``; a mesh passes the norm of the whole gradients, whose blocks
    ``grads`` holds)."""
    clipped, gnorm = clip_by_global_norm({k: grads[k] for k in state.mu}, cfg.grad_clip, grad_norm)
    dev = state.step.device
    ok = torch.ones((), dtype=torch.bool, device=dev) if ok is None else ok

    def pick(on: float, off: float) -> torch.Tensor:  # device constants, no host copy
        full = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
        return torch.where(ok, full(on), full(off))

    step = state.step + 1
    lr = schedule(cfg, step)
    s32 = step.to(torch.float32)
    b1c = 1 - cfg.b1**s32
    b2c = 1 - cfg.b2**s32
    d1, c1, d2, c2 = pick(cfg.b1, 1.0), pick(1 - cfg.b1, 0.0), pick(cfg.b2, 1.0), pick(1 - cfg.b2, 0.0)
    lr_eff = torch.where(ok, lr, 0.0)
    for k in state.mu:
        g = clipped[k]  # clipped, one parameter at a time
        flat = params[k].view(-1), state.mu[k].view(-1), state.nu[k].view(-1), g.reshape(-1)
        for a in range(0, flat[0].numel(), UPDATE_SLICE):
            p, mu, nu, gs = (t[a:a + UPDATE_SLICE] for t in flat)
            g32 = torch.where(ok, gs.float(), 0.0)
            mu.mul_(d1).add_(c1 * g32)
            nu.mul_(d2).add_(c2 * g32 * g32)
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr_eff * delta).to(p.dtype))
    state.step = torch.where(ok, step, state.step)
    return {"grad_norm": gnorm, "lr": lr}
