"""RMSNorm (gemma's ``1 + w``) and LayerNorm, f32 math.  Counterpart of
:mod:`repro.layers.norms`."""
from __future__ import annotations

import torch
from torch import nn


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5, zero_centered: bool = True) -> torch.Tensor:
    """LayerNorm over ``p["scale"]``/``p["bias"]``; ``zero_centered`` stores
    gamma − 1 (nemotron's layernorm1p)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    g = p["scale"].float()
    g = 1.0 + g if zero_centered else g
    return (y * g + p["bias"].float()).to(x.dtype)


def norm_params(kind: str, dim: int, dtype, device):
    """Zero-initialized norm parameters: one vector (rms) or scale and bias."""
    if kind == "rms":
        return nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device))
    if kind in ("ln", "ln1p"):
        return nn.ParameterDict({
            "scale": nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device)),
            "bias": nn.Parameter(torch.zeros((dim,), dtype=dtype, device=device)),
        })
    raise ValueError(kind)


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(p, x)
    if kind in ("ln", "ln1p"):
        return layernorm(p, x, zero_centered=True)
    raise ValueError(kind)
