"""Rotary position embeddings: half-split convention, f32 rotation.
Counterpart of :mod:`repro.layers.rope`."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, rotary_dim: int, base: float, device=None) -> torch.Tensor:
    """Inverse frequencies of the rotated sub-dimension, ``(rotary_dim // 2,)``."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    return 1.0 / (base**exponent)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, rotary_dim: int | None = None, base: float = 10000.0
) -> torch.Tensor:
    """Rotate ``x (..., seq, heads, head_dim)`` by ``positions (..., seq)``."""
    head_dim = x.shape[-1]
    rotary_dim = head_dim if rotary_dim is None else rotary_dim
    if rotary_dim % 2 or rotary_dim > head_dim:
        raise ValueError(f"rotary_dim {rotary_dim} must be even and at most {head_dim}")
    inv_freq = rope_frequencies(head_dim, rotary_dim, base, device=x.device)
    angles = positions.float()[..., None] * inv_freq  # (..., S, rd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, rd/2)
    sin = torch.sin(angles)[..., None, :]
    xr = x[..., :rotary_dim].float()
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    if rotary_dim == head_dim:
        return rotated
    return torch.cat([rotated, x[..., rotary_dim:]], dim=-1)
