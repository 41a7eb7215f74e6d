"""Token embedding and the unembedding (dense, FAµST or tied).
Counterpart of :mod:`repro.layers.embedding`."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.layers.faust_linear import FaustLinear, FaustSpec


def dense_param(in_dim: int, out_dim: int, *, generator, dtype, device, scale: float = 1.0) -> nn.Parameter:
    """LeCun-normal dense kernel ``(in, out)``: std ``scale/sqrt(in)``
    (``repro.layers.param.dense_init``), drawn on ``generator``'s device."""
    w = torch.randn((in_dim, out_dim), generator=generator, dtype=torch.float32, device=generator.device)
    return nn.Parameter((w * (scale / math.sqrt(in_dim))).to(device=device, dtype=dtype))


class Embedding(nn.Module):
    """``table (vocab, d_model)`` of N(0, 1) values."""

    def __init__(self, vocab: int, d_model: int, *, generator, dtype, device):
        super().__init__()
        t = torch.randn((vocab, d_model), generator=generator, dtype=torch.float32, device=generator.device)
        self.table = nn.Parameter(t.to(device=device, dtype=dtype))

    def forward(self, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
        x = self.table[tokens.long()]
        if scale_by_sqrt_dim:
            x = x * math.sqrt(self.table.shape[-1])
        return x


class Unembed(nn.Module):
    """Logits ``(..., vocab)``: ``x @ w``, or a :class:`FaustLinear` (``faust``)."""

    def __init__(self, d_model: int, vocab: int, faust: FaustSpec | None, *, generator, dtype, device):
        super().__init__()
        if faust is None:
            self.w = dense_param(d_model, vocab, generator=generator, dtype=dtype, device=device)
        else:
            self.faust = FaustLinear(d_model, vocab, faust, generator=generator, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "faust"):
            return self.faust(x)
        return x @ self.w


def unembed_apply(unembed: Unembed | None, x: torch.Tensor, tied_table: torch.Tensor | None = None) -> torch.Tensor:
    """Logits; ``tied_table`` (the embedding table) overrides ``unembed``."""
    if tied_table is not None:
        return x @ tied_table.T
    return unembed(x)
