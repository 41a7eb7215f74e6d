"""Token embedding and the unembedding (dense, FAµST or tied).
Counterpart of :mod:`repro.layers.embedding`, with the reference's
per-codebook stacking (``repro.models.lm._init_annotated``): ``n`` tables
``(n, vocab, d_model)`` and ``n`` heads, each applied on its own.  On a
mesh whose policy splits the vocabulary a head computes its rank's block
of the logits (:meth:`Unembed.forward` ``split=``)."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.layers.faust_linear import FaustLinear, FaustSpec, StackedFaustLinear


def dense_param(in_dim: int, out_dim: int, *, generator, dtype, device, scale: float = 1.0) -> nn.Parameter:
    """LeCun-normal dense kernel ``(in, out)``: std ``scale/sqrt(in)``
    (``repro.layers.param.dense_init``), drawn on ``generator``'s device."""
    w = torch.randn((in_dim, out_dim), generator=generator, dtype=torch.float32, device=generator.device)
    return nn.Parameter((w * (scale / math.sqrt(in_dim))).to(device=device, dtype=dtype))


class Embedding(nn.Module):
    """``table (vocab, d_model)`` of N(0, 1) values, or with ``n > 1``
    codebooks ``table (n, vocab, d_model)``, one table per codebook."""

    def __init__(self, vocab: int, d_model: int, *, generator, dtype, device, n: int = 1):
        super().__init__()
        shape = (vocab, d_model) if n == 1 else (n, vocab, d_model)
        t = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
        self.table = nn.Parameter(t.to(device=device, dtype=dtype))

    def forward(self, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
        """``tokens (...)`` → ``(..., d_model)``; with codebooks ``tokens
        (B, n, S)`` → ``(B, S, d_model)``, the sum over the codebooks of
        ``table[k, tokens[b, k, s]]`` in the table's dtype."""
        if self.table.ndim == 3:
            k = torch.arange(self.table.shape[0], device=tokens.device)[None, :, None]
            return self.table[k, tokens.long()].sum(dim=1)
        x = self.table[tokens.long()]
        if scale_by_sqrt_dim:
            x = x * math.sqrt(self.table.shape[-1])
        return x


class Unembed(nn.Module):
    """Logits ``(..., vocab)``: ``x @ w``, or a :class:`FaustLinear`
    (``faust``).  With ``n > 1`` heads (one per codebook) the parameters
    are stacked, ``w (n, d_model, vocab)`` or a :class:`StackedFaustLinear`,
    and ``forward(x, head)`` applies one of them."""

    def __init__(self, d_model: int, vocab: int, faust: FaustSpec | None, *, generator, dtype, device, n: int = 1):
        super().__init__()
        self.n = n
        if faust is None:
            ws = [dense_param(d_model, vocab, generator=generator, dtype=dtype, device=device) for _ in range(n)]
            self.w = ws[0] if n == 1 else nn.Parameter(torch.stack([w.detach() for w in ws]))
        elif n == 1:
            self.faust = FaustLinear(d_model, vocab, faust, generator=generator, dtype=dtype, device=device)
        else:
            self.faust = StackedFaustLinear(d_model, vocab, faust, n, generator=generator, dtype=dtype,
                                            device=device)

    def forward(self, x: torch.Tensor, head: int | None = None, split=None) -> torch.Tensor:
        """Logits of ``x`` (``head``: one of ``n`` heads).  ``split`` (a
        :class:`~repro_torch.distributed.layout.TPSplit`): the parameters
        are this rank's vocabulary block, and so are the logits."""
        if self.n > 1:
            return self.faust(x, head) if hasattr(self, "faust") else x @ self.w[head]
        if split is not None:
            x = split.enter(x)
            return self.faust(x, split=split) if hasattr(self, "faust") else x @ self.w
        if hasattr(self, "faust"):
            return self.faust(x)
        return x @ self.w


def unembed_apply(unembed: Unembed | None, x: torch.Tensor, tied_table: torch.Tensor | None = None) -> torch.Tensor:
    """Logits; ``tied_table`` (the embedding table) overrides ``unembed``."""
    if tied_table is not None:
        return x @ tied_table.T
    return unembed(x)
