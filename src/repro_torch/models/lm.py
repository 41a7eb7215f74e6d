"""Decoder LM in train mode.  Counterpart of :mod:`repro.models.lm`
(``_layer_init``, ``init_model``, ``_apply_layer``, ``_run_stages``,
``_embed_tokens``, ``_logits``, ``forward_train``, ``train_loss``) for the
dense ``"attn"`` layer kind.

The reference stacks every layer's parameters on a leading axis and scans
over them; here the layers are an ``nn.ModuleList`` run in a Python loop,
each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
reference's ``jax.checkpoint`` of the scan body).  State dict keys mirror
the reference's parameter paths with the stack unrolled:
``embed.table``, ``layers.{i}.norm1``, ``layers.{i}.attn.wq``,
``layers.{i}.mlp.w_up`` (or ``...w_up.factors.{f}.values`` with
``faust_mlp``), ``final_norm``, ``unembed.w`` or ``unembed.faust...``;
:mod:`repro_torch.bridge` maps one onto the other.  Prefill, decode, the
other layer kinds and the modality front ends come with later slices
(:func:`repro_torch.configs.base.check_supported`).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, check_supported
from repro_torch.device import resolve_device
from repro_torch.layers.attention import Attention, AttnSpec
from repro_torch.layers.embedding import Embedding, Unembed, unembed_apply
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import apply_norm, norm_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def attn_spec(cfg: ArchConfig) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_base=cfg.rope_base,
        qk_norm=cfg.qk_norm,
        scale=cfg.attn_scale,
    )


class Layer(nn.Module):
    """One ``"attn"`` layer: norm → attention → residual, norm → MLP → residual."""

    def __init__(self, cfg: ArchConfig, *, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.attn = Attention(cfg.d_model, attn_spec(cfg), **kw)
        self.norm2 = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, faust=cfg.faust_mlp, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg.norm, self.norm1, x)
        x = x + self.attn(h, cfg.attn_chunk).to(x.dtype)
        h = apply_norm(cfg.norm, self.norm2, x)
        return x + self.mlp(h).to(x.dtype)


class LM(nn.Module):
    """The model of ``cfg`` with parameters drawn from ``seed`` on ``device``
    (default: the CUDA card)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=gen, dtype=dtype, device=dev)
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw) for _ in cfg.layer_kinds())
        self.final_norm = norm_params(cfg.norm, cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(cfg.d_model, cfg.vocab, cfg.faust_unembed, **kw)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens).to(DTYPES[self.cfg.dtype])
        if self.cfg.scale_embed:
            x = x * math.sqrt(self.cfg.d_model)  # a Python float keeps x's dtype
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        tied = self.embed.table if self.cfg.tie_embeddings else None
        return unembed_apply(getattr(self, "unembed", None), x, tied).float()

    def forward_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """f32 logits ``(B, S, vocab)`` of ``tokens (B, S)``."""
        x = self._embed_tokens(tokens)
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        x = apply_norm(self.cfg.norm, self.final_norm, x)
        return self._logits(x)

    def train_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy: ``(loss, {"loss", "ce", "aux"})``."""
        tokens = batch["tokens"]
        logits = self.forward_train(tokens)
        labels = tokens[:, 1:].long()
        lg = logits[:, :-1]
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        ce = torch.mean(lse - gold)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
