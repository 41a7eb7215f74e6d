"""Decoder LM: training and serving.  Counterpart of :mod:`repro.models.lm`
(``_layer_init``, ``init_model``, ``_apply_layer``, ``_run_stages``,
``_embed_tokens``, ``_logits``, ``forward_train``, ``train_loss``,
``make_caches``, ``gather_cache_slots``, ``scatter_cache_slots``,
``prefill``, ``decode_step``, ``greedy_token``) for the dense ``"attn"``
layer kind.

The reference stacks every layer's parameters on a leading axis and scans
over them; here the layers are an ``nn.ModuleList`` run in a Python loop,
each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
reference's ``jax.checkpoint`` of the scan body).  State dict keys mirror
the reference's parameter paths with the stack unrolled:
``embed.table``, ``layers.{i}.norm1``, ``layers.{i}.attn.wq``,
``layers.{i}.mlp.w_up`` (or ``...w_up.factors.{f}.values`` with
``faust_mlp``), ``final_norm``, ``unembed.w`` or ``unembed.faust...``;
:mod:`repro_torch.bridge` maps one onto the other.  The other layer kinds
and the modality front ends come with later slices
(:func:`repro_torch.configs.base.check_supported`).

Serving: :func:`make_caches` gives one :class:`KVCache` per layer in a
list (the layers are unrolled, so there is no repeat axis); the batch axis
of every cache tensor, axis 0, is the serving engine's *slot* axis, where
the reference's stacked caches have it at axis 1 (``_CACHE_BATCH_AXIS``).
:meth:`LM.prefill` returns the last position's logits and the filled
caches; :meth:`LM.decode_step` feeds one token per row, each row at its
own cache position.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, check_supported
from repro_torch.device import resolve_device
from repro_torch.layers.attention import Attention, AttnSpec, KVCache, attn_decode, attn_prefill, kv_cache_init
from repro_torch.layers.embedding import Embedding, Unembed, unembed_apply
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import apply_norm, norm_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


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

    def forward(self, x: torch.Tensor, mode: str = TRAIN, cache: KVCache | None = None,
                chunk: int | None = None):
        """``(x, new cache)``: ``mode`` train (no cache), prefill (fills
        ``cache``) or decode (one token per row into ``cache``)."""
        cfg = self.cfg
        chunk = cfg.attn_chunk if chunk is None else chunk
        h = apply_norm(cfg.norm, self.norm1, x)
        if mode == TRAIN:
            y = self.attn(h, chunk)
        elif mode == PREFILL:
            y, cache = attn_prefill(self.attn, h, self.attn.spec, cache, chunk)
        elif mode == DECODE:
            y, cache = attn_decode(self.attn, h, self.attn.spec, cache)
        else:
            raise ValueError(f"mode must be {TRAIN!r}, {PREFILL!r} or {DECODE!r}; got {mode!r}")
        x = x + y.to(x.dtype)
        h = apply_norm(cfg.norm, self.norm2, x)
        return x + self.mlp(h).to(x.dtype), cache


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

    def forward_train(self, tokens: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
        """f32 logits ``(B, S, vocab)`` of ``tokens (B, S)``; ``chunk`` is
        attention's key chunk (default ``cfg.attn_chunk``: a sequence longer
        than it must be a multiple of it)."""
        x = self._embed_tokens(tokens)
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, TRAIN, None, chunk, use_reentrant=False)[0]
            else:
                x = layer(x, TRAIN, None, chunk)[0]
        x = apply_norm(self.cfg.norm, self.final_norm, x)
        return self._logits(x)

    def _run(self, x: torch.Tensor, mode: str, caches: list[KVCache]):
        new = []
        for layer, cache in zip(self.layers, caches, strict=True):
            x, cache = layer(x, mode, cache)
            new.append(cache)
        return apply_norm(self.cfg.norm, self.final_norm, x), new

    def prefill(self, tokens: torch.Tensor, caches: list[KVCache]):
        """``tokens (B, S)`` through the model into ``caches``: the last
        position's f32 logits ``(B, 1, vocab)`` and the filled caches."""
        x, new = self._run(self._embed_tokens(tokens), PREFILL, caches)
        return self._logits(x[:, -1:]), new

    def decode_step(self, tokens: torch.Tensor, caches: list[KVCache]):
        """One token per row, ``tokens (B, 1)``, each row at its cache's
        position: f32 logits ``(B, 1, vocab)`` and the new caches."""
        x, new = self._run(self._embed_tokens(tokens), DECODE, caches)
        return self._logits(x), new

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


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def make_caches(cfg: ArchConfig, batch: int, cache_len: int, dtype=torch.bfloat16, device=None) -> list[KVCache]:
    """One empty :class:`KVCache` of ``batch`` rows and capacity
    ``cache_len`` per layer, on ``device`` (default: the CUDA card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [kv_cache_init(batch, cache_len, cfg.n_kv_heads, cfg.head_dim, dtype, dev) for _ in cfg.layer_kinds()]


def gather_cache_slots(caches: list[KVCache], slot_idx: torch.Tensor) -> list[KVCache]:
    """The rows ``slot_idx (B,)`` of a slot pool, as a live-batch cache
    list with batch ``len(slot_idx)`` (a copy)."""
    return [KVCache(*(t.index_select(0, slot_idx) for t in c)) for c in caches]


def scatter_cache_slots(pool: list[KVCache], caches: list[KVCache], slot_idx: torch.Tensor) -> list[KVCache]:
    """Write a live-batch cache list into the pool rows ``slot_idx``, in
    place (the pool's owner hands it over, as the reference donates its
    buffer), and return the pool."""
    for p, c in zip(pool, caches, strict=True):
        for dst, src in zip(p, c):
            dst.index_copy_(0, slot_idx, src.to(dst.dtype))
    return pool


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
