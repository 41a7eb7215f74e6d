"""Attention in train mode: MQA/GQA projections, rotary, and chunked
online-softmax attention in f32.  Counterpart of the train path of
:mod:`repro.layers.attention` (``attn_init``, ``_mask_bias``,
``_gqa_scores``, ``flash_attention_ref``, ``attn_qkv``, ``attn_train``).

Plain PyTorch: the reference computes attention outside any Pallas
kernel.  The softmax runs over chunks of ``chunk`` keys with a running
max and sum, so the logits held at once are ``(B, KH, G, S, chunk)``.
Sliding windows, KV caches and decode come with later slices.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.layers.embedding import dense_param
from repro_torch.layers.norms import rmsnorm
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_base: float = 10000.0
    rotary_dim: int | None = None
    window: int | None = None
    qk_norm: bool = False
    scale: float | None = None
    use_rope: bool = True


class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` as ``(in, out)`` parameters (the
    reference's layout), plus ``q_norm``/``k_norm`` with ``qk_norm``."""

    def __init__(self, d_model: int, spec: AttnSpec, *, generator, dtype, device):
        super().__init__()
        self.spec = spec
        h, kh, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = dense_param(d_model, h * d, **kw)
        self.wk = dense_param(d_model, kh * d, **kw)
        self.wv = dense_param(d_model, kh * d, **kw)
        self.wo = dense_param(h * d, d_model, **kw)
        if spec.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros((d,), dtype=dtype, device=device))
            self.k_norm = nn.Parameter(torch.zeros((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        return attn_train(self, x, self.spec, chunk)


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    """``(..., Sq, Skv)`` additive bias from position comparisons."""
    q, k = q_pos[..., :, None], kv_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    return torch.where(ok, 0.0, NEG_INF)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``q (B,Sq,KH,G,D) · k (B,C,KH,D) → (B,KH,G,Sq,C)`` in f32."""
    return torch.einsum("bqhgd,bchd->bhgqc", q.float(), k.float()) * scale


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Chunked stable-softmax attention: ``q (B,Sq,H,D)``, ``k``/``v``
    ``(B,Skv,KH,D)`` with ``H = KH·G``.  Returns ``(B,Sq,H,D)`` in q's dtype."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = d**-0.5 if scale is None else scale
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"key length {skv} is not a multiple of the chunk {chunk}")
    qg = q.reshape(b, sq, kh, g, d)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kch, vch = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _gqa_scores(qg, kch, scale) + _mask_bias(q_positions, kv_positions[c0:c0 + chunk], causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # p rounds to v's dtype before the product, as the reference
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype).float(), vch.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attn_qkv(p: Attention, x: torch.Tensor, spec: AttnSpec, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kh, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ p.wq).reshape(b, s, h, d)
    k = (x @ p.wk).reshape(b, s, kh, d)
    v = (x @ p.wv).reshape(b, s, kh, d)
    if spec.qk_norm:
        q, k = rmsnorm(p.q_norm, q), rmsnorm(p.k_norm, k)
    if spec.use_rope:
        q = apply_rope(q, positions, rotary_dim=spec.rotary_dim, base=spec.rope_base)
        k = apply_rope(k, positions, rotary_dim=spec.rotary_dim, base=spec.rope_base)
    return q, k, v


def attn_train(p: Attention, x: torch.Tensor, spec: AttnSpec, chunk: int = 512) -> torch.Tensor:
    """Causal self-attention over a full sequence."""
    if spec.window is not None:
        raise NotImplementedError("sliding-window attention (the local layer kind) comes with a later slice")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = attn_qkv(p, x, spec, positions)
    o = flash_attention_ref(q, k, v, q_positions=positions, kv_positions=positions, causal=True,
                            scale=spec.scale, chunk=min(chunk, s))
    return o.reshape(b, s, -1) @ p.wo
