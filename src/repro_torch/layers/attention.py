"""Attention: MQA/GQA projections, rotary, chunked online-softmax
attention in f32, and decode over per-row KV caches.  Counterpart of
:mod:`repro.layers.attention` (``attn_init``, ``_mask_bias``,
``_gqa_scores``, ``flash_attention_ref``, ``decode_attention``,
``banded_attention_ref``, ``KVCache`` and its functions, ``attn_qkv``,
``attn_train``, ``attn_prefill``, ``attn_decode``).

Plain PyTorch: the reference computes attention outside any Pallas
kernel.  The softmax runs over chunks of ``chunk`` keys with a running
max and sum, so the logits held at once are ``(B, KH, G, S, chunk)``.

A :class:`KVCache` holds ``(B, KH, capacity, D)`` keys and values (the
dot-native layout: decode reads it without a transpose) and a per-row
``pos (B,)``, the tokens each row has seen, so the serving engine's pool
rows decode at independent positions.  A capacity below the sequence is a
ring buffer (token ``p`` in slot ``p % capacity``).  The cache functions
return new caches and leave their inputs as they were, as the reference's.
A sliding window shorter than the sequence (the ``local`` layer kind) runs
the banded form, each query chunk against its band of ``window + chunk``
keys, in O(S·(window + chunk)).  On a mesh whose policy splits the
sequence, a rank computes its chunk of the positions against the keys and
values of all of them (:func:`gather_kv`), the window as a mask.

Served on a mesh whose decode policy splits the cache's positions
(``kv_seq``), a rank's :class:`KVCache` holds only its block of them, the
positions ``[seq.start, seq.start + seq.local)`` of the whole capacity
``seq.length`` (``seq`` a :class:`~repro_torch.distributed.layout.
SeqSplit`; such a cache is never a ring).  A prefill keeps the block's
part of the sequence, a decode step writes the new token only on the rank
whose block holds its position, and :func:`decode_attention_split`
attends over the block and merges the blocks by log-sum-exp over the
group (:func:`merge_blocks`); :func:`decode_attention`, over the whole
cache, is its plain version.

Split over the heads (:class:`HeadSplit`, training under a policy whose
``heads_act`` names the axes the projections' heads lie on): a rank
computes its ``h/n`` query heads with its columns of ``wq`` and the KV
heads they read, either its columns of ``wk``/``wv`` (``n`` divides the KV
heads) or, by GQA's group map, the one KV head its query heads share,
from the whole projection; its rows of ``wo`` give a partial output that
the split sums (``distributed/layout.py`` :class:`TPSplit`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """A rank's heads (module docstring): the split ``tp`` (a
    :class:`~repro_torch.distributed.layout.TPSplit`), its ``heads`` query
    heads from ``heads · tp.index``, its ``kv`` KV heads from ``kv_lo``,
    and whether ``wk``/``wv`` hold just those (``kv_kept``) or whole."""

    tp: object
    heads: int
    kv_lo: int
    kv: int
    kv_kept: bool


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

    def forward(self, x: torch.Tensor, chunk: int = 512, seq=None, heads: HeadSplit | None = None) -> torch.Tensor:
        return attn_train(self, x, self.spec, chunk, seq, heads)


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


def banded_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    scale: float | None = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Causal sliding-window self-attention over positions ``0..S-1``:
    each chunk of ``chunk`` queries attends to the keys of its band
    ``[chunk start − window + 1, chunk end)``, read as a static width of
    ``window + chunk`` keys whose start is clamped into ``[0, S − band]``.
    ``q (B,S,H,D)``, ``k``/``v (B,S,KH,D)``; returns ``(B,S,H,D)`` in q's
    dtype."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = d**-0.5 if scale is None else scale
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    band = window + chunk
    width = min(band, s)
    qg = q.reshape(b, s // chunk, chunk, kh, g, d)
    outs = []
    for i in range(s // chunk):
        start = min(max(i * chunk + chunk - band, 0), max(s - band, 0))
        kb, vb = k[:, start:start + width], v[:, start:start + width]
        sc = _gqa_scores(qg[:, i], kb, scale)  # (B,KH,G,chunk,width)
        q_pos = i * chunk + torch.arange(chunk, device=q.device)
        kv_pos = start + torch.arange(width, device=q.device)
        sc = sc + _mask_bias(q_pos, kv_pos, True, window)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        # p rounds to v's dtype before the product, as the reference
        o = torch.einsum("bhgqc,bchd->bhgqd", p.to(v.dtype).float(), vb.float())
        outs.append(o / p.sum(dim=-1)[..., None])
    out = torch.stack(outs, dim=1)  # (B, n_chunks, KH, G, chunk, D)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    q_position: torch.Tensor,
    kv_positions: torch.Tensor,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """One decode step: ``q (B,Sq,H,D)`` over the cache ``(B,KH,L,D)``.

    Direct stable softmax over the whole cache.  ``kv_positions`` holds the
    global position of every cache row (a ring buffer passes its unrolled
    positions); rows not yet written sit beyond ``q_position`` and causality
    masks them.  Both positions may carry a leading batch dim
    (``q_position (B,Sq)``, ``kv_positions (B,L)``) or none.  The reference's
    rounding points are kept: the scores dot in the cache dtype, the
    softmax in f32, ``p`` cast to the values' dtype before its dot."""
    b, sq, h, d = q.shape
    _, kh, l, _ = k_cache.shape
    g = h // kh
    s = _decode_scores(q, k_cache, kv_positions, q_position, window, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = (p / p.sum(dim=-1, keepdim=True)).to(v_cache.dtype)
    o = torch.matmul(p.reshape(b, kh, g * sq, l), v_cache)  # (B,KH,G·Sq,D)
    o = o.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
    return o.reshape(b, sq, h, d).to(q.dtype)


def _decode_scores(q, k_cache, kv_positions, q_position, window, scale):
    """The f32 scores ``(B,KH,G,Sq,L)`` of one decode step, masked: the
    dot in the cache dtype, then f32, as the reference."""
    b, sq, h, d = q.shape
    _, kh, l, _ = k_cache.shape
    g = h // kh
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).reshape(b, kh, g * sq, d).to(k_cache.dtype)
    s = torch.matmul(qg, k_cache.transpose(-1, -2))  # (B,KH,G·Sq,L) in the cache dtype
    s = s.float().reshape(b, kh, g, sq, l) * scale
    bias = _mask_bias(q_position, kv_positions, True, window)  # ([B,]Sq,L)
    return s + (bias[:, None, None] if bias.ndim == 3 else bias)


def merge_blocks(t: torch.Tensor, seq, op: str = "sum") -> torch.Tensor:
    """One step of the blocks' merge in :func:`decode_attention_split`:
    ``t`` reduced by ``op`` over ``seq``'s group (a narrow float summed in
    f32)."""
    from repro_torch.distributed.layout import reduce_over

    return reduce_over(t, seq.group, op, "kv_merge")


def decode_attention_split(
    q: torch.Tensor,
    k_block: torch.Tensor,
    v_block: torch.Tensor,
    *,
    q_position: torch.Tensor,
    kv_positions: torch.Tensor,
    seq,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose positions are split
    over ``seq``'s group, this rank holding the block ``(B,KH,L/n,D)`` at
    global positions ``kv_positions``; every rank of the group returns the
    whole cache's attention.  The blocks merge by log-sum-exp
    (:func:`merge_blocks`): the row max over every block, each block's
    exponentials against it and their sum over every block; ``p`` is
    normalised by that sum and cast to the values' dtype before its dot
    with the block, as the whole function rounds it, and the blocks'
    ``p·V`` are summed.  A block none of whose positions a row may see
    adds zeros."""
    b, sq, h, d = q.shape
    _, kh, l, _ = k_block.shape
    g = h // kh
    s = _decode_scores(q, k_block, kv_positions, q_position, window, scale)
    m = merge_blocks(s.amax(dim=-1, keepdim=True), seq, "max")
    p = torch.exp(s - m)
    p = (p / merge_blocks(p.sum(dim=-1, keepdim=True), seq)).to(v_block.dtype)
    o = merge_blocks(torch.matmul(p.reshape(b, kh, g * sq, l), v_block), seq)  # (B,KH,G·Sq,D)
    o = o.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
    return o.reshape(b, sq, h, d).to(q.dtype)


class KVCache(NamedTuple):
    """Fixed-capacity cache: ``k``/``v (B, KH, capacity, D)`` and ``pos``,
    the tokens each row has seen, ``(B,)`` int32 (a 0-d ``pos`` shares one
    position over the rows)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def kv_cache_init(b: int, capacity: int, kh: int, d: int, dtype=torch.bfloat16, device=None) -> KVCache:
    z = torch.zeros((b, kh, capacity, d), dtype=dtype, device=device)
    return KVCache(z, z.clone(), torch.zeros((b,), dtype=torch.int32, device=device))


def kv_cache_update_decode(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, seq=None) -> KVCache:
    """Insert one token ``(B,1,KH,D)`` at each row's ``pos % capacity``.
    ``seq``: the cache is this rank's block of the positions (module
    docstring); a row whose position lies outside it keeps its block."""
    k_t = k_new.to(cache.k.dtype).transpose(1, 2)  # (B,KH,1,D)
    v_t = v_new.to(cache.v.dtype).transpose(1, 2)
    k, v = cache.k.clone(), cache.v.clone()
    if seq is not None:
        # written where the block holds the position: the old entry is
        # written back elsewhere (no host sync on which rows those are)
        at = (cache.pos % seq.length).long() - seq.start
        here = ((at >= 0) & (at < seq.local)).reshape(-1, 1, 1)
        at = at.clamp(0, seq.local - 1).expand(k.shape[0])
        rows = torch.arange(k.shape[0], device=k.device)
        k[rows, :, at] = torch.where(here, k_t[:, :, 0], k[rows, :, at])
        v[rows, :, at] = torch.where(here, v_t[:, :, 0], v[rows, :, at])
        return KVCache(k, v, cache.pos + 1)
    idx = (cache.pos % cache.capacity).long()
    if idx.ndim == 0:  # one shared position: one slice for every row
        k[:, :, idx] = k_t[:, :, 0]
        v[:, :, idx] = v_t[:, :, 0]
    else:  # the advanced indices split by a slice put B first: (B, KH, D)
        rows = torch.arange(k.shape[0], device=k.device)
        k[rows, :, idx] = k_t[:, :, 0]
        v[rows, :, idx] = v_t[:, :, 0]
    return KVCache(k, v, cache.pos + 1)


def kv_cache_positions(cache: KVCache, seq=None) -> torch.Tensor:
    """Global position of each cache slot's entry: ``(B, capacity)`` for a
    per-row ``pos``, ``(capacity,)`` for a shared one.  Slots not yet
    written get a position past ``pos``, so causality masks them; a reused
    pool row's stale entries sit there too until they are overwritten.
    ``seq``: the slots of this rank's block of the whole capacity."""
    cap = cache.capacity if seq is None else seq.length
    slots = torch.arange(cap, device=cache.pos.device) if seq is None else seq.positions(cache.pos.device)
    pos = cache.pos[..., None].long()  # (B,1), or (1,) for a shared pos
    n_wraps = torch.div(pos, cap, rounding_mode="floor")
    base = slots + (n_wraps - 1) * cap
    latest = slots + n_wraps * cap
    positions = torch.where(latest < pos, latest, base)
    return torch.where(positions >= 0, positions, pos + 1 + slots)


def kv_cache_prefill(cache: KVCache, k_seq: torch.Tensor, v_seq: torch.Tensor, seq=None) -> KVCache:
    """Fill from a whole prefill sequence ``(B,S,KH,D)``; a ring buffer
    keeps the last ``capacity`` tokens, laid out so that slot = pos % capacity.
    ``seq``: the cache is this rank's block of the positions, which keeps
    the sequence's part in it."""
    s, cap = k_seq.shape[1], cache.capacity
    pos = torch.full(cache.pos.shape, s, dtype=torch.int32, device=cache.pos.device)
    k_t, v_t = k_seq.transpose(1, 2), v_seq.transpose(1, 2)  # (B,KH,S,D)
    if seq is not None:
        if s > seq.length:
            raise ValueError(f"a prefill of {s} positions into a split cache of {seq.length}")
        n = min(max(s - seq.start, 0), seq.local)
        k, v = cache.k.clone(), cache.v.clone()
        k[:, :, :n] = k_t[:, :, seq.start:seq.start + n]
        v[:, :, :n] = v_t[:, :, seq.start:seq.start + n]
        return KVCache(k, v, pos)
    if s <= cap:
        k, v = cache.k.clone(), cache.v.clone()
        k[:, :, :s] = k_t
        v[:, :, :s] = v_t
        return KVCache(k, v, pos)
    roll = (s - cap) % cap  # the token at global position p lives in slot p % cap
    k = torch.roll(k_t[:, :, s - cap:], shifts=roll, dims=2).to(cache.k.dtype)
    v = torch.roll(v_t[:, :, s - cap:], shifts=roll, dims=2).to(cache.v.dtype)
    return KVCache(k, v, pos)


def attn_qkv(p: Attention, x: torch.Tensor, spec: AttnSpec, positions: torch.Tensor, heads: HeadSplit | None = None):
    """Queries, keys and values of ``x`` (``heads``: this rank's, from its
    blocks of the projections)."""
    b, s, _ = x.shape
    h, kh, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    wk, wv = p.wk, p.wv
    if heads is not None:
        x = heads.tp.enter(x)
        h, kh = heads.heads, heads.kv
        if not heads.kv_kept:  # the KV heads this rank's query heads read, of the whole projection
            wk, wv = (w.narrow(1, heads.kv_lo * d, kh * d) for w in (wk, wv))
    q = (x @ p.wq).reshape(b, s, h, d)
    k = (x @ wk).reshape(b, s, kh, d)
    v = (x @ wv).reshape(b, s, kh, d)
    if spec.qk_norm:
        q, k = rmsnorm(p.q_norm, q), rmsnorm(p.k_norm, k)
    if spec.use_rope:
        q = apply_rope(q, positions, rotary_dim=spec.rotary_dim, base=spec.rope_base)
        k = apply_rope(k, positions, rotary_dim=spec.rotary_dim, base=spec.rope_base)
    return q, k, v


def gather_kv(k: torch.Tensor, v: torch.Tensor, seq) -> tuple:
    """Keys and values of the whole sequence from each rank's chunk
    (``seq``, a :class:`~repro_torch.distributed.layout.SeqSplit`), and
    their positions; the backward sums their cotangents over the sequence
    group (a reduce-scatter)."""
    return seq.gather(k, 1), seq.gather(v, 1), torch.arange(seq.length, device=k.device)


def _self_attention(p: Attention, x: torch.Tensor, spec: AttnSpec, chunk: int, seq=None,
                    heads: HeadSplit | None = None):
    """Causal self-attention over a whole sequence: ``(y, k, v)``; a window
    shorter than the sequence runs banded, any other through the chunked
    softmax with the window's mask.  Under a sequence split (``seq``) ``x``
    is this rank's chunk of positions: rope, the mask and the window at
    its global positions, against the keys and values of every position
    (:func:`gather_kv`), chunked as the whole sequence's.  Split over the
    heads (``heads``): this rank's heads, their output summed over the
    split."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device) if seq is None else seq.positions(x.device)
    q, k, v = attn_qkv(p, x, spec, positions, heads)
    kv_positions = positions
    if seq is not None:
        k, v, kv_positions = gather_kv(k, v, seq)
    n = k.shape[1]
    if spec.window is not None and spec.window < n and seq is None:
        o = banded_attention_ref(q, k, v, window=spec.window, scale=spec.scale, chunk=min(chunk, s))
    else:
        o = flash_attention_ref(q, k, v, q_positions=positions, kv_positions=kv_positions, causal=True,
                                window=spec.window, scale=spec.scale, chunk=min(chunk, n))
    o = o.reshape(b, s, -1)
    return (o @ p.wo if heads is None else heads.tp.project(o, p.wo)), k, v


def attn_train(p: Attention, x: torch.Tensor, spec: AttnSpec, chunk: int = 512, seq=None,
               heads: HeadSplit | None = None) -> torch.Tensor:
    """Causal self-attention over a full sequence (``seq``: this rank's
    chunk of it; ``heads``: this rank's heads, :func:`_self_attention`)."""
    return _self_attention(p, x, spec, chunk, seq, heads)[0]


def attn_prefill(p: Attention, x: torch.Tensor, spec: AttnSpec, cache: KVCache, chunk: int = 512, seq=None):
    """The train path's attention that also fills the cache: ``(y, cache)``
    (``seq``: the cache is this rank's block of the positions)."""
    y, k, v = _self_attention(p, x, spec, chunk)
    return y, kv_cache_prefill(cache, k, v, seq)


def attn_decode(p: Attention, x: torch.Tensor, spec: AttnSpec, cache: KVCache, seq=None):
    """One decode step of ``x (B,1,d)``: each row at its cache's ``pos``
    (rope and mask positions ``(B,S)``; a shared ``pos`` gives ``(S,)``).
    ``seq``: the cache is this rank's block of the positions, and the
    blocks' attention is merged over its group."""
    b, s, _ = x.shape
    positions = cache.pos[..., None].long() + torch.arange(s, device=x.device)
    q, k, v = attn_qkv(p, x, spec, positions)
    cache = kv_cache_update_decode(cache, k, v, seq)
    kw = dict(q_position=positions, kv_positions=kv_cache_positions(cache, seq), window=spec.window, scale=spec.scale)
    if seq is None:
        o = decode_attention(q, cache.k, cache.v, **kw)
    else:
        o = decode_attention_split(q, cache.k, cache.v, seq=seq, **kw)
    return o.reshape(b, s, -1) @ p.wo, cache
