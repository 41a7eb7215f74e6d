"""Decoder LM: training and serving.  Counterpart of :mod:`repro.models.lm`
(``_layer_init``, ``init_model``, ``_apply_layer``, ``_run_stages``,
``_embed_tokens``, ``_logits``, ``forward_train``, ``train_loss``,
``make_caches``, ``gather_cache_slots``, ``scatter_cache_slots``,
``prefill``, ``decode_step``, ``greedy_token``) for the ``"attn"``
(global attention + FFN), ``"local"`` (sliding-window attention + FFN),
``"moe"`` (global attention + MoE FFN), ``"ssm"`` (mamba2) and
``"shared"`` (zamba2's shared attention block) layer kinds, with partial
rotary and the two modality front ends.

The reference stacks every layer's parameters on a leading axis and scans
over them; here the layers are an ``nn.ModuleList`` run in a Python loop,
each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the
reference's ``jax.checkpoint`` of the scan body).  State dict keys mirror
the reference's parameter paths with the stack unrolled:
``embed.table``, ``layers.{i}.norm1``, ``layers.{i}.attn.wq``,
``layers.{i}.mlp.w_up`` (or ``...w_up.factors.{f}.values`` with
``faust_mlp``) or ``layers.{i}.moe.router``/``.w_up``/``.w_gate``/
``.w_down``/``.shared.*``, ``layers.{i}.norm`` and
``layers.{i}.mamba.*`` for an ``"ssm"`` layer, ``shared.*`` (one
``"attn"`` layer's parameters, held once and run at every ``"shared"``
position, whose list entry is a :class:`SharedSlot` without parameters),
``final_norm``, ``unembed.w`` or ``unembed.faust...``;
:mod:`repro_torch.bridge` maps one onto the other.  The layers run in
``cfg.layer_kinds()`` order (the stages unrolled).  The loss adds every
MoE layer's load-balancing term to the cross entropy, as the reference's.

Modality front ends, stubs as in the reference (no ViT, no EnCodec):

* audio (``n_codebooks`` K > 1): tokens ``(B, K, S)``; ``embed.table (K,
  V, d)`` summed over the codebooks, plus sinusoidal positions computed in
  f32 from ``pos0`` (0 in train and prefill, each row's cache position in
  decode) and cast; K heads, stacked as the reference stacks them
  (``unembed.w (K, d, V)`` or every ``unembed.faust`` leaf with a leading
  K), each applied on its own; logits ``(B, S, K, V)``; the loss over
  every codebook's next token;
* vision (``n_vision_tokens`` nv): ``vision_embeds (B, nv, d)`` replace the
  first nv positions in train and prefill, cast to the activation dtype.
  A sequence shorter than nv raises ``ValueError``: the reference's
  ``concatenate`` lengthens it to nv positions instead (reference caveat
  R6 in ROADMAP.md).

Serving: :func:`make_caches` gives one cache per layer in a list (the
layers are unrolled, so there is no repeat axis): a :class:`MambaCache`
for an ``"ssm"`` layer, a :class:`KVCache` for the others (each
``"shared"`` occurrence its own), a ``local`` layer's a ring of
``min(window, cache_len)`` tokens; the batch axis of every cache tensor,
axis 0, is the serving engine's *slot* axis, where the reference's stacked
caches have it at axis 1 (``_CACHE_BATCH_AXIS``).  :meth:`LM.prefill`
returns the last position's logits and the filled caches; a prompt must
be a length every chunked path accepts (:func:`prefill_length`).
:meth:`LM.decode_step` feeds one token per row, each row at its own cache
position.
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
from repro_torch.layers.mamba2 import Mamba2, MambaCache, mamba2_apply, mamba_cache_init
from repro_torch.layers.mlp import MLP
from repro_torch.layers.moe import MoE
from repro_torch.layers.norms import apply_norm, norm_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
Cache = KVCache | MambaCache


def _check_mode(mode: str) -> None:
    if mode not in (TRAIN, PREFILL, DECODE):
        raise ValueError(f"mode must be {TRAIN!r}, {PREFILL!r} or {DECODE!r}; got {mode!r}")


def attn_spec(cfg: ArchConfig, kind: str) -> AttnSpec:
    """The attention of a ``kind`` layer: rotary over ``rotary_pct`` of the
    head dim (rounded down to even; none at 0), and for ``"local"`` the
    window and the local rope base."""
    local = kind == "local"
    rotary_dim = int(cfg.head_dim * cfg.rotary_pct)
    rotary_dim -= rotary_dim % 2
    return AttnSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_base=(cfg.rope_base_local or cfg.rope_base) if local else cfg.rope_base,
        rotary_dim=rotary_dim if cfg.rotary_pct < 1.0 else None,
        window=cfg.window if local else None,
        qk_norm=cfg.qk_norm,
        scale=cfg.attn_scale,
        use_rope=cfg.rotary_pct > 0.0,
    )


class Layer(nn.Module):
    """One layer of ``kind``: norm → attention → residual, then norm → MLP
    (``"attn"``, ``"local"``) or MoE (``"moe"``) → residual."""

    def __init__(self, cfg: ArchConfig, kind: str, *, generator, dtype, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.attn = Attention(cfg.d_model, attn_spec(cfg, kind), **kw)
        self.norm2 = norm_params(cfg.norm, cfg.d_model, dtype, device)
        if kind == "moe":
            self.moe = MoE(cfg.d_model, cfg.moe, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, faust=cfg.faust_mlp, **kw)

    def forward(self, x: torch.Tensor, mode: str = TRAIN, cache: KVCache | None = None,
                chunk: int | None = None):
        """``(x, aux, new cache)``: ``mode`` train (no cache), prefill
        (fills ``cache``) or decode (one token per row into ``cache``);
        ``aux`` is a MoE layer's weighted load-balancing loss, None for
        the others."""
        cfg = self.cfg
        chunk = cfg.attn_chunk if chunk is None else chunk
        h = apply_norm(cfg.norm, self.norm1, x)
        if mode == TRAIN:
            y = self.attn(h, chunk)
        elif mode == PREFILL:
            y, cache = attn_prefill(self.attn, h, self.attn.spec, cache, chunk)
        else:
            _check_mode(mode)
            y, cache = attn_decode(self.attn, h, self.attn.spec, cache)
        x = x + y.to(x.dtype)
        h = apply_norm(cfg.norm, self.norm2, x)
        aux = None
        if self.kind == "moe":
            y, aux = self.moe(h)
        else:
            y = self.mlp(h)
        return x + y.to(x.dtype), aux, cache


class SSMLayer(nn.Module):
    """An ``"ssm"`` layer: norm → mamba2 → residual (no FFN)."""

    kind = "ssm"

    def __init__(self, cfg: ArchConfig, *, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.norm = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.mamba = Mamba2(cfg.ssm, generator=generator, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mode: str = TRAIN, cache: MambaCache | None = None,
                chunk: int | None = None):
        """``(x, None, new cache)`` as :meth:`Layer.forward`; ``chunk`` is
        the SSD chunk (default ``cfg.ssm.chunk``)."""
        _check_mode(mode)
        h = apply_norm(self.cfg.norm, self.norm, x)
        y, cache = mamba2_apply(self.mamba, h, self.cfg.ssm, None if mode == TRAIN else cache, mode == DECODE,
                                chunk)
        return x + y.to(x.dtype), None, cache


class SharedSlot(nn.Module):
    """A ``"shared"`` position of the layer list: no parameters; the model
    runs its :attr:`LM.shared` block there."""

    kind = "shared"


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
        self.embed = Embedding(cfg.vocab, cfg.d_model, n=cfg.n_codebooks, **kw)
        kinds = cfg.layer_kinds()
        self.layers = nn.ModuleList(
            SSMLayer(cfg, **kw) if kind == "ssm" else SharedSlot() if kind == "shared" else Layer(cfg, kind, **kw)
            for kind in kinds)
        if "shared" in kinds:
            self.shared = Layer(cfg, "attn", **kw)
        self.final_norm = norm_params(cfg.norm, cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(cfg.d_model, cfg.vocab, cfg.faust_unembed, n=cfg.n_codebooks, **kw)

    def _embed_tokens(self, tokens: torch.Tensor, pos0=0) -> torch.Tensor:
        """``(B, S, d)`` in the activation dtype; with codebooks the summed
        embeddings plus the sinusoid at positions ``pos0 + [0, S)``
        (``pos0`` an int or per-row ``(B,)``)."""
        dt = DTYPES[self.cfg.dtype]
        x = self.embed(tokens).to(dt)
        if self.cfg.n_codebooks > 1:
            return x + sinusoid(self.cfg.d_model, pos0, tokens.shape[-1], x.device).to(dt)
        if self.cfg.scale_embed:
            x = x * math.sqrt(self.cfg.d_model)  # a Python float keeps x's dtype
        return x

    def _front(self, tokens: torch.Tensor, vision_embeds: torch.Tensor | None) -> torch.Tensor:
        """The embedded sequence of train and prefill: positions from 0,
        and ``vision_embeds (B, nv, d)`` in place of the first nv."""
        x = self._embed_tokens(tokens)
        nv = self.cfg.n_vision_tokens
        if not nv:
            if vision_embeds is not None:
                raise ValueError(f"{self.cfg.name} takes no vision_embeds")
            return x
        if vision_embeds is None:
            raise ValueError(f"{self.cfg.name} needs vision_embeds (B, {nv}, {self.cfg.d_model})")
        if tuple(vision_embeds.shape) != (x.shape[0], nv, x.shape[-1]):
            raise ValueError(f"vision_embeds {tuple(vision_embeds.shape)}, want {(x.shape[0], nv, x.shape[-1])}")
        if x.shape[1] < nv:  # reference caveat R6: the reference lengthens the sequence to nv
            raise ValueError(f"a sequence of {x.shape[1]} positions is shorter than the {nv} vision tokens")
        return torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.n_codebooks > 1:  # (B, S, K, V): one head per codebook
            return torch.stack([self.unembed(x, k) for k in range(self.cfg.n_codebooks)], dim=-2).float()
        tied = self.embed.table if self.cfg.tie_embeddings else None
        return unembed_apply(getattr(self, "unembed", None), x, tied).float()

    def forward_train(self, tokens: torch.Tensor, chunk: int | None = None,
                      vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """f32 logits ``(B, S, vocab)`` of ``tokens (B, S)`` (audio: ``(B,
        S, K, vocab)`` of ``(B, K, S)``; vision: with ``vision_embeds``).
        ``chunk``, when given, is the chunk of every chunked path
        (attention's keys and the SSD); each defaults to its config's
        (``cfg.attn_chunk``, ``cfg.ssm.chunk``).  A sequence longer than a
        chunk must be a multiple of it."""
        return self._forward_train(tokens, chunk, vision_embeds)[0]

    def _layer(self, layer: nn.Module) -> nn.Module:
        """The module that runs at ``layer``'s position."""
        return self.shared if layer.kind == "shared" else layer

    def _forward_train(self, tokens: torch.Tensor, chunk: int | None = None,
                       vision_embeds: torch.Tensor | None = None):
        """The logits and the f32 sum of the MoE layers' aux losses."""
        x = self._front(tokens, vision_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            layer = self._layer(layer)
            if self.cfg.remat and torch.is_grad_enabled():
                x, layer_aux, _ = checkpoint(layer, x, TRAIN, None, chunk, use_reentrant=False)
            else:
                x, layer_aux, _ = layer(x, TRAIN, None, chunk)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = apply_norm(self.cfg.norm, self.final_norm, x)
        return self._logits(x), aux

    def _run(self, x: torch.Tensor, mode: str, caches: list[Cache]):
        new = []
        for layer, cache in zip(self.layers, caches, strict=True):
            x, _, cache = self._layer(layer)(x, mode, cache)
            new.append(cache)
        return apply_norm(self.cfg.norm, self.final_norm, x), new

    def prefill(self, tokens: torch.Tensor, caches: list[Cache], vision_embeds: torch.Tensor | None = None):
        """``tokens (B, S)`` (audio: ``(B, K, S)``; vision: with
        ``vision_embeds``) through the model into ``caches``: the last
        position's f32 logits ``(B, 1, vocab)`` (audio: ``(B, 1, K,
        vocab)``) and the filled caches.  ``S`` must be a length every
        chunked path takes whole (:func:`prefill_length`), or the SSD or
        attention raises."""
        x, new = self._run(self._front(tokens, vision_embeds), PREFILL, caches)
        return self._logits(x[:, -1:]), new

    def decode_step(self, tokens: torch.Tensor, caches: list[Cache]):
        """One token per row, ``tokens (B, 1)`` (audio: ``(B, K, 1)``), each
        row at its cache's position (the first layer's ``pos``, which the
        audio sinusoid reads): f32 logits ``(B, 1, vocab)`` (audio: ``(B,
        1, K, vocab)``) and the new caches."""
        x, new = self._run(self._embed_tokens(tokens, caches[0].pos), DECODE, caches)
        return self._logits(x), new

    def train_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy (over every codebook's) plus the
        MoE layers' aux losses: ``(loss, {"loss", "ce", "aux"})``.
        ``batch`` holds ``tokens`` and, for a vision model,
        ``vision_embeds``."""
        tokens = batch["tokens"]
        logits, aux = self._forward_train(tokens, vision_embeds=batch.get("vision_embeds"))
        if self.cfg.n_codebooks > 1:
            labels = tokens[:, :, 1:].long()  # (B, K, S-1)
            lg = logits[:, :-1].transpose(1, 2)  # (B, K, S-1, V)
        else:
            labels = tokens[:, 1:].long()
            lg = logits[:, :-1]
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        ce = torch.mean(lse - gold)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    """A ``kind`` layer's cache capacity: ``min(window, cache_len)`` for
    ``"local"`` (a ring buffer), else ``cache_len``."""
    if kind == "local" and cfg.window is not None:
        return min(cfg.window, cache_len)
    return cache_len


def make_caches(cfg: ArchConfig, batch: int, cache_len: int, dtype=torch.bfloat16, device=None) -> list[Cache]:
    """One empty cache of ``batch`` rows per layer on ``device`` (default:
    the CUDA card): a :class:`MambaCache` (conv history in ``dtype``, f32
    state) for an ``"ssm"`` layer, else a :class:`KVCache` of capacity
    :func:`cache_capacity`."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [mamba_cache_init(batch, cfg.ssm, dtype, dev) if kind == "ssm" else
            kv_cache_init(batch, cache_capacity(cfg, kind, cache_len), cfg.n_kv_heads, cfg.head_dim, dtype, dev)
            for kind in cfg.layer_kinds()]


def prefill_length(cfg: ArchConfig, n: int) -> int:
    """The longest prefix of an ``n``-token prompt that :meth:`LM.prefill`
    takes whole: at most each chunk of the model's chunked paths or a
    multiple of it (attention's ``attn_chunk``, and with ``"ssm"`` layers
    the SSD's ``ssm.chunk``).  The serving engine replays the rest through
    the decode step.  The reference aligns to ``attn_chunk`` alone, so it
    raises in the SSD where ``attn_chunk`` is no multiple of ``ssm.chunk``
    (mamba2's 512 over 256: prompts of 257–511 tokens not a multiple of
    256).  A vision model's prefix must hold every image position, so a
    prefix shorter than ``n_vision_tokens`` raises ``ValueError``."""
    chunks = [cfg.attn_chunk] + ([cfg.ssm.chunk] if "ssm" in cfg.layer_kinds() else [])
    m = next(m for m in range(n, 0, -1) if all(m <= c or m % c == 0 for c in chunks))
    if m < cfg.n_vision_tokens:
        raise ValueError(f"{cfg.name}: a prefill of {m} of {n} tokens would leave out vision positions "
                         f"(n_vision_tokens {cfg.n_vision_tokens})")
    return m


def sinusoid(d_model: int, pos0, s: int, device) -> torch.Tensor:
    """The f32 sinusoidal positions ``pos0 + [0, s)``: ``(s, d_model)`` for
    an int ``pos0``, ``(B, s, d_model)`` for a per-row ``(B,)`` one; sines
    over the first half of the features, cosines over the second, at
    frequencies ``10000^(-i/half)``."""
    pos = torch.as_tensor(pos0, device=device)[..., None] + torch.arange(s, device=device)
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = pos[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gather_cache_slots(caches: list[Cache], slot_idx: torch.Tensor) -> list[Cache]:
    """The rows ``slot_idx (B,)`` of a slot pool, as a live-batch cache
    list with batch ``len(slot_idx)`` (a copy, each cache of its own type)."""
    return [type(c)(*(t.index_select(0, slot_idx) for t in c)) for c in caches]


def scatter_cache_slots(pool: list[Cache], caches: list[Cache], slot_idx: torch.Tensor) -> list[Cache]:
    """Write a live-batch cache list into the pool rows ``slot_idx``, in
    place (the pool's owner hands it over, as the reference donates its
    buffer), and return the pool."""
    for p, c in zip(pool, caches, strict=True):
        for dst, src in zip(p, c):
            dst.index_copy_(0, slot_idx, src.to(dst.dtype))
    return pool


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
