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

On a mesh (:meth:`LM.shard_`, then :meth:`LM.train_loss` inside
:func:`~repro_torch.distributed.sharding.use_rules`): each rank keeps its
block of every parameter, gathers each module's parameters whole just
before it runs (:meth:`LM._call`, again in a remat recompute), and computes
its rows and, where the policy's ``seq`` names a mesh axis, its chunk of
the positions: attention gathers the keys and values of every position,
rope, the mask and the audio sinusoid take global positions, a MoE layer
routes whole rows; its share of the loss sums over the mesh to the loss.

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
position.  Served on a mesh (``runtime/engine.py`` ``LMExecutor``), the
caches of :data:`SPLIT_KV_KINDS` hold a rank's block of the positions
(``kv``, ``layers/attention.py``), and outside autograd a split embedding
table is read in place (:meth:`LM._lookup`).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, check_supported
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.layout import embed_lookup, gather_param, seq_split, take_block
from repro_torch.distributed.sharding import shard_act
from repro_torch.layers.param import param_axes, param_shapes  # param_axes: the reference's lm.param_axes
from repro_torch.layers.attention import Attention, AttnSpec, KVCache, attn_decode, attn_prefill, kv_cache_init
from repro_torch.layers.embedding import Embedding, Unembed, unembed_apply
from repro_torch.layers.mamba2 import Mamba2, MambaCache, mamba2_apply, mamba_cache_init
from repro_torch.layers.mlp import MLP
from repro_torch.layers.moe import MoE
from repro_torch.layers.norms import apply_norm, norm_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
Cache = KVCache | MambaCache
# the layer kinds whose cache (a global-attention KVCache) a decode policy's
# kv_seq splits by position; a "local" ring and a MambaCache stay whole
# (ROADMAP caveat R11)
SPLIT_KV_KINDS = ("attn", "moe", "shared")


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
                chunk: int | None = None, seq=None):
        """``(x, aux, new cache)``: ``mode`` train (no cache), prefill
        (fills ``cache``) or decode (one token per row into ``cache``);
        ``aux`` is a MoE layer's weighted load-balancing loss, None for
        the others.  ``seq`` (a :class:`~repro_torch.distributed.layout.
        SeqSplit`): in train ``x`` is this rank's chunk of the positions;
        in prefill and decode ``cache`` is this rank's block of the
        cache's positions (``layers/attention.py``)."""
        cfg = self.cfg
        chunk = cfg.attn_chunk if chunk is None else chunk
        h = shard_act(apply_norm(cfg.norm, self.norm1, x), "batch", "seq", None)
        if mode == TRAIN:
            y = self.attn(h, chunk, seq)
        elif mode == PREFILL:
            y, cache = attn_prefill(self.attn, h, self.attn.spec, cache, chunk, seq)
        else:
            _check_mode(mode)
            y, cache = attn_decode(self.attn, h, self.attn.spec, cache, seq)
        x = x + shard_act(y.to(x.dtype), "batch", "seq", None)
        h = apply_norm(cfg.norm, self.norm2, x)
        aux = None
        if self.kind == "moe" and seq is not None and mode == TRAIN:
            # routing and its capacity ceil(T·k/E·cf) count the whole row's
            # T, so the MoE runs on whole rows under any sequence split,
            # whatever the policy's moe_gather_seq says (llama4's policy
            # splits the sequence without setting it).  In prefill and
            # decode ``seq`` splits the cache, not ``h``: its rows are whole
            y, aux = self.moe(seq.gather(h, 1))
            y = seq.take(y, 1)
        elif self.kind == "moe":
            y, aux = self.moe(h)
        else:
            y = self.mlp(h)
        return x + shard_act(y.to(x.dtype), "batch", "seq", None), aux, cache


class SSMLayer(nn.Module):
    """An ``"ssm"`` layer: norm → mamba2 → residual (no FFN)."""

    kind = "ssm"

    def __init__(self, cfg: ArchConfig, *, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.norm = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.mamba = Mamba2(cfg.ssm, generator=generator, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mode: str = TRAIN, cache: MambaCache | None = None,
                chunk: int | None = None, seq=None):
        """``(x, None, new cache)`` as :meth:`Layer.forward`; ``chunk`` is
        the SSD chunk (default ``cfg.ssm.chunk``).  ``seq`` is always None:
        the SSD's scan runs over whole sequences, and
        :meth:`LM._mesh_train_loss` refuses a sequence split."""
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

    # -- storage on a mesh -------------------------------------------------------
    mesh = None  # set by shard_
    blocks: dict | None = None  # {parameter name: Block} on a mesh

    def shard_(self, mesh) -> dict:
        """Keep only this rank's block of every parameter, in place, as
        ``cfg.policy``'s parameter rules place it on ``mesh``
        (:func:`~repro_torch.distributed.sharding.resolve_param_pspecs`
        over :func:`param_axes`); the FAµST supports (buffers) stay whole.
        Returns ``{name: Block}`` of the parameters.  From then on every
        forward gathers each module's parameters whole just before it runs
        (:meth:`_call`)."""
        if self.blocks is not None:
            raise ValueError("the model is sharded already")
        shapes = param_shapes(self.cfg)
        specs = sharding.resolve_param_pspecs(param_axes(self.cfg), shapes, mesh, self.cfg.policy)
        blocks = sharding.tree_named_sharding(specs, shapes, mesh)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not blocks[name].whole:
                    p.data = take_block(p.data, blocks[name]).contiguous().clone()
        self.mesh = mesh
        self.blocks = {name: blocks[name] for name, _ in self.named_parameters()}
        return self.blocks

    def _gathered(self, module: nn.Module, prefix: str) -> dict:
        return {n: gather_param(p, self.blocks[prefix + n], self.mesh) for n, p in module.named_parameters()}

    def _call(self, module: nn.Module, prefix: str, *args):
        """``module(*args)``; on a mesh with ``module``'s parameters
        (state dict prefix ``prefix``) gathered whole for the call."""
        if self.blocks is None:
            return module(*args)
        return functional_call(module, self._gathered(module, prefix), args)

    def _param(self, name: str):
        """The parameter (or a norm's parameter dict) ``name``, gathered
        whole on a mesh."""
        p = getattr(self, name) if "." not in name else self.get_parameter(name)
        if self.blocks is None:
            return p
        if isinstance(p, nn.ParameterDict):
            return {k: gather_param(v, self.blocks[f"{name}.{k}"], self.mesh) for k, v in p.items()}
        return gather_param(p, self.blocks[name], self.mesh)

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding table's rows of ``tokens``.  On a mesh outside
        autograd (serving) a split 2-D table is read in place
        (:func:`~repro_torch.distributed.layout.embed_lookup`: the rows of
        the tokens move, not the table); under autograd it is gathered
        whole, as every module's weights."""
        block = None if self.blocks is None else self.blocks["embed.table"]
        if block is None or block.whole or torch.is_grad_enabled() or self.embed.table.ndim != 2:
            return self._call(self.embed, "embed.", tokens)
        return embed_lookup(tokens, self.embed.table, block, self.mesh)

    # -- forward -------------------------------------------------------------------
    def _embed_tokens(self, tokens: torch.Tensor, pos0=0) -> torch.Tensor:
        """``(B, S, d)`` in the activation dtype; with codebooks the summed
        embeddings plus the sinusoid at positions ``pos0 + [0, S)``
        (``pos0`` an int or per-row ``(B,)``)."""
        dt = DTYPES[self.cfg.dtype]
        x = self._lookup(tokens).to(dt)
        if self.cfg.n_codebooks > 1:
            return x + sinusoid(self.cfg.d_model, pos0, tokens.shape[-1], x.device).to(dt)
        if self.cfg.scale_embed:
            x = x * math.sqrt(self.cfg.d_model)  # a Python float keeps x's dtype
        return x

    def _front(self, tokens: torch.Tensor, vision_embeds: torch.Tensor | None, seq=None) -> torch.Tensor:
        """The embedded sequence of train and prefill: positions from 0,
        and ``vision_embeds (B, nv, d)`` in place of the first nv.  Under a
        sequence split ``tokens`` are this rank's chunk of the positions
        (``seq``), embedded at their global positions."""
        pos0 = 0 if seq is None else seq.start
        x = self._embed_tokens(tokens, pos0)
        nv = self.cfg.n_vision_tokens
        if not nv:
            if vision_embeds is not None:
                raise ValueError(f"{self.cfg.name} takes no vision_embeds")
            return x
        if vision_embeds is None:
            raise ValueError(f"{self.cfg.name} needs vision_embeds (B, {nv}, {self.cfg.d_model})")
        if tuple(vision_embeds.shape) != (x.shape[0], nv, x.shape[-1]):
            raise ValueError(f"vision_embeds {tuple(vision_embeds.shape)}, want {(x.shape[0], nv, x.shape[-1])}")
        length = x.shape[1] if seq is None else seq.length
        if length < nv:  # reference caveat R6: the reference lengthens the sequence to nv
            raise ValueError(f"a sequence of {length} positions is shorter than the {nv} vision tokens")
        here = min(max(nv - pos0, 0), x.shape[1])  # this chunk's image positions
        return torch.cat([vision_embeds[:, pos0:pos0 + here].to(x.dtype), x[:, here:]], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.n_codebooks > 1:  # (B, S, K, V): one head per codebook
            return torch.stack([self._call(self.unembed, "unembed.", x, k) for k in range(self.cfg.n_codebooks)],
                               dim=-2).float()
        if self.cfg.tie_embeddings:
            return unembed_apply(None, x, self._param("embed.table")).float()
        return self._call(self.unembed, "unembed.", x).float()

    def forward_train(self, tokens: torch.Tensor, chunk: int | None = None,
                      vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """f32 logits ``(B, S, vocab)`` of ``tokens (B, S)`` (audio: ``(B,
        S, K, vocab)`` of ``(B, K, S)``; vision: with ``vision_embeds``).
        ``chunk``, when given, is the chunk of every chunked path
        (attention's keys and the SSD); each defaults to its config's
        (``cfg.attn_chunk``, ``cfg.ssm.chunk``).  A sequence longer than a
        chunk must be a multiple of it."""
        return self._forward_train(tokens, chunk, vision_embeds)[0]

    def _layer(self, i: int, layer: nn.Module) -> tuple[nn.Module, str]:
        """The module that runs at position ``i`` (``layer``) and its state
        dict prefix."""
        return (self.shared, "shared.") if layer.kind == "shared" else (layer, f"layers.{i}.")

    def _forward_train(self, tokens: torch.Tensor, chunk: int | None = None,
                       vision_embeds: torch.Tensor | None = None, seq=None):
        """The logits and the f32 sum of the MoE layers' aux losses (of
        this rank's chunk of positions ``seq`` under a sequence split)."""
        x = shard_act(self._front(tokens, vision_embeds, seq), "batch", "seq", None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            module, prefix = self._layer(i, layer)

            def run(x, module=module, prefix=prefix):  # gathers inside: a remat recompute gathers again
                return self._call(module, prefix, x, TRAIN, None, chunk, seq)

            if self.cfg.remat and torch.is_grad_enabled():
                x, layer_aux, _ = checkpoint(run, x, use_reentrant=False)
            else:
                x, layer_aux, _ = run(x)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = apply_norm(self.cfg.norm, self._param("final_norm"), x)
        return self._logits(x), aux

    def _run(self, x: torch.Tensor, mode: str, caches: list[Cache], kv=None):
        new = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches, strict=True)):
            split = kv if layer.kind in SPLIT_KV_KINDS else None
            x, _, cache = self._call(*self._layer(i, layer), x, mode, cache, None, split)
            new.append(cache)
        return apply_norm(self.cfg.norm, self._param("final_norm"), x), new

    def prefill(self, tokens: torch.Tensor, caches: list[Cache], vision_embeds: torch.Tensor | None = None,
                kv=None):
        """``tokens (B, S)`` (audio: ``(B, K, S)``; vision: with
        ``vision_embeds``) through the model into ``caches``: the last
        position's f32 logits ``(B, 1, vocab)`` (audio: ``(B, 1, K,
        vocab)``) and the filled caches.  ``S`` must be a length every
        chunked path takes whole (:func:`prefill_length`), or the SSD or
        attention raises.  ``kv`` (a :class:`~repro_torch.distributed.
        layout.SeqSplit`): the caches of :data:`SPLIT_KV_KINDS` hold this
        rank's block of the positions (:func:`make_caches` with ``kv``)."""
        x, new = self._run(self._front(tokens, vision_embeds), PREFILL, caches, kv)
        return self._logits(x[:, -1:]), new

    def decode_step(self, tokens: torch.Tensor, caches: list[Cache], kv=None):
        """One token per row, ``tokens (B, 1)`` (audio: ``(B, K, 1)``), each
        row at its cache's position (the first layer's ``pos``, which the
        audio sinusoid reads): f32 logits ``(B, 1, vocab)`` (audio: ``(B,
        1, K, vocab)``) and the new caches.  ``kv`` as in :meth:`prefill`:
        each split cache's attention is merged over its group."""
        x, new = self._run(self._embed_tokens(tokens, caches[0].pos), DECODE, caches, kv)
        return self._logits(x), new

    def train_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross entropy (over every codebook's) plus the
        MoE layers' aux losses: ``(loss, {"loss", "ce", "aux"})``.
        ``batch`` holds ``tokens`` and, for a vision model,
        ``vision_embeds``.  On a mesh (after :meth:`shard_`, inside
        :func:`~repro_torch.distributed.sharding.use_rules`) ``batch`` is
        the whole batch and each value is this rank's share: summed over
        the mesh it is the loss (:meth:`_mesh_train_loss`)."""
        if self.blocks is not None:
            return self._mesh_train_loss(batch)
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

    def _mesh_train_loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """This rank's share of the loss on the mesh of :meth:`shard_`.

        The rank computes the rows of its coordinate over the policy's
        batch axes (:func:`batch_axes`) and, where the policy's ``seq``
        names a mesh axis (fitted as :func:`~repro_torch.distributed.
        sharding.shard_act` fits it), its contiguous chunk of their
        positions.  Labels are the whole rows' tokens at the chunk's global
        positions + 1 (the last global position has none).  Its share is
        the cross entropy summed over its positions over the global count,
        plus the aux loss of its rows (the reference's mean over rows)
        weighted by its rows' share; each divided by the number of ranks
        that compute the same rows and positions, so the sum over the mesh
        is the loss and the sum of the gradients its gradient."""
        rules = sharding._current()
        if rules is None or rules.mesh is not self.mesh:
            raise RuntimeError("a sharded model trains inside use_rules(mesh, policy) of its own mesh")
        mesh, policy, cfg = self.mesh, rules.policy, self.cfg
        tokens, ve = batch["tokens"], batch.get("vision_embeds")
        b, s = tokens.shape[0], tokens.shape[-1]
        rows = batch_axes(policy, mesh)
        n_rows = math.prod(mesh.shape[a] for a in rows)
        if b % n_rows:
            raise ValueError(f"a batch of {b} rows does not split over {rows} ({n_rows} ranks)")
        seq_axes = sharding.axes_tuple(sharding._fit_axes(policy.seq, s, mesh))
        if set(seq_axes) & set(rows):
            raise ValueError(f"the policy splits rows over {rows} and positions over {seq_axes}")
        seq = seq_split(mesh, seq_axes, s)
        if seq is not None and "ssm" in cfg.layer_kinds():
            raise NotImplementedError(f"{cfg.name}: the SSD runs whole sequences; a policy that splits "
                                      f"the sequence over {seq_axes} is not supported")
        n_seq = 1 if seq is None else seq.n
        bl = b // n_rows
        r0 = mesh.index(rows) * bl
        tok = tokens[r0:r0 + bl]
        s0, sl = (0, s) if seq is None else (seq.start, seq.local)
        logits, aux = self._forward_train(tok[..., s0:s0 + sl], vision_embeds=None if ve is None else ve[r0:r0 + bl],
                                          seq=seq)
        labels = tok[..., s0 + 1:s0 + sl + 1].long()  # the last global position has none
        n_lab = labels.shape[-1]
        lg = logits[:, :n_lab]
        if cfg.n_codebooks > 1:
            lg = lg.transpose(1, 2)  # (B, K, n, V)
        lg = shard_act(lg, *(("batch",) + (None,) * (lg.ndim - 2) + ("vocab_act",)))
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        count = b * (s - 1) * cfg.n_codebooks
        ce = torch.sum(lse - gold) / count / (mesh.size // (n_rows * n_seq))
        aux = aux * (bl / b) / (mesh.size // n_rows)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}


def batch_axes(policy, mesh) -> tuple[str, ...]:
    """The mesh axes the rows split over: the policy's ``batch`` axes the
    mesh has (the reference's ``runtime.trainer._fit_batch_axes``)."""
    return tuple(a for a in sharding.axes_tuple(policy.batch) if a in mesh.shape)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    """A ``kind`` layer's cache capacity: ``min(window, cache_len)`` for
    ``"local"`` (a ring buffer), else ``cache_len``."""
    if kind == "local" and cfg.window is not None:
        return min(cfg.window, cache_len)
    return cache_len


def make_caches(cfg: ArchConfig, batch: int, cache_len: int, dtype=torch.bfloat16, device=None,
                kv=None) -> list[Cache]:
    """One empty cache of ``batch`` rows per layer on ``device`` (default:
    the CUDA card): a :class:`MambaCache` (conv history in ``dtype``, f32
    state) for an ``"ssm"`` layer, else a :class:`KVCache` of capacity
    :func:`cache_capacity`.  ``kv`` (a :class:`~repro_torch.distributed.
    layout.SeqSplit` of ``cache_len`` positions): a layer of
    :data:`SPLIT_KV_KINDS` holds only this rank's block of them."""
    check_supported(cfg)
    dev = resolve_device(device)
    if kv is not None and kv.length != cache_len:
        raise ValueError(f"a split of {kv.length} positions for caches of {cache_len}")

    def capacity(kind):
        return kv.local if kv is not None and kind in SPLIT_KV_KINDS else cache_capacity(cfg, kind, cache_len)

    return [mamba_cache_init(batch, cfg.ssm, dtype, dev) if kind == "ssm" else
            kv_cache_init(batch, capacity(kind), cfg.n_kv_heads, cfg.head_dim, dtype, dev)
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
