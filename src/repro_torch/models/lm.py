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
Where the policy's ``heads_act``, ``mlp_act`` or ``vocab_act`` names the
axes a module's output lies on (:func:`split_plan`), the ranks on those
axes compute the module in blocks instead (tensor parallelism): each
keeps its block of the projections' columns (and the partner's rows),
attention its heads, the MLP its hidden columns, a mamba block its
heads (``heads_act`` fitted to the SSM's heads), the head and a
vocab-parallel embedding lookup its vocabulary block; the logits stay
split, and the loss is a vocab-parallel cross entropy
(``distributed/layout.py``).  A MoE layer computes its experts where the
policy's ``experts_act`` names their axes (else, where the experts stay
replicated, every expert's block of hidden columns over ``mlp_act``),
routing whole rows on every rank; its partial output is summed over
those axes, to the rank's chunk of the positions where they are the
sequence's (:class:`Layer`).

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
(``kv``, ``layers/attention.py``), a mamba block whose heads the plan
splits computes them and its :class:`MambaCache` holds them
(:func:`make_caches` with ``ssm``), and outside autograd a split
embedding table is read in place (:meth:`LM._lookup`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, check_supported
from repro_torch.device import resolve_device
from repro_torch.distributed import layout, sharding
from repro_torch.distributed.layout import embed_lookup, gather_param, seq_split, take_block
from repro_torch.distributed.sharding import shard_act
from repro_torch.layers.param import param_axes, param_shapes  # param_axes: the reference's lm.param_axes
from repro_torch.layers.attention import (Attention, AttnSpec, HeadSplit, KVCache, attn_decode, attn_prefill,
                                          kv_cache_init)
from repro_torch.layers.embedding import Embedding, Unembed, unembed_apply
from repro_torch.layers.mamba2 import Mamba2, MambaCache, SSMSplit, mamba2_apply, mamba_cache_init
from repro_torch.layers.mlp import MLP
from repro_torch.layers.moe import MoE, MoESplit
from repro_torch.layers.norms import apply_norm, norm_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
Cache = KVCache | MambaCache
# the layer kinds whose cache (a global-attention KVCache) a decode policy's
# kv_seq splits by position; a "local" ring stays whole (ROADMAP caveat
# R11), and a MambaCache splits by heads over the axes the serving plan's
# SSM split names (SplitPlan.ssm), not by position
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
                chunk: int | None = None, seq=None, split: LayerSplit | None = None):
        """``(x, aux, new cache)``: ``mode`` train (no cache), prefill
        (fills ``cache``) or decode (one token per row into ``cache``);
        ``aux`` is a MoE layer's weighted load-balancing loss, None for
        the others.  ``seq`` (a :class:`~repro_torch.distributed.layout.
        SeqSplit`): in train ``x`` is this rank's chunk of the positions;
        in prefill and decode ``cache`` is this rank's block of the
        cache's positions (``layers/attention.py``).  ``split``: the
        attention's heads, the MLP's hidden columns and the MoE's experts
        or columns this rank computes (:func:`split_plan`); its
        parameters are those blocks."""
        cfg = self.cfg
        chunk = cfg.attn_chunk if chunk is None else chunk
        heads = None if split is None else split.heads
        if heads is not None and mode != TRAIN:
            raise NotImplementedError(f"{cfg.name}: a cache of the rank's KV heads is not supported; serve under "
                                      f"a policy whose heads_act splits no heads (the decode policies)")
        h = shard_act(apply_norm(cfg.norm, self.norm1, x), "batch", "seq", None)
        if mode == TRAIN:
            y = self.attn(h, chunk, seq, heads)
        elif mode == PREFILL:
            y, cache = attn_prefill(self.attn, h, self.attn.spec, cache, chunk, seq)
        else:
            _check_mode(mode)
            y, cache = attn_decode(self.attn, h, self.attn.spec, cache, seq)
        x = x + shard_act(y.to(x.dtype), "batch", "seq", None)
        h = apply_norm(cfg.norm, self.norm2, x)
        aux = None
        if self.kind == "moe":
            # in prefill and decode ``seq`` splits the cache, not ``h``: its rows are whole
            y, aux = self._moe(h, seq if mode == TRAIN else None, None if split is None else split.moe)
        else:
            y = self.mlp(h, None if split is None else split.mlp)
        return x + shard_act(y.to(x.dtype), "batch", "seq", None), aux, cache

    def _moe(self, h: torch.Tensor, seq, split: MoESplit | None):
        """The MoE of ``h`` and its aux loss.  Routing and its capacity
        ``ceil(T·k/E·cf)`` count the whole row's T, so under a sequence
        split (``seq``: ``h`` is the rank's chunk of the positions) the
        rows are gathered whole, whatever the policy's ``moe_gather_seq``
        says (llama4's policy splits the sequence without setting it).
        ``split``: the rank computes its experts or columns, and the
        partial output is summed over the split's axes: under a sequence
        split they are the sequence's (:func:`split_plan`), so by one
        reduce-scatter to the rank's chunk (the shared expert then runs on
        the rank's own positions), else over whole rows, the input
        entering the split as a column-parallel projection's; the shared
        expert is added once, after the sum."""
        if seq is not None and split is None:
            y, aux = self.moe(seq.gather(h, 1))
            return seq.take(y, 1), aux
        if split is None:
            return self.moe(h)
        if seq is not None:
            y, aux = self.moe(seq.gather(h, 1), split)
            return self._shared(seq.scatter(y, 1, h.dtype), h), aux
        y, aux = self.moe(split.tp.enter(h, "moe_input_grad"), split)
        return self._shared(split.tp.reduce(y, "moe_combine"), h), aux

    def _shared(self, y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """A split MoE's summed output ``y`` (f32 for a narrower float),
        rounded once, plus the shared expert of ``h``."""
        y = y.to(h.dtype)
        return y + self.moe.shared(h) if self.cfg.moe.shared_expert_ff else y


class SSMLayer(nn.Module):
    """An ``"ssm"`` layer: norm → mamba2 → residual (no FFN)."""

    kind = "ssm"

    def __init__(self, cfg: ArchConfig, *, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.norm = norm_params(cfg.norm, cfg.d_model, dtype, device)
        self.mamba = Mamba2(cfg.ssm, generator=generator, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mode: str = TRAIN, cache: MambaCache | None = None,
                chunk: int | None = None, seq=None, split: LayerSplit | None = None):
        """``(x, None, new cache)`` as :meth:`Layer.forward`; ``chunk`` is
        the SSD chunk (default ``cfg.ssm.chunk``).  ``split``: the heads
        this rank computes (``split.ssm``, an :class:`~repro_torch.layers.
        mamba2.SSMSplit` of :func:`split_plan`); its ``out_proj`` and
        ``norm_w`` are their block, and in prefill and decode ``cache``
        holds their state.  ``seq`` is always None: the SSD's scan runs
        over whole sequences, and :meth:`LM._mesh_train_loss` refuses a
        sequence split."""
        _check_mode(mode)
        h = apply_norm(self.cfg.norm, self.norm, x)
        y, cache = mamba2_apply(self.mamba, h, self.cfg.ssm, None if mode == TRAIN else cache, mode == DECODE,
                                chunk, None if split is None else split.ssm)
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

    _plan: "SplitPlan | None" = None  # what this forward computes in blocks (split_plan)
    _plans: list | None = None  # [(policy, avoided axes, serving, plan)] computed on this mesh

    def _placement(self, name: str, plan: "SplitPlan | None") -> tuple:
        """``(keep, whole)`` of :func:`~repro_torch.distributed.layout.gather_param` for ``name``."""
        return ((), ()) if plan is None else (plan.keep.get(name, ()), plan.whole(name))

    def _gathered(self, module: nn.Module, prefix: str, plan: "SplitPlan | None" = None) -> dict:
        return {n: gather_param(p, self.blocks[prefix + n], self.mesh, *self._placement(prefix + n, plan))
                for n, p in module.named_parameters()}

    def _call(self, module: nn.Module, prefix: str, *args, plan: "SplitPlan | None" = None):
        """``module(*args)``; on a mesh with ``module``'s parameters
        (state dict prefix ``prefix``) gathered for the call: whole, or the
        blocks ``plan`` keeps."""
        if self.blocks is None:
            return module(*args)
        return functional_call(module, self._gathered(module, prefix, plan), args)

    def _param(self, name: str):
        """The parameter (or a norm's parameter dict) ``name``, gathered
        on a mesh (whole, or the block the forward's plan keeps)."""
        p = getattr(self, name) if "." not in name else self.get_parameter(name)
        if self.blocks is None:
            return p
        if isinstance(p, nn.ParameterDict):
            return {k: gather_param(v, self.blocks[f"{name}.{k}"], self.mesh,
                                    *self._placement(f"{name}.{k}", self._plan)) for k, v in p.items()}
        return gather_param(p, self.blocks[name], self.mesh, *self._placement(name, self._plan))

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding table's rows of ``tokens``.  On a mesh outside
        autograd (serving) a split 2-D table is read in place
        (:func:`~repro_torch.distributed.layout.embed_lookup`: the rows of
        the tokens move, not the table); under autograd a table the
        forward's plan splits by vocabulary is looked up in its block
        (:func:`~repro_torch.distributed.layout.vocab_lookup`), any other
        gathered whole, as every module's weights."""
        block = None if self.blocks is None else self.blocks["embed.table"]
        plan = self._plan
        if block is not None and torch.is_grad_enabled() and plan is not None and plan.embed:
            return layout.vocab_lookup(self._param("embed.table"), tokens, plan.vocab_start, plan.tp)
        if block is None or block.whole or torch.is_grad_enabled() or self.embed.table.ndim != 2:
            return self._call(self.embed, "embed.", tokens, plan=plan)
        return embed_lookup(tokens, self.embed.table, block, self.mesh)

    def split_plan(self, seq_axes=(), serving: bool = False) -> "SplitPlan | None":
        """What this rank computes in blocks under the current rules
        (:func:`~repro_torch.distributed.sharding.use_rules` on the
        model's mesh; None elsewhere or unsharded): :func:`split_plan` of
        the rules' policy, avoiding the policy's batch axes and
        ``seq_axes`` (the positions' split); ``serving``: prefill's and
        decode's (the SSM on its cache's heads)."""
        rules = sharding._current()
        if self.blocks is None or rules is None or rules.mesh is not self.mesh:
            return None
        avoid = tuple(batch_axes(rules.policy, self.mesh)) + tuple(seq_axes)
        for policy, av, sv, plan in self._plans or ():
            if policy is rules.policy and av == avoid and sv == serving:
                return plan
        plan = split_plan(self.cfg, self.blocks, self.mesh, rules.policy, avoid, serving)
        self._plans = (self._plans or []) + [(rules.policy, avoid, serving, plan)]
        return plan

    @contextlib.contextmanager
    def _splitting(self, plan: "SplitPlan | None"):
        prev, self._plan = self._plan, plan
        try:
            yield
        finally:
            self._plan = prev

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
        """f32 logits of the final hidden states; where the forward's plan
        splits the vocabulary, this rank's block of them."""
        plan = self._plan
        split = plan.tp if plan is not None and plan.head else None
        if self.cfg.n_codebooks > 1:  # (B, S, K, V): one head per codebook
            return torch.stack([self._call(self.unembed, "unembed.", x, k, plan=plan)
                                for k in range(self.cfg.n_codebooks)], dim=-2).float()
        if self.cfg.tie_embeddings:
            return unembed_apply(None, x if split is None else split.enter(x), self._param("embed.table")).float()
        if split is None:
            return self._call(self.unembed, "unembed.", x, plan=plan).float()
        return self._call(self.unembed, "unembed.", x, None, split, plan=plan).float()

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
        plan = self._plan
        for i, layer in enumerate(self.layers):
            module, prefix = self._layer(i, layer)
            split = None if plan is None else plan.layers.get(prefix)

            def run(x, module=module, prefix=prefix, split=split):  # gathers inside: a remat recompute gathers again
                return self._call(module, prefix, x, TRAIN, None, chunk, seq, split, plan=plan)

            if self.cfg.remat and torch.is_grad_enabled():
                x, layer_aux, _ = checkpoint(run, x, use_reentrant=False)
            else:
                x, layer_aux, _ = run(x)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = apply_norm(self.cfg.norm, self._param("final_norm"), x)
        return self._logits(x), aux

    def _run(self, x: torch.Tensor, mode: str, caches: list[Cache], kv=None):
        new, plan = [], self._plan
        for i, (layer, cache) in enumerate(zip(self.layers, caches, strict=True)):
            seq = kv if layer.kind in SPLIT_KV_KINDS else None
            module, prefix = self._layer(i, layer)
            split = None if plan is None else plan.layers.get(prefix)
            x, _, cache = self._call(module, prefix, x, mode, cache, None, seq, split, plan=plan)
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
        rank's block of the positions (:func:`make_caches` with ``kv``).
        On a mesh whose decode policy splits the vocabulary (or the MLP),
        the logits are this rank's block of them (:meth:`split_plan`); a
        split mamba block's caches hold the rank's heads
        (:func:`make_caches` with the plan's ``ssm``)."""
        with self._splitting(self.split_plan(serving=True)):
            x, new = self._run(self._front(tokens, vision_embeds), PREFILL, caches, kv)
            return self._logits(x[:, -1:]), new

    def decode_step(self, tokens: torch.Tensor, caches: list[Cache], kv=None):
        """One token per row, ``tokens (B, 1)`` (audio: ``(B, K, 1)``), each
        row at its cache's position (the first layer's ``pos``, which the
        audio sinusoid reads): f32 logits ``(B, 1, vocab)`` (audio: ``(B,
        1, K, vocab)``) and the new caches.  ``kv`` as in :meth:`prefill`:
        each split cache's attention is merged over its group; the logits
        and the mamba caches as :meth:`prefill`'s."""
        with self._splitting(self.split_plan(serving=True)):
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
        is the loss and the sum of the gradients its gradient.

        Where the policy computes modules in blocks (:meth:`split_plan`),
        the ranks of the split cooperate on their rows rather than repeat
        them: a split vocabulary's cross entropy is the vocab-parallel one
        (:func:`~repro_torch.distributed.layout.vocab_cross_entropy`),
        each share's gradient is its own (every rank backpropagates into
        its own blocks) and its value is divided over the split
        (:func:`~repro_torch.distributed.layout.share_value`), so the sum
        over the mesh is still the loss.  Where a MoE layer splits over
        axes ``A`` (:attr:`SplitPlan.moe`), every rank of ``A`` computes
        the aux loss whole from the same logits, and its gradient flows
        into the router and the layer's input, both summed over ``A``:
        value and gradient are divided over ``A``
        (:func:`~repro_torch.distributed.layout.part_value`)."""
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
        plan = self.split_plan(seq_axes)
        tp = None if plan is None else plan.tp
        n_tp = 1 if tp is None else tp.n
        bl = b // n_rows
        r0 = mesh.index(rows) * bl
        tok = tokens[r0:r0 + bl]
        s0, sl = (0, s) if seq is None else (seq.start, seq.local)
        with self._splitting(plan):
            logits, aux = self._forward_train(tok[..., s0:s0 + sl],
                                              vision_embeds=None if ve is None else ve[r0:r0 + bl], seq=seq)
        labels = tok[..., s0 + 1:s0 + sl + 1].long()  # the last global position has none
        n_lab = labels.shape[-1]
        lg = logits[:, :n_lab]
        if cfg.n_codebooks > 1:
            lg = lg.transpose(1, 2)  # (B, K, n, V)
        lg = shard_act(lg, *(("batch",) + (None,) * (lg.ndim - 2) + ("vocab_act",)))
        if plan is not None and plan.head:
            nll = layout.vocab_cross_entropy(lg, labels, plan.vocab_start, tp)
        else:  # the whole vocabulary: the same Function, its backward in one logits-sized buffer
            nll = layout.vocab_cross_entropy(lg, labels)
        count = b * (s - 1) * cfg.n_codebooks
        ce = torch.sum(nll) / count / (mesh.size // (n_rows * n_seq * n_tp))
        moe = None if plan is None else plan.moe
        if moe is not None:
            aux = layout.part_value(aux * (bl / b) / (mesh.size // (n_rows * moe.n)), moe.n)
        else:
            aux = aux * (bl / b) / (mesh.size // (n_rows * n_tp))
        if tp is not None:
            ce = layout.share_value(ce, n_tp)
            if moe is None:
                aux = layout.share_value(aux, n_tp)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}


@dataclasses.dataclass(frozen=True)
class LayerSplit:
    """What a layer computes in blocks: its attention's heads (a
    :class:`~repro_torch.layers.attention.HeadSplit`), its MLP's hidden
    columns (a :class:`~repro_torch.distributed.layout.TPSplit`), its
    mamba block's heads (an :class:`~repro_torch.layers.mamba2.SSMSplit`)
    and its MoE's experts or columns (a :class:`~repro_torch.layers.moe.
    MoESplit`), each None where whole."""

    heads: HeadSplit | None = None
    mlp: object = None
    ssm: SSMSplit | None = None
    moe: MoESplit | None = None


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """What a rank computes in blocks under one policy (:func:`split_plan`):
    the split ``tp`` over the axes ``T`` of every split module (None where
    only MoE layers split, over the sequence's axes: their own
    :class:`~repro_torch.layers.moe.MoESplit` holds that split); ``keep``,
    each kept parameter's axes (its block of columns or rows, never
    gathered over them); ``partial``, the parameters whole on the rank
    that a split module reads in part (the query and key norms, the KV
    projections gathered for GQA's group map, a FAµST head's λ, a split
    MoE's router: their gradient is summed over ``T``); ``layers``, each
    layer's
    :class:`LayerSplit` by state dict prefix; whether the head computes its
    vocabulary block (``head``, from ``vocab_start``) and the embedding
    lookup under autograd is vocab-parallel (``embed``).  Every other
    parameter is computed with whole on every rank of ``T``, which then
    holds its whole gradient: it is not summed over ``T``."""

    tp: object
    keep: dict
    partial: frozenset
    layers: dict
    head: bool
    embed: bool
    vocab_start: int

    def whole(self, name: str) -> tuple:
        """The axes over which ``name``'s gradient is whole on every rank."""
        return () if self.tp is None or name in self.partial or name in self.keep else self.tp.axes

    @property
    def ssm(self) -> SSMSplit | None:
        """The heads every split mamba block of the plan computes (its
        :class:`MambaCache`'s), None where they compute whole."""
        return next((s.ssm for s in self.layers.values() if s.ssm is not None), None)

    @property
    def moe(self):
        """The split (a :class:`~repro_torch.distributed.layout.TPSplit`)
        every split MoE layer of the plan computes over, None where they
        compute whole."""
        return next((s.moe.tp for s in self.layers.values() if s.moe is not None), None)


def split_plan(cfg: ArchConfig, blocks: dict, mesh, policy, avoid, serving: bool = False) -> SplitPlan | None:
    """What a rank of ``mesh`` computes in blocks under ``policy``, the
    parameters stored as ``blocks`` (:meth:`LM.shard_`): a module whose
    weight's spec splits an output dimension over axes ``A`` that the
    policy's matching activation name gives too, sharing none with
    ``avoid`` (:func:`~repro_torch.distributed.sharding.compute_axes`):

    * attention (``wq``'s ``heads_flat``, fitted to the query heads): the
      rank's query heads, ``wo``'s rows; ``wk``/``wv`` keep their block
      where ``kv_flat`` splits over ``A`` too (``A`` divides the KV heads),
      else are gathered whole and the rank computes the KV head its query
      heads share (``A``'s ranks must not straddle a GQA group);
    * a dense MLP (``w_up``'s ``mlp``): ``w_up``/``w_gate``'s columns,
      ``w_down``'s rows; a FAµST MLP stays whole;
    * a MoE layer (``w_up``'s ``experts``, fitted to their count, avoiding
      only the batch axes: it routes whole rows): the rank's experts,
      ``w_up``/``w_gate``/``w_down`` kept; else, where the experts stay
      replicated, ``w_up``'s ``mlp`` (fitted to ``moe.d_ff``): every
      expert's columns of ``w_up``/``w_gate``, rows of ``w_down``; the
      router read whole and in part either way (its gradient summed over
      ``A``).  Under a sequence split (``avoid`` less the batch axes)
      ``A`` must be the sequence's axes; the MoE's split is then its own
      (:attr:`SplitPlan.moe`), and no other module may split: ``tp`` stays
      None, since every other parameter's gradient is the rank's
      positions' and is summed over ``A``;
    * a mamba block (``out_proj``'s rows, ``inner_flat``, fitted to the
      SSM's heads; ``serving``: to the axes a ``MambaCache``'s heads lie
      on, :data:`~repro_torch.distributed.sharding.SSM_SERVE_AXES`): the
      rank's heads, ``out_proj``'s rows and ``norm_w``'s block kept;
      ``in_proj``, the conv and the per-head vectors gathered whole and
      read in part (their gradient summed over ``A``); the rank's heads
      must lie in one state group or cover whole groups;
    * the head (``unembed.w``'s ``vocab``, a FAµST head's ``blocks``, a
      tied table's ``vocab``) and a 2-D embedding table (``vocab``): the
      rank's vocabulary block.

    Every split must be over the same axes, and a FAµST head's vocabulary
    must split into whole blocks, or it raises.  None where nothing splits."""
    axes = param_axes(cfg)
    v = cfg.vocab
    rows = batch_axes(policy, mesh)
    seq_axes = tuple(a for a in avoid if a not in rows)

    def ax(name, dim, size):
        if name not in blocks:
            return ()
        return sharding.compute_axes(axes[name][dim], blocks[name].spec[dim], size, policy, mesh, avoid, serving)

    def entry(name, dim):
        return sharding.axes_tuple(blocks[name].spec[dim])

    keep, partial, found, per_layer = {}, set(), [], {}
    kinds = cfg.layer_kinds()
    prefixes = [(f"layers.{i}.", kind) for i, kind in enumerate(kinds) if kind in ("attn", "local", "moe")]
    if "shared" in kinds:
        prefixes.append(("shared.", "attn"))
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for p, kind in prefixes:
        heads = mlp = None
        a = ax(p + "attn.wq", 1, h)
        if a:
            n = math.prod(mesh.shape[x] for x in a)
            hl, g = h // n, h // kh
            if entry(p + "attn.wo", 0) != a:
                raise ValueError(f"{cfg.name}: {p}attn.wo's rows lie on {entry(p + 'attn.wo', 0)}, its heads on {a}")
            kept = ax(p + "attn.wk", 1, kh) == a and ax(p + "attn.wv", 1, kh) == a
            if not kept and g % hl:
                raise ValueError(f"{cfg.name}: {hl} query heads a rank straddle GQA groups of {g} over {a}")
            keep.update({p + "attn.wq": a, p + "attn.wo": a})
            if kept:
                keep.update({p + "attn.wk": a, p + "attn.wv": a})
            else:
                partial.update({p + "attn.wk", p + "attn.wv"})
            partial.update(k for k in (p + "attn.q_norm", p + "attn.k_norm") if k in blocks)
            heads = (a, hl, kh // n if kept else 1, kept)
            found.append(a)
        if kind != "moe" and p + "mlp.w_up" in blocks:
            a = ax(p + "mlp.w_up", 1, cfg.d_ff)
            if a:
                names = [p + "mlp.w_up"] + ([p + "mlp.w_gate"] if p + "mlp.w_gate" in blocks else [])
                if any(entry(n_, 1) != a for n_ in names) or entry(p + "mlp.w_down", 0) != a:
                    raise ValueError(f"{cfg.name}: {p}mlp's projections do not all split their width over {a}")
                keep.update(dict.fromkeys(names + [p + "mlp.w_down"], a))
                mlp = a
                found.append(a)
        if heads is not None or mlp is not None:
            per_layer[p] = (heads, mlp, None)
    for p in (f"layers.{i}." for i, kind in enumerate(kinds) if kind == "ssm"):
        m = cfg.ssm
        a = ax(p + "mamba.out_proj", 0, m.n_heads)
        if not a:
            continue
        n = math.prod(mesh.shape[x] for x in a)
        hl, rep = m.n_heads // n, m.n_heads // m.n_groups
        if hl % rep and rep % hl:
            raise ValueError(f"{cfg.name}: {hl} SSM heads a rank straddle state groups of {rep} heads over {a}")
        if entry(p + "mamba.norm_w", 0) != a:
            raise ValueError(f"{cfg.name}: {p}mamba.norm_w lies on {entry(p + 'mamba.norm_w', 0)}, its heads on {a}")
        keep.update(dict.fromkeys((p + "mamba.out_proj", p + "mamba.norm_w"), a))
        partial.update(p + "mamba." + k for k in ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias"))
        per_layer[p] = (None, None, (hl, rep))
        found.append(a)
    moe = {}
    for p in (f"layers.{i}." for i, kind in enumerate(kinds) if kind == "moe"):
        m = cfg.moe
        names = [p + "moe.w_up"] + ([p + "moe.w_gate"] if p + "moe.w_gate" in blocks else [])
        a = sharding.compute_axes("experts", blocks[p + "moe.w_up"].spec[0], m.n_experts, policy, mesh,
                                  tuple(x for x in avoid if x in rows), serving)
        ep = bool(a)
        if ep:
            if any(entry(n_, 0) != a for n_ in names + [p + "moe.w_down"]):
                raise ValueError(f"{cfg.name}: {p}moe's weights do not all split their experts over {a}")
        else:
            a = sharding.compute_axes("mlp", blocks[p + "moe.w_up"].spec[2], m.d_ff, policy, mesh,
                                      tuple(x for x in avoid if x in rows), serving)
            if not a:
                continue
            if any(entry(n_, 2) != a for n_ in names) or entry(p + "moe.w_down", 1) != a:
                raise ValueError(f"{cfg.name}: {p}moe's experts do not all split their width over {a}")
        keep.update(dict.fromkeys(names + [p + "moe.w_down"], a))
        partial.add(p + "moe.router")
        moe[p] = (a, ep)
    on_seq = bool(moe and seq_axes)
    if on_seq and {a for a, _ in moe.values()} != {seq_axes}:
        raise ValueError(f"{cfg.name}: MoE layers split over {sorted({a for a, _ in moe.values()})}, the sequence "
                         f"over {seq_axes}")
    if not on_seq:
        found += [a for a, _ in moe.values()]
    head = ()
    if cfg.n_codebooks == 1 and not cfg.tie_embeddings:
        if "unembed.w" in blocks:
            head = ax("unembed.w", 1, v)
            keep.update(dict.fromkeys(["unembed.w"] if head else [], head))
        else:
            names = sorted(k for k in blocks if k.startswith("unembed.faust.factors.") and k.endswith(".values"))
            each = {ax(k, 0, v) for k in names}
            head = next(iter(each)) if len(each) == 1 else ()
            if head:
                if len(head) != 1:
                    raise ValueError(f"{cfg.name}: a FAµST head splits its out-blocks over one mesh axis, not {head}")
                blk, n = blocks[names[-1]].global_shape[-1], mesh.shape[head[0]]
                if v % (blk * n):  # a rank's out-blocks must be the dense head's vocabulary block
                    raise ValueError(f"{cfg.name}: a FAµST head's vocabulary of {v} in blocks of {blk} does not "
                                     f"split into {n} whole-block ranges")
                keep.update(dict.fromkeys(names, head))
                partial.add("unembed.faust.lam")
    embed = ()
    if blocks["embed.table"].spec and len(blocks["embed.table"].global_shape) == 2:
        embed = ax("embed.table", 0, v)
        if embed:
            keep["embed.table"] = embed
    if cfg.tie_embeddings and cfg.n_codebooks == 1:
        head = embed
    found += [x for x in (head, embed) if x]
    if on_seq and found:
        raise ValueError(f"{cfg.name}: MoE layers split over the sequence's axes {seq_axes}, other modules over "
                         f"{sorted(set(found))}")
    if not found and not moe:
        return None
    if len(set(found)) > 1:
        raise ValueError(f"{cfg.name}: the modules split over different axes {sorted(set(found))}")
    tp = layout.tp_split(mesh, found[0]) if found else None
    layers = {}
    for p, (heads, mlp, ssm) in per_layer.items():
        hs = ss = None
        if heads is not None:
            _, hl, kvl, kept = heads
            lo = tp.index * kvl if kept else tp.index * hl // (h // kh)
            hs = HeadSplit(tp, hl, lo, kvl, kept)
        if ssm is not None:
            hl, rep = ssm
            ss = SSMSplit(tp, hl, tp.index * hl, max(hl // rep, 1), tp.index * hl // rep)
        layers[p] = LayerSplit(hs, tp if mlp is not None else None, ss)
    for p, (a, ep) in moe.items():
        mt = tp if tp is not None else layout.tp_split(mesh, a)
        e, ff = cfg.moe.n_experts, cfg.moe.d_ff
        split = (MoESplit(mt, e // mt.n, mt.index * (e // mt.n), ff, 0) if ep else
                 MoESplit(mt, e, 0, ff // mt.n, mt.index * (ff // mt.n)))
        layers[p] = dataclasses.replace(layers.get(p, LayerSplit()), moe=split)
    return SplitPlan(tp, keep, frozenset(partial), layers, bool(head), bool(embed),
                     0 if tp is None else tp.index * (v // tp.n))


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
                kv=None, ssm: SSMSplit | None = None) -> list[Cache]:
    """One empty cache of ``batch`` rows per layer on ``device`` (default:
    the CUDA card): a :class:`MambaCache` (conv history in ``dtype``, f32
    state) for an ``"ssm"`` layer, else a :class:`KVCache` of capacity
    :func:`cache_capacity`.  ``kv`` (a :class:`~repro_torch.distributed.
    layout.SeqSplit` of ``cache_len`` positions): a layer of
    :data:`SPLIT_KV_KINDS` holds only this rank's block of them.  ``ssm``
    (the serving plan's :attr:`SplitPlan.ssm`): a :class:`MambaCache`
    holds only this rank's heads and conv channels."""
    check_supported(cfg)
    dev = resolve_device(device)
    if kv is not None and kv.length != cache_len:
        raise ValueError(f"a split of {kv.length} positions for caches of {cache_len}")

    def capacity(kind):
        return kv.local if kv is not None and kind in SPLIT_KV_KINDS else cache_capacity(cfg, kind, cache_len)

    return [mamba_cache_init(batch, cfg.ssm, dtype, dev, ssm) if kind == "ssm" else
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


def greedy_token(logits: torch.Tensor, plan: SplitPlan | None = None) -> torch.Tensor:
    """The argmax over the vocabulary, int32; where ``plan`` splits the
    head, ``logits`` are this rank's block and the pick is the whole
    row's (:func:`~repro_torch.distributed.layout.vocab_argmax`)."""
    if plan is not None and plan.head:
        return layout.vocab_argmax(logits, plan.vocab_start, plan.tp).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
