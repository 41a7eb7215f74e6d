"""Architecture config schema of the port.  Counterpart of
:mod:`repro.configs.base`, with the same field names and defaults.

``stages`` describes the layer pattern as ``(repeat, unit)`` pairs, as in
the reference.  Layer kinds: ``"attn"`` (global attention + FFN),
``"local"`` (sliding-window attention + FFN), ``"moe"`` (global attention
+ MoE FFN), ``"ssm"`` (a mamba2 block, ``ssm``'s :class:`Mamba2Spec`) and
``"shared"`` (zamba2's attention + FFN block, one parameter set run at
every such position).  ``n_codebooks > 1`` (audio) sums that many token
embeddings, adds sinusoidal positions and predicts each codebook with its
own head; ``n_vision_tokens`` (vlm) replaces the first positions with
precomputed patch embeddings.  ``policy`` (training and prefill) and
``policy_decode`` are the reference's sharding policies
(:class:`~repro_torch.distributed.sharding.ShardingPolicy`), with its
common ones: :data:`TP_POLICY`, :data:`CP_POLICY`, :data:`DECODE_POLICY`,
:data:`DECODE_LONG_POLICY`.  :func:`check_supported` names what a config
needs that the port does not have.
:func:`param_count` and :func:`active_param_count` are the reference's
analytic counts: the projections, embeddings and routers, not the norms'
vectors (but a mamba block's ``norm_w``, and not its ``conv_b``), the
shared block once, a FAµST projection (``faust_unembed``, ``faust_mlp``)
counted as the dense matrix it stands for.  :func:`stored_param_count`
counts what the port's model stores but the norms.  :data:`SHAPES` and
:func:`cells_for` are the reference's shape cells (train_4k, prefill_32k,
decode_32k, and long_500k for a ``sub_quadratic`` arch), which the dry run
(``launch/dryrun.py``) runs every arch at.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.layers.mamba2 import Mamba2Spec
from repro_torch.layers.moe import MoESpec

Stage = tuple[int, tuple[str, ...]]
SUPPORTED_KINDS = ("attn", "local", "moe", "ssm", "shared")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # geglu | swiglu | gelu | sq_relu
    norm: str = "rms"  # rms | ln | ln1p
    stages: tuple[Stage, ...] = ()
    # attention details
    rope_base: float = 10000.0
    rope_base_local: float | None = None
    rotary_pct: float = 1.0
    qk_norm: bool = False
    window: int | None = None
    attn_scale: float | None = None
    # embeddings
    tie_embeddings: bool = False
    scale_embed: bool = False
    n_codebooks: int = 1
    n_vision_tokens: int = 0
    # moe / ssm
    moe: MoESpec | None = None
    ssm: Mamba2Spec | None = None
    # the paper's technique
    faust_unembed: FaustSpec | None = None
    faust_mlp: FaustSpec | None = None
    # numerics / distribution
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512
    policy: ShardingPolicy = dataclasses.field(default_factory=ShardingPolicy)
    policy_decode: ShardingPolicy | None = None
    sub_quadratic: bool = False

    def layer_kinds(self) -> tuple[str, ...]:
        kinds: list[str] = []
        for repeat, unit in self.stages:
            kinds.extend(unit * repeat)
        if len(kinds) != self.n_layers:
            raise ValueError(f"{self.name}: stages give {len(kinds)} layers, n_layers is {self.n_layers}")
        return tuple(kinds)

    def decode_policy(self) -> ShardingPolicy:
        return self.policy_decode if self.policy_decode is not None else self.policy


# --- shape cells (assigned to every LM arch) -------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cells_for(cfg: ArchConfig) -> list[str]:
    """The shape cells of ``cfg``: train, prefill and decode, and
    ``long_500k`` for a ``sub_quadratic`` arch."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


# --- common sharding policies ----------------------------------------------

TP_POLICY = ShardingPolicy()  # heads/mlp/vocab on 'model', batch on pod+data

# context-parallel: seq on 'model' (archs whose head counts don't divide 16)
CP_POLICY = ShardingPolicy(seq="model", heads_act=None)

# decode: KV-cache sequence on 'model' (SP decode), batch on data
DECODE_POLICY = ShardingPolicy(batch=("pod", "data"), seq=None, heads_act=None, kv_seq="model")
# long-context decode (batch=1): cache sequence over everything available
DECODE_LONG_POLICY = ShardingPolicy(batch=None, seq=None, heads_act=None, kv_seq=("pod", "data", "model"))


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a layer kind the reference does
    not have, ``ValueError`` for a ``moe``/``ssm`` layer without its spec."""
    bad = sorted(set(cfg.layer_kinds()) - set(SUPPORTED_KINDS))
    if "moe" in cfg.layer_kinds() and cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe layers need a MoESpec (moe)")
    if "ssm" in cfg.layer_kinds() and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: ssm layers need a Mamba2Spec (ssm)")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port trains and serves {SUPPORTED_KINDS} layers; this config needs layer kinds {bad}"
        )


def _glu(cfg: ArchConfig) -> int:
    return 3 if cfg.act in ("geglu", "swiglu") else 2


def _stored(spec: FaustSpec | None, in_dim: int, out_dim: int) -> int:
    """Parameters one projection stores: dense, or a FAµST chain's values and λ."""
    return in_dim * out_dim if spec is None else spec.s_tot(in_dim, out_dim) + 1


def _dense(spec: FaustSpec | None, in_dim: int, out_dim: int) -> int:
    return in_dim * out_dim


def _count(cfg: ArchConfig, stored: bool) -> int:
    """Embedding + layers + unembedding as the reference counts them, or
    (``stored``) as the model stores them: each FAµST projection by its
    values and λ, a mamba block's ``conv_b`` in place of its ``norm_w``."""
    proj = _stored if stored else _dense
    d = cfg.d_model
    total = cfg.vocab * d * cfg.n_codebooks  # embedding
    if not cfg.tie_embeddings:
        total += proj(cfg.faust_unembed, d, cfg.vocab) * cfg.n_codebooks
    glu = _glu(cfg)
    attn_p = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.n_heads * cfg.head_dim * d
    mlp_p = (glu - 1) * proj(cfg.faust_mlp, d, cfg.d_ff) + proj(cfg.faust_mlp, cfg.d_ff, d)
    shared_seen = False
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local"):
            total += attn_p + mlp_p
        elif kind == "moe":
            e = cfg.moe.n_experts
            moe_p = d * e + e * glu * d * cfg.moe.d_ff
            if cfg.moe.shared_expert_ff:
                moe_p += glu * d * cfg.moe.shared_expert_ff
            total += attn_p + moe_p
        elif kind == "ssm":
            s = cfg.ssm
            din = s.d_inner
            total += d * (2 * din + 2 * s.n_groups * s.d_state + s.n_heads) + din * d  # in_proj, out_proj
            total += s.d_conv * s.conv_dim + 3 * s.n_heads  # conv_w; a_log, d_skip, dt_bias
            total += s.conv_dim if stored else din  # conv_b, or the reference's norm_w
        elif kind == "shared":
            if not shared_seen:
                total += attn_p + mlp_p
                shared_seen = True
        else:
            raise ValueError(kind)
    return total


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embedding + layers + unembedding), a
    FAµST projection counted as the dense matrix it stands for, the
    shared block once.  A mamba block counts its ``norm_w`` and not its
    ``conv_b``, as the reference's."""
    return _count(cfg, stored=False)


def stored_param_count(cfg: ArchConfig) -> int:
    """:func:`param_count` with each FAµST projection counted by what it
    stores (block values and λ): the port model's parameter sizes summed
    over every parameter whose name lacks ``norm``.  It differs from
    :func:`param_count` by that and, per mamba block, in two vectors: it
    counts ``conv_b`` (``conv_dim``), which the reference's count leaves
    out, and not ``norm_w`` (``d_inner``), which the reference counts."""
    return _count(cfg, stored=True)


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters a token reads (MoE: its top-k experts and the shared
    expert only)."""
    if cfg.moe is None:
        return param_count(cfg)
    glu = _glu(cfg)
    routed = cfg.moe.n_experts * glu * cfg.d_model * cfg.moe.d_ff
    active_routed = cfg.moe.top_k * glu * cfg.d_model * cfg.moe.d_ff
    n_moe = sum(1 for kind in cfg.layer_kinds() if kind == "moe")
    return param_count(cfg) - n_moe * (routed - active_routed)
