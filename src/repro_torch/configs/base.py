"""Architecture config schema of the port.  Counterpart of
:mod:`repro.configs.base`, with the same field names and defaults.

``stages`` describes the layer pattern as ``(repeat, unit)`` pairs, as in
the reference.  Layer kinds: ``"attn"`` (global attention + FFN),
``"local"`` (sliding-window attention + FFN), ``"moe"`` (global attention
+ MoE FFN); the reference's ``"ssm"`` and ``"shared"`` come with a later
slice.  The reference's sharding policies have no counterpart yet
(multi-GPU is a later slice), and ``ssm`` is a placeholder that must stay
``None``: :func:`check_supported` names what a config needs that the port
does not have.  :func:`param_count` and :func:`active_param_count` are the
reference's analytic counts: the projections, embeddings and routers,
not the norms' vectors, a FAµST projection (``faust_unembed``,
``faust_mlp``) counted as the dense matrix it stands for.
:func:`stored_param_count` counts such a projection by what it stores,
its block values and λ.
"""
from __future__ import annotations

import dataclasses

from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.layers.moe import MoESpec

Stage = tuple[int, tuple[str, ...]]
SUPPORTED_KINDS = ("attn", "local", "moe")


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
    # moe; ssm: a later slice
    moe: MoESpec | None = None
    ssm: object | None = None
    # the paper's technique
    faust_unembed: FaustSpec | None = None
    faust_mlp: FaustSpec | None = None
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512
    sub_quadratic: bool = False

    def layer_kinds(self) -> tuple[str, ...]:
        kinds: list[str] = []
        for repeat, unit in self.stages:
            kinds.extend(unit * repeat)
        if len(kinds) != self.n_layers:
            raise ValueError(f"{self.name}: stages give {len(kinds)} layers, n_layers is {self.n_layers}")
        return tuple(kinds)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the later slice a config needs."""
    needs = []
    if cfg.ssm is not None:
        needs.append("mamba2 layers (ssm)")
    if cfg.n_codebooks > 1:
        needs.append("the audio front end (n_codebooks > 1)")
    if cfg.n_vision_tokens:
        needs.append("the vision front end (n_vision_tokens)")
    bad = sorted(set(cfg.layer_kinds()) - set(SUPPORTED_KINDS))
    if bad:
        needs.append(f"layer kinds {bad}")
    if "moe" in cfg.layer_kinds() and cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe layers need a MoESpec (moe)")
    if needs:
        raise NotImplementedError(
            f"{cfg.name}: the port trains and serves {SUPPORTED_KINDS} layers; "
            f"this config needs {', '.join(needs)}, which come with later slices"
        )


def _glu(cfg: ArchConfig) -> int:
    return 3 if cfg.act in ("geglu", "swiglu") else 2


def _stored(spec: FaustSpec | None, in_dim: int, out_dim: int) -> int:
    """Parameters one projection stores: dense, or a FAµST chain's values and λ."""
    return in_dim * out_dim if spec is None else spec.s_tot(in_dim, out_dim) + 1


def _dense(spec: FaustSpec | None, in_dim: int, out_dim: int) -> int:
    return in_dim * out_dim


def _count(cfg: ArchConfig, proj) -> int:
    """Embedding + layers + unembedding, each projection counted by ``proj``."""
    d = cfg.d_model
    total = cfg.vocab * d * cfg.n_codebooks  # embedding
    if not cfg.tie_embeddings:
        total += proj(cfg.faust_unembed, d, cfg.vocab) * cfg.n_codebooks
    glu = _glu(cfg)
    attn_p = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.n_heads * cfg.head_dim * d
    mlp_p = (glu - 1) * proj(cfg.faust_mlp, d, cfg.d_ff) + proj(cfg.faust_mlp, cfg.d_ff, d)
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local"):
            total += attn_p + mlp_p
        elif kind == "moe":
            e = cfg.moe.n_experts
            moe_p = d * e + e * glu * d * cfg.moe.d_ff
            if cfg.moe.shared_expert_ff:
                moe_p += glu * d * cfg.moe.shared_expert_ff
            total += attn_p + moe_p
        elif kind in ("ssm", "shared"):
            raise NotImplementedError(f"{cfg.name}: counting {kind} layers comes with a later slice")
        else:
            raise ValueError(kind)
    return total


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (embedding + layers + unembedding), a
    FAµST projection counted as the dense matrix it stands for."""
    return _count(cfg, _dense)


def stored_param_count(cfg: ArchConfig) -> int:
    """:func:`param_count` with each FAµST projection counted by what it
    stores (block values and λ): the port model's parameter sizes summed
    over every parameter but the norms'."""
    return _count(cfg, _stored)


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
