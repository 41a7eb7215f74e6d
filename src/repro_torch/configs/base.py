"""Architecture config schema of the port.  Counterpart of
:mod:`repro.configs.base`, with the same field names and defaults.

``stages`` describes the layer pattern as ``(repeat, unit)`` pairs, as in
the reference.  The reference's sharding policies have no counterpart yet
(multi-GPU is a later slice), and ``moe``/``ssm`` are placeholders that
must stay ``None``: :func:`check_supported` names what a config needs
that the port does not have.
"""
from __future__ import annotations

import dataclasses

from repro_torch.layers.faust_linear import FaustSpec

Stage = tuple[int, tuple[str, ...]]
SUPPORTED_KINDS = ("attn",)


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
    # moe / ssm: later slices
    moe: object | None = None
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
    if cfg.moe is not None:
        needs.append("MoE layers (moe)")
    if cfg.ssm is not None:
        needs.append("mamba2 layers (ssm)")
    if cfg.n_codebooks > 1:
        needs.append("the audio front end (n_codebooks > 1)")
    if cfg.n_vision_tokens:
        needs.append("the vision front end (n_vision_tokens)")
    bad = sorted(set(cfg.layer_kinds()) - set(SUPPORTED_KINDS))
    if bad:
        needs.append(f"layer kinds {bad}")
    if cfg.rotary_pct != 1.0:
        needs.append("partial rotary")
    if needs:
        raise NotImplementedError(
            f"{cfg.name}: the port trains and serves dense {SUPPORTED_KINDS} layers; "
            f"this config needs {', '.join(needs)}, which come with later slices"
        )
