"""gemma3-27b [dense]: 5:1 local:global attention [hf:google/gemma-3 family].
Counterpart of :mod:`repro.configs.gemma3_27b`.

62 layers, d_model 5376, 32 query heads and 16 KV heads of head_dim 128,
d_ff 21504 GeGLU, vocab 262144, qk-norm, a sliding window of 1024 on the
local layers, rope bases 10k (local) and 1M (global), embeddings scaled by
sqrt(d_model), attention scaled by (d_model / n_heads)^-0.5.  Its
262144 × 5376 unembedding is the reference's flagship FAµST target.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

# 62 layers: [local×5, global] ×10, then 2 local tail layers
STAGES = ((10, ("local",) * 5 + ("attn",)), (1, ("local", "local")))

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    act="geglu",
    norm="rms",
    stages=STAGES,
    rope_base=1_000_000.0,
    rope_base_local=10_000.0,
    qk_norm=True,
    window=1024,
    scale_embed=True,
    attn_scale=(5376 // 32) ** -0.5,  # query_pre_attn_scalar = d/H
    sub_quadratic=True,  # 52 of 62 layers window-bounded
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=151,
        stages=((1, ("local",) * 5 + ("attn",)), (1, ("local", "local"))),
        window=16,
        attn_scale=16**-0.5,
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
