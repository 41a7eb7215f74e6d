"""gemma-2b [dense]: GeGLU, head_dim 256, MQA [arXiv:2403.08295].
Counterpart of :mod:`repro.configs.gemma_2b`.

18 layers, d_model 2048, 8 query heads and one KV head, d_ff 16384,
vocab 256000, tied embeddings scaled by sqrt(d_model).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, CP_POLICY, DECODE_POLICY

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="geglu",
    norm="rms",
    stages=((18, ("attn",)),),
    scale_embed=True,
    tie_embeddings=True,
    policy=CP_POLICY,
    policy_decode=DECODE_POLICY,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=96,
        vocab=131,
        stages=((2, ("attn",)),),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
