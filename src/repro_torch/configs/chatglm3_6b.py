"""chatglm3-6b [dense]: 2d/partial RoPE, GQA [arXiv:2406.12793].
Counterpart of :mod:`repro.configs.chatglm3_6b`.

28 layers, d_model 4096, 32 query heads and 2 KV heads of head_dim 128,
d_ff 13696 SwiGLU, vocab 65024; rotary over half the head dim.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    act="swiglu",
    norm="rms",
    stages=((28, ("attn",)),),
    rotary_pct=0.5,  # "RoPE 2d": rotary on half the channels
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=112,
        vocab=123,
        stages=((2, ("attn",)),),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
