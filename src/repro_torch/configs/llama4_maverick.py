"""llama4-maverick-400b-a17b [moe]: 128 routed experts, top-1, and a
shared expert [hf:meta-llama/Llama-4 family].  Counterpart of
:mod:`repro.configs.llama4_maverick`.

48 layers, d_model 5120, 40 query heads and 8 KV heads of head_dim 128,
d_ff 8192 per expert, SwiGLU, vocab 202048, MoE in every layer; text
tokens only.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.moe import MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    norm="rms",
    stages=((48, ("moe",)),),
    rope_base=500000.0,
    moe=MoESpec(
        n_experts=128,
        top_k=1,
        d_ff=8192,
        act="swiglu",
        capacity_factor=1.25,
        shared_expert_ff=8192,
    ),
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab=113,
        stages=((2, ("moe",)),),
        moe=MoESpec(
            n_experts=8, top_k=1, d_ff=64, act="swiglu",
            capacity_factor=8.0,  # drop-free (= E/k) for consistency tests
            shared_expert_ff=64,
        ),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
