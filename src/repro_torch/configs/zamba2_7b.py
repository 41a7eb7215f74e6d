"""zamba2-7b [hybrid]: a Mamba2 backbone with a shared attention block
[arXiv:2411.15242].  Counterpart of :mod:`repro.configs.zamba2_7b`.

81 layers, d_model 3584 (mamba2 state 64, 112 heads of 64), and one
shared transformer block (32 heads of 112, MHA, d_ff 14336 SwiGLU) run at
every 6th position: one parameter set at 13 positions, each with its own
KV cache (the released model's per-occurrence LoRA deltas are left out,
as in the reference).  vocab 32000.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.mamba2 import Mamba2Spec

# 81 layers = 13 × (5 mamba + 1 shared) + a tail of 3 mamba
STAGES = ((13, ("ssm",) * 5 + ("shared",)), (1, ("ssm",) * 3))

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    act="swiglu",
    norm="rms",
    stages=STAGES,
    ssm=Mamba2Spec(d_model=3584, d_state=64, headdim=64, expand=2, chunk=256),
    sub_quadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=9,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=109,
        stages=((2, ("ssm",) * 3 + ("shared",)), (1, ("ssm",))),
        ssm=Mamba2Spec(d_model=64, d_state=16, headdim=32, expand=2, chunk=8),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
