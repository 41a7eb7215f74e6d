"""mamba2-2.7b [ssm]: SSD, attention-free [arXiv:2405.21060].
Counterpart of :mod:`repro.configs.mamba2_2p7b`.

64 mamba2 layers, d_model 2560 (d_inner 5120, 80 heads of 64, state 128,
SSD chunk 256), no FFN, vocab 50280, the head tied to the embedding.
Sub-quadratic: O(1) decode state.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, DECODE_POLICY, TP_POLICY
from repro_torch.layers.mamba2 import Mamba2Spec

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,  # d_inner / headdim = 5120 / 64
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    act="swiglu",  # unused (no FFN)
    norm="rms",
    stages=((64, ("ssm",)),),
    ssm=Mamba2Spec(d_model=2560, d_state=128, headdim=64, expand=2, chunk=256),
    tie_embeddings=True,
    sub_quadratic=True,
    policy=TP_POLICY,
    policy_decode=DECODE_POLICY,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,  # d_inner 128 / headdim 32
        vocab=97,
        stages=((2, ("ssm",)),),
        ssm=Mamba2Spec(d_model=64, d_state=16, headdim=32, expand=2, chunk=8),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
