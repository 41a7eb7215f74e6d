"""nemotron-4-15b [dense]: GQA and a squared-ReLU FFN [arXiv:2402.16819].
Counterpart of :mod:`repro.configs.nemotron4_15b`.

32 layers, d_model 6144, 48 query heads and 8 KV heads of head_dim 128,
d_ff 24576, vocab 256000, zero-centered LayerNorm ("layernorm1p"),
rotary over half the head dim.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, DECODE_POLICY, TP_POLICY

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    act="sq_relu",
    norm="ln1p",
    stages=((32, ("attn",)),),
    rotary_pct=0.5,
    policy=TP_POLICY,
    policy_decode=DECODE_POLICY,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab=119,
        stages=((2, ("attn",)),),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
