"""musicgen-medium [audio]: a decoder over EnCodec tokens
[arXiv:2306.05284].  Counterpart of :mod:`repro.configs.musicgen_medium`.

48 layers, d_model 1536, 24 heads (MHA, head_dim 64), d_ff 6144 GELU,
vocab 2048, 4 parallel codebooks: the model sums the codebooks'
embeddings and predicts each with its own head.  No rope: sinusoidal
positions are added to the embeddings.  The EnCodec front end is a stub,
as in the reference: the model takes the token ids.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, CP_POLICY, DECODE_POLICY

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    norm="ln",
    stages=((48, ("attn",)),),
    rotary_pct=0.0,  # sinusoidal positions instead
    n_codebooks=4,
    policy=CP_POLICY,
    policy_decode=DECODE_POLICY,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        head_dim=12,
        d_ff=96,
        vocab=67,
        stages=((2, ("attn",)),),
        n_codebooks=2,
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
