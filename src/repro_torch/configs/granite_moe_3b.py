"""granite-moe-3b-a800m [moe]: 40 experts, top-8 [hf:ibm-granite family].
Counterpart of :mod:`repro.configs.granite_moe_3b`.

32 layers, d_model 1536, 24 query heads and 8 KV heads of head_dim 64,
d_ff 512 per expert, SwiGLU, vocab 49155, tied embeddings.  The smoke
config's capacity factor is E/k, which drops no token: a whole sequence
routes as one token at a time does.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, DECODE_POLICY
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.layers.moe import MoESpec

# context-parallel activations, the sequence gathered at the MoE boundary
GRANITE_POLICY = ShardingPolicy(seq="model", heads_act=None, moe_gather_seq=True)

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    act="swiglu",
    norm="rms",
    stages=((32, ("moe",)),),
    tie_embeddings=True,
    moe=MoESpec(n_experts=40, top_k=8, d_ff=512, act="swiglu", capacity_factor=1.25),
    policy=GRANITE_POLICY,
    policy_decode=DECODE_POLICY,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        head_dim=12,
        d_ff=32,
        vocab=101,
        stages=((2, ("moe",)),),
        # capacity_factor = E/k: drop-free for consistency tests
        moe=MoESpec(n_experts=5, top_k=2, d_ff=32, act="swiglu", capacity_factor=2.5),
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
