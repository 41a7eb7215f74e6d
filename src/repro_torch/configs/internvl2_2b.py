"""internvl2-2b [vlm]: InternViT front end and InternLM2 backbone
[arXiv:2404.16821].  Counterpart of :mod:`repro.configs.internvl2_2b`.

24 layers, d_model 2048, 16 query heads and 8 KV heads of head_dim 128,
d_ff 8192 SwiGLU, vocab 92553.  The ViT front end is a stub, as in the
reference: the model takes precomputed patch embeddings
(``vision_embeds``, 256 positions: InternVL's 448 px pixel-shuffle
output), which replace the first ``n_vision_tokens`` positions.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    act="swiglu",
    norm="rms",
    stages=((24, ("attn",)),),
    n_vision_tokens=256,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=117,
        stages=((2, ("attn",)),),
        n_vision_tokens=8,
        dtype="float32",
        remat=False,
        attn_chunk=8,
    )
