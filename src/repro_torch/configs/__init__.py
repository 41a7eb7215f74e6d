"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke(name)``.  Counterpart of :mod:`repro.configs`.

The port trains and serves the dense ``"attn"`` layer kind so far, so
gemma-2b is the one architecture it holds; the others need layer kinds
(sliding-window, MoE, mamba) or modality front ends that come with later
slices, and asking for one raises, naming that slice.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma_2b"]
# the reference's other architectures, and what each still needs
LATER = {
    "mamba2_2p7b": "the mamba2 (ssm) layer kind",
    "gemma3_27b": "the sliding-window (local) layer kind",
    "nemotron4_15b": "partial rotary, squared-ReLU MLPs and layernorm1p",
    "chatglm3_6b": "partial rotary (2d RoPE)",
    "internvl2_2b": "the vision front end (n_vision_tokens)",
    "llama4_maverick": "the MoE layer kind",
    "granite_moe_3b": "the MoE layer kind",
    "musicgen_medium": "the audio front end (n_codebooks > 1)",
    "zamba2_7b": "the mamba2 and shared layer kinds",
}
ALIASES = {"gemma-2b": "gemma_2b"}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name in LATER:
        raise NotImplementedError(f"arch {name!r} needs {LATER[name]}, which the port has not reached yet")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke_config()
