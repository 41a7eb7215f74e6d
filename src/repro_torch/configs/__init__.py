"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke(name)``.  Counterpart of :mod:`repro.configs`.

The port trains and serves the ``"attn"``, ``"local"`` (sliding-window),
``"moe"``, ``"ssm"`` (mamba2) and ``"shared"`` layer kinds with partial
rotary and the two modality front ends (internvl2's vision embeddings,
musicgen's codebooks with sinusoidal positions), so it holds all ten of
the reference's architectures.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["mamba2_2p7b", "gemma3_27b", "gemma_2b", "nemotron4_15b", "chatglm3_6b", "internvl2_2b",
            "llama4_maverick", "granite_moe_3b", "musicgen_medium", "zamba2_7b"]
ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma3-27b": "gemma3_27b",
    "gemma-2b": "gemma_2b",
    "nemotron-4-15b": "nemotron4_15b",
    "chatglm3-6b": "chatglm3_6b",
    "internvl2-2b": "internvl2_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke_config()
