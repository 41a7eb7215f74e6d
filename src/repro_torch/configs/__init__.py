"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke(name)``.  Counterpart of :mod:`repro.configs`.

The port trains and serves the ``"attn"``, ``"local"`` (sliding-window),
``"moe"``, ``"ssm"`` (mamba2) and ``"shared"`` layer kinds with partial
rotary, so it holds eight of the reference's ten architectures; the other
two need a modality front end that comes with a later slice, and asking
for one raises, naming what it needs.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["mamba2_2p7b", "gemma3_27b", "gemma_2b", "nemotron4_15b", "chatglm3_6b", "llama4_maverick",
            "granite_moe_3b", "zamba2_7b"]
# the reference's other architectures, and what each still needs
LATER = {
    "internvl2_2b": "the vision front end (n_vision_tokens)",
    "musicgen_medium": "the audio front end (n_codebooks > 1)",
}
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
    if name in LATER:
        raise NotImplementedError(f"arch {name!r} needs {LATER[name]}, which the port has not reached yet")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke_config()
