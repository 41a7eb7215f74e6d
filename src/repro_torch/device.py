"""The port's device rule, in one place.

Entry points take ``device=None`` and resolve it here: ``None`` means the
current CUDA card, and raises when there is none — the port never carries
on quietly on the CPU.  Callers that want the CPU (the tests) say so with
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a concrete :class:`torch.device` (``cuda`` gets its
    index, so it compares equal to ``tensor.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
