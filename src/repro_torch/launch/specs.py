"""Stand-ins for every model input: tensors of the right shape and dtype
that hold no data.  Counterpart of :mod:`repro.launch.specs`, whose
``ShapeDtypeStruct``\\ s these are: on the ``"meta"`` device by default, or
on any device inside a ``FakeTensorMode`` (``launch/dryrun.py``).

``batch_specs(cfg, cell)`` is the abstract batch of a shape cell,
``cache_specs(cfg, cell)`` the decode caches of
:func:`repro_torch.models.lm.make_caches` (one per layer, the batch on axis
0; the reference stacks each stage's and puts the repeat first), and
``input_specs(cfg, cell_name)`` both as the cell's entry point takes them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.models import lm


def batch_specs(cfg: ArchConfig, cell: ShapeCell, device="meta", batch: int | None = None) -> dict:
    """``tokens`` int32 ``(B, S)`` (``(B, K, S)`` with codebooks; ``S = 1``
    in decode) and, outside decode, a vision model's f32 ``vision_embeds
    (B, nv, d)``; ``batch`` overrides the cell's global batch."""
    b = cell.global_batch if batch is None else batch
    s = 1 if cell.kind == "decode" else cell.seq_len
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks > 1 else (b, s)
    out = {"tokens": torch.zeros(shape, dtype=torch.int32, device=device)}
    if cfg.n_vision_tokens and cell.kind != "decode":
        out["vision_embeds"] = torch.zeros((b, cfg.n_vision_tokens, cfg.d_model), dtype=torch.float32, device=device)
    return out


def cache_specs(cfg: ArchConfig, cell: ShapeCell, device="meta") -> list:
    """The caches of the cell's rows for ``cell.seq_len`` positions, in the
    model's dtype (``launch/steps.py`` ``decode_pool`` is a rank's share)."""
    return lm.make_caches(cfg, cell.global_batch, cell.seq_len, dtype=lm.DTYPES[cfg.dtype], device=device)


def input_specs(cfg: ArchConfig, cell_name: str, device="meta") -> dict:
    """The abstract inputs of the cell's entry point: ``batch``, and for
    prefill and decode ``caches``."""
    cell = SHAPES[cell_name]
    specs = {"batch": batch_specs(cfg, cell, device)}
    if cell.kind in ("prefill", "decode"):
        specs["caches"] = cache_specs(cfg, cell, device)
    return specs
