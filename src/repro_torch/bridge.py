"""Weights carried across as plain numpy dicts.

The port never imports the JAX package; chains and factors cross between
the two as dicts of numpy arrays and Python numbers, so both packages
compute on the same arrays:

* Faust:        ``{"factors": [ndarray, ...], "lam": float}``
* BlockFaust:   ``{"factors": [{"values", "in_idx", "in_features",
                "out_features"}, ...], "lam": float}``
* PackedChain:  ``{"values", "in_idx", "lam", "plan": {ChainPlan fields}}``

bf16 values cross as ``uint16`` bit views with ``"dtype": "bfloat16"``
beside them (``torch.from_numpy`` has no bfloat16).  The ``*_from_numpy``
converters run on ``device`` (default: the CUDA card; raises without
one) and check index ranges, so a malformed table never reaches a kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import BlockFaust, BlockSparseFactor, ChainPlan, PackedChain
from repro_torch.core.faust import Faust
from repro_torch.device import resolve_device

_PLAN_FIELDS = ("block", "in_blocks", "out_blocks", "k_blocks", "offsets", "in_feats", "out_feats")


def _tensor(a, device: torch.device, dtype_name: str | None = None) -> torch.Tensor:
    a = np.array(a)  # a private, writable, contiguous copy
    if dtype_name == "bfloat16":
        if a.dtype != np.uint16:
            raise TypeError(f"bfloat16 values cross as uint16 bit views; got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _lam(lam, device) -> torch.Tensor:
    return torch.tensor(float(lam), dtype=torch.float32, device=device)


def _check_idx(in_idx: np.ndarray, n_in_blocks: int) -> np.ndarray:
    idx = np.asarray(in_idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n_in_blocks):
        raise ValueError(f"in_idx outside [0, {n_in_blocks}): {idx.min()}..{idx.max()}")
    return idx.astype(np.int32)


def faust_from_numpy(d: dict, device=None) -> Faust:
    dev = resolve_device(device)
    return Faust(tuple(_tensor(f, dev) for f in d["factors"]), _lam(d["lam"], dev))


def _factor_from_numpy(f: dict, dev, dtype_name) -> BlockSparseFactor:
    values = _tensor(f["values"], dev, dtype_name)
    n_in = -(-int(f["in_features"]) // values.shape[2])
    return BlockSparseFactor(
        values,
        _tensor(_check_idx(f["in_idx"], n_in), dev),
        int(f["in_features"]),
        int(f["out_features"]),
    )


def blockfaust_from_numpy(d: dict, device=None) -> BlockFaust:
    dev = resolve_device(device)
    dtype_name = d.get("dtype")
    factors = tuple(_factor_from_numpy(f, dev, dtype_name) for f in d["factors"])
    return BlockFaust(factors, _lam(d["lam"], dev))


def packed_from_numpy(d: dict, device=None) -> PackedChain:
    dev = resolve_device(device)
    p = d["plan"]
    plan = ChainPlan(
        block=int(p["block"]),
        **{k: tuple(int(v) for v in p[k]) for k in _PLAN_FIELDS[1:]},
    )
    idx = np.asarray(d["in_idx"])
    for j in range(plan.n_factors):
        _check_idx(idx[plan.offsets[j]:plan.offsets[j + 1]], plan.in_blocks[j])
    return PackedChain(
        _tensor(d["values"], dev, d.get("dtype")),
        _tensor(idx.astype(np.int32), dev),
        _lam(d["lam"], dev),
        plan,
    )


def to_numpy(obj) -> dict:
    """The dict form of a :class:`Faust`, :class:`BlockFaust` or
    :class:`PackedChain` (inverse of the ``*_from_numpy`` converters)."""
    if isinstance(obj, Faust):
        return {"factors": [_array(f)[0] for f in obj.factors], "lam": float(obj.lam)}
    if isinstance(obj, BlockFaust):
        factors, dtype_name = [], None
        for f in obj.factors:
            values, dtype_name = _array(f.values)
            factors.append({
                "values": values,
                "in_idx": _array(f.in_idx)[0],
                "in_features": f.in_features,
                "out_features": f.out_features,
            })
        return {"factors": factors, "lam": float(obj.lam), "dtype": dtype_name}
    if isinstance(obj, PackedChain):
        values, dtype_name = _array(obj.values)
        return {
            "values": values,
            "in_idx": _array(obj.in_idx)[0],
            "lam": float(obj.lam),
            "plan": {k: getattr(obj.plan, k) for k in _PLAN_FIELDS},
            "dtype": dtype_name,
        }
    raise TypeError(f"to_numpy expects Faust | BlockFaust | PackedChain, got {type(obj).__name__}")
