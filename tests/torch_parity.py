"""Shared helpers for the ``tests/test_torch_*.py`` parity tests: turn the
JAX package's objects into the plain numpy dicts :mod:`repro_torch.bridge`
reads, so both packages compute on the same arrays.  JAX stays on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def jax_chain(dims, blk, k, seed=0, lam=0.75, dtype=np.float32):
    """A JAX ``BlockFaust`` over ``dims`` made with numpy from ``seed``:
    k distinct sorted input blocks per output block, values of std
    1/sqrt(k·blk) (as ``random_block_factor``)."""
    import jax.numpy as jnp

    from repro.core.compress import BlockFaust, BlockSparseFactor

    rng = np.random.default_rng(seed)
    factors = []
    for in_f, out_f in zip(dims[:-1], dims[1:]):
        ib, ob = -(-in_f // blk), -(-out_f // blk)
        kk = min(k, ib)
        idx = np.sort(np.stack([rng.permutation(ib)[:kk] for _ in range(ob)]), axis=1)
        values = rng.standard_normal((ob, kk, blk, blk)).astype(np.float32) / np.sqrt(kk * blk)
        factors.append(BlockSparseFactor(
            jnp.asarray(values, dtype), jnp.asarray(idx, jnp.int32), in_f, out_f
        ))
    return BlockFaust(tuple(factors), jnp.asarray(lam, jnp.float32))


def array(a) -> tuple[np.ndarray, str | None]:
    """numpy view of a JAX array; bf16 as uint16 bits and fp8 as uint8
    bits, each with its dtype name."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return a.view(np.uint8), a.dtype.name
    return a, None


def faust_dict(f) -> dict:
    return {"factors": [np.asarray(s) for s in f.factors], "lam": float(f.lam)}


def blockfaust_dict(bf) -> dict:
    factors, dtype = [], None
    for f in bf.factors:
        values, dtype = array(f.values)
        factors.append({
            "values": values,
            "in_idx": np.asarray(f.in_idx),
            "in_features": f.in_features,
            "out_features": f.out_features,
        })
    return {"factors": factors, "lam": float(bf.lam), "dtype": dtype}


def packed_dict(pc) -> dict:
    values, dtype = array(pc.values)
    d = {
        "values": values,
        "in_idx": np.asarray(pc.in_idx),
        "lam": float(pc.lam),
        "plan": dataclasses.asdict(pc.plan),
        "dtype": dtype,
    }
    if pc.qscheme is not None:
        d["scales"], d["qscheme"] = np.asarray(pc.scales), pc.qscheme
    return d


def to_np(t) -> np.ndarray:
    """A torch tensor (any float dtype) as f32 numpy."""
    return t.detach().float().cpu().numpy()


def rel_max_err(y, ref) -> float:
    """max |y − ref| over max |ref|."""
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def kv_caches_dict(caches) -> tuple[list, str | None]:
    """A reference cache tree (``repro.models.lm.make_caches``: stages of
    unit positions of stacked ``KVCache``) as nested lists of
    ``{"k", "v", "pos"}`` numpy dicts, with the k/v dtype name."""
    tree, dtype = [], None
    for stage in caches:
        out = []
        for c in stage:
            k, dtype = array(c.k)
            out.append({"k": k, "v": array(c.v)[0], "pos": np.asarray(c.pos)})
        tree.append(out)
    return tree, dtype
