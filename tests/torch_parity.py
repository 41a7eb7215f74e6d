"""Shared helpers for the ``tests/test_torch_*.py`` parity tests: turn the
JAX package's objects into the plain numpy dicts :mod:`repro_torch.bridge`
reads, so both packages compute on the same arrays.  JAX stays on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

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


def tensor(a):
    """A torch tensor (on the CPU) of a JAX or numpy array; bf16 through
    its bits."""
    import torch

    a, dtype = array(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_np(t) -> np.ndarray:
    """A torch tensor (any float dtype) as f32 numpy."""
    return t.detach().float().cpu().numpy()


def rel_max_err(y, ref) -> float:
    """max |y − ref| over max |ref|."""
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def caches_dict(caches) -> tuple[list, str | None]:
    """A reference cache tree (``repro.models.lm.make_caches``: stages of
    unit positions of stacked ``KVCache`` or ``MambaCache``) as nested
    lists of numpy dicts of the caches' fields, with the name of the dtype
    that crosses as bit views (k/v, or a mamba cache's conv history)."""
    tree, dtype = [], None
    for stage in caches:
        out = []
        for c in stage:
            leaf = {}
            for name, a in c._asdict().items():
                leaf[name], dt = array(a)
                dtype = dt or dtype
            out.append(leaf)
        tree.append(out)
    return tree, dtype


# the architectures of the port's slice 10, and the FAµST unembedding
# their parity tests give them (n_factors, block, k)
SLICE10_ARCHS = ["chatglm3_6b", "nemotron4_15b", "gemma3_27b", "granite_moe_3b", "llama4_maverick"]
# slice 11: the mamba2 (ssm) and zamba2 (ssm + shared) architectures
SSM_ARCHS = ["mamba2_2p7b", "zamba2_7b"]
ARCH_HEAD = (2, 16, 2)


def arch_cfgs(arch: str, faust: bool = False):
    """(reference smoke config, port smoke config) of ``arch``, with the
    FAµST unembedding ``ARCH_HEAD`` (untied) when ``faust``."""
    from repro.configs import get_smoke as jget_smoke
    from repro.layers.faust_linear import FaustSpec as JSpec
    from repro_torch.configs import get_smoke
    from repro_torch.layers.faust_linear import FaustSpec

    jextra = dict(faust_unembed=JSpec(*ARCH_HEAD), tie_embeddings=False) if faust else {}
    extra = dict(faust_unembed=FaustSpec(*ARCH_HEAD), tie_embeddings=False) if faust else {}
    return dataclasses.replace(jget_smoke(arch), **jextra), dataclasses.replace(get_smoke(arch), **extra)


@functools.lru_cache(maxsize=None)
def arch_pair(arch: str, faust: bool = False):
    """(reference cfg, reference params, port cfg, port LM on the CPU) on
    the same parameters: the reference's ``init_model(PRNGKey(0))``
    carried across by the bridge."""
    import jax

    from repro.models import lm as jlm
    from repro_torch import bridge
    from repro_torch.models.lm import LM

    jcfg, cfg = arch_cfgs(arch, faust)
    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device="cpu"), strict=True)
    return jcfg, params, cfg, model


def arch_tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def bf16_tree(params):
    """A reference parameter tree with numpy leaves, bf16 as uint16 bits."""
    import jax

    return jax.tree_util.tree_map(lambda a: array(a)[0], params)


def same_tree(a, b) -> bool:
    """Two trees of the same structure with bitwise-equal leaves."""
    import jax

    return jax.tree_util.tree_all(jax.tree_util.tree_map(lambda x, y: np.array_equal(np.asarray(x), np.asarray(y)),
                                                         a, b))
