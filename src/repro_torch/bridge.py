"""Weights carried across as plain numpy dicts.

The port never imports the JAX package; chains and factors cross between
the two as dicts of numpy arrays and Python numbers, so both packages
compute on the same arrays:

* Faust:        ``{"factors": [ndarray, ...], "lam": float}``
* BlockFaust:   ``{"factors": [{"values", "in_idx", "in_features",
                "out_features"}, ...], "lam": float}``
* PackedChain:  ``{"values", "in_idx", "lam", "plan": {ChainPlan fields}}``,
                plus ``"scales"`` and ``"qscheme"`` for a quantized chain
* KV caches:    the reference's cache tree (``repro.models.lm``
                ``make_caches``: per stage, per unit position, a
                ``{"k", "v", "pos"}`` dict stacked over the stage's repeat
                on axis 0, slots on axis 1), mapped to and from the port's
                per-layer :class:`~repro_torch.layers.attention.KVCache`
                list (slots on axis 0)
* LM params:    the reference's parameter tree (``repro.models.lm``
                ``init_model``: nested dicts and lists, each stage's layers
                stacked on a leading axis) with numpy leaves, mapped to and
                from the port's :class:`~repro_torch.models.lm.LM` state
                dict (layers unstacked: ``stages/0/0/attn/wq[l]`` is
                ``layers.{l}.attn.wq``)
* train state:  the reference trainer's ``{"params", "opt": AdamWState(mu,
                nu, step), "ef": EFState(residual)}`` with numpy leaves,
                mapped to and from the port's state dict, ``AdamWState``
                and ``EFState`` (moments and residuals keyed like the
                parameters)

bf16 values cross as ``uint16`` bit views with ``"dtype": "bfloat16"``
beside them (``torch.from_numpy`` has no bfloat16); fp8 codes likewise as
``uint8`` bit views with ``"dtype": "float8_e4m3fn"`` or ``"float8_e5m2"``.
int8 codes cross as they are.  The ``*_from_numpy``
converters run on ``device`` (default: the CUDA card; raises without
one) and check index ranges, so a malformed table never reaches a kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import (
    QUANT_DTYPES,
    QUANT_SCHEMES,
    BlockFaust,
    BlockSparseFactor,
    ChainPlan,
    PackedChain,
)
from repro_torch.core.faust import Faust
from repro_torch.device import resolve_device
from repro_torch.layers.attention import KVCache

_PLAN_FIELDS = ("block", "in_blocks", "out_blocks", "k_blocks", "offsets", "in_feats", "out_feats")
# dtypes numpy lacks: name -> (torch dtype, numpy dtype of the bit view)
_BIT_VIEWS = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}


def _tensor(a, device: torch.device, dtype_name: str | None = None) -> torch.Tensor:
    a = np.array(a)  # a private, writable, contiguous copy
    if dtype_name in _BIT_VIEWS:
        tdt, bits = _BIT_VIEWS[dtype_name]
        if a.dtype != bits:
            raise TypeError(f"{dtype_name} values cross as {np.dtype(bits).name} bit views; got {a.dtype}")
        if bits == np.uint16:  # torch has no uint16 view source: go through int16
            return torch.from_numpy(a.view(np.int16)).view(tdt).to(device)
        return torch.from_numpy(a).view(tdt).to(device)
    return torch.from_numpy(a).to(device)


def _array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name in _BIT_VIEWS:
        bits = _BIT_VIEWS[name][1]
        view = torch.int16 if bits == np.uint16 else torch.uint8
        return t.view(view).numpy().view(bits), name
    return t.numpy(), name


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
    values = _tensor(d["values"], dev, d.get("dtype"))
    qscheme = d.get("qscheme")
    scales = None
    if qscheme is not None:
        qdtype, _, scheme = qscheme.partition(":")
        if qdtype not in QUANT_DTYPES or scheme not in QUANT_SCHEMES:
            raise ValueError(f"unknown qscheme {qscheme!r}")
        if values.dtype != QUANT_DTYPES[qdtype][0]:
            raise TypeError(f"qscheme {qscheme!r} needs {QUANT_DTYPES[qdtype][0]} codes; got {values.dtype}")
        scales = _tensor(np.asarray(d["scales"], np.float32), dev)
        want = (plan.n_steps,) if scheme == "per_block" else (plan.n_steps, plan.block)
        if tuple(scales.shape) != want:
            raise ValueError(f"{scheme} scales must be {want}; got {tuple(scales.shape)}")
    return PackedChain(values, _tensor(idx.astype(np.int32), dev), _lam(d["lam"], dev), plan,
                       scales, qscheme)


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
        d = {
            "values": values,
            "in_idx": _array(obj.in_idx)[0],
            "lam": float(obj.lam),
            "plan": {k: getattr(obj.plan, k) for k in _PLAN_FIELDS},
            "dtype": dtype_name,
        }
        if obj.quantized:
            d["scales"], _ = _array(obj.scales)
            d["qscheme"] = obj.qscheme
        return d
    raise TypeError(f"to_numpy expects Faust | BlockFaust | PackedChain, got {type(obj).__name__}")


def flatten_tree(tree, prefix: str = "", pick=None) -> dict[str, np.ndarray]:
    """A nested dict/list tree of arrays as ``{dotted path: array}`` (the
    state dict keys of the matching module); ``pick`` indexes every leaf."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}.", pick))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}.", pick))
    else:
        out[prefix[:-1]] = np.asarray(tree) if pick is None else np.asarray(tree)[pick]
    return out


def flatten_lm_tree(tree: dict, cfg) -> dict[str, np.ndarray]:
    """The reference's LM tree as ``{state dict key: array}``: paths joined
    with dots, each stage's stacked layers split into ``layers.{l}``."""
    out = flatten_tree({k: v for k, v in tree.items() if k != "stages"})
    layer = 0
    for si, (repeat, unit) in enumerate(cfg.stages):
        for r in range(repeat):
            for pos in range(len(unit)):
                out.update(flatten_tree(tree["stages"][si][pos], f"layers.{layer}.", r))
                layer += 1
    return out


def lm_state_dict_from_numpy(tree: dict, cfg, *, dtype: str | None = None, device=None) -> dict[str, torch.Tensor]:
    """The port's LM state dict from the reference's tree; ``dtype`` names
    the floating leaves' type when they cross as bit views (``bfloat16``)."""
    dev = resolve_device(device)
    return {
        k: _tensor(a, dev, dtype if a.dtype == np.uint16 else None)
        for k, a in flatten_lm_tree(tree, cfg).items()
    }


def _nest(flat: dict) -> dict:
    """``{dotted path: array}`` as a nested tree; a dict whose keys are
    0..n-1 becomes a list."""
    root: dict = {}
    for key, a in flat.items():
        *head, last = key.split(".")
        node = root
        for part in head:
            node = node.setdefault(part, {})
        node[last] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def lm_state_dict_to_numpy(state_dict: dict, cfg) -> tuple[dict, str | None]:
    """The reference's tree (layers stacked again) from the port's state
    dict, with the floating leaves' dtype name (bf16 as ``uint16`` bits)."""
    flat, dtype = {}, None
    for key, t in state_dict.items():
        flat[key], name = _array(t)
        if name in _BIT_VIEWS:
            dtype = name
    where = [(si, pos) for si, (repeat, unit) in enumerate(cfg.stages) for _ in range(repeat)
             for pos in range(len(unit))]
    per: dict = {}
    for key in [k for k in flat if k.startswith("layers.")]:
        _, layer, rest = key.split(".", 2)
        si, pos = where[int(layer)]
        per.setdefault(f"stages.{si}.{pos}.{rest}", {})[int(layer)] = flat.pop(key)
    for key, rows in per.items():
        flat[key] = np.stack([rows[layer] for layer in sorted(rows)])
    return _nest(flat), dtype


def kv_caches_from_numpy(tree: list, cfg, *, dtype: str | None = None, device=None) -> list[KVCache]:
    """The port's per-layer cache list from the reference's cache tree
    with numpy leaves; ``dtype`` names the k/v leaves' type when they
    cross as bit views (``bfloat16``)."""
    dev = resolve_device(device)
    out = []
    for si, (repeat, unit) in enumerate(cfg.stages):
        for r in range(repeat):
            for pos in range(len(unit)):
                c = tree[si][pos]
                kv = [_tensor(np.asarray(c[n])[r], dev, dtype if np.asarray(c[n]).dtype == np.uint16 else None)
                      for n in ("k", "v")]
                out.append(KVCache(*kv, _tensor(np.asarray(c["pos"])[r].astype(np.int32), dev)))
    return out


def kv_caches_to_numpy(caches: list[KVCache], cfg) -> tuple[list, str | None]:
    """The reference's cache tree (layers stacked per stage again) from
    the port's cache list, with the k/v leaves' dtype name (bf16 as
    ``uint16`` bits)."""
    tree, layer, dtype = [], 0, None
    for repeat, unit in cfg.stages:
        stage = []
        for pos in range(len(unit)):
            rows = [caches[layer + r * len(unit) + pos] for r in range(repeat)]
            leaf = {}
            for n in ("k", "v", "pos"):
                arrs = [_array(getattr(c, n)) for c in rows]
                leaf[n] = np.stack([a for a, _ in arrs])
                if n != "pos" and arrs[0][1] in _BIT_VIEWS:
                    dtype = arrs[0][1]
            stage.append(leaf)
        tree.append(stage)
        layer += repeat * len(unit)
    return tree, dtype


def _field(obj, name: str):
    """``obj.name`` of a NamedTuple, or ``obj[name]`` of a dict."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _is_float_array(a) -> bool:
    a = np.asarray(a)
    return a.dtype.kind == "f" or a.dtype == np.uint16  # uint16: bf16 bits


def _per_param(params, moments, other):
    """The moment tree with ``other(param)`` in place of each leaf whose
    parameter is not floating (the FAµST supports, whose reference moments
    are 0-d zeros, never stacked per layer)."""
    if isinstance(params, dict):
        return {k: _per_param(params[k], moments[k], other) for k in params}
    if isinstance(params, (list, tuple)):
        return [_per_param(p, m, other) for p, m in zip(params, moments)]
    return moments if _is_float_array(params) else other(params)


def train_state_from_numpy(tree: dict, cfg, *, dtype: str | None = None, device=None):
    """The port's ``(state dict, AdamWState, EFState | None)`` from the
    reference trainer's state with numpy leaves (``tree["opt"]`` and
    ``tree["ef"]`` as the NamedTuples or as dicts of their fields).  The
    moments and residuals of integer parameters have no counterpart and
    are dropped; ``dtype`` names the parameters' type when they cross as
    bit views (``bfloat16``)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.compression import EFState

    dev = resolve_device(device)
    params = tree["params"]
    sd = lm_state_dict_from_numpy(params, cfg, dtype=dtype, device=dev)
    floats = {k for k, t in sd.items() if t.is_floating_point()}

    def moments(m) -> dict:
        # the integer parameters stand in for their moments while the layers unstack
        flat = flatten_lm_tree(_per_param(params, m, lambda a: a), cfg)
        return {k: _tensor(np.asarray(a, np.float32), dev) for k, a in flat.items() if k in floats}

    opt = tree["opt"]
    step = _tensor(np.asarray(_field(opt, "step"), np.int32), dev)
    state = AdamWState(moments(_field(opt, "mu")), moments(_field(opt, "nu")), step)
    ef = EFState(moments(_field(tree["ef"], "residual"))) if tree.get("ef") is not None else None
    return sd, state, ef


def train_state_to_numpy(state_dict: dict, opt, ef, cfg) -> tuple[dict, str | None]:
    """The reference trainer's state tree ``{"params", "opt": {"mu", "nu",
    "step"}, "ef": {"residual"}}`` (``"ef"`` only with ``ef``) from the
    port's, with the parameters' dtype name (bf16 as ``uint16`` bits).
    Integer parameters get the reference's 0-d zero moments."""
    params, dtype = lm_state_dict_to_numpy(state_dict, cfg)

    def moments(m: dict):
        # the integer parameters stand in for their moments while the layers stack
        full = {k: m.get(k, state_dict[k]) for k in state_dict}
        return _per_param(params, lm_state_dict_to_numpy(full, cfg)[0], lambda a: np.zeros((), np.float32))

    out = {"params": params,
           "opt": {"mu": moments(opt.mu), "nu": moments(opt.nu), "step": _array(opt.step)[0]}}
    if ef is not None:
        out["ef"] = {"residual": moments(ef.residual)}
    return out, dtype
