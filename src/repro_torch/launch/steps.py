"""A rank's step on a mesh, and where its state lies: what the dry run
(``launch/dryrun.py``) drives.  Counterpart of :mod:`repro.launch.steps`.

The reference returns jitted functions of abstract arguments under
shardings it chooses; the port's step functions return callables that run
the port's own code on the model :meth:`LM.shard_ <repro_torch.models.lm.LM.shard_>`
split, on whatever tensors the model holds (real, or fake in a dry run):

* :func:`make_sharded_train_step`: the trainer's step
  (``runtime/trainer.py`` ``make_train_step(model, ..., mesh)``): loss and
  gradients, the NaN guard decided on the device, AdamW.  The trainer's
  host loop (checkpoints, the guard's read-back) is not part of it;
* :func:`make_sharded_prefill` and :func:`make_sharded_decode`: ``LM.prefill``
  and ``LM.decode_step`` as ``runtime/engine.py``'s ``LMExecutor(mesh=)``
  runs them, under the config's **decode** policy.  The reference prefills
  under ``cfg.policy`` (train-like sharding, a batch of prompts split over
  the rows); the port's executor prefills one request at a time, the same
  on every rank, into a fresh one-row cache whose global-attention blocks
  are split by position (:func:`make_sharded_prefill` runs one; a cell of
  B prompts is B of them).  A decode step gathers the rank's live rows
  from its pool, steps them, scatters them back, and gathers every row's
  token and finite flag over the rows' axes.

Where the state lies (the rank's :class:`~repro_torch.distributed.sharding.
Block` of each tensor): :func:`param_shardings` (``cfg.policy``'s
parameter rules, as ``LM.shard_`` keeps them; AdamW's moments the same
blocks), :func:`batch_shardings` (the trainer takes the whole batch on
every rank and each computes its rows; a decode step's tokens are the
rank's rows) and :func:`cache_shardings` (the executor's pool: rows over
the decode policy's ``batch`` axes, each global-attention cache's
positions over its ``kv_seq`` axes; a sliding-window ring and a
``MambaCache`` whole on every rank of their rows, ROADMAP caveat R11,
where the reference splits the ring's positions and the SSM state's heads
too).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding
from repro_torch.distributed.layout import seq_split
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.layers.attention import KVCache
from repro_torch.layers.mamba2 import MambaCache
from repro_torch.layers.param import param_axes, param_shapes
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.engine import RowLogits, _split_axes


def param_specs(cfg: ArchConfig, mesh) -> dict:
    """``{name: spec}`` of every parameter under ``cfg.policy``."""
    return sharding.resolve_param_pspecs(param_axes(cfg), param_shapes(cfg), mesh, cfg.policy)


def param_shardings(cfg: ArchConfig, mesh) -> dict:
    """``{name: Block}``: this rank's block of every parameter (rank 0's on
    an :class:`~repro_torch.distributed.mesh.AbstractMesh`)."""
    return sharding.tree_named_sharding(param_specs(cfg, mesh), param_shapes(cfg), mesh)


def batch_shardings(cfg: ArchConfig, mesh, policy: ShardingPolicy, batch: dict, kind: str = "train") -> dict:
    """``{key: Block}`` of a batch as the port holds it: whole on every
    rank for ``"train"`` and ``"prefill"``, the rank's rows over the
    policy's ``batch`` axes for ``"decode"``."""
    rows = _split_axes(policy.batch, batch["tokens"].shape[0], mesh) if kind == "decode" else ()
    specs = {k: ((rows or None),) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    return sharding.tree_named_sharding(specs, {k: tuple(v.shape) for k, v in batch.items()}, mesh)


def cache_shardings(cfg: ArchConfig, mesh, policy: ShardingPolicy, cell: ShapeCell) -> list:
    """One cache of :class:`~repro_torch.distributed.sharding.Block`\\ s per
    layer (:func:`~repro_torch.models.lm.make_caches`' order): the pool of
    ``cell.global_batch`` slots for ``cell.seq_len`` positions as
    ``LMExecutor(mesh=)`` keeps it (module docstring)."""
    b, s = cell.global_batch, cell.seq_len
    rows = _split_axes(policy.batch, b, mesh) or None
    kv = _split_axes(policy.kv_seq, s, mesh) or None
    out = []
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            m = cfg.ssm
            shapes = {"conv": (b, m.d_conv - 1, m.conv_dim), "ssm": (b, m.n_heads, m.headdim, m.d_state), "pos": (b,)}
            specs = {"conv": (rows, None, None), "ssm": (rows, None, None, None), "pos": (rows,)}
            blk = sharding.tree_named_sharding(specs, shapes, mesh)
            out.append(MambaCache(blk["conv"], blk["ssm"], blk["pos"]))
            continue
        cap = lm.cache_capacity(cfg, kind, s)
        pos_ax = kv if kind in lm.SPLIT_KV_KINDS else None
        shapes = {"k": (b, cfg.n_kv_heads, cap, cfg.head_dim), "pos": (b,)}
        specs = {"k": (rows, None, pos_ax, None), "pos": (rows,)}
        blk = sharding.tree_named_sharding(specs, shapes, mesh)
        out.append(KVCache(blk["k"], blk["k"], blk["pos"]))
    return out


def sharded_model(cfg: ArchConfig, mesh, device="cpu", seed: int = 0) -> lm.LM:
    """``LM(cfg)`` on ``device`` (inside a ``FakeTensorMode`` its tensors
    are fake: nothing is allocated), split by :meth:`LM.shard_` on ``mesh``."""
    model = lm.LM(cfg, seed=seed, device=device)
    model.shard_(mesh)
    return model


def abstract_train_state(cfg: ArchConfig, mesh, device="cpu"):
    """``(model, AdamW state)`` of a rank: the sharded model and the f32
    moments of its blocks."""
    model = sharded_model(cfg, mesh, device)
    return model, adamw.init_state(dict(model.named_parameters()))


def make_sharded_train_step(model: lm.LM, opt_cfg: AdamWConfig, mesh):
    """``step(batch, opt_state) -> metrics``: the trainer's step on the
    model's blocks (``runtime/trainer.py`` ``make_train_step``)."""
    from repro_torch.runtime.trainer import TrainConfig, make_train_step

    return make_train_step(model, opt_cfg, TrainConfig(), mesh)


def _decode_placement(model: lm.LM, mesh, cell: ShapeCell):
    """``(policy, rows, kv)`` as ``LMExecutor(mesh=)`` places a pool of
    ``cell.global_batch`` slots of ``cell.seq_len`` positions."""
    policy = model.cfg.decode_policy()
    rows = _split_axes(policy.batch, cell.global_batch, mesh)
    kv = seq_split(mesh, _split_axes(policy.kv_seq, cell.seq_len, mesh), cell.seq_len)
    return policy, rows, kv


def make_sharded_prefill(model: lm.LM, mesh, cell: ShapeCell):
    """``prefill(batch) -> (logits, caches)``: one request's prefill
    (``batch`` of one row, the same on every rank) into a fresh one-row
    cache of ``cell.seq_len`` positions, as ``LMExecutor.prefill_forward``
    runs a prompt of a length every chunked path takes whole."""
    policy, _, kv = _decode_placement(model, mesh, cell)
    cfg = model.cfg

    def prefill(batch: dict):
        with torch.no_grad(), sharding.use_rules(mesh, policy):
            dev = batch["tokens"].device
            caches = lm.make_caches(cfg, 1, cell.seq_len, dtype=lm.DTYPES[cfg.dtype], device=dev, kv=kv)
            return model.prefill(batch["tokens"], caches, kv=kv, vision_embeds=batch.get("vision_embeds"))

    return prefill


def decode_pool(model: lm.LM, mesh, cell: ShapeCell, device="cpu") -> list:
    """The rank's slot pool for the cell (its rows, its blocks of the
    global-attention caches), as ``LMExecutor`` makes it."""
    _, rows, kv = _decode_placement(model, mesh, cell)
    n_local = cell.global_batch // math.prod(mesh.shape[a] for a in rows)
    return lm.make_caches(model.cfg, n_local, cell.seq_len, dtype=lm.DTYPES[model.cfg.dtype], device=device, kv=kv)


def make_sharded_decode(model: lm.LM, mesh, cell: ShapeCell):
    """``decode(tokens, pool) -> gathered``: one step of every slot of the
    rank's pool (:func:`decode_pool`), ``tokens`` its rows' ``(b, 1)``
    (``(b, K, 1)``): the rows gathered from the pool, stepped and
    scattered back, then every row's token and finite flag gathered over
    the rows' axes (``LMExecutor._decode`` and ``RowLogits``); returns the
    logits where the rows are not split."""
    policy, rows, kv = _decode_placement(model, mesh, cell)

    def decode(tokens: torch.Tensor, pool: list):
        with torch.no_grad(), sharding.use_rules(mesh, policy):
            idx = torch.arange(tokens.shape[0], device=tokens.device)
            caches = lm.gather_cache_slots(pool, idx)
            logits, caches = model.decode_step(tokens.long(), caches, kv=kv)
            lm.scatter_cache_slots(pool, caches, idx)
            if not rows:
                return logits
            return RowLogits(logits, idx + mesh.index(rows) * tokens.shape[0], cell.global_batch,
                             mesh.group(rows)).gathered()

    return decode
