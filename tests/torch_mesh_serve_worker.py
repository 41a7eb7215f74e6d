"""The rank program of ``tests/test_torch_mesh_serve.py``: four CPU
processes on ``gloo`` serving the smoke gemma-2b, split by ``LM.shard_``,
through ``Engine(LMExecutor(mesh=))`` under its decode policy on the
meshes of :data:`MESHES`, and what goes with it (the split decode
attention, the skipped merge, gemma3's ring caches, ``Server(mesh=)``).
Each rank saves what it computed for the test module to hold against the
reference.  Imports no JAX: the reference runs in the test process.

Every scenario runs on every rank in the same order (the collectives
pair up across ranks).  A scenario that raises ends the run on that rank
and its traceback is saved; the other ranks then fail in their next
collective at the group's timeout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60
# name: ((data, model), decode policy: None for the config's, "long" for
# DECODE_LONG_POLICY, batch 1's: the cache over every axis)
MESHES = {"2x2": ((2, 2), None), "1x4": ((1, 4), None), "4x1": ((4, 1), None), "2x2_long": ((2, 2), "long")}
N_SLOTS, MAX_LEN = 4, 24
# the engine's trace: four requests at once (the third and fourth end
# first, so the second data rank of 2 x 2 and two ranks of 4 x 1 idle),
# two more at step 3; prompts ragged above attn_chunk (8) replay, and the
# lowest-slot request is evicted at step 1: its re-prefill (13 + 2
# tokens) replays 7 through decode
LENGTHS = (13, 5, 10, 7, 19, 4)
BUDGETS = (8, 6, 2, 3, 4, 5)
FIRST, LATER_AT, EVICT_AT = 4, 3, 1
PLANTED_GAIN = 8.0


def drive(engine, prompts, budgets) -> list[str]:
    """The trace above through ``engine`` (the reference's or the port's):
    the request ids, in submission order."""
    rids = [engine.submit(p, b) for p, b in zip(prompts[:FIRST], budgets[:FIRST])]
    step = 0
    while engine.n_pending or len(rids) < len(prompts):
        if step == LATER_AT:
            rids += [engine.submit(p, b) for p, b in zip(prompts[FIRST:], budgets[FIRST:])]
        if step == EVICT_AT:
            victim = min(engine.running.values(), key=lambda r: r.slot)
            assert engine.evict(victim.rid)
        engine.step()
        step += 1
    return rids


def _np(t):
    return t.detach().float().cpu().numpy()


def _counts() -> dict:
    from repro_torch.distributed.layout import BYTES, COLLECTIVES

    out = {"calls": dict(COLLECTIVES), "bytes": dict(BYTES)}
    for d in (COLLECTIVES, BYTES):
        d.update(dict.fromkeys(d, 0))
    return out


def _model(inp, mesh, case="gemma", policy=None, head_shard=False):
    from repro_torch.api.operator import ShardSpec
    from repro_torch.configs.base import DECODE_LONG_POLICY
    from repro_torch.models.lm import LM

    cfg = inp[case]["cfg"]
    if policy == "long":
        cfg = dataclasses.replace(cfg, policy_decode=DECODE_LONG_POLICY)
    if head_shard:
        cfg = dataclasses.replace(cfg, faust_unembed=dataclasses.replace(cfg.faust_unembed, shard=ShardSpec(mesh)))
    model = LM(cfg, device="cpu")
    model.load_state_dict(inp[case]["state"])
    if head_shard:
        model.unembed.faust.backend = "fused_sharded"  # auto prices one card cheaper at the smoke width
    model.shard_(mesh)
    return model


def _pool(ex) -> list:
    return [[tuple(t.shape) for t in c] for c in ex.pool]


def _serve(inp, mesh, case="gemma", policy=None, head_shard=False) -> dict:
    """The trace through ``Engine(LMExecutor(mesh=))``; every decode
    step's logits kept as this rank's rows of them, their positions and
    the first column of its vocabulary block."""
    from repro_torch.runtime.engine import Engine, LMExecutor, RowLogits

    model = _model(inp, mesh, case, policy, head_shard)
    ex = LMExecutor(model, MAX_LEN, N_SLOTS, mesh=mesh)
    steps, decode = [], ex.decode_forward

    def logged(slots, tokens):
        logits = decode(slots, tokens)
        if isinstance(logits, RowLogits):  # this rank's rows, and its vocabulary block where split
            start = logits.plan.vocab_start if logits.plan is not None and logits.plan.head else 0
            steps.append((_np(logits.local), logits.rows.tolist(), start))
        else:
            steps.append((_np(logits), list(range(len(slots))), 0))
        return logits

    ex.decode_forward = logged
    engine = Engine(ex)
    _counts()
    rids = drive(engine, inp[case]["prompts"], list(BUDGETS))
    return {"tokens": [engine.result(r) for r in rids], "states": sorted({r.state for r in engine.done.values()}),
            "pool": _pool(ex), "rows": ex.rows, "kv": None if ex.kv is None else (ex.kv.start, ex.kv.local),
            "idle_steps": ex.idle_steps, "steps": engine.stats.steps, "counts": _counts(), "logits": steps}


def meshes(inp) -> dict:
    """The smoke gemma-2b served on every mesh of :data:`MESHES` (on 2 x 2
    with its FAµST head sharded too)."""
    from repro_torch.distributed import make_debug_mesh

    out = {}
    for name, (shape, policy) in MESHES.items():
        mesh = make_debug_mesh(*shape)
        out[name] = {**_serve(inp, mesh, policy=policy, head_shard=name == "2x2"), "coord": dict(mesh.coord)}
    return out


@contextlib.contextmanager
def merge_skipped():
    """While it runs, each rank of a split cache attends over its own
    block only: the blocks' log-sum-exp merge is skipped."""
    from repro_torch.layers import attention

    real = attention.merge_blocks
    attention.merge_blocks = lambda t, seq, op="sum": t
    try:
        yield
    finally:
        attention.merge_blocks = real


def planted(inp) -> dict:
    """The 2 x 2 engine run with the merge skipped, beside the sound run,
    on the smoke model with its attention's values scaled by
    :data:`PLANTED_GAIN` (at random init attention adds too little to the
    residual stream for a wrong one to move a greedy token)."""
    from repro_torch.distributed import make_debug_mesh

    state = {k: v * PLANTED_GAIN if k.endswith(("attn.wv", "attn.wo")) else v
             for k, v in inp["gemma"]["state"].items()}
    loud = {**inp, "gemma": {**inp["gemma"], "state": state}}
    mesh = make_debug_mesh(2, 2)
    sound = _serve(loud, mesh)
    with merge_skipped():
        bad = _serve(loud, mesh)
    return {"tokens": bad["tokens"], "states": bad["states"], "sound": sound["tokens"]}


def gemma3(inp) -> dict:
    """gemma3's smoke config (seven sliding-window layers, one global) on
    2 x 2: the rings stay whole (ROADMAP caveat R11), the global layer's
    cache is split."""
    from repro_torch.distributed import make_debug_mesh

    res = _serve(inp, make_debug_mesh(2, 2), case="gemma3")
    res.pop("logits")
    return res


def server(inp) -> dict:
    """``Server(model, max_len, mesh=)`` on the model split on 2 x 2 (four
    rows: two a data rank)."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.runtime.server import Server

    mesh = make_debug_mesh(2, 2)
    srv = Server(_model(inp, mesh), 12, mesh=mesh)
    gen, stats = srv.generate({"tokens": inp["server_tokens"]}, 5)
    return {"gen": gen, "mesh_axes": stats.mesh_axes, "rows": srv._executor.rows}


def split_attention(inp) -> dict:
    """``decode_attention_split`` over 2 blocks (2 x 2's model axis) and 4
    (1 x 4's): each rank's block of the cache, every rank's result."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.distributed.layout import seq_split
    from repro_torch.layers.attention import KVCache, decode_attention_split, kv_cache_positions

    a = inp["attention"]
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_debug_mesh(*shape)
        seq = seq_split(mesh, "model", a["k"].shape[2])
        blk = slice(seq.start, seq.start + seq.local)
        k, v = torch.as_tensor(a["k"][:, :, blk]), torch.as_tensor(a["v"][:, :, blk])
        cache = KVCache(k, v, torch.as_tensor(a["pos"]))
        q_pos = cache.pos[:, None].long() - 1  # the last token written
        with torch.no_grad():
            o = decode_attention_split(torch.as_tensor(a["q"]), k, v, q_position=q_pos,
                                       kv_positions=kv_cache_positions(cache, seq), seq=seq, window=a["window"])
        out[shape] = _np(o)
    return out


def embedding(inp) -> dict:
    """The embedding table read in place on 2 x 2 and 1 x 4 (each rank
    with its own tokens and its own count of them) against the table
    gathered whole: whether every row is the same bit for bit."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.distributed.layout import COLLECTIVES

    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_debug_mesh(*shape)
        model = _model(inp, mesh)
        rank = dist.get_rank()
        tokens = torch.as_tensor(inp["embed_tokens"][: 3 * (rank + 1)]).reshape(rank + 1, 3)
        with torch.enable_grad():
            whole = model._lookup(tokens).detach()
        calls = COLLECTIVES["embed_lookup"]
        with torch.no_grad():
            rows = model._lookup(tokens)
        out[shape] = {"equal": torch.equal(rows, whole), "shape": tuple(rows.shape),
                      "calls": COLLECTIVES["embed_lookup"] - calls}
    return out


SCENARIOS = (meshes, planted, gemma3, server, split_attention, embedding)


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """One rank: join the group, run every scenario, save the results to
    ``out_dir/rank{rank}.pt``, leave the group."""
    torch.set_num_threads(1)
    os.environ["REPRO_AUTOTUNE"] = "off"
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    results: dict = {}
    try:
        inp = torch.load(inputs, weights_only=False)
        for fn in SCENARIOS:
            results[fn.__name__] = fn(inp)
    except Exception:  # noqa: BLE001 — saved for the test module to report
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
