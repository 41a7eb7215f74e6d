"""The rank program of ``tests/test_torch_ssm_split.py``: four CPU
processes on ``gloo`` computing the smoke SSM models' loss and gradients
under ``TP_POLICY`` on a 2 × 2 and a 1 × 4 ``("data", "model")`` mesh
(each mamba block on the rank's heads), the same with the gated norm's
backward sum over the split dropped (the planted fault), and both smoke
models served on 2 × 2 under ``DECODE_POLICY`` (each ``MambaCache`` at
the rank's heads).  Each rank saves what it computed for the test module
to hold against the reference.  Imports no JAX: the reference runs in the
test process.

Every scenario runs on every rank in the same order (the collectives
pair up across ranks).  A scenario that raises ends the run on that rank
and its traceback is saved; the other ranks then fail in their next
collective at the group's timeout.
"""
from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from torch_tp_worker import _counts, _np, _recording

TIMEOUT_S = 60
MESHES = ((2, 2), (1, 4))
PLANTED = ((2, 2), "mamba2_2p7b")
# the engine's trace: four requests at once, two more at step 3; prompts
# ragged above the chunks (8) replay, and the lowest-slot request is
# evicted at step 1: its re-prefill replays through decode
N_SLOTS, MAX_LEN = 4, 32
LENGTHS, BUDGETS = (13, 5, 10, 7, 16, 4), (6, 4, 3, 5, 2, 4)
FIRST, LATER_AT, EVICT_AT = 4, 3, 1


def drive(engine, prompts, budgets=BUDGETS) -> list[str]:
    """The trace above through ``engine``: the request ids, in submission
    order."""
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


def prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _ssd_heads(seen: list):
    """Patch the SSD to record the heads of every call (``x (B, S, H,
    P)``) and the shape of its final state; returns the undo."""
    from repro_torch.layers import mamba2

    real = mamba2.ssd_chunked

    def rec(x, *a, **k):
        y, state = real(x, *a, **k)
        seen.append((x.shape[2], tuple(state.shape)))
        return y, state

    mamba2.ssd_chunked = rec

    def undo():
        mamba2.ssd_chunked = real

    return undo


def _train(mesh, case, tokens) -> dict:
    """One case's loss (summed over the mesh), every parameter's gradient
    block, the shapes its modules computed with, the SSD's heads, the
    collectives and the plan."""
    from repro_torch.distributed.layout import sum_over
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.lm import LM

    cfg = case["cfg"]
    model = LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    blocks = model.shard_(mesh)
    seen, ssd = {}, []
    undo = _recording(seen), _ssd_heads(ssd)
    _counts()
    try:
        with use_rules(mesh, cfg.policy):
            plan = model.split_plan()
            loss, _ = model.train_loss({"tokens": torch.as_tensor(tokens)})
        loss.backward()
    finally:
        for u in undo:
            u()
    ssm = plan.ssm
    return {
        "loss": float(sum_over(loss.detach(), mesh)),
        "grads": {k: {"value": _np(p.grad), "offset": blocks[k].offset, "global_shape": blocks[k].global_shape}
                  for k, p in model.named_parameters()},
        "computed": seen, "ssd": ssd, "counts": _counts(), "coord": dict(mesh.coord),
        "plan": {"axes": plan.tp.axes, "keep": plan.keep, "partial": sorted(plan.partial),
                 "ssm_layers": sorted(p for p, s in plan.layers.items() if s.ssm is not None),
                 "ssm": (ssm.heads, ssm.head_lo, ssm.groups, ssm.group_lo)},
    }


def grads(inp) -> dict:
    """Every case on both meshes."""
    from repro_torch.distributed import make_debug_mesh

    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape)
        for name, case in inp["cases"].items():
            out[(shape, name)] = _train(mesh, case, inp["tokens"])
    return out


def planted(inp) -> dict:
    """The gated norm's backward sum over the split dropped: each rank
    keeps only its own columns' cotangent of the mean of squares."""
    from repro_torch.distributed import layout, make_debug_mesh

    shape, name = PLANTED
    real = layout._SplitTotal.backward
    layout._SplitTotal.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        return _train(make_debug_mesh(*shape), inp["cases"][name], inp["tokens"])
    finally:
        layout._SplitTotal.backward = real


def serve(inp) -> dict:
    """Both smoke models on 2 × 2 under their decode policy: the engine's
    tokens through the trace (prefills, decode steps, an eviction and its
    re-prefill), the plan, the pool's cache shapes and the collectives."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.layers.mamba2 import MambaCache
    from repro_torch.models.lm import LM
    from repro_torch.runtime.engine import Engine, LMExecutor

    mesh = make_debug_mesh(2, 2)
    out = {}
    for name, case in inp["serve"].items():
        model = LM(case["cfg"], device="cpu")
        model.load_state_dict(case["state"])
        model.shard_(mesh)
        ex = LMExecutor(model, MAX_LEN, N_SLOTS, mesh=mesh)
        engine = Engine(ex)
        _counts()
        rids = drive(engine, case["prompts"])
        ssm = ex.plan.ssm
        out[name] = {"tokens": [engine.result(r) for r in rids], "counts": _counts(), "coord": dict(mesh.coord),
                     "ssm": None if ssm is None else (ssm.tp.axes, ssm.heads, ssm.head_lo),
                     "pool": [(type(c).__name__, [tuple(t.shape) for t in c]) for c in ex.pool],
                     "mamba_bytes": sum(t.numel() * t.element_size() for c in ex.pool if isinstance(c, MambaCache)
                                        for t in c)}
    return out


SCENARIOS = (grads, planted, serve)


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """One rank: every scenario, the results saved to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(1)
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
