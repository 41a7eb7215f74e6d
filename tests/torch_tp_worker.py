"""The rank program of ``tests/test_torch_tensor_parallel.py``: four CPU
processes on ``gloo`` computing the smoke models' loss and gradients
under ``TP_POLICY`` on a 2 × 2 and a 1 × 4 ``("data", "model")`` mesh,
a greedy pick over a split vocabulary, and the smoke gemma-2b served on
2 × 2 under ``DECODE_POLICY``.  Each rank saves what it computed for the
test module to hold against the reference.  Imports no JAX: the
reference runs in the test process.

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

TIMEOUT_S = 60
MESHES = ((2, 2), (1, 4))
N_SLOTS, MAX_LEN = 4, 24
LENGTHS, BUDGETS = (13, 5, 10, 7, 16, 4), (6, 4, 3, 5, 2, 4)


def _np(t):
    return t.detach().float().cpu().numpy()


def _counts() -> dict:
    from repro_torch.distributed.layout import BYTES, COLLECTIVES

    out = {"calls": dict(COLLECTIVES), "bytes": dict(BYTES)}
    for d in (COLLECTIVES, BYTES):
        d.update(dict.fromkeys(d, 0))
    return out


def _recording(seen: dict):
    """Patch ``LM._gathered`` and ``LM._param`` to record the shape of
    every parameter a module computes with, by state dict key; returns
    the function that undoes it."""
    from repro_torch.models.lm import LM

    gathered, param = LM._gathered, LM._param

    def rec_gathered(self, module, prefix, plan=None):
        out = gathered(self, module, prefix, plan)
        seen.update({prefix + n: tuple(t.shape) for n, t in out.items()})
        return out

    def rec_param(self, name):
        out = param(self, name)
        if isinstance(out, dict):
            seen.update({f"{name}.{k}": tuple(v.shape) for k, v in out.items()})
        else:
            seen[name] = tuple(out.shape)
        return out

    LM._gathered, LM._param = rec_gathered, rec_param

    def undo():
        LM._gathered, LM._param = gathered, param

    return undo


def grads(inp) -> dict:
    """Each case's loss (summed over the mesh) and every parameter's
    gradient block on both meshes, with the shapes its modules computed
    with and the collectives by purpose."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.distributed.layout import sum_over
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.lm import LM

    out = {}
    for shape in MESHES:
        mesh = make_debug_mesh(*shape)
        for name, case in inp["cases"].items():
            cfg = case["cfg"]
            model = LM(cfg, device="cpu")
            model.load_state_dict(case["state"])
            blocks = model.shard_(mesh)
            seen: dict = {}
            undo = _recording(seen)
            _counts()
            try:
                with use_rules(mesh, cfg.policy):
                    plan = model.split_plan()
                    loss, _ = model.train_loss({"tokens": torch.as_tensor(inp["tokens"])})
                loss.backward()
            finally:
                undo()
            out[(shape, name)] = {
                "loss": float(sum_over(loss.detach(), mesh)),
                "grads": {k: {"value": _np(p.grad), "offset": blocks[k].offset, "global_shape": blocks[k].global_shape}
                          for k, p in model.named_parameters()},
                "computed": seen, "counts": _counts(), "coord": dict(mesh.coord),
                "plan": None if plan is None else {"axes": plan.tp.axes, "keep": plan.keep,
                                                   "partial": sorted(plan.partial), "head": plan.head,
                                                   "embed": plan.embed, "vocab_start": plan.vocab_start,
                                                   "layers": sorted(plan.layers)},
            }
    return out


def pick(inp) -> dict:
    """``vocab_argmax`` of rows split four ways over ``model`` (1 × 4),
    with ties inside a block and across blocks, against the whole rows'."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.distributed.layout import tp_split, vocab_argmax

    mesh = make_debug_mesh(1, 4)
    split = tp_split(mesh, "model")
    rows = torch.as_tensor(inp["pick_rows"])
    n = rows.shape[-1] // split.n
    start = split.index * n
    return {"picks": vocab_argmax(rows[..., start:start + n], start, split).tolist()}


def serve(inp) -> dict:
    """The smoke gemma-2b (vocabulary 128, tied) on 2 × 2 under its decode
    policy: the engine's tokens, the plan and the collectives."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.models.lm import LM
    from repro_torch.runtime.engine import Engine, LMExecutor

    mesh = make_debug_mesh(2, 2)
    case = inp["serve"]
    model = LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    model.shard_(mesh)
    ex = LMExecutor(model, MAX_LEN, N_SLOTS, mesh=mesh)
    engine = Engine(ex)
    _counts()
    rids = [engine.submit(p, b) for p, b in zip(case["prompts"], BUDGETS)]
    engine.run()
    plan = ex.plan
    return {"tokens": [engine.result(r) for r in rids], "counts": _counts(),
            "plan": {"head": plan.head, "embed": plan.embed,
                     "heads": [p for p, s in plan.layers.items() if s.heads is not None],
                     "mlp": [p for p, s in plan.layers.items() if s.mlp is not None]}}


SCENARIOS = (grads, pick, serve)


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


def prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]
