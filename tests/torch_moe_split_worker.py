"""The rank program of ``tests/test_torch_moe_split.py``: four CPU
processes on ``gloo`` computing the smoke MoE models' loss and gradients
under their training policies on a 2 × 2 and a 1 × 4 ``("data",
"model")`` mesh (each MoE layer on the rank's experts or hidden columns),
the same with two planted faults (the aux loss's gradient counted on every
rank of the split, the router's gradient not summed over it), and both
smoke models served on 2 × 2 under their decode policies.  Each rank saves
what it computed for the test module to hold against the reference.
Imports no JAX: the reference runs in the test process.

Every scenario runs on every rank in the same order (the collectives
pair up across ranks).  A scenario that raises ends the run on that rank
and its traceback is saved; the other ranks then fail in their next
collective at the group's timeout.
"""
from __future__ import annotations

import datetime
import os
import traceback

import torch
import torch.distributed as dist

from torch_ssm_split_worker import drive
from torch_tp_worker import _counts, _np, _recording

TIMEOUT_S = 60
MESHES = ((2, 2), (1, 4))
PLANTED = ((2, 2), "granite_ep")
N_SLOTS, MAX_LEN = 4, 32


def _einsums(seen: list):
    """Patch ``torch.einsum`` to record the operand shapes of every
    expert product (``"becd,edf->becf"`` and ``"becf,efd->becd"``);
    returns the undo."""
    real = torch.einsum

    def rec(eq, *ops):
        if eq in ("becd,edf->becf", "becf,efd->becd"):
            seen.append((eq, tuple(ops[0].shape), tuple(ops[1].shape)))
        return real(eq, *ops)

    torch.einsum = rec

    def undo():
        torch.einsum = real

    return undo


def _train(mesh, case, tokens) -> dict:
    """One case's loss (summed over the mesh), every parameter's gradient
    block, the shapes its modules computed with, the expert products'
    operands, the collectives and the plan."""
    from repro_torch.distributed.layout import sum_over
    from repro_torch.distributed.sharding import _fit_axes, axes_tuple, use_rules
    from repro_torch.models.lm import LM

    cfg = case["cfg"]
    model = LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    blocks = model.shard_(mesh)
    seen, products = {}, []
    undo = _recording(seen), _einsums(products)
    _counts()
    try:
        with use_rules(mesh, cfg.policy):
            plan = model.split_plan(axes_tuple(_fit_axes(cfg.policy.seq, tokens.shape[-1], mesh)))
            loss, _ = model.train_loss({"tokens": torch.as_tensor(tokens)})
        loss.backward()
    finally:
        for u in undo:
            u()
    splits = {p: (s.moe.tp.axes, s.moe.experts, s.moe.expert_lo, s.moe.ff, s.moe.ff_lo)
              for p, s in plan.layers.items() if s.moe is not None}
    return {
        "loss": float(sum_over(loss.detach(), mesh)),
        "grads": {k: {"value": _np(p.grad), "offset": blocks[k].offset, "global_shape": blocks[k].global_shape}
                  for k, p in model.named_parameters()},
        "computed": seen, "products": products, "counts": _counts(), "coord": dict(mesh.coord),
        "plan": {"tp": None if plan.tp is None else plan.tp.axes, "keep": plan.keep, "partial": sorted(plan.partial),
                 "moe": splits},
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


def planted_aux(inp) -> dict:
    """The aux loss's gradient counted whole on every rank of the split
    (its value still divided over it)."""
    from repro_torch.distributed import layout, make_debug_mesh

    shape, name = PLANTED
    real = layout.part_value
    layout.part_value = layout.share_value
    try:
        return _train(make_debug_mesh(*shape), inp["cases"][name], inp["tokens"])
    finally:
        layout.part_value = real


def planted_router(inp) -> dict:
    """The router's gradient not summed over the MoE's ranks: each keeps
    its own experts' part."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.models.lm import LM

    shape, name = PLANTED
    real = LM._placement

    def placement(self, pname, plan):
        keep, whole = real(self, pname, plan)
        return (keep, plan.moe.axes) if pname.endswith("moe.router") else (keep, whole)

    LM._placement = placement
    try:
        return _train(make_debug_mesh(*shape), inp["cases"][name], inp["tokens"])
    finally:
        LM._placement = real


def serve(inp) -> dict:
    """Both smoke models on 2 × 2 under their decode policies: the
    engine's tokens through the trace (prefills, decode steps, an eviction
    and its re-prefill), the MoE split and the collectives."""
    from repro_torch.distributed import make_debug_mesh
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
        products = []
        undo = _einsums(products)
        _counts()
        try:
            rids = drive(engine, case["prompts"])
        finally:
            undo()
        split = ex.plan.layers["layers.0."].moe
        out[name] = {"tokens": [engine.result(r) for r in rids], "counts": _counts(), "coord": dict(mesh.coord),
                     "moe": (split.tp.axes, split.experts, split.expert_lo, split.ff, split.ff_lo),
                     "w_up": sorted({p[2] for p in products if p[0] == "becd,edf->becf"})}
    return out


SCENARIOS = (grads, planted_aux, planted_router, serve)


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
