"""The rank program of ``tests/test_torch_sharded.py``'s process group:
four CPU processes on ``gloo``, each running every scenario below on a
2 × 2 ``("data", "model")`` mesh (and the crossing chain on 1 × 4 and
4 × 1), and saving what it computed for the test module to hold against
the reference.  Imports no JAX: the reference runs in the test process.

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


def _np(t):
    return t.detach().float().cpu().numpy()


class _Calls:
    """Calls of the fused chain kernels' wrappers (on the CPU they run the
    plain versions; each call stands for one launch on the card)."""

    NAMES = ("chain_matmul", "chain_dgrad", "chain_wgrad")

    def __init__(self):
        from repro_torch.kernels import ops

        self.counts = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = getattr(ops, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*a, **kw)

            setattr(ops, name, counted)

    def take(self) -> dict:
        out = dict(self.counts)
        self.counts.update(dict.fromkeys(self.NAMES, 0))
        return out


def _collectives() -> dict:
    from repro_torch.kernels.chain_sharded import COLLECTIVES

    out = dict(COLLECTIVES)
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
    return out


def _trainable(bf):
    """``bf`` with fresh leaf values and λ that require grad."""
    from repro_torch.core.compress import BlockFaust

    leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    return BlockFaust(tuple(type(f)(leaf(f.values), f.in_idx, f.in_features, f.out_features) for f in bf.factors),
                      leaf(bf.lam))


def chains(mesh, inp, calls):
    """Each chain forward (leading batch dims, an odd batch) and its
    gradients wrt x, every factor's values and λ, through
    ``FaustOp.with_sharding(...).apply(backend="fused_sharded")``."""
    from repro_torch import bridge
    from repro_torch.api.operator import FaustOp, ShardSpec
    from repro_torch.kernels.chain_sharded import plan_shard

    out = {}
    for name, d in inp["chains"].items():
        bf = bridge.blockfaust_from_numpy(d, device="cpu")
        x = torch.as_tensor(inp["x"][name])
        _collectives(), calls.take()
        with torch.no_grad():
            y = FaustOp(bf).with_sharding(ShardSpec(mesh)).apply(x, "fused_sharded", device="cpu")
        fwd = {"y": _np(y), "collectives": _collectives(), "calls": calls.take()}
        tb = _trainable(bf)
        xg = x.clone().requires_grad_(True)
        y = FaustOp(tb, shard=ShardSpec(mesh)).apply(xg, "fused_sharded", device="cpu")
        (y * torch.as_tensor(inp["g"][name])).sum().backward()
        out[name] = {**fwd, "summary": plan_shard(bf, mesh).summary(), "dx": _np(xg.grad),
                     "dvalues": [_np(f.values.grad) for f in tb.factors], "dlam": float(tb.lam.grad),
                     "grad_collectives": _collectives(), "grad_calls": calls.take()}
    return out


def quantized(mesh, inp, calls):
    """The int8 chain (codes and per-block scales): forward, and the
    gradients wrt x and the scales."""
    import dataclasses

    from repro_torch import bridge
    from repro_torch.api.operator import FaustOp, ShardSpec

    pc = bridge.packed_from_numpy(inp["qchain"], device="cpu")
    x = torch.as_tensor(inp["x"]["crossing"]).clone().requires_grad_(True)
    pc = dataclasses.replace(pc, scales=pc.scales.clone().requires_grad_(True))
    calls.take()
    y = FaustOp(pc, shard=ShardSpec(mesh)).apply(x, "fused_sharded", device="cpu")
    (y * torch.as_tensor(inp["g"]["crossing"])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "dscales": _np(pc.scales.grad), "calls": calls.take()}


def dispatch(mesh, inp, calls):
    """``apply`` under ``auto`` and forced: the reports; a composite whose
    leaves each dispatch on the mesh."""
    from repro_torch import bridge
    from repro_torch.api import last_report
    from repro_torch.api.operator import FaustOp, ShardSpec, hstack

    spec = ShardSpec(mesh)
    bf = bridge.blockfaust_from_numpy(inp["chains"]["crossing"], device="cpu")
    op = FaustOp(bf).with_sharding(spec)
    x = torch.as_tensor(inp["x"]["crossing"])
    out = {}
    with torch.no_grad():
        for backend in ("auto", "fused_sharded", "fused"):
            op.apply(x, backend, device="cpu")
            out[backend] = last_report().as_row()
        comp = hstack([FaustOp(bf), FaustOp(bridge.blockfaust_from_numpy(inp["chains"]["local"], device="cpu"))])
        comp = comp.with_sharding(spec)
        _collectives()
        out["composite"] = _np(comp.apply(x, "fused_sharded", device="cpu"))
        out["composite_collectives"] = _collectives()
        out["composite_leaves"] = [leaf.shard is spec for leaf in comp.leaves()]
        out["composite_auto"] = _np(comp.apply(x, device="cpu"))
        out["composite_report"] = last_report().as_row()
    return out


def _chain_arrays(op) -> list:
    return [_np(t) for t in op._tensors()]


def factorize(mesh, inp, calls):
    """``factorize`` with ``FactorizeSpec(mesh=)``: rank 0's chain on
    every rank, placed and sharded; rank 0 also factorizes unsharded."""
    import dataclasses

    from repro_torch.api import FactorizeSpec
    from repro_torch.api import factorize as fz

    spec = FactorizeSpec(strategy="hierarchical", n_factors=2, block=8, k_first=2, k_mid=2, n_iter_two=4,
                         n_iter_global=4, mesh=mesh)
    w = torch.as_tensor(inp["w"])
    op, info = fz(w, spec, device="cpu")
    out = {"chain": _chain_arrays(op), "shard": op.shard is not None and op.shard.mesh is mesh,
           "n_sweeps": info.n_sweeps, "faust": [_np(s) for s in info.fausts[0].factors]}
    with torch.no_grad():
        out["y"] = _np(op.apply(torch.as_tensor(inp["wx"]), device="cpu"))
    if dist.get_rank() == 0:
        plain, _ = fz(w, dataclasses.replace(spec, mesh=None), device="cpu")
        out["plain_chain"] = _chain_arrays(plain)
    return out


def streaming(mesh, inp, calls):
    """A ``StreamingFaust`` on the mesh: the refresh re-placed (rank 0's
    on every rank) and sharded; rank 0 also tracks unsharded."""
    import dataclasses

    from repro_torch.api import FactorizeSpec
    from repro_torch.streaming import StreamingConfig, StreamingFaust

    spec = FactorizeSpec(strategy="hierarchical", n_factors=2, block=8, k_first=2, k_mid=2, n_iter_two=4,
                         n_iter_global=4, mesh=mesh)
    cfg = StreamingConfig(n_iter_update=3, full_above=0.99)
    w0, w1 = torch.as_tensor(inp["w"]), torch.as_tensor(inp["w1"])
    sf = StreamingFaust.track(w0, spec, cfg, device="cpu")
    rec = sf.update(w1)
    out = {"chain": _chain_arrays(sf.op), "action": rec.action, "drift": rec.drift,
           "shard": sf.op.shard is not None and sf.op.shard.mesh is mesh}
    if dist.get_rank() == 0:
        plain = StreamingFaust.track(w0, dataclasses.replace(spec, mesh=None), cfg, device="cpu")
        prec = plain.update(w1)
        out["plain_chain"], out["plain_action"] = _chain_arrays(plain.op), prec.action
    return out


def faust_linear(mesh, inp, calls):
    """``FaustLinear.forward(shard=)`` forward and gradients."""
    from repro_torch.api.operator import ShardSpec
    from repro_torch.layers.faust_linear import FaustLinear, FaustSpec

    layer = FaustLinear(48, 64, FaustSpec(2, 8, 2), generator=torch.Generator().manual_seed(0), device="cpu")
    layer.load_state_dict(inp["layer"])
    x = torch.as_tensor(inp["layer_x"]).clone().requires_grad_(True)
    calls.take()
    y = layer(x, "fused_sharded", shard=ShardSpec(mesh))
    (y * torch.as_tensor(inp["layer_g"])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "dvalues": [_np(f.values.grad) for f in layer.factors],
            "dlam": float(layer.lam.grad), "calls": calls.take()}


def serve(mesh, inp, calls):
    """``Server(mesh=)`` on the smoke model with its FAµST head sharded and
    forced onto the mesh; rank 0 also serves the same model unsharded."""
    import dataclasses

    from repro_torch.api.operator import ShardSpec
    from repro_torch.layers.faust_linear import FaustSpec
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import Server

    cfg = inp["lm_cfg"]
    head = dataclasses.replace(cfg.faust_unembed, shard=ShardSpec(mesh))
    model = LM(dataclasses.replace(cfg, faust_unembed=head), device="cpu")
    model.load_state_dict(inp["lm_state"])
    model.unembed.faust.backend = "fused_sharded"  # auto prices one card cheaper at the smoke width
    calls.take()
    _collectives()
    gen, stats = Server(model, max_len=12, mesh=mesh).generate({"tokens": inp["tokens"]}, 5)
    out = {"gen": gen, "mesh_axes": stats.mesh_axes, "backend": stats.faust_dispatch.backend,
           "calls": calls.take(), "collectives": _collectives()}
    if dist.get_rank() == 0:
        plain = LM(cfg, device="cpu")
        plain.load_state_dict(inp["lm_state"])
        out["plain_gen"], _ = Server(plain, max_len=12).generate({"tokens": inp["tokens"]}, 5)
    return out


def autotune(mesh, inp, calls):
    """``apply(autotune=True)`` on the mesh, each rank on its own table:
    the same entry on every rank."""
    from repro_torch import bridge
    from repro_torch.api import autotune as at
    from repro_torch.api.operator import FaustOp, ShardSpec

    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = os.path.join(inp["out_dir"], f"table{dist.get_rank()}.json")
    os.environ["REPRO_AUTOTUNE"] = "1"
    try:
        op = FaustOp(bridge.blockfaust_from_numpy(inp["chains"]["crossing"], device="cpu"), shard=ShardSpec(mesh))
        with torch.no_grad():
            op.apply(torch.as_tensor(inp["x"]["crossing"]), device="cpu", autotune=True)
        table = at.load_table()
    finally:
        os.environ["REPRO_AUTOTUNE"] = "off"
    return {"entries": {k: (v["best"], v["us"]) for k, v in table["entries"].items()}}


def other_meshes(mesh, inp, calls):
    """The crossing chain on a 1 × 4 and a 4 × 1 mesh of the same group."""
    from repro_torch import bridge
    from repro_torch.api.operator import FaustOp, ShardSpec
    from repro_torch.distributed import make_debug_mesh

    out = {}
    for shape in ((1, 4), (4, 1)):
        m = make_debug_mesh(*shape)
        bf = _trainable(bridge.blockfaust_from_numpy(inp["chains"]["crossing"], device="cpu"))
        x = torch.as_tensor(inp["x"]["crossing"]).clone().requires_grad_(True)
        y = FaustOp(bf, shard=ShardSpec(m)).apply(x, "fused_sharded", device="cpu")
        (y * torch.as_tensor(inp["g"]["crossing"])).sum().backward()
        out[shape] = {"y": _np(y), "dx": _np(x.grad), "dvalues": [_np(f.values.grad) for f in bf.factors],
                      "dlam": float(bf.lam.grad)}
    return out


SCENARIOS = (chains, quantized, dispatch, factorize, streaming, faust_linear, serve, autotune, other_meshes)


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """One rank: join the group, run every scenario, save the results to
    ``out_dir/rank{rank}.pt``, leave the group."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    results: dict = {}
    try:
        from repro_torch.distributed import make_debug_mesh

        inp = torch.load(inputs, weights_only=False)
        inp["out_dir"] = out_dir
        mesh = make_debug_mesh(2, 2)
        results["mesh"] = {"shape": dict(mesh.shape), "coord": dict(mesh.coord), "rank": mesh.rank}
        calls = _Calls()
        for fn in SCENARIOS:
            results[fn.__name__] = fn(mesh, inp, calls)
    except Exception:  # noqa: BLE001 — saved for the test module to report
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
