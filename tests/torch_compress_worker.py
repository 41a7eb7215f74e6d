"""The rank program of ``tests/test_torch_compress_drivers.py``'s process
group: four CPU processes on ``gloo``, a 2 × 2 ``("data", "model")`` mesh,
each running ``compress_layers(mesh=)`` and saving what it computed.
Imports no JAX.

Every rank solves with one thread, and rank 0 also runs the unsharded
``compress_layers`` on the same weights, so the test compares chains
computed under the same thread count.  A rank that raises saves its
traceback; the others then fail in their next collective at the group's
timeout.
"""
from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60


def _chains(chains: dict) -> dict:
    from repro_torch import bridge

    return {k: bridge.to_numpy(bf) for k, bf in chains.items()}


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """``compress_layers`` on the mesh (and, on rank 0, without it); the
    chains, the solves this rank ran (``(shape, on the mesh)`` per
    ``factorize`` call) and one placed chain's ``fused_sharded`` apply
    saved to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    results: dict = {}
    try:
        import importlib

        from repro_torch.api.operator import FaustOp, ShardSpec
        from repro_torch.core.compress import compress_layers
        from repro_torch.distributed import make_debug_mesh

        api = importlib.import_module("repro_torch.api.factorize")  # the module: the package exports the function
        inp = np.load(inputs)
        weights = {k: torch.as_tensor(inp[k]) for k in inp.files if k != "x"}
        kw = dict(bk=8, bn=8, n_iter_two=4, n_iter_global=4)
        mesh = make_debug_mesh(2, 2)
        solves = []
        real = api.factorize

        def recorded(a, spec, **k):
            solves.append((tuple(a.shape), spec.mesh is not None))
            return real(a, spec, **k)

        api.factorize = recorded
        try:
            chains = compress_layers(weights, mesh=mesh, device="cpu", **kw)
        finally:
            api.factorize = real
        op = FaustOp(chains["a1"], shard=ShardSpec(mesh))
        x = torch.as_tensor(inp["x"])
        results = {"coord": dict(mesh.coord), "chains": _chains(chains), "solves": solves,
                   "devices": sorted({str(f.values.device) for bf in chains.values() for f in bf.factors}),
                   "sharded_apply": op.apply(x, "fused_sharded", device="cpu").numpy(),
                   "dense_apply": (x @ chains["a1"].todense()).numpy()}
        if rank == 0:
            results["unsharded"] = _chains(compress_layers(weights, device="cpu", **kw))
    except Exception:  # noqa: BLE001 — saved for the test module to report
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
