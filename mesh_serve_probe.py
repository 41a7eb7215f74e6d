#!/usr/bin/env python3
"""Phase 18 (c) of ``chip_smoke.py`` under ``torch.profiler``: where a
prefill's and a decode step's time goes when four ranks serve gemma-2b on
one card over ``gloo``.

    python3 mesh_serve_probe.py                       # the model whole on every rank, the head sharded
    python3 mesh_serve_probe.py --sharded             # the model split by LM.shard_, under its decode policy
    python3 mesh_serve_probe.py --requests 8 --lengths 32 512 --budgets 16 32

Builds the kernels, then spawns four ranks on ``cuda:0`` (a 2 × 2
``("data", "model")`` mesh over ``gloo``, as phase 18 does).  Every rank
builds ``chip_smoke.serve_config()``'s gemma-2b (full width,
``SERVE_LAYERS`` deep, seed 0) with its FAµST head sharded and forced
onto ``fused_sharded`` (with ``--sharded`` also ``model.shard_(mesh)``),
waits for the others (``skew_s``: how long rank 0 waited), and serves
the trace of ``chip_smoke._trace`` (seed 0; the defaults are phase 18
(c)'s) through ``Engine(LMExecutor(mesh=))``, rank 0 under the profiler.
Prints rank 0's run (prefill, decode and wall seconds, TTFT and TPOT
p50), one line a prefill (its length and seconds: the whole call, the
layers, the head), the collectives by purpose with their bytes, then the
profiler's top spans by host time and by device time, and the card's
``name, power.limit``.  The tables and each rank's results also go to
``build/mesh_serve_probe/<mode>/``.  Exits 1 if a rank failed.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORLD = 4


def _timed(name: str, fn, spent: dict):
    """``fn`` with its seconds (device synchronized) added to ``spent[name]``
    and a profiler span ``name``."""
    import torch

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*a, **k)
        torch.cuda.synchronize()
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def rank_main(rank: int, rendezvous: str, out_dir: str, args: dict) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.models.lm import LM
    from repro_torch.runtime import engine as eng

    os.environ["REPRO_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=180))
    res: dict = {"rank": rank}
    try:
        from repro_torch.api.operator import ShardSpec
        from repro_torch.distributed import layout, make_debug_mesh

        mesh = make_debug_mesh(2, 2, device=dev)
        cfg = cs.serve_config()
        cfg = dataclasses.replace(cfg, faust_unembed=dataclasses.replace(cfg.faust_unembed, shard=ShardSpec(mesh)))
        model = LM(cfg, seed=0, device=dev)
        if args["sharded"]:
            model.shard_(mesh)
        prompts, budgets = cs._trace(args["requests"], 0, tuple(args["lengths"]), tuple(args["budgets"]), (),
                                     cfg.vocab)
        parts, spent = [], {}
        real_prefill = eng.LMExecutor.prefill_forward

        def prefill(self, slot, prompt, extras):
            spent.clear()
            t0 = time.perf_counter()
            out = real_prefill(self, slot, prompt, extras)
            torch.cuda.synchronize()
            parts.append({"len": int(len(prompt)), "s": time.perf_counter() - t0,
                          "layers_s": spent.get("layers", 0.0), "head_s": spent.get("head", 0.0)})
            return out

        eng.LMExecutor.prefill_forward = prefill
        LM._run = _timed("layers", LM._run, spent)
        LM._logits = _timed("head", LM._logits, spent)
        eng.LMExecutor.decode_forward = _timed("decode_forward", eng.LMExecutor.decode_forward, {})
        t0 = time.perf_counter()
        layout.sum_over(torch.ones((), device=dev), mesh)  # every rank has built its model
        res["skew_s"] = time.perf_counter() - t0
        for d in (layout.COLLECTIVES, layout.BYTES):
            d.update(dict.fromkeys(d, 0))
        prof = None
        if rank == 0:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        with cs.faust_backend(model, "fused_sharded", head_only=True):
            run = cs._mesh_engine("mesh_serve_probe", "", model, mesh, prompts, budgets)
        if prof is not None:
            prof.__exit__(None, None, None)
            ka = prof.key_averages()
            res["host_top"] = ka.table(sort_by="cpu_time_total", row_limit=40)
            res["self_host_top"] = ka.table(sort_by="self_cpu_time_total", row_limit=40)
            res["device_top"] = ka.table(sort_by="self_cuda_time_total", row_limit=30)
        row = run["row"]
        res.update(run={k: row[k] for k in ("prefill_s", "decode_s", "wall_s", "ttft_p50_s", "tpot_p50_s", "steps",
                                            "tokens_decoded", "states", "launches")},
                   prefills=parts, collectives=dict(layout.COLLECTIVES), bytes=dict(layout.BYTES),
                   prompt_lengths=[len(p) for p in prompts], tokens=run["tokens"])
    except Exception:  # noqa: BLE001 — reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res, default=str))
        dist.destroy_process_group()


def main() -> int:
    import multiprocessing

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sharded", action="store_true", help="split the model by LM.shard_ (decode policy)")
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--lengths", type=int, nargs=2, default=None)
    p.add_argument("--budgets", type=int, nargs=2, default=None)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("mesh_serve_probe: no CUDA device is available", file=sys.stderr)
        return 2
    build.build()
    mode = "sharded" if args.sharded else "whole"
    opts = {"sharded": args.sharded, "requests": args.requests or cs.MESH_REQUESTS,
            "lengths": args.lengths or list(cs.MESH_LENGTHS), "budgets": args.budgets or list(cs.MESH_BUDGETS)}
    out = ROOT / "build" / "mesh_serve_probe" / mode
    out.mkdir(parents=True, exist_ok=True)
    folder = ROOT / "build" / "mesh_serve_probe"
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "rendezvous").unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, str(folder / "rendezvous"), str(out), opts)) for r in range(WORLD)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(600)
        if proc.is_alive():
            proc.kill()
    results = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD) if (out / f"rank{r}.json").exists()]
    failed = len(results) < WORLD or any("error" in r for r in results)
    for r in results:
        if "error" in r:
            print(f"rank {r['rank']}:\n{r['error']}", file=sys.stderr)
    if results and "run" in results[0]:
        r0 = results[0]
        print(json.dumps({"mode": mode, **opts, **r0["run"], "skew_s": [r.get("skew_s") for r in results],
                          "prompt_lengths": r0["prompt_lengths"],
                          "same_tokens": len({json.dumps(r.get("tokens")) for r in results}) == 1}))
        for part in r0["prefills"]:
            print(json.dumps(part))
        print(json.dumps({"collectives": r0["collectives"], "bytes": r0["bytes"]}))
        for name in ("host_top", "device_top"):
            (out / f"{name}.txt").write_text(r0[name])
            print(r0[name])
    print(cs.card())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
