#!/usr/bin/env python3
"""A short card run of ``chip_smoke.py``'s two gates that hold a
table-steered ``auto`` apply within ``AUTO_SLACK`` of its pick forced,
repeated while the host is loaded: how far host contention moves them.
They are the ``auto_time`` rows of ``measure_quantized`` (forward) and
phase 11, ``grad_dispatch`` (training applies).

    python3 dispatch_probe.py             # from the repository root, one card
    python3 dispatch_probe.py --load 0 6  # busy processes, one run each
    python3 dispatch_probe.py --cost-only # the measure costs alone

Builds the kernels, factorizes and quantizes the gemma-2b up-projection
as ``chip_smoke.py``'s main and quantized paths do, and first times one
``autotune.measure(grad=True)`` of the f32 operator with f32 x at B = 128
and 4096 (a ``measure_cost`` line each: seconds, the tile it kept and
every tile's µs).  Then it runs both gates once for each ``--load`` (the
forward one after ``measured_dispatch`` fills a fresh table), with that
many processes spinning on the host.  In phase 11 the grad table's fused
tile must also run within ``TILE_MARGIN`` of the default tile (its pick
forced at the table's tile over it forced at tile 64, medians of the
same alternating calls).  Every row they log is printed (a failed gate is
printed and the next load runs), then one ``{"load", "phase", "op",
"dtype", "batch", "ratio", "tile_ratio"}`` line a gated row, and the
card's ``name, power.limit``.  Exits 1 if any run failed.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _spin(stop) -> None:
    x = 0
    while not stop.is_set():
        x = (x * 31 + 7) % 1000003


def forward_gate(cs, qops: dict, ops: dict, card: str) -> list[dict]:
    cs.measured_dispatch(ops)  # the forward table the auto_time rows read
    return cs.measure_quantized(qops, ops, card)


def measure_cost(ops: dict, batches=(128, 4096)) -> list[dict]:
    """Seconds of one ``autotune.measure(grad=True)`` of the f32 operator
    with f32 x at each batch (nothing recorded in a table)."""
    import torch

    from repro_torch.api import autotune

    op = ops["float32"]
    rows = []
    for b in batches:
        x = torch.randn((b, op.shape[0]), generator=torch.Generator().manual_seed(b)).to(op.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry = autotune.measure(op, x, grad=True, use_kernel=True)
        torch.cuda.synchronize()
        row = {"phase": "measure_cost", "batch": b, "seconds": time.perf_counter() - t0, "bt": entry.get("bt"),
               "bt_us": entry.get("bt_us"), "us": entry["us"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def tile_ratio(row: dict) -> float:
    """A grad row's pick forced at the table's tile over it forced at the
    default tile."""
    return row["forced_fwd_bwd_ms"] / row["forced_default_tile_ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load", type=int, nargs="+", default=[0, 6, 12, 0],
                    help="busy host processes during each run of the gates")
    ap.add_argument("--cost-only", action="store_true", help="time measure(grad=True) and stop")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dispatch_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    info = cs.setup()
    op, _, w_dev = cs.main_path(dev)
    qops, _ = cs.quantized_path(op, w_dev)
    ops = {"float32": op, "int8:per_block": qops["int8:per_block"]}
    measure_cost(ops)
    if args.cost_only:
        print(info["card"], flush=True)
        return 0
    from repro_torch.api.autotune import TILE_MARGIN

    out, failed = [], 0
    for load in args.load:
        stop = mp.Event()
        procs = [mp.Process(target=_spin, args=(stop,)) for _ in range(load)]
        for p in procs:
            p.start()
        t0 = time.perf_counter()
        rows = []
        try:
            for gate in (lambda: forward_gate(cs, qops, ops, info["card"]),
                         lambda: cs.grad_dispatch(ops, info["card"])):
                try:
                    rows += [r for r in gate() if "auto_over_forced" in r]
                except RuntimeError as e:
                    failed += 1
                    print(json.dumps({"load": load, "failed": str(e)}), flush=True)
            for r in rows:
                if r["phase"] == "grad_dispatch" and tile_ratio(r) > 1.0 + TILE_MARGIN:
                    failed += 1
                    print(json.dumps({"load": load, "failed": f"the grad table's tile {r['report']['bt']} ran "
                                      f"{tile_ratio(r):.3f}× tile 64's time", "key": r["key"]}), flush=True)
        finally:
            stop.set()
            for p in procs:
                p.join()
        print(json.dumps({"load": load, "s": time.perf_counter() - t0}), flush=True)
        out += [{"load": load, "phase": r["phase"], "op": r["op"], "dtype": r.get("dtype", "float32"),
                 "batch": r["batch"], "ratio": r["auto_over_forced"],
                 "tile_ratio": tile_ratio(r) if r["phase"] == "grad_dispatch" else None} for r in rows]
    for row in out:
        print(json.dumps(row), flush=True)
    print(info["card"], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
