#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each fatal on failure (non-zero exit):

1. setup: card name and power limit, torch/CUDA versions, TF32 off, the
   kernels built from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel) with their ``-Xptxas -v`` lines;
2. every CUDA kernel against its plain PyTorch version on the card: the
   fused chain (K1) on ragged chains with J ∈ {1,2,3,4}, block 16 and 128,
   and a batch that is no multiple of the tile; the single factor (K6)
   with bk ≠ bn; f32 within 1e-5·max|y|, bf16 within 3e-2·max|y|;
3. the main path at full width: gemma-2b's MLP up-projection
   ``W (2048, 16384)`` (d_model 2048, d_ff 16384) from a seed, factorized on
   the card into J = 3 block-sparse factors (block 128, k 4), then
   ``apply("auto" | "fused" | "bsr")`` at B = 128 and 4096, each checked
   against the plain version and against ``x @ op.todense()``; the kernel
   launch counters are zeroed before and read after, and must have risen;
4. times (CUDA events, warm-up, then 20 launches) of each kernel, its
   plain version and one PyTorch call computing the same function
   (``torch.matmul`` on the materialized matrix), beside the card's bound,
   and the cost of an empty launch.

Prints one JSON object per line; the last three lines are the kernels
summary, the card's ``name, power.limit`` and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BW = 3.35e12  # B/s, H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # FLOP/s: FFMA f32, dense bf16 tensor cores
TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # max|kernel − plain| / max|plain|
DENSE_TOL = 1e-4  # vs x @ todense(): another association order of the same f32 products
ITERS = 20


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(y, ref) -> tuple[float, float]:
    """(max |y − ref|, that over max |ref|)."""
    err = float((y.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def time_ms(fn, iters: int = ITERS) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def setup() -> dict:
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in text.splitlines() if "Used" in ln or "Compiling entry" in ln]
        for name, text in logs.items()
    }
    info = {
        "phase": "setup",
        "card": card(),
        "device_name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "build_s": build_s,
        "ptxas": ptxas,
    }
    log(info)
    return info


def _random_chain(dims, blk, k, seed, dev):
    import torch

    from repro_torch.core.compress import BlockFaust, random_block_factor

    g = torch.Generator().manual_seed(seed)
    factors = tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, k, generator=g, device=dev)
        for j in range(len(dims) - 1)
    )
    return BlockFaust(factors, torch.ones((), device=dev)), g


def check_kernels(dev) -> list[dict]:
    """Phase 2: each kernel against its plain version on the same inputs."""
    import torch

    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for blk, dims in dims_by_blk.items():
            for n_factors in (1, 2, 3, 4):
                for bt in (SUPPORTED_BT if n_factors == 3 else (32,)):
                    bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
                    pc = pack_chain(bf).to(dtype=dtype)
                    plan = pc.plan
                    x = torch.randn((37, dims[0]), generator=g)
                    x = torch.nn.functional.pad(x, (0, plan.in_blocks[0] * blk - dims[0]))
                    x = x.to(dev, dtype)
                    meta = chain_meta(plan, pc.in_idx)
                    yk = chain_matmul(x, pc.values, meta, plan=plan, bt=bt)
                    yp = chain_matmul_plain(x, pc.values, meta, plan=plan)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err, rel = rel_err(yk, yp)
                    row = {"phase": "kernel_check", "kernel": "chain_matmul", "dtype": dname,
                           "J": n_factors, "block": blk, "dims": list(dims[: n_factors + 1]),
                           "batch": 37, "bt": bt, "max_abs_err": err, "rel_err": rel,
                           "tol": TOL[dname]}
                    log(row)
                    require(rel <= TOL[dname], f"chain_matmul disagrees with its plain version: {row}")
                    rows.append(row)
        for batch, (o, k, bk, bn, n_in) in zip(
            (37, 130, 5), ((6, 3, 64, 128, 9), (4, 2, 128, 96, 3), (3, 2, 32, 160, 5))
        ):
            g = torch.Generator().manual_seed(batch)
            idx = torch.stack([torch.randperm(n_in, generator=g)[:k] for _ in range(o)])
            idx = torch.sort(idx, dim=1).values.to(torch.int32).to(dev)
            values = (torch.randn((o, k, bk, bn), generator=g) / math.sqrt(k * bk)).to(dev, dtype)
            x = torch.randn((batch, n_in * bk), generator=g).to(dev, dtype)
            yp = bsr_matmul_plain(x, values, idx)
            for bt in SUPPORTED_BT:
                yk = bsr_matmul(x, values, idx, bt=bt)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                err, rel = rel_err(yk, yp)
                row = {"phase": "kernel_check", "kernel": "bsr_matmul", "dtype": dname,
                       "values_shape": [o, k, bk, bn], "batch": batch, "bt": bt,
                       "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                log(row)
                require(rel <= TOL[dname], f"bsr_matmul disagrees with its plain version: {row}")
                rows.append(row)
    return rows


def main_path(dev, in_f: int = 2048, out_f: int = 16384, batches=(128, 4096)):
    """Phase 3: factorize → pack → apply through the user entry points."""
    import numpy as np
    import torch

    from repro_torch.api import FactorizeSpec, factorize, last_report
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    w = np.random.default_rng(0).standard_normal((in_f, out_f), dtype=np.float32) / np.sqrt(in_f)
    chain_matmul.launches = 0
    bsr_matmul.launches = 0
    t0 = time.perf_counter()
    op, info = factorize(
        w, FactorizeSpec(strategy="hierarchical", n_factors=3, block=128, k_first=4, k_mid=4),
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fact_s = time.perf_counter() - t0
    w_dev = torch.as_tensor(w, device=dev)
    plan = op._packed.plan
    log({"phase": "factorize", "shape": [in_f, out_f], "seconds": fact_s,
         "rel_error_fro": float(op.rel_error_fro(w_dev)), "s_tot": op.s_tot, "rcg": op.rcg,
         "sweeps": info.n_sweeps, "global_losses": info.hierarchical.global_losses,
         "plan": {"block": plan.block, "in_blocks": plan.in_blocks,
                  "out_blocks": plan.out_blocks, "k_blocks": plan.k_blocks,
                  "n_steps": plan.n_steps, "max_blocks": plan.max_blocks}})
    dense = op.todense()
    g = torch.Generator().manual_seed(1)
    for b in batches:
        x = torch.randn((b, in_f), generator=g).to(dev)
        y_dense = x @ dense
        for backend in ("auto", "fused", "bsr"):
            y = op.apply(x, backend, device=dev)
            report = last_report()
            y_plain = op.apply(x, report.backend, use_kernel=False, device=dev)
            err_p, rel_p = rel_err(y, y_plain)
            err_d, rel_d = rel_err(y, y_dense)
            row = {"phase": "apply", "batch": b, "requested": backend,
                   "report": report.as_row(), "max_abs_err_plain": err_p, "rel_err_plain": rel_p,
                   "max_abs_err_dense": err_d, "rel_err_dense": rel_d,
                   "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}
            log(row)
            require(row["finite"] and tuple(y.shape) == (b, out_f), f"bad output: {row}")
            require(rel_p <= TOL["float32"], f"{backend} apply disagrees with the plain version")
            require(rel_d <= DENSE_TOL, f"{backend} apply disagrees with x @ todense()")
    launches = {"chain_matmul": chain_matmul.launches, "bsr_matmul": bsr_matmul.launches}
    log({"phase": "launches", **launches})
    if dev.type == "cuda":
        require(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")
    return op, launches


def measure(op, card_line: str) -> tuple[list[dict], float]:
    """Phase 4: kernel, plain and library times at the main path's shapes;
    every row names the card and its power limit."""
    import torch

    from repro_torch.core.compress import unpack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain, launch_noop
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta

    dev = op.device
    t_launch_us = time_ms(launch_noop, iters=1000) * 1e3
    log({"phase": "t_launch", "card": card_line, "t_launch_us": t_launch_us})
    m, n = op.shape
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        elt = torch.empty((), dtype=dtype).element_size()
        pc = op._packed.to(dtype=dtype)
        plan, s_tot = pc.plan, pc.values.numel()
        bf = unpack_chain(pc)
        a_dense = op.todense().to(dtype)
        meta = chain_meta(plan, pc.in_idx)
        for b in (128, 4096):
            x = torch.randn((b, m), device=dev).to(dtype)

            # every width of this chain is a block multiple: no pad, no slice
            def k6(fn=bsr_matmul):
                y = x
                for f in bf.factors:
                    y = fn(y, f.values, f.in_idx)
                return y

            fns = {
                "chain_matmul": (lambda: chain_matmul(x, pc.values, meta, plan=plan),
                                 lambda: chain_matmul_plain(x, pc.values, meta, plan=plan), 1),
                "bsr_matmul": (k6, lambda: k6(bsr_matmul_plain), plan.n_factors),
            }
            flops = 2.0 * b * s_tot
            byts = elt * s_tot + elt * b * (m + n)
            t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
            for name, (kern, plain, per_call) in fns.items():
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"{name} {dname} B={b} disagrees with its plain version")
                row = {"phase": "time", "card": card_line, "kernel": name, "dtype": dname, "batch": b,
                       "launches_per_apply": per_call, "max_abs_err": err, "rel_err": rel,
                       "ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lambda: torch.matmul(x, a_dense)),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)
    # end to end: one op.apply per backend, host work (padding, step table,
    # allocation, λ) included
    for b in (128, 4096):
        x = torch.randn((b, m), device=dev)
        log({"phase": "apply_time", "card": card_line, "dtype": "float32", "batch": b,
             **{f"{be}_ms": time_ms(lambda be=be: op.apply(x, be, device=dev))
                for be in ("fused", "bsr", "dense")},
             "auto_picks": op.dispatch_for(b).backend})

    # batch-tile sweep (f32): the data behind DEFAULT_BT
    pc = op._packed
    bf = unpack_chain(pc)
    meta = chain_meta(pc.plan, pc.in_idx)
    for b in (128, 4096):
        x = torch.randn((b, m), device=dev)
        for bt in SUPPORTED_BT:
            def k6(bt=bt):
                y = x
                for f in bf.factors:
                    y = bsr_matmul(y, f.values, f.in_idx, bt=bt)
                return y

            log({"phase": "bt_sweep", "card": card_line, "dtype": "float32", "batch": b, "bt": bt,
                 "chain_matmul_ms": time_ms(lambda: chain_matmul(x, pc.values, meta, plan=pc.plan, bt=bt)),
                 "bsr_matmul_ms": time_ms(k6)})
    return rows, t_launch_us


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    info = setup()
    checks = check_kernels(dev)
    op, launches = main_path(dev)
    rows, _ = measure(op, info["card"])

    sources = {
        "chain_matmul": ("src/repro_torch/kernels/csrc/chain_matmul.cu",
                         "src/repro/kernels/chain.py:125"),
        "bsr_matmul": ("src/repro_torch/kernels/csrc/bsr_matmul.cu",
                       "src/repro/kernels/bsr_matmul.py:63"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        cases = [r for r in rows if r["kernel"] == name]
        head = next(r for r in cases if r["dtype"] == "float32" and r["batch"] == 128)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "card": info["card"],
            "launches": launches[name], "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "headline": {"dtype": "float32", "batch": 128},
            "check_max_rel_err": max(c["rel_err"] for c in checks if c["kernel"] == name),
            "cases": [{k: r[k] for k in ("dtype", "batch", "launches_per_apply", "max_abs_err",
                                         "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                      for r in cases],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
