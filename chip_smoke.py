#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each fatal on failure (non-zero exit):

1. setup: card name and power limit, torch/CUDA versions, TF32 off, the
   kernels built from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel) with their ``-Xptxas -v`` lines and K1/K4's SASS
   counts of HMMA (bf16 tensor cores), FFMA and LDGSTS (cp.async), then K1/K4's
   launch at the main path's and the trainer's shapes: resident CTAs,
   grid, dynamic shared memory and work items per factor;
2. every CUDA kernel against its plain PyTorch version on the card: the
   fused chain (K1) on ragged chains with J ∈ {1,2,3,4}, block 16 and 128,
   and a batch that is no multiple of the tile, then on a grid of blocks
   8 to 128 (24: no power of two; 100: no multiple of the MMA depth), J up
   to 6 and B ∈ {1, 37, 4096}, with K4 on the same grid; the single factor (K6)
   with bk ≠ bn; the quantized chain (K4) on the same chains for int8,
   fp8 e4m3 and fp8 e5m2 codes with per-block and per-row scales, every
   batch tile, f32 and bf16 activations; the chain backward (K2 dgrad, K3
   wgrad, K5 both on codes: dx, dvalues, dscales) on the same grid; f32
   within 1e-5·max|y|, bf16 within 3e-2·max|y|;
3. the main path at full width: gemma-2b's MLP up-projection
   ``W (2048, 16384)`` (d_model 2048, d_ff 16384) from a seed, factorized on
   the card into J = 3 block-sparse factors (block 128, k 4), then
   ``apply("auto" | "fused" | "bsr")`` at B = 128 and 4096, each checked
   against the plain version and against ``x @ op.todense()``; the kernel
   launch counters are zeroed before and read after, and must have risen;
4. the quantized path: that chain through ``quantize_chain`` (int8
   per-block and per-row, fp8 e4m3, fp8 e5m2), ``weight_bytes`` against
   the f32 chain's, ΔRE = RE(quantized) − RE(f32) against W within the
   reference's thresholds, and ``apply("fused" | "bsr" | "dense" |
   "auto")`` at B = 128 and 4096 in f32 and bf16, each checked against the
   plain version and ``x @ op.todense()``; counters zeroed before, read
   after;
5. measured dispatch: a fresh table under ``build/``, filled by
   ``apply(autotune=True)`` for the f32 and the int8 operator at both
   batches; ``auto`` must then report ``source == "measured"``, pick the
   fastest measured backend and run the fused tile the table holds;
6. training applies at full width (slice 3): the f32 operator (gradient
   wrt x and the values) and the int8 one (wrt x and the scales), f32 and
   bf16, B = 128 and 4096, fwd+bwd through ``fused`` (K1+K2+K3,
   K4+K5), ``bsr`` and ``dense``, held against the plain versions and
   autograd of ``x @ op.todense()``, with fwd and fwd+bwd times and
   ``apply("auto")``'s report under grad; counters zeroed before, read
   after, K2/K3/K5 required;
7. the trainer: ``repro_torch.launch.train --arch gemma_2b --faust
   --steps 3 --batch 8 --seq 128`` (full width and depth, bf16, remat,
   FAµST unembedding) on a fresh autotune table; loss, step time and
   tokens/s per step, peak memory, the captured FAµST dispatch; finite
   losses and K2/K3 launches required; then one more step under
   ``torch.profiler``: device busy time and idle share, device time by
   kernel family (K1/K4, K2, K3, dense matmul, elementwise, other);
8. times (CUDA events, warm-up, then 20 launches; 5 for the backward) of
   each kernel, its plain version and one PyTorch call computing the same
   function (``torch.matmul`` on the materialized matrix; none for the
   wgrad), beside the card's bound, the cost of an empty launch, and
   ``apply("auto")`` with the model alone and with the table beside the
   forced backend it picks; K1 and K4 (int8 per-block and per-row, fp8
   e4m3 and e5m2) also with a cold L2 (a 256 MB buffer written between
   launches); the batch-tile sweep of K1 and K6 in f32 and bf16; K1, K2
   and K3 also at the trainer's shapes (the FAµST unembedding, bf16,
   B = 1024).

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
TABLE = ROOT / "build" / "chip_smoke_autotune.json"  # this run's own measured table
HBM_BW = 3.35e12  # B/s, H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # FLOP/s: FFMA f32, dense bf16 tensor cores
TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # max|kernel − plain| / max|plain|
DENSE_TOL = 1e-4  # vs x @ todense(): another association order of the same f32 products
# ΔRE = RE(quantized) − RE(f32) bounds: the reference's thresholds
# (benchmarks/quantized_re.py THRESHOLDS)
DRE_MAX = {"int8": 8e-3, "fp8_e4m3": 1e-1, "fp8_e5m2": 1.5e-1}
QUANTS = (("int8", "per_block"), ("int8", "per_row"), ("fp8_e4m3", "per_block"),
          ("fp8_e5m2", "per_block"))
AUTO_SLACK = 1.10  # a table-steered auto apply within 10 % of its forced backend
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


def time_ms_cold(fn, iters: int = 10) -> float:
    """Mean time of ``fn`` with the 50 MB L2 flushed before each launch:
    a 256 MB buffer is written between launches, outside the timed span."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def _plan(dims, blk, k):
    """The ChainPlan of a chain over ``dims`` at block ``blk`` with ``k``
    input blocks per output block (an int, or one per factor)."""
    from repro_torch.core.compress import ChainPlan

    ib = tuple(-(-d // blk) for d in dims[:-1])
    ob = tuple(-(-d // blk) for d in dims[1:])
    kb = tuple(min(k, i) for i in ib) if isinstance(k, int) else tuple(k)
    offs = [0]
    for o, kk in zip(ob, kb):
        offs.append(offs[-1] + o * kk)
    return ChainPlan(blk, ib, ob, kb, tuple(offs), tuple(dims[:-1]), tuple(dims[1:]))


# the gemma-2b up-projection as factorized on the card (F_1 16x6, F_2 16x4,
# F_3 128x4 out blocks x slots) and the trainer's FAµST unembedding
UP_PROJ = ((2048, 2048, 2048, 16384), 128, (6, 4, 4))
UNEMBED = ((2048, 2048, 256000), 16, 4)


def launch_configs(card_line: str) -> list[dict]:
    """K1/K4's launch at the main path's and the trainer's shapes, at their
    default tile: resident CTAs, grid, shared memory, items per factor."""
    import torch

    from repro_torch.kernels.chain import FORWARD_BT, chain_schedule, launch_config

    rows = []
    cases = [("up-projection", UP_PROJ, b, dt, q) for b in (128, 4096)
             for dt in (torch.float32, torch.bfloat16) for q in (None, torch.int8)]
    cases.append(("unembedding", UNEMBED, 1024, torch.bfloat16, None))
    for name, layout, b, dtype, qdtype in cases:
        plan = _plan(*layout)
        sched = chain_schedule(plan, b, FORWARD_BT)
        cfg = launch_config(dtype, plan.block, FORWARD_BT, qdtype)
        row = {"phase": "launch_config", "card": card_line, "chain": name,
               "kernel": "chain_matmul" if qdtype is None else "chain_matmul_q",
               "dtype": str(dtype).removeprefix("torch."), "batch": b, "bt": FORWARD_BT,
               "block": plan.block, "blkp": sched.blkp, "group": sched.group, "ctas": cfg["ctas"],
               "grid": min(cfg["ctas"], max(sched.items)), "smem_bytes": cfg["smem_bytes"],
               "items_per_factor": list(sched.items), "barriers": plan.n_factors - 1}
        log(row)
        rows.append(row)
    return rows


def sass_counts(lib) -> dict | None:
    """Tensor-core (HMMA), FFMA and cp.async (LDGSTS) instructions in a
    built kernel library's SASS, by ``cuobjdump -sass``; None without the
    tool."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: sass.count(op) for op in ("HMMA", "FFMA", "LDGSTS")}


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
        "sass": sass_counts(build.library_path("chain_matmul")),
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


def check_quantized_kernel(dev) -> list[dict]:
    """Phase 2, K4: the quantized chain kernel against its plain version on
    the chains K1 is checked on, for every code type and scale scheme."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    for blk, dims in dims_by_blk.items():
        for n_factors in (1, 2, 3, 4):
            bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
            pc = pack_chain(bf)
            plan = pc.plan
            x0 = torch.randn((37, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            meta = chain_meta(plan, pc.in_idx)
            for qdtype, scheme in [(d, s) for d in DRE_MAX for s in ("per_block", "per_row")]:
                q = quantize_chain(pc, qdtype, scheme)
                scales = expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x = x0.to(dev, dtype)
                    yp = chain_matmul_q_plain(x, q.values, scales, meta, plan=plan)
                    for bt in (SUPPORTED_BT if n_factors == 3 else (16,)):
                        yk = chain_matmul(x, q.values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(yk, yp)
                        row = {"phase": "kernel_check", "kernel": "chain_matmul_q", "dtype": dname,
                               "quant": q.qscheme, "J": n_factors, "block": blk,
                               "dims": list(dims[: n_factors + 1]), "batch": 37, "bt": bt,
                               "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                        log(row)
                        require(yk.dtype == dtype and rel <= TOL[dname],
                                f"chain_matmul_q disagrees with its plain version: {row}")
                        rows.append(row)
    return rows


# (block, J) of the grid check: blocks 8 to 128, 24 (no power of two) and 100
# (no multiple of the MMA depth 16); J up to 6, so each ping-pong buffer of the
# workspace is written again after the grid barrier of a later factor
GRID = ((8, 6), (16, 5), (24, 6), (64, 4), (100, 3), (128, 6))


def check_chain_grid(dev, batches=(1, 37, 4096)) -> list[dict]:
    """Phase 2, K1 and K4 on the persistent schedule: the GRID of blocks and
    depths at batches below, at and far above one tile, every tile at
    B = 37; f32 and bf16; K4 for int8, e4m3 and e5m2, per-block and per-row."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import (
        SUPPORTED_BT,
        chain_matmul,
        chain_matmul_plain,
        chain_matmul_q_plain,
    )
    from repro_torch.kernels.ops import chain_meta

    rows = []
    forms = [(None, None)] + [(d, sch) for d in DRE_MAX for sch in ("per_block", "per_row")]
    for blk, n_factors in GRID:
        base = (40, 72, 56, 90, 33, 61, 47) if blk <= 24 else (200, 300, 260, 330, 150, 210, 190)
        dims = base[: n_factors + 1]
        bf, g = _random_chain(dims, blk, 3, 100 * blk + n_factors, dev)
        pc = pack_chain(bf)
        plan = pc.plan
        meta = chain_meta(plan, pc.in_idx)
        for b in batches:
            x0 = torch.randn((b, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            for qdtype, scheme in forms:
                q = None if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if q is None else expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x = x0.to(dev, dtype)
                    if q is None:
                        values = pc.values.to(dtype)
                        yp = chain_matmul_plain(x, values, meta, plan=plan)
                    else:
                        values = q.values
                        yp = chain_matmul_q_plain(x, values, scales, meta, plan=plan)
                    for bt in SUPPORTED_BT if b == 37 else (16, 64):
                        yk = chain_matmul(x, values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(yk, yp)
                        row = {"phase": "kernel_check", "kernel": "chain_matmul" + ("" if q is None else "_q"),
                               "dtype": dname, "quant": None if q is None else q.qscheme, "J": n_factors,
                               "block": blk, "dims": list(dims), "batch": b, "bt": bt,
                               "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                        log(row)
                        require(yk.dtype == dtype and rel <= TOL[dname],
                                f"{row['kernel']} disagrees with its plain version: {row}")
                        rows.append(row)
    return rows


def check_backward_kernels(dev) -> list[dict]:
    """Phase 2, slice 3: K2 (chain_dgrad), K3 (chain_wgrad) and K5 (both on
    codes) against their plain versions on the chains K1 is checked on:
    dx, dvalues and, for codes, dscales = Σ_c q·dv."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    forms = [(None, None)] + [(d, s) for d in DRE_MAX for s in ("per_block", "per_row")]
    for blk, dims in dims_by_blk.items():
        for n_factors in (1, 2, 3, 4):
            bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
            pc = pack_chain(bf)
            plan = pc.plan
            x0 = torch.randn((37, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            dy0 = torch.randn((37, plan.out_blocks[-1] * blk), generator=g)
            dmeta, wmeta = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
            for qdtype, scheme in forms:
                q = pc if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if qdtype is None else expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x, dy = x0.to(dev, dtype), dy0.to(dev, dtype)
                    values = q.values if qdtype is not None else q.values.to(dtype)
                    dx_p = chain_dgrad_plain(dy, values, dmeta, plan=plan, scales=scales)
                    dv_p = chain_wgrad_plain(x, dy, values, wmeta, plan=plan, scales=scales)
                    for bt in (SUPPORTED_BT if n_factors == 3 else (16,)):
                        dx = chain_dgrad(dy, values, dmeta, plan=plan, bt=bt, scales=scales)
                        dv = chain_wgrad(x, dy, values, wmeta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        outs = {"dx": (dx, dx_p), "dvalues": (dv, dv_p)}
                        if scales is not None:
                            outs["dscales"] = tuple(torch.sum(values.float() * d, dim=2) for d in (dv, dv_p))
                        for what, (got, want) in outs.items():
                            err, rel = rel_err(got, want)
                            kernel = ("chain_dgrad" if what == "dx" else "chain_wgrad") + ("_q" if scales is not None else "")
                            row = {"phase": "kernel_check", "kernel": kernel, "output": what, "dtype": dname,
                                   "quant": q.qscheme, "J": n_factors, "block": blk,
                                   "dims": list(dims[: n_factors + 1]), "batch": 37, "bt": bt,
                                   "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                            log(row)
                            require(bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                                    f"{kernel} disagrees with its plain version: {row}")
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
    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
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
    return op, launches, w_dev


def quantized_path(op, w_dev, batches=(128, 4096)) -> tuple[dict, dict]:
    """Phase 4: the main path's chain quantized, served through every
    backend; returns ({qscheme: op}, launch counts of this phase)."""
    import torch

    from repro_torch.api import FaustOp, last_report
    from repro_torch.core.compress import quantize_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    dev = op.device
    m, n = op.shape
    f32_bytes = op._packed.weight_bytes
    re_f32 = float(op.rel_error_fro(w_dev))
    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
    qops = {}
    g = torch.Generator().manual_seed(2)
    xs = {b: torch.randn((b, m), generator=g).to(dev) for b in batches}
    for qdtype, scheme in QUANTS:
        qop = FaustOp.from_packed(quantize_chain(op._packed, qdtype, scheme), device=dev)
        qops[qop.rep.qscheme] = qop
        dense = qop.todense()
        dre = float(qop.rel_error_fro(w_dev)) - re_f32
        row = {"phase": "quantize", "qscheme": qop.rep.qscheme, "weight_bytes": qop.rep.weight_bytes,
               "f32_weight_bytes": f32_bytes, "bytes_ratio": qop.rep.weight_bytes / f32_bytes,
               "rel_error_fro": re_f32 + dre, "delta_re": dre, "delta_re_max": DRE_MAX[qdtype]}
        log(row)
        require(row["bytes_ratio"] <= 0.26, f"quantized chain is not ~4x smaller: {row}")
        require(abs(dre) <= DRE_MAX[qdtype], f"quantization error over the threshold: {row}")
        for b, x32 in xs.items():
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                x = x32.to(dtype)
                y_dense = x.float() @ dense
                for backend in ("fused", "bsr", "dense", "auto"):
                    y = qop.apply(x, backend, device=dev)
                    report = last_report()
                    y_plain = qop.apply(x, report.backend, use_kernel=False, device=dev)
                    err_p, rel_p = rel_err(y, y_plain)
                    err_d, rel_d = rel_err(y, y_dense)
                    row = {"phase": "apply_quantized", "qscheme": qop.rep.qscheme, "dtype": dname,
                           "batch": b, "requested": backend, "report": report.as_row(),
                           "max_abs_err_plain": err_p, "rel_err_plain": rel_p,
                           "max_abs_err_dense": err_d, "rel_err_dense": rel_d,
                           "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}
                    log(row)
                    require(row["finite"] and tuple(y.shape) == (b, n) and y.dtype == dtype,
                            f"bad output: {row}")
                    require(rel_p <= TOL[dname], f"{backend} quantized apply disagrees with the plain version")
                    require(rel_d <= (DENSE_TOL if dtype == torch.float32 else TOL[dname]),
                            f"{backend} quantized apply disagrees with x @ todense()")
    launches = {"chain_matmul": chain_matmul.launches, "chain_matmul_q": chain_matmul.q_launches,
                "bsr_matmul": bsr_matmul.launches}
    log({"phase": "launches_quantized", **launches})
    if dev.type == "cuda":
        require(launches["chain_matmul_q"] > 0 and launches["bsr_matmul"] > 0,
                f"a kernel of the quantized path never ran: {launches}")
    return qops, launches


def measured_dispatch(ops: dict, batches=(128, 4096)) -> dict:
    """Phase 5: fill a fresh table through ``apply(autotune=True)``; then
    ``auto`` must follow it.  Returns {(name, batch): table entry}."""
    import os

    import torch

    from repro_torch.api import autotune, dispatch, last_report
    from repro_torch.kernels.chain import DEFAULT_BT, chain_matmul

    TABLE.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(TABLE)
    os.environ.pop("REPRO_AUTOTUNE", None)  # read-only: only autotune=True measures
    autotune.reload()
    entries = {}
    g = torch.Generator().manual_seed(3)
    for name, op in ops.items():
        for b in batches:
            x = torch.randn((b, op.shape[0]), generator=g).to(op.device)
            op.apply(x, autotune=True, device=op.device)
            entry = autotune.lookup(autotune.key_for_op(op, batch=b, dtype=x.dtype))
            require(entry is not None, f"{name} B={b}: no table entry after apply(autotune=True)")
            before = (chain_matmul.launches, chain_matmul.q_launches)
            y = op.apply(x, device=op.device)
            report = last_report()
            fastest = min(entry["us"], key=lambda k: (entry["us"][k], dispatch._ORDER[k]))
            row = {"phase": "measured_dispatch", "op": name, "batch": b, "key":
                   autotune.key_for_op(op, batch=b, dtype=x.dtype), "entry": entry,
                   "report": report.as_row(), "finite": bool(torch.isfinite(y).all())}
            log(row)
            require(report.source == "measured", f"auto did not read the table: {row}")
            require(report.backend == fastest, f"auto did not pick the fastest measured backend: {row}")
            # the card's entries always carry the tile sweep's winner
            require(report.bt == entry.get("bt", DEFAULT_BT), f"auto did not take the table's fused tile: {row}")
            if report.backend == "fused" and op.device.type == "cuda":
                require((chain_matmul.launches, chain_matmul.q_launches) != before,
                        f"auto picked fused but launched no chain kernel: {row}")
            entries[(name, b)] = entry
    return entries


def measure(op, card_line: str) -> tuple[list[dict], float]:
    """Phase 8: kernel, plain and library times at the main path's shapes;
    every row names the card and its power limit."""
    import torch

    from repro_torch.core.compress import unpack_chain
    from repro_torch.kernels.bsr_matmul import DEFAULT_BT as BSR_BT
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain, launch_noop
    from repro_torch.kernels.chain import FORWARD_BT, SUPPORTED_BT, chain_matmul, chain_matmul_plain
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
            tiles = {"chain_matmul": FORWARD_BT, "bsr_matmul": BSR_BT}
            flops = 2.0 * b * s_tot
            byts = elt * s_tot + elt * b * (m + n)
            t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
            for name, (kern, plain, per_call) in fns.items():
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"{name} {dname} B={b} disagrees with its plain version")
                row = {"phase": "time", "card": card_line, "kernel": name, "dtype": dname, "batch": b,
                       "bt": tiles[name], "launches_per_apply": per_call, "max_abs_err": err, "rel_err": rel,
                       "ms": time_ms(kern), "cold_ms": time_ms_cold(kern), "plain_ms": time_ms(plain),
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

    # batch-tile sweep: the data behind FORWARD_BT (K1) and K6's default
    for dtype in (torch.float32, torch.bfloat16):
        pc = op._packed.to(dtype=dtype)
        bf = unpack_chain(pc)
        meta = chain_meta(pc.plan, pc.in_idx)
        for b in (128, 4096):
            x = torch.randn((b, m), device=dev).to(dtype)
            for bt in SUPPORTED_BT:
                def k6(bt=bt):
                    y = x
                    for f in bf.factors:
                        y = bsr_matmul(y, f.values, f.in_idx, bt=bt)
                    return y

                log({"phase": "bt_sweep", "card": card_line, "dtype": str(dtype).removeprefix("torch."),
                     "batch": b, "bt": bt,
                     "chain_matmul_ms": time_ms(lambda: chain_matmul(x, pc.values, meta, plan=pc.plan, bt=bt)),
                     "bsr_matmul_ms": time_ms(k6)})
    return rows, t_launch_us


def measure_quantized(qops: dict, ops: dict, card_line: str, batches=(128, 4096)) -> list[dict]:
    """Phase 8, slice 2: K4 per code type at both batches beside its bound,
    its plain version and ``torch.matmul`` on the dequantized dense
    matrix; then ``apply("auto")`` on the model alone and on the table,
    beside the forced backend the table picks."""
    import os

    import torch

    from repro_torch.api import last_report
    from repro_torch.core.compress import expand_scales
    from repro_torch.kernels.chain import FORWARD_BT, chain_matmul, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    for qscheme in ("int8:per_block", "int8:per_row", "fp8_e4m3:per_block", "fp8_e5m2:per_block"):
        qop = qops[qscheme]
        q = qop.rep
        dev, (m, n) = qop.device, qop.shape
        plan, s_tot = q.plan, q.values.numel()
        scales = expand_scales(q.scales, plan.block).contiguous()
        meta = chain_meta(plan, q.in_idx)
        dense = qop.todense()
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            elt = torch.empty((), dtype=dtype).element_size()
            a_dense = dense.to(dtype)
            for b in batches:
                x = torch.randn((b, m), device=dev).to(dtype)
                kern = lambda: chain_matmul(x, q.values, meta, plan=plan, scales=scales)  # noqa: E731
                plain = lambda: chain_matmul_q_plain(x, q.values, scales, meta, plan=plan)  # noqa: E731
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"chain_matmul_q {qscheme} {dname} B={b} disagrees with its plain version")
                flops = 2.0 * b * s_tot
                byts = q.values.element_size() * s_tot + 4 * scales.numel() + elt * b * (m + n)
                t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
                row = {"phase": "time", "card": card_line, "kernel": "chain_matmul_q", "quant": qscheme,
                       "dtype": dname, "batch": b, "bt": FORWARD_BT, "launches_per_apply": 1, "max_abs_err": err,
                       "rel_err": rel, "ms": time_ms(kern), "cold_ms": time_ms_cold(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lambda: torch.matmul(x, a_dense)),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)

    # auto: the model alone (table off) and the table, beside the forced
    # backend the table picks (at the table's tile), in alternation
    for name, op in ops.items():
        for b in batches:
            x = torch.randn((b, op.shape[0]), device=op.device)
            os.environ["REPRO_AUTOTUNE"] = "off"
            op.apply(x, device=op.device)
            model = last_report()
            model_ms = time_ms(lambda: op.apply(x, device=op.device))
            del os.environ["REPRO_AUTOTUNE"]
            op.apply(x, device=op.device)
            tuned = last_report()
            t0 = time.perf_counter()
            for _ in range(1000):
                op.dispatch_for(b)
            dispatch_us = (time.perf_counter() - t0) * 1e3  # µs per table-hit decision, host
            forced, auto = [], []
            for _ in range(3):
                forced.append(time_ms(lambda: op.apply(x, tuned.backend, bt=tuned.bt, device=op.device)))
                auto.append(time_ms(lambda: op.apply(x, device=op.device)))
            row = {"phase": "auto_time", "card": card_line, "op": name, "batch": b,
                   "model_picks": model.backend, "model_source": model.source, "auto_model_ms": model_ms,
                   "table_picks": tuned.backend, "table_source": tuned.source, "table_bt": tuned.bt,
                   "auto_table_ms": sorted(auto)[1], "forced_ms": sorted(forced)[1],
                   "auto_table_runs_ms": auto, "forced_runs_ms": forced, "dispatch_us": dispatch_us}
            row["auto_over_forced"] = row["auto_table_ms"] / row["forced_ms"]
            log(row)
            require(model.source == "model" and tuned.source == "measured", f"wrong sources: {row}")
            require(row["auto_over_forced"] <= AUTO_SLACK, f"auto is slower than its forced backend: {row}")
            rows.append(row)
    return rows


def _bwd_counts() -> dict:
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad

    return {"chain_matmul": chain_matmul.launches, "chain_matmul_q": chain_matmul.q_launches,
            "bsr_matmul": bsr_matmul.launches, "chain_dgrad": chain_dgrad.launches,
            "chain_wgrad": chain_wgrad.launches, "chain_dgrad_q": chain_dgrad.q_launches,
            "chain_wgrad_q": chain_wgrad.q_launches}


def _zero_counts() -> None:
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad

    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
    chain_dgrad.launches = chain_dgrad.q_launches = chain_wgrad.launches = chain_wgrad.q_launches = 0


def _trainable(op):
    """A copy of ``op`` whose trained tensor (the values of an f32 chain,
    the scales of a quantized one) is a fresh leaf that requires grad."""
    import dataclasses

    from repro_torch.api import FaustOp

    pc = op._packed
    name = "scales" if pc.quantized else "values"
    leaf = getattr(pc, name).detach().clone().requires_grad_(True)
    return FaustOp(dataclasses.replace(pc, **{name: leaf})), leaf


def training_path(ops: dict, card_line: str, batches=(128, 4096)) -> tuple[list[dict], dict]:
    """Phase 6, slice 3: FaustOp-level training applies at full width.  For
    the f32 chain (gradient wrt x and the values) and its int8 per-block
    form (wrt x and the scales), f32 and bf16 x, both batches: fwd+bwd
    through ``fused`` (K1+K2+K3, K4+K5), ``bsr`` and ``dense``, each held
    against the plain versions and against autograd of x @ op.todense();
    fwd and fwd+bwd times; ``apply("auto")``'s report under grad.  Counts
    zeroed before, read after."""
    import torch

    from repro_torch.api import last_report

    _zero_counts()
    rows = []
    g = torch.Generator().manual_seed(4)
    for name, op in ops.items():
        m, n = op.shape
        dev = op.device
        for b in batches:
            x32 = torch.randn((b, m), generator=g).to(dev)
            w = torch.randn((b, n), generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                top, leaf = _trainable(op)

                def grads(backend, use_kernel=None, dense=False):
                    x = x32.to(dtype, copy=True).requires_grad_(True)
                    leaf.grad = None
                    if dense:
                        y = x.float() @ top.todense()
                    else:
                        y = top.apply(x, backend, use_kernel=use_kernel, device=dev)
                    (y.float() * w).sum().backward()
                    return y.detach(), x.grad.detach().clone(), leaf.grad.detach().clone()

                _, dx_d, dl_d = grads(None, dense=True)
                for backend in ("fused", "bsr", "dense"):
                    y, dx, dl = grads(backend)
                    report = last_report()
                    _, dx_p, dl_p = grads(backend, use_kernel=False)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    errs = {"dx_plain": rel_err(dx, dx_p), "dleaf_plain": rel_err(dl, dl_p),
                            "dx_dense": rel_err(dx, dx_d), "dleaf_dense": rel_err(dl, dl_d)}
                    x = x32.to(dtype, copy=True).requires_grad_(True)
                    with torch.no_grad():
                        fwd_ms = time_ms(lambda: top.apply(x, backend, device=dev), iters=5)
                    fwdbwd_ms = time_ms(lambda: top.apply(x, backend, device=dev).backward(w.to(dtype)), iters=5)
                    row = {"phase": "train_apply", "card": card_line, "op": name, "dtype": dname, "batch": b,
                           "backend": backend, "grad_wrt": "scales" if op._packed.quantized else "values",
                           "report": report.as_row(), "fwd_ms": fwd_ms, "fwd_bwd_ms": fwdbwd_ms,
                           **{f"rel_err_{k}": v[1] for k, v in errs.items()},
                           "finite": bool(torch.isfinite(dx).all() and torch.isfinite(dl).all())}
                    log(row)
                    tol_dense = DENSE_TOL if dtype == torch.float32 else TOL[dname]
                    require(row["finite"] and report.grad, f"bad training apply: {row}")
                    require(errs["dx_plain"][1] <= TOL[dname] and errs["dleaf_plain"][1] <= TOL[dname],
                            f"{backend} gradients disagree with the plain versions: {row}")
                    require(errs["dx_dense"][1] <= tol_dense and errs["dleaf_dense"][1] <= tol_dense,
                            f"{backend} gradients disagree with autograd of x @ todense(): {row}")
                    rows.append(row)
                x = x32.to(dtype, copy=True).requires_grad_(True)
                top.apply(x, device=dev)
                auto = last_report()
                log({"phase": "train_auto", "op": name, "dtype": dname, "batch": b, "report": auto.as_row()})
                require(auto.grad, f"auto under autograd was not priced for training: {auto.as_row()}")
    counts = _bwd_counts()
    log({"phase": "launches_train_apply", **counts})
    if any(op.device.type == "cuda" for op in ops.values()):
        require(all(counts[k] > 0 for k in ("chain_dgrad", "chain_wgrad", "chain_dgrad_q", "chain_wgrad_q")),
                f"a backward kernel of the training apply never ran: {counts}")
    return rows, counts


def train_lm(card_line: str, argv=None) -> dict:
    """Phase 7, slice 3: ``repro_torch.launch.train``'s own path at
    gemma-2b's full width and depth with a FAµST unembedding (the reference
    CLI's defaults: bf16, remat, block 16, k 4, 2 factors, untied), on a
    fresh autotune table so ``auto`` is the model's choice.  Per step: loss,
    step time, tokens/s; peak memory; the captured FAµST dispatch; the
    kernel counts of the phase, which must include K2 and K3."""
    import os

    import torch

    from repro_torch.api import autotune
    from repro_torch.launch import train

    table = ROOT / "build" / "chip_smoke_train_autotune.json"
    table.unlink(missing_ok=True)
    saved = {k: os.environ.get(k) for k in ("REPRO_TORCH_AUTOTUNE_TABLE", "REPRO_AUTOTUNE")}
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(table)
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reload()
    argv = argv or ["--arch", "gemma_2b", "--faust", "--steps", "3", "--batch", "8", "--seq", "128"]
    args = train.parse_args(argv)
    try:
        trainer = train.build(args)
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        out = trainer.run()
        wall_s = time.perf_counter() - t0
        counts = _bwd_counts()
        profile = profile_step(trainer, out, card_line) if trainer.device.type == "cuda" else None
    finally:  # the later phases read phase 5's table again
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reload()
    n_params = sum(p.numel() for p in out["model"].parameters())
    tokens = args.batch * args.seq
    for h in out["history"]:
        log({"phase": "train_step", "card": card_line, "step": h["step"], "loss": h["loss"],
             "step_time_s": h["step_time_s"], "tokens_per_s": tokens / h["step_time_s"],
             "grad_norm": h.get("grad_norm"), "lr": h.get("lr"), "skipped": h["skipped"]})
    rep = trainer.faust_dispatch
    row = {"phase": "train_lm", "card": card_line, "argv": argv, "n_layers": trainer.cfg.n_layers,
           "d_model": trainer.cfg.d_model, "vocab": trainer.cfg.vocab, "dtype": trainer.cfg.dtype,
           "remat": trainer.cfg.remat, "faust_unembed": str(trainer.cfg.faust_unembed), "params": n_params,
           "wall_s": wall_s,
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                       if trainer.device.type == "cuda" else None),
           "faust_dispatch": None if rep is None else rep.as_row(), "launches": counts, "profile": profile}
    log(row)
    losses = [h["loss"] for h in out["history"]]
    require(len(losses) == args.steps and all(math.isfinite(v) for v in losses), f"bad losses: {losses}")
    require(rep is not None and rep.grad, f"no FAµST dispatch priced for training was captured: {row}")
    if trainer.device.type == "cuda":
        require(counts["chain_dgrad"] > 0 and counts["chain_wgrad"] > 0,
                f"the trainer never ran K2/K3: {counts}")
    del out
    return row


# kernel families of a trainer step, by the device kernel's name
FAMILIES = (("K1/K4 chain_matmul", ("chain_fwd_kernel",)), ("K2 chain_dgrad", ("chain_dgrad",)),
            ("K3 chain_wgrad", ("chain_wgrad",)),
            ("dense matmul", ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
            ("elementwise and reductions", ("elementwise", "reduce_kernel", "Memset", "Memcpy")))


def profile_step(trainer, out, card_line: str) -> dict:
    """Phase 7, one more steady step of the trained model under
    ``torch.profiler``: the host's step time, the device's busy time (the
    union of kernel spans) and idle share, and device time by kernel family
    and by the ten costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch

    from repro_torch.data.pipeline import DataIterator
    from repro_torch.runtime.trainer import make_train_step

    step_fn = make_train_step(out["model"], trainer.opt_cfg, trainer.tcfg)
    data = DataIterator(trainer.data_cfg)
    batches = [{k: torch.from_numpy(v).to(trainer.device) for k, v in next(data).items()} for _ in range(2)]
    float(step_fn(batches[0], out["opt"])["loss"])  # warm: the step's allocations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(step_fn(batches[1], out["opt"])["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the kernel spans
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    families = {fam: 0.0 for fam, _ in FAMILIES} | {"other": 0.0}
    for name, us in by_name.items():
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        families[fam] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    row = {"phase": "train_profile", "card": card_line, "loss": loss, "step_s": step_s,
           "device_busy_ms": busy_us / 1e3, "n_kernels": len(spans),
           "device_idle_share": (1.0 - busy_us / 1e6 / step_s) if spans else None,
           "family_ms": families, "top_kernels_ms": [[n[:120], us / 1e3] for n, us in top]}
    log(row)
    require(math.isfinite(loss), f"the profiled step's loss is not finite: {row}")
    return {k: row[k] for k in ("step_s", "device_busy_ms", "device_idle_share", "family_ms")}


def measure_backward(op, qop, card_line: str, batches=(128, 4096)) -> list[dict]:
    """Phase 8, slice 3: K2, K3 and K5 (its dgrad and wgrad halves on int8
    codes) at the main path's shapes beside their bound, their plain
    versions and, for the dgrads, one PyTorch call computing the same
    function (``dy @ A_denseᵀ``)."""
    import torch

    from repro_torch.core.compress import expand_scales
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )

    rows = []
    m, n = op.shape
    dev = op.device
    q = qop._packed
    qscales = expand_scales(q.scales, q.plan.block).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        elt = torch.empty((), dtype=dtype).element_size()
        pc = op._packed.to(dtype=dtype)
        plan = pc.plan
        sizes = [plan.offsets[j + 1] - plan.offsets[j] for j in range(plan.n_factors)]
        s_tot = pc.values.numel()
        s_j = [sz * plan.block * plan.block for sz in sizes]
        dm, wm = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
        a_dense, aq_dense = op.todense().to(dtype), qop.todense().to(dtype)
        q_bytes = s_tot + 4 * qscales.numel()  # int8 codes and f32 row scales
        for b in batches:
            x = torch.randn((b, m), device=dev).to(dtype)
            dy = torch.randn((b, n), device=dev).to(dtype)
            w_flops = 2.0 * b * (sum(s_j[:-1]) + s_tot + sum(s_j[1:]))
            cases = {
                "chain_dgrad": (lambda: chain_dgrad(dy, pc.values, dm, plan=plan),
                                lambda: chain_dgrad_plain(dy, pc.values, dm, plan=plan),
                                lambda: torch.matmul(dy, a_dense.T), 2.0 * b * s_tot,
                                elt * (s_tot + b * (m + n))),
                "chain_wgrad": (lambda: chain_wgrad(x, dy, pc.values, wm, plan=plan),
                                lambda: chain_wgrad_plain(x, dy, pc.values, wm, plan=plan),
                                None, w_flops, elt * (s_tot + b * (m + n)) + 4 * s_tot),
                "chain_dgrad_q": (lambda: chain_dgrad(dy, q.values, dm, plan=plan, scales=qscales),
                                  lambda: chain_dgrad_plain(dy, q.values, dm, plan=plan, scales=qscales),
                                  lambda: torch.matmul(dy, aq_dense.T), 2.0 * b * s_tot,
                                  q_bytes + elt * b * (m + n)),
                "chain_wgrad_q": (lambda: chain_wgrad(x, dy, q.values, wm, plan=plan, scales=qscales),
                                  lambda: chain_wgrad_plain(x, dy, q.values, wm, plan=plan, scales=qscales),
                                  None, w_flops, q_bytes + elt * b * (m + n) + 4 * s_tot),
            }
            for name, (kern, plain, lib, flops, byts) in cases.items():
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"{name} {dname} B={b} disagrees with its plain version")
                t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
                row = {"phase": "time", "card": card_line, "kernel": name, "dtype": dname, "batch": b,
                       "quant": q.qscheme if name.endswith("_q") else None, "launches_per_apply": 1,
                       "max_abs_err": err, "rel_err": rel, "ms": time_ms(kern, iters=5),
                       "plain_ms": time_ms(plain, iters=5),
                       "library_ms": None if lib is None else time_ms(lib, iters=5),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)
    return rows


def measure_unembed(card_line: str, dev, b: int = 1024, dims=(2048, 2048, 256000)) -> list[dict]:
    """Phase 8, slice 3: K1, K2 and K3 at the shapes the trainer gives them:
    the ``--faust`` unembedding (2048 → 2048 → 256000, block 16, k 4, bf16)
    at B = 8·128 tokens, on random values of that layout, beside their
    bound, plain versions and, for K1/K2, one ``torch.matmul`` on the
    dense matrix."""
    import torch

    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )
    from repro_torch.kernels.ops import chain_meta

    blk = 16
    bf, g = _random_chain(dims, blk, 4, 5, dev)
    pc = pack_chain(bf).to(dtype=torch.bfloat16)
    plan, s_tot = pc.plan, pc.values.numel()
    m, n = dims[0], dims[-1]
    s_j = [(plan.offsets[j + 1] - plan.offsets[j]) * blk * blk for j in range(plan.n_factors)]
    x = torch.randn((b, m), generator=g).to(dev, torch.bfloat16)
    dy = torch.randn((b, n), generator=g).to(dev, torch.bfloat16)
    fm, dm, wm = chain_meta(plan, pc.in_idx), dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
    a_dense = bf.todense().to(torch.bfloat16)
    edge = 2 * (s_tot + b * (m + n))
    cases = {
        "chain_matmul": (lambda: chain_matmul(x, pc.values, fm, plan=plan),
                         lambda: chain_matmul_plain(x, pc.values, fm, plan=plan),
                         lambda: torch.matmul(x, a_dense), 2.0 * b * s_tot, edge),
        "chain_dgrad": (lambda: chain_dgrad(dy, pc.values, dm, plan=plan),
                        lambda: chain_dgrad_plain(dy, pc.values, dm, plan=plan),
                        lambda: torch.matmul(dy, a_dense.T), 2.0 * b * s_tot, edge),
        "chain_wgrad": (lambda: chain_wgrad(x, dy, pc.values, wm, plan=plan),
                        lambda: chain_wgrad_plain(x, dy, pc.values, wm, plan=plan), None,
                        2.0 * b * (sum(s_j[:-1]) + s_tot + sum(s_j[1:])), edge + 4 * s_tot),
    }
    rows = []
    for name, (kern, plain, lib, flops, byts) in cases.items():
        err, rel = rel_err(kern(), plain())
        require(rel <= TOL["bfloat16"], f"{name} at the unembedding's shape disagrees with its plain version")
        t_ops, t_bytes = flops / PEAK["bfloat16"], byts / HBM_BW
        row = {"phase": "time", "card": card_line, "kernel": name, "chain": f"unembedding {m}x{n} block 16 k 4",
               "dtype": "bfloat16", "batch": b, "launches_per_apply": 1, "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(kern, iters=3), "plain_ms": time_ms(plain, iters=3),
               "cold_ms": time_ms_cold(kern, iters=3) if name == "chain_matmul" else None,
               "library_ms": None if lib is None else time_ms(lib, iters=3),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops, "bytes": byts}
        log(row)
        rows.append(row)
    return rows


def _kernel_entry(name, source, replaces, launches, cases, checks, card_line, head) -> dict:
    first = next(r for r in cases if all(r.get(k) == v for k, v in head.items()))
    keys = ("chain", "quant", "dtype", "batch", "bt", "launches_per_apply", "max_abs_err", "ms", "cold_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "card": card_line,
        "launches": launches, "max_abs_err": first["max_abs_err"], "ms": first["ms"],
        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"], "headline": head,
        "check_max_rel_err": max(c["rel_err"] for c in checks if c["kernel"] == name),
        "cases": [{k: r[k] for k in keys if k in r} for r in cases],
    }


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
    launch_configs(info["card"])
    checks = check_kernels(dev) + check_quantized_kernel(dev) + check_chain_grid(dev)
    checks += check_backward_kernels(dev)
    op, launches, w_dev = main_path(dev)
    qops, qlaunches = quantized_path(op, w_dev)
    ops = {"float32": op, "int8:per_block": qops["int8:per_block"]}
    measured_dispatch(ops)
    _, train_counts = training_path(ops, info["card"])
    lm = train_lm(info["card"])
    rows, _ = measure(op, info["card"])
    rows += measure_quantized(qops, ops, info["card"])
    rows += measure_backward(op, qops["int8:per_block"], info["card"])
    rows += measure_unembed(info["card"], dev)

    src = "src/repro_torch/kernels/csrc/"
    f32_b128 = {"dtype": "float32", "batch": 128}
    kernels = [
        _kernel_entry("chain_matmul", src + "chain_matmul.cu", "src/repro/kernels/chain.py:125",
                      launches["chain_matmul"], [r for r in rows if r.get("kernel") == "chain_matmul"],
                      checks, info["card"], f32_b128),
        _kernel_entry("bsr_matmul", src + "bsr_matmul.cu", "src/repro/kernels/bsr_matmul.py:63",
                      launches["bsr_matmul"], [r for r in rows if r.get("kernel") == "bsr_matmul"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_matmul_q", src + "chain_matmul.cu",
                      "src/repro/kernels/chain.py:125", qlaunches["chain_matmul_q"],
                      [r for r in rows if r.get("kernel") == "chain_matmul_q"], checks, info["card"],
                      {"quant": "int8:per_block", **f32_b128}),
        # K2 and K3: launches in the trainer's run (phase 7); K5, the two
        # of them on codes: in the training applies (phase 6), the path
        # that trains a quantized chain
        _kernel_entry("chain_dgrad", src + "chain_dgrad.cu", "src/repro/kernels/chain_bwd.py:283",
                      lm["launches"]["chain_dgrad"], [r for r in rows if r.get("kernel") == "chain_dgrad"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_wgrad", src + "chain_wgrad.cu", "src/repro/kernels/chain_bwd.py:433",
                      lm["launches"]["chain_wgrad"], [r for r in rows if r.get("kernel") == "chain_wgrad"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_dgrad_q", src + "chain_dgrad.cu", "src/repro/kernels/chain_bwd.py:283",
                      train_counts["chain_dgrad_q"], [r for r in rows if r.get("kernel") == "chain_dgrad_q"],
                      checks, info["card"], {"quant": "int8:per_block", **f32_b128}),
        _kernel_entry("chain_wgrad_q", src + "chain_wgrad.cu", "src/repro/kernels/chain_bwd.py:433",
                      train_counts["chain_wgrad_q"], [r for r in rows if r.get("kernel") == "chain_wgrad_q"],
                      checks, info["card"], {"quant": "int8:per_block", **f32_b128}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
