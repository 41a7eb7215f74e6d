"""Measure the card's roofline constants and cache them for dispatch.
Counterpart of ``scripts/calibrate_roofline.py``.

    python -m repro_torch.launch.calibrate [--out PATH]
    python -m repro_torch.launch.calibrate --autotune [--cases "1024,4096,2,4,128"] \\
        [--batch 128] [--no-grad] [--device cpu]

The dispatch cost model (:mod:`repro_torch.api.dispatch`) prices backends
with :func:`repro_torch.launch.roofline.roofline_constants`: the H100 SXM
data sheet's numbers, unless a calibration cache holds measured ones.
This measures, on the CUDA card (it refuses the CPU: a CPU rate is no
device constant):

* ``peak_flops``: 2n³ over the median time of a bf16 ``torch.matmul`` of
  two n × n matrices;
* ``peak_flops_f32``: the same in f32 with TF32 off (the rate an f32
  apply runs at);
* ``hbm_bw``: bytes read and written over the median time of a device
  copy of a 1 GiB buffer;
* ``t_launch_us``: CUDA events over back-to-back launches of an empty
  kernel through the ctypes path the kernel wrappers use;
* ``link_bw``: one card has no link to time; the builtin value is written
  and marked so;

and writes them to the cache (``build/roofline.json``, or
``REPRO_TORCH_ROOFLINE``, or ``--out``), effective for this process at
once.  ``--autotune`` instead fills the measured dispatch table
(:mod:`repro_torch.api.autotune`) over ``BENCH_CASES`` (the reference's
``benchmarks/apply_speed.py`` shapes), forward and grad keys, at
``--batch``; existing entries are kept.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch.launch import roofline

# (in, out, J, k, block): the reference's benchmark shapes
BENCH_CASES = (
    (1024, 4096, 2, 4, 128),
    (2048, 8192, 2, 4, 128),
    (2048, 8192, 3, 4, 128),
)


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"roofline constants are the card's: calibrate on a CUDA device, not {dev}")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def _median_ms(fn, n_warmup: int = 3, n_iter: int = 10) -> float:
    """Median of ``n_iter`` CUDA-event timings of one call each."""
    for _ in range(n_warmup):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(n_iter):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in spans)


def measure_peak_flops(dtype: torch.dtype = torch.bfloat16, n: int = 8192, device="cuda") -> float:
    """FLOP/s of an n × n × n ``torch.matmul`` in ``dtype`` (TF32 off)."""
    dev = _card(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev).to(dtype)
    b = torch.randn((n, n), generator=g, device=dev).to(dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = _median_ms(lambda: torch.matmul(a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return 2.0 * n**3 / (ms * 1e-3)


def measure_hbm_bw(nbytes: int = 1 << 30, device="cuda") -> float:
    """Bytes/s of a device copy: each byte read once and written once."""
    dev = _card(device)
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev).fill_(1)
    dst = torch.empty_like(src)
    ms = _median_ms(lambda: dst.copy_(src))
    return 2.0 * nbytes / (ms * 1e-3)


def measure_t_launch_us(iters: int = 1000, device="cuda") -> float:
    """µs a launch of an empty kernel (``bsr_matmul.launch_noop``, the
    kernel wrappers' ctypes path): CUDA events around ``iters`` launches
    back to back, after three."""
    from repro_torch.kernels.bsr_matmul import launch_noop

    dev = _card(device)
    with torch.cuda.device(dev):
        for _ in range(3):
            launch_noop()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            launch_noop()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters * 1e3


def calibrate(device="cuda") -> dict:
    """The measured constants, ``link_bw`` builtin, and where they came from."""
    dev = _card(device)
    return {
        "peak_flops": measure_peak_flops(torch.bfloat16, device=dev),
        "peak_flops_f32": measure_peak_flops(torch.float32, device=dev),
        "hbm_bw": measure_hbm_bw(device=dev),
        "t_launch_us": measure_t_launch_us(device=dev),
        "link_bw": roofline._BUILTIN["link_bw"],
        "meta": {
            "device": torch.cuda.get_device_name(dev),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "link_bw_source": "builtin (one card: no link to time)",
        },
    }


def write(record: dict, out: str | None = None) -> str:
    """Write ``record`` to ``out`` (default: the cache path) and make it
    the constants of this process; returns the path."""
    out = out or roofline.roofline_cache_path()
    if out.lower() in roofline._OFF:
        raise ValueError(f"refusing to write to the sentinel path {out!r}; pass --out")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    roofline.reload()
    return out


def parse_cases(spec: str | None) -> tuple:
    """``"in,out,J,k,block;..."`` as 5-tuples (default ``BENCH_CASES``)."""
    if not spec:
        return BENCH_CASES
    cases = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        vals = tuple(int(t) for t in part.split(","))
        if len(vals) != 5:
            raise ValueError(f"--cases entries are 'in,out,J,k,block' 5-tuples; got {part!r}")
        cases.append(vals)
    return tuple(cases)


def autotune_table(cases, batch: int, grad: bool = True, device=None) -> list[dict]:
    """Measure every (case × fwd/grad) key into the autotune table
    (existing entries are kept); returns one row per key."""
    from repro_torch.api import FaustOp, autotune
    from repro_torch.core.compress import BlockFaust, random_block_factor
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    rows = []
    for in_dim, out_dim, n_factors, k, block in cases:
        g = torch.Generator().manual_seed(0)
        dims = [in_dim] + [min(in_dim, out_dim)] * (n_factors - 1) + [out_dim]
        factors = tuple(random_block_factor(dims[i], dims[i + 1], block, block, k, generator=g, device=dev)
                        for i in range(n_factors))
        op = FaustOp(BlockFaust(factors, torch.ones((), device=dev)))
        x = torch.randn((batch, in_dim), generator=g).to(dev)
        for gr in ((False, True) if grad else (False,)):
            entry = autotune.ensure_measured(op, x, batch=batch, dtype=x.dtype, grad=gr,
                                             use_kernel=dev.type == "cuda")
            rows.append({"case": [in_dim, out_dim, n_factors, k, block], "batch": batch,
                         "kind": "grad" if gr else "fwd", "best": entry["best"], "bt": entry.get("bt"),
                         "us": entry["us"]})
    autotune.reload()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.calibrate", description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="cache path (default: REPRO_TORCH_ROOFLINE or build/roofline.json)")
    ap.add_argument("--autotune", action="store_true", help="fill the measured dispatch table instead")
    ap.add_argument("--cases", default=None, help="autotune shapes: ';'-separated 'in,out,J,k,block'")
    ap.add_argument("--batch", type=int, default=128, help="autotune apply batch")
    ap.add_argument("--no-grad", action="store_true", help="autotune forward keys only")
    ap.add_argument("--device", default=None, help="autotune device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.autotune:
        from repro_torch.api import autotune

        print(f"autotune table: {autotune.table_path()}")
        for row in autotune_table(parse_cases(args.cases), args.batch, not args.no_grad, args.device):
            print(json.dumps(row))
        return 0
    record = calibrate()
    out = write(record, args.out)
    print(f"wrote {out}")
    for k in ("peak_flops", "peak_flops_f32", "hbm_bw", "link_bw", "t_launch_us"):
        tag = " (builtin)" if k == "link_bw" else ""
        print(f"  {k:14s} = {record[k]:.4g}{tag}  (builtin {roofline._BUILTIN[k]:.4g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
