"""The roofline table of the dry run's records.  Counterpart of
:mod:`repro.launch.report`.

Usage: ``PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16]``
reads ``build/dryrun/*__<mesh>.json`` (``launch/dryrun.py``), writes
``build/roofline.md`` and prints the three hillclimb candidates (worst
useful-flops ratio, most collective-bound, most FAµST-representative).
Every term is a rank's seconds at the constants of
:func:`repro_torch.launch.roofline.roofline_constants` (the H100 data
sheet's, or a calibration's), named in the table's header: a model of the
card, not a measurement.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, active_param_count
from repro_torch.launch.dryrun import RESULTS_DIR, apply_variant
from repro_torch.launch.roofline import roofline_constants, roofline_terms


def model_flops(arch: str, cell_name: str, variant: str | None = None) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (train), 2·N·tokens (prefill, decode:
    one token a sequence), N the active parameters (a MoE arch's top-k and
    shared experts)."""
    cfg = apply_variant(get_config(arch), variant)
    n_act = active_param_count(cfg)
    cell = SHAPES[cell_name]
    if cell.kind == "train":
        return 6.0 * n_act * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.global_batch * cell.seq_len
    return 2.0 * n_act * cell.global_batch


def load_records(mesh: str, results_dir=RESULTS_DIR) -> list[dict]:
    """The mesh's records (variants included), each with ``_arch_id``."""
    recs = []
    for path in sorted(glob.glob(os.path.join(str(results_dir), f"*__{mesh}*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
        recs[-1]["_arch_id"] = os.path.basename(path).split("__")[0]
    return recs


def analyze(rec: dict, consts: dict | None = None) -> dict:
    """A record's roofline terms (:func:`roofline_terms`), its model flops,
    the useful-flops ratio (model flops over the flops of every rank, each
    counted as this one) and the rank's peak bytes."""
    terms = roofline_terms(rec, consts)
    mf = model_flops(rec["_arch_id"], rec["cell"], rec.get("variant"))
    flops = rec["cost"]["flops"]
    return {
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        "dominant": terms["dominant"].removesuffix("_s"),
        "roofline_fraction": terms["roofline_fraction"],
        "model_flops": mf,
        "useful_flops_ratio": mf / (flops * rec["n_devices"]) if flops else 0.0,
        "mem_bytes_per_dev": rec["memory"]["peak_bytes"],
        "fits": rec["memory"]["fits_card"],
    }


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def table(recs: list[dict], mesh: str) -> tuple[str, list]:
    consts, source = roofline_constants()
    rows = [(rec, analyze(rec, consts)) for rec in recs]
    lines = [
        f"## Roofline table — mesh {mesh}, one rank's step "
        f"(H100 SXM: {consts['peak_flops']/1e12:.0f} TF/s bf16, {consts['peak_flops_f32']/1e12:.0f} TF/s f32, "
        f"{consts['hbm_bw']/1e12:.2f} TB/s HBM, {consts['link_bw']/1e9:.0f} GB/s link; {source})",
        "",
        "| arch | cell | compute | memory | collective | dominant | frac | MODEL_FLOPS/counted | peak GB/rank | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec, a in rows:
        cell = rec["cell"] + (f" ({rec['variant']})" if rec.get("variant") else "")
        lines.append(
            f"| {rec['_arch_id']} | {cell} | {fmt_s(a['compute_s'])} | {fmt_s(a['memory_s'])} | "
            f"{fmt_s(a['collective_s'])} | {a['dominant']} | {a['roofline_fraction']:.2f} | "
            f"{a['useful_flops_ratio']:.3f} | {a['mem_bytes_per_dev']/1e9:.2f} | {'yes' if a['fits'] else 'no'} |"
        )
    return "\n".join(lines) + "\n", rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the roofline table of the dry run's records")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=str(RESULTS_DIR.parent / "roofline.md"))
    args = ap.parse_args(argv)

    recs = load_records(args.mesh)
    if not recs:
        raise SystemExit(f"no dry-run records for mesh {args.mesh} in {RESULTS_DIR}: run launch.dryrun first")
    out, rows = table(recs, args.mesh)
    with open(args.out, "w") as f:
        f.write(out)
    print(out)

    # hillclimb candidates
    worst = min(rows, key=lambda ra: ra[1]["useful_flops_ratio"] or 9e9)
    coll_bound = max(rows, key=lambda ra: ra[1]["collective_s"] / max(sum(
        (ra[1]["compute_s"], ra[1]["memory_s"], ra[1]["collective_s"])), 1e-12))
    print("\n# hillclimb candidates")
    print("worst useful-flops ratio:", worst[0]["_arch_id"], worst[0]["cell"], worst[1]["useful_flops_ratio"])
    print("most collective-bound:", coll_bound[0]["_arch_id"], coll_bound[0]["cell"],
          fmt_s(coll_bound[1]["collective_s"]))
    print("FAµST-representative: gemma3_27b decode/train (262k-vocab unembed)")


if __name__ == "__main__":
    main()
