"""Dry run: one rank's step of every (arch × shape cell × production mesh),
run on fake tensors.  Counterpart of :mod:`repro.launch.dryrun`.

The reference lowers and compiles each cell for 512 host devices and reads
XLA's memory and cost analyses.  The port runs the rank's own step
(``launch/steps.py``: the trainer's step, or a prefill or decode step as
the serving executor runs it) under a ``FakeTensorMode`` on a fake
process group of the mesh's size (``launch/mesh.py`` ``abstract_rank``):
every operator runs on shapes alone and every collective returns at once,
so a 784 G-parameter model's rank takes seconds on a CPU-only host and no
card.  :class:`~repro_torch.launch.step_cost.StepCost` counts the step.
The kernels run as their operators' fake implementations
(``kernels/library.py``), priced as on the card; ``auto`` dispatch of a
FAµST layer is priced by the cost model alone (``REPRO_AUTOTUNE=off``
while the step runs): nothing is timed.

Each record, in ``build/dryrun/<arch>__<cell>__<mesh>[__variant].json``:

* ``n_devices``, ``rank``, ``dtype``, ``trace_s`` (the seconds the fake
  step took, in place of the reference's ``lower_s``/``compile_s``);
* ``memory``: the rank's argument bytes, exact from its blocks (parameters,
  AdamW's moments, the batch it holds, its slot pool), the peak of live
  bytes over the step, and whether the peak fits one card
  (``CARD_BYTES``);
* ``cost``: flops, bytes, matmul flops and the kernels' flops by kernel;
  ``launches`` of K1–K6; ``collectives`` (:func:`~repro_torch.launch.
  roofline.collective_stats`).  A prefill cell of B prompts is B one-row
  prefills (the executor's), so its counts are one prefill's × B
  (``repeats``).

Usage (no card needed)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch X] [--cell Y] \\
        [--mesh single|multi|both] [--variant faust] [--rank R] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, cells_for
from repro_torch.launch import roofline
from repro_torch.launch.mesh import abstract_rank, production_shape, release
from repro_torch.launch.specs import batch_specs
from repro_torch.launch.step_cost import StepCost
from repro_torch.launch.steps import (
    abstract_train_state,
    decode_pool,
    make_sharded_decode,
    make_sharded_prefill,
    make_sharded_train_step,
    sharded_model,
)
from repro_torch.optim.adamw import AdamWConfig

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD_BYTES = 80 * 10**9  # one H100's device memory (80 GB)


def apply_variant(cfg: ArchConfig, variant: str | None) -> ArchConfig:
    """The reference's config variants: ``faust`` (a FAµST unembedding, k
    8, and FFN projections, k 4, blocks of 128, J = 2, untied),
    ``faust_unembed`` (the unembedding alone), ``remat_attn`` (attention
    chunks of 1024)."""
    from repro_torch.layers.faust_linear import FaustSpec

    if not variant:
        return cfg
    if variant == "faust":
        return dataclasses.replace(
            cfg,
            faust_unembed=FaustSpec(n_factors=2, block=128, k=8),
            faust_mlp=FaustSpec(n_factors=2, block=128, k=4) if cfg.d_ff else None,
            tie_embeddings=False,
        )
    if variant == "faust_unembed":
        return dataclasses.replace(cfg, faust_unembed=FaustSpec(n_factors=2, block=128, k=8), tie_embeddings=False)
    if variant == "remat_attn":
        return dataclasses.replace(cfg, attn_chunk=1024)
    raise ValueError(variant)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def model_priced():
    """``auto`` FAµST dispatch by the cost model alone: nothing is timed."""
    prev = os.environ.get("REPRO_AUTOTUNE")
    os.environ["REPRO_AUTOTUNE"] = "off"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["REPRO_AUTOTUNE"]
        else:
            os.environ["REPRO_AUTOTUNE"] = prev


def dry_run(cfg: ArchConfig, cell: ShapeCell, mesh, *, fake: bool = True, prepare=None) -> dict:
    """One rank's step of ``cell`` on ``mesh`` (this process's rank of it),
    counted: the record's ``memory``, ``cost``, ``launches``,
    ``collectives`` and ``trace_s`` (module docstring).  ``fake=False``
    runs it on real tensors (tests hold the two equal).  Fake or real, the
    tensors lie on the CPU: fake tensors take the card's path
    (``kernels/ops.py`` ``on_card``).
    ``prepare(model)``, where given, runs on the sharded model before the
    step (a caller's setting, such as a layer's forced backend)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    device = "cpu"
    t0 = time.monotonic()
    with mode, model_priced():
        repeats = 1
        if cell.kind == "train":
            model, opt = abstract_train_state(cfg, mesh, device)
            if prepare is not None:
                prepare(model)
            step = make_sharded_train_step(model, AdamWConfig(), mesh)
            batch = batch_specs(cfg, cell, device)
            held = {"params": _bytes(model.parameters()) + _bytes(model.buffers()),
                    "optimizer": _bytes([*opt.mu.values(), *opt.nu.values(), opt.step]),
                    "batch": _bytes(batch.values())}
            run = lambda: step(batch, opt)  # noqa: E731
        else:
            model = sharded_model(cfg, mesh, device)
            if prepare is not None:
                prepare(model)
            pool = decode_pool(model, mesh, cell, device)
            held = {"params": _bytes(model.parameters()) + _bytes(model.buffers()),
                    "pool": _bytes(t for c in pool for t in c)}
            if cell.kind == "prefill":
                batch = batch_specs(cfg, cell, device, batch=1)
                step, repeats = make_sharded_prefill(model, mesh, cell), cell.global_batch
                run = lambda: step(batch)  # noqa: E731
            else:
                tokens = batch_specs(cfg, cell, device, batch=pool[0].pos.shape[0])["tokens"]
                step = make_sharded_decode(model, mesh, cell)
                run = lambda: step(tokens, pool)  # noqa: E731
                batch = {"tokens": tokens}
            held["batch"] = _bytes(batch.values())
        args = sum(held.values())
        with StepCost(base_bytes=args) as sc:
            run()
    counted = sc.record()
    cost = {k: (v * repeats if isinstance(v, float) else {n: f * repeats for n, f in v.items()})
            for k, v in counted["cost"].items()}
    coll = counted["counted"]
    coll = {"by_op": {k: v * repeats for k, v in coll["by_op"].items()},
            "count": {k: v * repeats for k, v in coll["count"].items()},
            "by_purpose": {k: {n: v * repeats for n, v in d.items()} for k, d in coll["by_purpose"].items()}}
    peak = counted["peak_live_bytes"]
    return {
        "n_devices": mesh.size,
        "rank": mesh.rank,
        "dtype": cfg.dtype,
        "repeats": repeats,
        "memory": {"argument_bytes": args, "held": held, "peak_bytes": peak, "fits_card": peak <= CARD_BYTES,
                   "card_bytes": CARD_BYTES},
        "cost": cost,
        "launches": {k: v * repeats for k, v in counted["launches"].items()},
        "collectives": roofline.collective_stats(coll),
        "trace_s": round(time.monotonic() - t0, 3),
    }


def run_cell(arch: str, cell_name: str, multi_pod: bool, variant: str | None = None, rank: int = 0) -> dict:
    """The dry run of one cell on rank ``rank`` of a production mesh."""
    cfg = apply_variant(get_config(arch), variant)
    shape, names = production_shape(multi_pod)
    mesh = abstract_rank(shape, names, rank)
    try:
        rec = dry_run(cfg, SHAPES[cell_name], mesh)
    finally:
        release()
    return {"arch": cfg.name, "arch_id": arch, "cell": cell_name, "mesh": "x".join(map(str, shape)),
            "variant": variant, **rec}


def result_path(arch: str, cell: str, multi_pod: bool, variant: str | None = None) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    return str(RESULTS_DIR / f"{arch}__{cell}__{mesh}{suffix}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    t_all = time.monotonic()
    for arch in archs:
        cfg = get_config(arch)
        cells = [args.cell] if args.cell else cells_for(cfg)
        for cell in cells:
            for multi_pod in meshes:
                path = result_path(arch, cell, multi_pod, args.variant)
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {path}")
                    continue
                tag = f"{arch} × {cell} × {'multi' if multi_pod else 'single'}"
                if args.variant:
                    tag += f" × {args.variant}"
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, cell, multi_pod, args.variant, args.rank)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[ok] {tag}: {rec['trace_s']}s flops={rec['cost']['flops']:.3e} "
                          f"peak={rec['memory']['peak_bytes'] / 1e9:.2f} GB", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                    traceback.print_exc()
    print(f"\n{time.monotonic() - t_all:.1f}s in all")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("all dry-run cells ran")


if __name__ == "__main__":
    main()
