"""Roofline constants of one NVIDIA H100 SXM, for the dispatch cost model
and the dry run's report.  Counterpart of ``load_roofline``/
``roofline_constants``/``reload``, ``collective_stats`` and
``roofline_terms`` in :mod:`repro.launch.roofline`; the port prices with
its own card's numbers.  The reference's HLO text parsers have no input
in eager PyTorch: :mod:`repro_torch.launch.step_cost` counts a step as it
runs instead.

Builtin constants:

* ``peak_flops`` 989e12 FLOP/s: dense bf16 tensor-core peak;
  ``peak_flops_f32`` 67e12 FLOP/s: f32 outside the tensor cores (FFMA),
  the rate an f32 apply runs at (TF32 stays off); ``hbm_bw`` 3.35e12 B/s,
  ``link_bw`` 450e9 B/s (NVLink, each way): NVIDIA's H100 SXM data sheet.
  The reference prices every dtype at one peak; the port prices f32 at
  its own.
* ``t_launch_us``: per-launch overhead, measured by ``chip_smoke.py``:
  CUDA events over 1000 back-to-back launches of an empty kernel through
  the same ctypes path the kernel wrappers use.  Four runs on an NVIDIA
  H100 80GB HBM3 at a 700 W power limit read 29.83, 19.52, 13.20 and
  11.20 µs; the constant is their median.  The spread (2.7×) is host
  time (Python and ctypes calls), not the card's own launch latency.

Measured constants: ``python -m repro_torch.launch.calibrate`` writes them
to the calibration cache, ``build/roofline.json`` at the repository root
(inside the checkout: a cache that outlived it would change a later run's
dispatch without notice) or the path in ``REPRO_TORCH_ROOFLINE``, where
``builtin`` or ``off`` (or ``0``, or empty) mean the builtin constants.
Each key of the cache is taken where it is a finite positive number and falls
back to its builtin value otherwise, so a partial cache contributes what
it measured.  :func:`roofline_constants` re-reads the cache when its path
changes, or its mtime, which it checks at most every ``RECHECK_S`` seconds
(every apply prices with these constants, and a stat per apply is a system
call on the serving path); :func:`reload` reads it at once.
``DispatchReport.roofline`` names the source that priced a decision.
"""
from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path

_BUILTIN = {
    "peak_flops": 989e12,
    "peak_flops_f32": 67e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "t_launch_us": 16.36,
}
BUILTIN_SOURCE = "builtin:h100-sxm-datasheet;t_launch_us=chip_smoke.py"
DEFAULT_CACHE = Path(__file__).resolve().parents[3] / "build" / "roofline.json"
_OFF = ("", "0", "builtin", "off")
RECHECK_S = 1.0  # seconds between checks of the cache's mtime


def roofline_cache_path() -> str:
    """Where the calibration lives: ``REPRO_TORCH_ROOFLINE`` or
    ``build/roofline.json`` at the repository root."""
    return os.environ.get("REPRO_TORCH_ROOFLINE", str(DEFAULT_CACHE))


def load_roofline() -> tuple[dict, str]:
    """(constants, source label): the cache's valid keys over the builtin
    constants, or the builtin constants alone."""
    path = roofline_cache_path()
    if path.lower() in _OFF:
        return dict(_BUILTIN), BUILTIN_SOURCE
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return dict(_BUILTIN), BUILTIN_SOURCE
    if not isinstance(data, dict):
        return dict(_BUILTIN), BUILTIN_SOURCE
    measured = {k: float(data[k]) for k in _BUILTIN
                if isinstance(data.get(k), (int, float)) and not isinstance(data[k], bool) and 0 < data[k] < math.inf}
    if not measured:
        return dict(_BUILTIN), BUILTIN_SOURCE
    return {**_BUILTIN, **measured}, f"measured:{path}"


# (path, mtime_ns) of the last load, what it gave, and when it was checked
_STATE: dict = {"stamp": None, "values": None, "source": None, "checked": float("-inf")}


def _stamp() -> tuple:
    path = roofline_cache_path()
    if path.lower() in _OFF:
        return (path, None)
    try:
        return (path, os.stat(path).st_mtime_ns)
    except OSError:
        return (path, None)


def roofline_constants() -> tuple[dict, str]:
    """The accessor the dispatch cost model reads on every decision:
    (constants, source), re-read when the cache's path changes or, checked
    at most every ``RECHECK_S``, its mtime."""
    now = time.monotonic()
    fresh = _STATE["stamp"] is not None and _STATE["stamp"][0] == roofline_cache_path()
    if not (fresh and now - _STATE["checked"] < RECHECK_S):
        _STATE["checked"] = now
        stamp = _stamp()
        if _STATE["stamp"] != stamp:
            _STATE["values"], _STATE["source"] = load_roofline()
            _STATE["stamp"] = stamp
    return dict(_STATE["values"]), _STATE["source"]


def reload() -> tuple[dict, str]:
    """Drop the cached constants and read the cache now."""
    _STATE["stamp"] = None
    return roofline_constants()


# ---------------------------------------------------------------------------
# A dry-run record's collectives and roofline terms (launch/dryrun.py)
# ---------------------------------------------------------------------------

COLLECTIVE_OPS = ("all-gather", "reduce-scatter", "all-reduce")


def collective_stats(counted: dict) -> dict:
    """The collectives of a rank's step in the reference's form,
    ``{"total_bytes", "by_op", "count"}``, from what
    :class:`~repro_torch.launch.step_cost.StepCost` counted (its
    ``record()["counted"]``): the bytes of each call's result on the rank
    by operator, and ``by_purpose``, the model's own count
    (``distributed/layout.py``: calls and bytes by purpose).  Where the
    reference parses them out of the partitioned HLO, the port counts the
    calls as they run."""
    by_op = dict.fromkeys(COLLECTIVE_OPS, 0)
    for k, v in counted.get("by_op", {}).items():
        by_op[k] = by_op.get(k, 0) + int(v)
    return {
        "total_bytes": int(sum(by_op.values())),
        "by_op": by_op,
        "count": int(sum(counted.get("count", {}).values())),
        "by_purpose": counted.get("by_purpose", {}),
    }


def roofline_terms(record: dict, consts: dict | None = None) -> dict:
    """The three terms of a dry-run record, a rank's seconds at the card's
    peaks (:func:`roofline_constants` unless ``consts`` is given):

        compute    = flops / peak (bf16 tensor cores; f32 FFMA for an f32 model)
        memory     = bytes / HBM bandwidth
        collective = collective bytes / link bandwidth (NVLink, each way)

    with the dominant one, the bound (the largest) and the roofline
    fraction (the dominant term over their sum: an overlap-optimistic
    model), as the reference's ``roofline_terms``."""
    if consts is None:
        consts, _ = roofline_constants()
    peak = consts["peak_flops"]
    if record.get("dtype") == "float32":
        peak = consts.get("peak_flops_f32", peak)
    terms = {
        "compute_s": record["cost"]["flops"] / peak,
        "memory_s": record["cost"]["bytes"] / consts["hbm_bw"],
        "collective_s": record["collectives"]["total_bytes"] / consts["link_bw"],
    }
    dominant = max(terms, key=lambda k: terms[k])
    bound, total = max(terms.values()), sum(terms.values())
    return {**terms, "dominant": dominant, "bound_s": bound, "roofline_fraction": bound / total if total else 0.0}
