"""Roofline constants of one NVIDIA H100 SXM, for the dispatch cost model.
Counterpart of ``load_roofline``/``roofline_constants`` in
:mod:`repro.launch.roofline`; the port prices with its own card's numbers.

* ``peak_flops`` 989e12 FLOP/s: dense bf16 tensor-core peak, and
  ``hbm_bw`` 3.35e12 B/s, ``link_bw`` 450e9 B/s (NVLink, each way): NVIDIA's
  H100 SXM data sheet.  Like the reference, f32 applies are priced at the
  bf16 peak.
* ``t_launch_us``: per-launch overhead, measured by ``chip_smoke.py``:
  CUDA events over 1000 back-to-back launches of an empty kernel through
  the same ctypes path the kernel wrappers use.  Four runs on an NVIDIA
  H100 80GB HBM3 at a 700 W power limit read 29.83, 19.52, 13.20 and
  11.20 µs; the constant is their median.  The spread (2.7×) is host
  time (Python and ctypes calls), not the card's own launch latency.
"""
from __future__ import annotations

_BUILTIN = {
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "t_launch_us": 16.36,
}
_SOURCE = "builtin:h100-sxm-datasheet;t_launch_us=chip_smoke.py"


def load_roofline() -> tuple[dict, str]:
    """(constants, source label)."""
    return dict(_BUILTIN), _SOURCE


def roofline_constants() -> tuple[dict, str]:
    """The accessor the dispatch cost model reads on every decision."""
    return load_roofline()
