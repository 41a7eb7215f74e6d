#!/usr/bin/env python3
"""Phase 16 (c)-(e) of ``chip_smoke.py`` at two depths in one run: mamba2
and zamba2 served at full depth (64 and 81 layers) and at the depths
``chip_smoke.py`` serves them (``MAMBA2_SERVE_LAYERS``,
``ZAMBA2_SERVE_LAYERS``), with every check of the phase, printing each
run's seconds.

    python3 ssm_serve_probe.py [--order full,cut]   # from the repository root, one card

Prints one JSON object per line, the card's ``name, power.limit`` among
them; the ``ssm_serving`` rows carry the layers and the seconds.
"""
from __future__ import annotations

import argparse
import sys

import chip_smoke as cs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_serve_probe: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="full,cut")
    args = ap.parse_args()
    sys.path.insert(0, str(cs.ROOT / "src"))
    dev = torch.device("cuda", 0)
    info = cs.setup()
    depths = {"full": (None, None), "cut": (cs.MAMBA2_SERVE_LAYERS, cs.ZAMBA2_SERVE_LAYERS)}
    with cs._fresh_tables("chip_smoke_ssm_autotune"):
        for name in args.order.split(","):
            cs.ssm_serving(info["card"], dev, *depths[name])
            cs._free()
    print(info["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
