#!/usr/bin/env python3
"""The host's time to enqueue one call of each kernel wrapper, alone.

    python3 host_probe.py [--rounds 7] [--calls 500]   # from the repository root, one card

Builds the kernels, then on a random chain of the gemma-2b up-projection's
shape (block 128, 2048 → 16384 in three factors, bf16, B = 128) times K1,
K2, K3, K5-wgrad (int8 per-block scales) and K6's three launches as
``dgrad_probe.py``'s ``host_us`` does (a host clock over ``--calls``
back-to-back calls, no synchronisation inside), ``--rounds`` times in
turn, and prints each wrapper's median and range in µs with the card's
``name, power.limit``.  The script uses the public wrappers only, so a
copy of it runs in another checkout of the repository, which is how two
trees are compared on one host: run them in turns, each several times.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import chip_smoke as cs
from dgrad_probe import host_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("host_probe: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.core.compress import BlockFaust, pack_chain, quantize_chain, random_block_factor, unpack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import FORWARD_BT, chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad, dgrad_meta, wgrad_meta
    from repro_torch.kernels.ops import chain_meta

    dev = torch.device("cuda", 0)
    card = cs.setup()["card"]
    gen = torch.Generator().manual_seed(0)
    dims, ks = cs.UP_PROJ[0], cs.UP_PROJ[2]
    pc = pack_chain(BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], 128, 128, ks[j], generator=gen, device=dev) for j in range(3)
    ), torch.ones((), device=dev)))
    plan, dtype = pc.plan, torch.bfloat16
    dm, fm, wm = dgrad_meta(plan, pc.in_idx), chain_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
    q = quantize_chain(pc, "int8", "per_block")
    x = torch.randn((128, dims[0]), device=dev).to(dtype)
    dy = torch.randn((128, dims[-1]), device=dev).to(dtype)
    v = pc.values.to(dtype)
    factors = unpack_chain(pc.to(dtype=dtype)).factors

    def k6():
        y = x
        for f in factors:
            y = bsr_matmul(y, f.values, f.in_idx)
        return y

    calls = {"chain_matmul": lambda: chain_matmul(x, v, fm, plan=plan, bt=FORWARD_BT),
             "chain_dgrad": lambda: chain_dgrad(dy, v, dm, plan=plan),
             "chain_wgrad": lambda: chain_wgrad(x, dy, v, wm, plan=plan),
             "chain_wgrad_q": lambda: chain_wgrad(x, dy, q.values, wm, plan=plan, scales=q.scales),
             "bsr_matmul_x3": k6}
    samples = {k: [] for k in calls}
    for _ in range(args.rounds):
        for k, fn in calls.items():
            samples[k].append(host_us(fn, args.calls))
    print(json.dumps({"phase": "host_us", "card": card, "dtype": "bfloat16", "batch": 128, "rounds": args.rounds,
                      "calls": args.calls, "median_us": {k: statistics.median(s) for k, s in samples.items()},
                      "min_us": {k: min(s) for k, s in samples.items()},
                      "max_us": {k: max(s) for k, s in samples.items()}}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
