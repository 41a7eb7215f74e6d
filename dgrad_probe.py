#!/usr/bin/env python3
"""A short card run of the chain dgrad (K2, K5-dgrad) alone: the data
behind its schedule's constants, and the host cost of every wrapper.

    python3 dgrad_probe.py         # from the repository root, one card

Builds the kernels, holds K2 and K5-dgrad to their plain versions on
``chip_smoke.py``'s grid (``check_dgrad_grid``: blocks 8 to 128, J up to
6, B ∈ {1, 37, 4096}, every code type, skewed and unread chains, repeats
bitwise equal), then times with CUDA events on random chains of the
shapes the main path gives the dgrad:

* the gemma-2b up-projection (block 128, 16x6 / 16x4 / 128x4 out blocks x
  slots) at B = 128 and 4096, f32 and bf16: K1 at ``FORWARD_BT`` beside
  K2 and K5-dgrad (int8 per-block) at every tile, with the dgrad's
  reader-list chunks per factor (the ``DGRAD_BT`` sweep);
* K2 at B = 128 with ``CHUNK_READERS`` 8, 4 and 2 (the split's rule);
* the host's time to enqueue one call of K1, K2, K3 and K5-wgrad (int8
  per-block scales) and of K6's three launches (bf16, B = 128; a host
  clock over 300 calls, no synchronisation inside): where it nears the
  kernel's time, back-to-back calls are paced by the host;
* K2 at the trainer's FAµST unembedding (2048 → 2048 → 256000, block 16,
  k 4, bf16, B = 1024) at every tile.

Prints one JSON object per line, the card's ``name, power.limit`` among
them.  Faster than ``chip_smoke.py`` (about a minute) for work on the
dgrad's schedule; ``chip_smoke.py`` remains the full check.
"""
from __future__ import annotations

import sys
import time

import chip_smoke as cs


def host_us(fn, calls: int = 300) -> float:
    """Mean host time to enqueue one call of ``fn``, in microseconds."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dgrad_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.core.compress import (
        BlockFaust,
        expand_scales,
        pack_chain,
        quantize_chain,
        random_block_factor,
        unpack_chain,
    )
    from repro_torch.kernels import chain_bwd
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import FORWARD_BT, SUPPORTED_BT, chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad, dgrad_meta, dgrad_schedule, launch_config, wgrad_meta
    from repro_torch.kernels.ops import chain_meta

    dev = torch.device("cuda", 0)
    info = cs.setup()
    card = info["card"]
    rows = cs.check_dgrad_grid(dev)
    cs.log({"phase": "dgrad_checks", "card": card, "n": len(rows),
            "max_rel_err": {d: max(r["rel_err"] for r in rows if r["dtype"] == d) for d in cs.TOL}})

    gen = torch.Generator().manual_seed(0)
    dims, ks = cs.UP_PROJ[0], cs.UP_PROJ[2]
    pc = pack_chain(BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], 128, 128, ks[j], generator=gen, device=dev) for j in range(3)
    ), torch.ones((), device=dev)))
    plan = pc.plan
    dm, fm, wm = dgrad_meta(plan, pc.in_idx), chain_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
    q = quantize_chain(pc, "int8", "per_block")
    qs = expand_scales(q.scales, 128).contiguous()
    for b in (128, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            dy = torch.randn((b, dims[-1]), device=dev).to(dtype)
            x = torch.randn((b, dims[0]), device=dev).to(dtype)
            v = pc.values.to(dtype)
            row = {"phase": "dgrad_tiles", "card": card, "chain": "up-projection", "dtype": str(dtype), "batch": b,
                   "chain_matmul_ms": cs.time_ms(lambda: chain_matmul(x, v, fm, plan=plan, bt=FORWARD_BT))}
            for bt in SUPPORTED_BT:
                ctas = launch_config(dtype, 128, bt)["ctas"]
                row[f"bt{bt}"] = {
                    "chain_dgrad_ms": cs.time_ms(lambda: chain_dgrad(dy, v, dm, plan=plan, bt=bt)),
                    "chain_dgrad_q_ms": cs.time_ms(lambda: chain_dgrad(dy, q.values, dm, plan=plan, bt=bt, scales=qs)),
                    "chunks": [f[3] for f in dgrad_schedule(plan, b, bt, ctas).factors]}
            if b == 128 and dtype == torch.bfloat16:
                factors = unpack_chain(pc.to(dtype=dtype)).factors

                def k6():
                    y = x
                    for f in factors:
                        y = bsr_matmul(y, f.values, f.in_idx)
                    return y

                row["host_us"] = {"chain_matmul": host_us(lambda: chain_matmul(x, v, fm, plan=plan, bt=FORWARD_BT)),
                                  "chain_dgrad": host_us(lambda: chain_dgrad(dy, v, dm, plan=plan)),
                                  "chain_wgrad": host_us(lambda: chain_wgrad(x, dy, v, wm, plan=plan)),
                                  "chain_wgrad_q": host_us(
                                      lambda: chain_wgrad(x, dy, q.values, wm, plan=plan, scales=q.scales)),
                                  "bsr_matmul_x3": host_us(k6)}
            cs.log(row)

    default = chain_bwd.CHUNK_READERS
    try:
        for readers in (8, 4, 2):
            chain_bwd.CHUNK_READERS = readers
            dgrad_schedule.cache_clear()
            for dtype in (torch.float32, torch.bfloat16):
                dy = torch.randn((128, dims[-1]), device=dev).to(dtype)
                v = pc.values.to(dtype)
                cs.log({"phase": "dgrad_chunk_readers", "card": card, "chunk_readers": readers, "dtype": str(dtype),
                        "batch": 128, **{f"bt{bt}_ms": cs.time_ms(lambda: chain_dgrad(dy, v, dm, plan=plan, bt=bt))
                                         for bt in SUPPORTED_BT}})
    finally:
        chain_bwd.CHUNK_READERS = default
        dgrad_schedule.cache_clear()

    bf, g = cs._random_chain(cs.UNEMBED[0], 16, 4, 5, dev)
    pu = pack_chain(bf).to(dtype=torch.bfloat16)
    du = dgrad_meta(pu.plan, pu.in_idx)
    dy = torch.randn((1024, cs.UNEMBED[0][-1]), generator=g).to(dev, torch.bfloat16)
    cs.log({"phase": "dgrad_tiles", "card": card, "chain": "unembedding", "dtype": "torch.bfloat16", "batch": 1024,
            **{f"bt{bt}": {"chain_dgrad_ms": cs.time_ms(lambda: chain_dgrad(dy, pu.values, du, plan=pu.plan, bt=bt),
                                                        iters=5)} for bt in SUPPORTED_BT}})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
