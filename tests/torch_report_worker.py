"""The rank program of ``tests/test_torch_report.py``: four CPU processes
on ``gloo``, a 2 × 2 ``("data", "model")`` mesh, each running every case's
step on real tensors through ``launch/dryrun.py``'s ``dry_run(fake=False)``
and saving the counted record for the test, which holds it against the
dry run of the same rank on fake tensors.  Imports no JAX."""
from __future__ import annotations

import datetime
import json
import os
import traceback

import torch
import torch.distributed as dist

TIMEOUT_S = 60


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    result: dict = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from repro_torch.distributed import make_debug_mesh
        from repro_torch.launch.dryrun import dry_run

        torch.set_num_threads(1)
        cases = torch.load(inputs, weights_only=False)
        mesh = make_debug_mesh(2, world // 2, device="cpu")
        for name, (cfg, cell) in cases.items():
            result[name] = dry_run(cfg, cell, mesh, fake=False)
        result["moe_serve"] = moe_serve(mesh)
    except Exception:  # noqa: BLE001 — reported by the test
        result["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.destroy_process_group()


def moe_serve(mesh) -> dict:
    """The smoke granite-moe-3b's prefill and one decode step on ``mesh``
    (split by ``LM.shard_``, the caches' positions over the decode
    policy's ``kv_seq``) against the same model whole: the largest
    difference of the logits, relative to their largest magnitude."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.layout import seq_split
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.lm import LM, make_caches

    cfg = get_smoke("granite_moe_3b")
    max_len, n = 32, 24
    tokens = torch.randint(0, cfg.vocab, (1, n), generator=torch.Generator().manual_seed(0))
    nxt = torch.randint(0, cfg.vocab, (1, 1), generator=torch.Generator().manual_seed(1))
    out = {}
    with torch.no_grad():
        whole = LM(cfg, seed=0, device="cpu")
        pre, caches = whole.prefill(tokens, make_caches(cfg, 1, max_len, dtype=torch.float32, device="cpu"))
        dec, _ = whole.decode_step(nxt, caches)
        model = LM(cfg, seed=0, device="cpu")
        model.shard_(mesh)
        kv = seq_split(mesh, cfg.decode_policy().kv_seq, max_len)
        with use_rules(mesh, cfg.decode_policy()):
            caches = make_caches(cfg, 1, max_len, dtype=torch.float32, device="cpu", kv=kv)
            spre, caches = model.prefill(tokens, caches, kv=kv)
            sdec, _ = model.decode_step(nxt, caches, kv=kv)
    for name, a, b in (("prefill", spre, pre), ("decode", sdec, dec)):
        out[name] = float((a - b).abs().max() / b.abs().max())
    out["kv_local"] = kv.local
    return out
