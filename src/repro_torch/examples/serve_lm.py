"""Serving example: batched prefill and greedy decode on ``--arch``'s
smoke config, through :class:`repro_torch.runtime.server.Server`.
Counterpart of the reference's ``examples/serve_lm.py``; ``--arch``
takes every architecture of the reference (internvl2-2b with its stand-in
``vision_embeds``, musicgen-medium's codebooks: tokens ``(B, K, n)``).

    python -m repro_torch.examples.serve_lm [--arch gemma3_27b] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.models.lm import LM
from repro_torch.runtime.server import Server


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="gemma_2b", help=f"one of {ARCH_IDS} (or an alias)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    model = LM(cfg, seed=0, device=args.device)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len, global_batch=args.batch,
                          n_codebooks=cfg.n_codebooks, n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model)
    batch = global_batch(data_cfg, 0)  # tokens, and a vision model's vision_embeds
    server = Server(model, max_len=args.prompt_len + args.new_tokens)
    gen, stats = server.generate(batch, args.new_tokens)
    print(f"arch={cfg.name} generated {gen.shape} tokens")
    print(f"prefill {stats.prefill_s * 1e3:.0f} ms; decode {stats.tokens_per_s:.1f} tok/s")
    if stats.faust_dispatch is not None:
        print(f"faust dispatch: {stats.faust_dispatch.backend} ({stats.faust_dispatch.reason})")
    return gen, stats


if __name__ == "__main__":
    main()
