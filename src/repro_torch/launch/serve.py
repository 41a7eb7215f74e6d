"""Serving launcher of the port: batched prefill + greedy decode through
:class:`~repro_torch.runtime.server.Server`.  Counterpart of
:mod:`repro.launch.serve`, with the same flags plus ``--device``.

    python -m repro_torch.launch.serve --arch gemma_2b --batch 4 \\
        --prompt-len 64 --new-tokens 32                  # on the CUDA card
    python -m repro_torch.launch.serve --arch gemma_2b --smoke --device cpu

Without ``--device`` it runs on the card and raises when there is none.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.models.lm import LM
from repro_torch.runtime.server import Server


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = LM(cfg, seed=0, device=args.device)
    data_cfg = DataConfig(
        vocab=cfg.vocab,
        seq_len=args.prompt_len,
        global_batch=args.batch,
        n_codebooks=cfg.n_codebooks,
        n_vision_tokens=cfg.n_vision_tokens,
        d_model=cfg.d_model,
    )
    batch = {"tokens": global_batch(data_cfg, 0)["tokens"]}
    server = Server(model, max_len=args.prompt_len + args.new_tokens)
    gen, stats = server.generate(batch, args.new_tokens)
    print(f"generated shape: {gen.shape}")
    print(
        f"prefill {stats.prefill_s*1e3:.1f} ms; decode {stats.decode_s*1e3:.1f} ms "
        f"({stats.tokens_per_s:.1f} tok/s)"
    )
    return gen, stats


if __name__ == "__main__":
    main()
