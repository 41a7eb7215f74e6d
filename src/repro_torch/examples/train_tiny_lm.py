"""Training example: a small LM for a few hundred steps on the synthetic
stream, with checkpoint/resume and an optional FAµST unembedding and FFN,
the paper's technique as a training-time parameterization (prescribed
block supports).  Counterpart of the reference's
``examples/train_tiny_lm.py``.

The model is ``--arch``'s smoke config widened to d_model 128 and a 2048
vocabulary (a dense family's layers become four ``"attn"`` layers).

    python -m repro_torch.examples.train_tiny_lm [--faust] [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_tiny_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--faust", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    dense = cfg.family == "dense"
    cfg = dataclasses.replace(
        cfg,
        n_layers=4 if dense else cfg.n_layers,
        stages=((4, ("attn",)),) if dense else cfg.stages,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab=2048,
        tie_embeddings=False,
    )
    if args.faust:
        cfg = dataclasses.replace(cfg, faust_unembed=FaustSpec(n_factors=2, block=32, k=2),
                                  faust_mlp=FaustSpec(n_factors=2, block=32, k=2))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    trainer = Trainer(
        cfg,
        data_cfg,
        AdamWConfig(lr=1e-3, warmup_steps=20, decay_steps=args.steps),
        TrainConfig(steps=args.steps, checkpoint_every=50, checkpoint_dir=args.ckpt, log_every=20),
        device=args.device,
    )
    out = trainer.run(resume=args.resume)
    hist = out["history"]
    first = sum(h["loss"] for h in hist[:10]) / max(len(hist[:10]), 1)
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    print(f"mean loss: first 10 steps {first:.4f} → last 10 steps {last:.4f}")
    if hist and not last < first:
        raise RuntimeError(f"training did not reduce the loss: {first:.4f} → {last:.4f}")
    return out


if __name__ == "__main__":
    main()
