"""Compress-then-serve: replace a trained dense projection by a FAµST
learned with the paper's hierarchical algorithm (checkpoint surgery).
Counterpart of the reference's ``examples/compress_operator.py``.

1. Train a small LM for a few steps (dense unembedding).
2. Factorize the trained unembedding with ``repro_torch.api.factorize``
   (block-constrained hierarchical PALM4MSA), at k = 2 and 4.
3. Put each chain into a copy of the model with a FAµST unembedding and
   compare its logits with the dense model's on a held-out batch: RCG,
   relative error and top-1 agreement, the chain applied with backend
   dispatch.

    python -m repro_torch.examples.compress_operator [--steps 60] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.api import FactorizeSpec, factorize, last_report
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.engine import swap_unembed
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.compress_operator")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--sweeps", type=int, default=30, help="PALM sweeps of each factorization stage")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_compress_demo"))
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_smoke("gemma_2b"),
        n_layers=2, stages=((2, ("attn",)),), d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab=512, tie_embeddings=False,
    )
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    trainer = Trainer(cfg, data_cfg, AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=args.steps),
                      TrainConfig(steps=args.steps, checkpoint_every=1000, checkpoint_dir=args.ckpt),
                      device=args.device)
    dense = trainer.run(resume=False)["model"]
    dev = trainer.device
    tokens = torch.as_tensor(global_batch(data_cfg, 999)["tokens"], device=dev)  # held out
    with torch.no_grad():
        logits_dense = dense.forward_train(tokens)

    w = dense.unembed.w.detach().float()  # (d_model, vocab)
    rows = []
    for k in (2, 4):
        spec = FaustSpec(n_factors=2, block=16, k=k)
        op, _ = factorize(w, FactorizeSpec(n_factors=2, block=16, k_first=k, k_mid=k, n_iter_two=args.sweeps,
                                           n_iter_global=args.sweeps), device=dev)
        # surgery: the trained weights, with the chain in place of the dense head
        model = LM(dataclasses.replace(cfg, faust_unembed=spec), device=dev)
        model.load_state_dict({n: t for n, t in dense.state_dict().items() if not n.startswith("unembed.")},
                              strict=False)
        swap_unembed(model, op.rep)
        with torch.no_grad():
            logits = model.forward_train(tokens)
        row = {
            "k": k, "rcg": op.rcg, "backend": last_report().backend,
            "re": float(op.rel_error_fro(w)),
            "logits_rel_err": float(torch.linalg.norm(logits - logits_dense) / torch.linalg.norm(logits_dense)),
            "top1_agreement": float((logits.argmax(-1) == logits_dense.argmax(-1)).float().mean()),
        }
        print(f"k={k}: RCG={row['rcg']:.2f}  RE={row['re']:.3f}  backend={row['backend']}  "
              f"logits rel-err={row['logits_rel_err']:.3f}  top-1 agreement={row['top1_agreement'] * 100:.1f}%")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
