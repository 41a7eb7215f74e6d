"""Training launcher of the port.  Counterpart of :mod:`repro.launch.train`,
with the same flags.

    python -m repro_torch.launch.train --arch gemma_2b --faust --steps 3 \\
        --batch 8 --seq 128                              # on the CUDA card
    python -m repro_torch.launch.train --arch gemma_2b --smoke --steps 20 \\
        --checkpoint-dir /tmp/ckpt --resume --device cpu # plain versions, CPU

``--faust`` makes the unembedding a FAµST chain (``--faust-factors``,
``--faust-block``, ``--faust-k``) and unties it from the embedding.
Checkpoints go to ``--checkpoint-dir`` every ``--checkpoint-every``
steps; ``--resume`` restores the newest intact one; ``--compress-grads
RATIO`` trains with EF top-k gradient compression.

``--mesh`` trains on the reference's production mesh (``(16, 16)`` over
``("data", "model")``; ``--multi-pod`` makes it ``(2, 16, 16)`` over ``("pod",
"data", "model")``), one process a rank, started by a launcher that sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``):
NCCL on the cards (each rank on ``LOCAL_RANK``'s), ``gloo`` with ``--device
cpu``.  A group of another size raises the mesh's ``ValueError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import TopKConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", type=float, default=0.0, help="EF top-k ratio (0 = off)")
    ap.add_argument("--faust", action="store_true", help="FAµST-parameterize the unembedding")
    ap.add_argument("--faust-block", type=int, default=16)
    ap.add_argument("--faust-k", type=int, default=4)
    ap.add_argument("--faust-factors", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", action="store_true", help="use production mesh")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def production_mesh(multi_pod: bool, device):
    """The production mesh over the launcher's process group (joined here
    when the launcher has not): NCCL with each rank on its
    ``LOCAL_RANK`` card, ``gloo`` on the CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import make_production_mesh

    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized():
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    return make_production_mesh(multi_pod=multi_pod, device="cpu" if cpu else None)


def build(args: argparse.Namespace) -> Trainer:
    """The trainer the flags describe (``--mesh``: on the production mesh
    of the launcher's process group)."""
    mesh = production_mesh(args.multi_pod, args.device) if args.mesh else None
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.faust:
        cfg = dataclasses.replace(
            cfg,
            faust_unembed=FaustSpec(n_factors=args.faust_factors, block=args.faust_block, k=args.faust_k),
            tie_embeddings=False,
        )
    data_cfg = DataConfig(
        vocab=cfg.vocab,
        seq_len=args.seq,
        global_batch=args.batch,
        n_codebooks=cfg.n_codebooks,
        n_vision_tokens=cfg.n_vision_tokens,
        d_model=cfg.d_model,
    )
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5), decay_steps=args.steps)
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        compression=TopKConfig(args.compress_grads) if args.compress_grads else None,
    )
    return Trainer(cfg, data_cfg, opt_cfg, tcfg, mesh=mesh, device=args.device)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    trainer = build(args)
    out = trainer.run(resume=args.resume)
    hist = out["history"]
    if hist:
        print(f"first loss {hist[0]['loss']:.4f} → last loss {hist[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
