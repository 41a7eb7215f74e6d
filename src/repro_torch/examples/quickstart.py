"""Quickstart: the paper's algorithm in five steps, through the port's
operator API (``repro_torch.api``).  Counterpart of the reference's
``examples/quickstart.py``.

1. Reverse-engineer the Hadamard transform (paper §IV-C): an exact
   factorization, RCG = n / (2·log2 n), from one ``factorize`` call.
2. Factorize an MEG-like operator at a chosen accuracy/complexity
   trade-off (paper §V-A).
3. Compress a dense weight into a deployment chain and apply it with
   backend dispatch (``FaustOp.apply(backend="auto")``).
4. Compress a stack of same-shaped weights in one batched solve; the
   stack comes back as one ``block_diag`` operator.
5. Operator algebra: lazy adjoint and composition.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import FactorizeSpec, factorize, last_report
from repro_torch.core.hierarchical import hadamard_matrix
from repro_torch.data.synthetic import synthetic_leadfield
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain versions")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {}

    # --- 1. Hadamard ------------------------------------------------------
    n = 32
    a = hadamard_matrix(n, device=dev)
    had, _ = factorize(a, FactorizeSpec(strategy="hadamard"), device=dev)
    out["hadamard_re"] = float(had.rel_error_fro(a))
    print(f"Hadamard {n}×{n}: {had.n_factors} factors, s_tot={had.s_tot} (dense {n * n}), "
          f"RCG={had.rcg:.2f}, RE={out['hadamard_re']:.2e}")

    # --- 2. MEG-like operator ---------------------------------------------
    m, nn = 64, 512
    g = torch.as_tensor(synthetic_leadfield(m, nn), device=dev)
    meg, _ = factorize(g, FactorizeSpec(strategy="meg", n_factors=4, k=8, s=4 * m), device=dev)
    out["meg_re_spec"] = float(meg.rel_error_spec(g))
    print(f"leadfield {m}×{nn}: RCG={meg.rcg:.2f}, RE={out['meg_re_spec']:.4f}")

    # --- 3. deployment: a chain applied with auto backend dispatch ---------
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((128, 256), generator=gen, device=dev) * 0.05
    fop, _ = factorize(w, FactorizeSpec(n_factors=2, block=16, k_first=4, k_mid=4), device=dev)
    x = torch.randn((8, 128), generator=gen, device=dev)
    y = fop.apply(x, "auto", device=dev)
    out["apply_err"] = float(torch.linalg.norm(y - x @ fop.todense()) / torch.linalg.norm(y))
    print(f"FaustOp 128→256: RCG={fop.rcg:.2f}, auto backend={last_report().backend}, "
          f"apply err={out['apply_err']:.2e}")

    # --- 4. batched: a stack of same-shaped weights in one solve -----------
    ws = torch.randn((4, 128, 256), generator=gen, device=dev) * 0.05
    stack, info = factorize(ws, FactorizeSpec(n_factors=2, block=16, k_first=4, k_mid=4, n_iter_two=20,
                                              n_iter_global=20), device=dev)
    res = [float(o.rel_error_fro(ws[i])) for i, o in enumerate(info.ops)]
    out["batched_re"] = res
    print(f"batched compress 4×(128→256) → {stack.kind} operator {stack.shape}: "
          f"solve buckets={info.hierarchical.cache.misses} (reused {info.hierarchical.cache.hits}), "
          f"RE={np.mean(res):.3f}±{np.std(res):.3f}")

    # --- 5. operator algebra: lazy adjoint and composition ------------------
    gram = fop @ fop.T  # (128, 128), still a lazy chain
    v = torch.randn((128,), generator=gen, device=dev)
    dense = fop.todense()
    out["gram_err"] = float(torch.linalg.norm(gram @ v - dense @ (dense.T @ v)) / torch.linalg.norm(gram @ v))
    print(f"gram = op @ op.T: shape={gram.shape}, s_tot={gram.s_tot}, err={out['gram_err']:.2e}")
    return out


if __name__ == "__main__":
    main()
