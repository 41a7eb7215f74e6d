"""The whole slice on the CPU — factorize → pack → ``apply("auto")`` — in
the port against the JAX reference's factorize → ``apply("bsr")`` on the
same W and x.  W is (64, 40): out < in, so the block route solves
A = Wᵀ with per-block-row budgets (the other orientation is held in
``test_torch_factorize.py``).

Tolerance: 1e-4 of max|y|.  Both sides run 2·(40 + 40) PALM sweeps on
the same f32 data; their sums differ in order and the iteration compounds
that, as in the PALM parity test.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import FactorizeSpec as JSpec
from repro.api import factorize as jfactorize
from repro_torch.api import FactorizeSpec, factorize, last_report
from torch_parity import rel_max_err, to_np


def test_slice_matches_reference():
    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    x = rng.standard_normal((13, 64)).astype(np.float32)
    kw = dict(strategy="hierarchical", n_factors=3, block=8, k_first=2, k_mid=2)
    jop, jinfo = jfactorize(jnp.asarray(w), JSpec(**kw))
    op, info = factorize(w, FactorizeSpec(**kw), device="cpu")
    assert info.transpose
    for f, jf in zip(info.blockfausts[0].factors, jinfo.blockfausts[0].factors):
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
    y = op.apply(torch.as_tensor(x), "auto", device="cpu")
    assert last_report().backend in op.feasible_backends()
    jy = jop.apply(jnp.asarray(x), backend="bsr", use_kernel=False)
    assert y.shape == (13, 40) and torch.isfinite(y).all()
    assert rel_max_err(to_np(y), np.asarray(jy)) <= 1e-4  # 160 f32 PALM sweeps, other summation order
    assert op.s_tot == jop.s_tot and op.rcg == jop.rcg
