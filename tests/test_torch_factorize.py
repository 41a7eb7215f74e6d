"""Parity of the port's factorizer (projections, power iteration, PALM,
the hierarchical block route) with the JAX reference on the CPU, and the
port's exact Hadamard factorization.

Tolerances: projections and the step table are selections, so supports
must be equal; values within 1e-6 (one f32 normalization apart).  PALM
over 5 sweeps within 1e-4 (the two packages sum the same f32 products in
another order and the iteration compounds it).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FactorizeSpec as JSpec
from repro.api import factorize as jfactorize
from repro.core import lipschitz as jl
from repro.core import projections as jp
from repro.core.faust import default_init as jdefault_init
from repro_torch.api import FactorizeSpec, factorize
from repro_torch.core import lipschitz as tl
from repro_torch.core import palm4msa as tpalm
from repro_torch.core import projections as tp
from repro_torch.core.faust import default_init
from repro_torch.core.hierarchical import hadamard_matrix, hadamard_spec
from torch_parity import to_np

CPU = "cpu"
# ``repro.core`` re-exports the function under the module's name
jpalm = importlib.import_module("repro.core.palm4msa")


def test_topk_ties_break_to_lowest_index():
    """``lax.top_k`` keeps the lowest index among ties; torch.topk does not."""
    v = np.array([1, 1, 1, 1, 2, 1], np.float32)
    mine = tp._topk_mask_flat(torch.as_tensor(v), 3).numpy()
    ref = np.asarray(jp._topk_mask_flat(jnp.asarray(v), 3))
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, [1, 1, 0, 0, 1, 0])


PROJ_CASES = [
    ("global", dict(k=37)),
    ("col", dict(k=3)),
    ("row", dict(k=5)),
    ("splincol", dict(k=2)),
    ("blockrow", dict(bm=8, bn=8, k_per_row=2)),
    ("blockcol", dict(bm=8, bn=4, k_per_col=3)),
    ("id", dict()),
]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("kind,kw", PROJ_CASES)
def test_projection_matches_reference(kind, kw, ties):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    if ties:  # Hadamard-like: many equal magnitudes
        x = np.sign(x) * (1.0 + (rng.random(x.shape) < 0.1))
        x = x.astype(np.float32)
    mine = tp.make_proj(kind, **kw)(torch.as_tensor(x)).numpy()
    ref = np.asarray(jp.make_proj(kind, **kw)(jnp.asarray(x)))
    np.testing.assert_array_equal(mine != 0, ref != 0)  # selections: equal supports
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-7)  # one f32 renormalization apart


@pytest.mark.parametrize("shape", [(24, 40), (40, 24)])
def test_spectral_norm_matches_reference(shape):
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    mine = float(tl.spectral_norm(torch.as_tensor(a), iters=32))
    ref = float(jl.spectral_norm(jnp.asarray(a), iters=32))
    assert abs(mine - ref) <= 1e-5 * ref  # f32 power iteration, same start and steps
    assert float(tl.spectral_norm_sq(torch.as_tensor(a))) == pytest.approx(mine**2, rel=1e-6)


def test_palm4msa_matches_reference():
    """Same init, same constraints, 5 sweeps: factors within 1e-4 with the
    same supports, λ and the loss history alike."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((32, 48)).astype(np.float32)
    dims = (48, 32, 32)
    kinds = (("blockcol", dict(bm=8, bn=8, k_per_col=2)), ("splincol", dict(k=6)))
    jfac, jlam = jdefault_init(dims)
    # a shared start with S_1 from numpy (S_1 = 0 would make the first
    # projection choose among ties)
    s1 = rng.standard_normal((32, 48)).astype(np.float32) * 0.1
    jfac = (jnp.asarray(s1),) + tuple(jfac[1:])
    res = jpalm.palm4msa(
        jnp.asarray(a), jfac, jlam, tuple(jp.make_proj(k, **kw) for k, kw in kinds), 5
    )
    tfac, tlam = default_init(dims, device=CPU)
    tfac = (torch.as_tensor(s1),) + tuple(tfac[1:])
    mine = tpalm.palm4msa(
        torch.as_tensor(a), tfac, tlam, tuple(tp.make_proj(k, **kw) for k, kw in kinds), 5
    )
    for s, js in zip(mine.factors, res.factors):
        np.testing.assert_array_equal(to_np(s) != 0, np.asarray(js) != 0)
        np.testing.assert_allclose(to_np(s), np.asarray(js), atol=1e-4)  # 5 sweeps compound f32 order
    assert float(mine.lam) == pytest.approx(float(res.lam), rel=1e-4)
    np.testing.assert_allclose(to_np(mine.loss_history), np.asarray(res.loss_history), rtol=1e-4)


def test_block_route_matches_reference():
    """The deployment route on a 48×80 W at block 8 (A = W, blockcol
    budgets): the same packed supports, RE within 1e-4 of the reference's."""
    w = np.random.default_rng(0).standard_normal((48, 80)).astype(np.float32)
    kw = dict(n_factors=3, block=8, k_first=2, k_mid=2)
    jop, jinfo = jfactorize(jnp.asarray(w), JSpec(**kw))
    op, info = factorize(w, FactorizeSpec(**kw), device=CPU)
    assert not info.transpose
    for f, jf in zip(info.blockfausts[0].factors, jinfo.blockfausts[0].factors):
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
    re = float(op.rel_error_fro(torch.as_tensor(w)))
    jre = float(jop.rel_error_fro(jnp.asarray(w)))
    assert abs(re - jre) <= 1e-4  # 160 sweeps of f32 PALM in another summation order
    assert info.n_sweeps == jinfo.n_sweeps == 2 * (40 + 40)
    np.testing.assert_allclose(
        info.hierarchical.global_losses, jinfo.hierarchical.global_losses, rtol=1e-4
    )


@pytest.mark.parametrize("n", [16, 32, 64])
def test_hadamard_is_exact(n):
    """Paper §IV-C: log2(n) butterfly factors with 2n nonzeros each
    reproduce the Hadamard matrix (RE < 1e-5)."""
    h = hadamard_matrix(n, device=CPU)
    op, info = factorize(h, FactorizeSpec(strategy="hadamard"), device=CPU)
    assert float(op.rel_error_fro(h)) < 1e-5  # exact up to f32 rounding (paper §IV-C)
    assert op.s_tot <= 2 * n * int(np.log2(n))
    assert len(info.fausts[0].factors) == int(np.log2(n))


def test_explicit_hier_route_equals_preset():
    h = hadamard_matrix(16, device=CPU)
    op, _ = factorize(h, FactorizeSpec(strategy="hadamard"), device=CPU)
    op2, info2 = factorize(h, FactorizeSpec(hier=hadamard_spec(16, 40, 40)), device=CPU)
    assert info2.strategy == "hierarchical"
    assert torch.equal(op.todense(), op2.todense())
