"""Parity of the port's operator and dispatch (``repro_torch.api``) with
the JAX reference on the CPU, and the port's device rule.

Tolerance: f32 applies ≤ 1e-5 of max|y| (the reference's forward bound;
the two packages sum the same f32 products in another order).  Dispatch
estimates are closed-form arithmetic on the same constants: equal to
1e-9 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FaustOp as JOp
from repro.api import dispatch as jdispatch
from repro.core import compress as jc
from repro.launch.roofline import roofline_constants as j_roofline_constants
from repro_torch import bridge
from repro_torch.api import FactorizeSpec, FaustOp, dispatch, factorize, last_report
from repro_torch.launch import roofline
from torch_parity import blockfaust_dict, jax_chain, packed_dict, rel_max_err, to_np

CPU = "cpu"
F32_TOL = 1e-5
DIMS = (40, 72, 56, 90)


@pytest.fixture(scope="module")
def ops_pair():
    jbf = jax_chain(DIMS, 16, 3, seed=4)
    bf = bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU)
    return JOp.from_blockfaust(jbf), FaustOp.from_blockfaust(bf, device=CPU)


@pytest.mark.parametrize("backend", ["dense", "bsr", "fused", "auto"])
def test_apply_matches_reference(ops_pair, backend):
    jop, op = ops_pair
    x = np.random.default_rng(0).standard_normal((9, DIMS[0])).astype(np.float32)
    y = op.apply(torch.as_tensor(x), backend, device=CPU)
    ref_backend = "bsr" if backend in ("fused", "auto") else backend  # JAX fused from a BlockFaust hits R1
    jy = jop.apply(jnp.asarray(x), backend=ref_backend, use_kernel=False)
    assert y.shape == (9, DIMS[-1])
    assert rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
    rep = last_report()
    assert rep.requested == backend and rep.device == "cpu"
    assert rep.backend == (backend if backend != "auto" else "fused")


def test_transpose_and_conversions_match_reference(ops_pair):
    jop, op = ops_pair
    y = np.random.default_rng(1).standard_normal((4, DIMS[-1])).astype(np.float32)
    for backend in ("dense", "bsr"):
        got = op.T.apply(torch.as_tensor(y), backend, device=CPU)
        ref = jop.T.apply(jnp.asarray(y), backend=backend, use_kernel=False)
        assert rel_max_err(to_np(got), np.asarray(ref)) <= F32_TOL
    assert op.T.shape == jop.T.shape == (DIMS[-1], DIMS[0])
    assert op.T.feasible_backends() == jop.T.feasible_backends() == ("dense", "bsr")
    assert op.H.shape == op.T.shape
    dense = to_np(op.todense())
    np.testing.assert_allclose(dense, np.asarray(jop.todense()), rtol=1e-5, atol=1e-6)
    for fmt in ("faust", "block", "packed"):
        conv, jconv = op.to(fmt), jop.to(fmt)
        assert conv.s_tot == jconv.s_tot and conv.shape == jconv.shape
        # 1e-4: conversions re-associate the chain product in f32
        np.testing.assert_allclose(to_np(conv.todense()), dense, rtol=1e-4, atol=1e-5)
        assert conv.feasible_backends() == jconv.feasible_backends()
    # a dense-factor chain re-packs at block 8 exactly as the reference does
    re8, jre8 = op.to("faust").to("packed", block=8), jop.to("faust").to("packed", block=8)
    np.testing.assert_array_equal(re8.rep.in_idx.numpy(), np.asarray(jre8.rep.in_idx))
    assert dataclasses.asdict(re8.rep.plan) == dataclasses.asdict(jre8.rep.plan)
    assert op.rcg == pytest.approx(jop.rcg)
    assert op.inner_dims() == jop.inner_dims() and op.T.inner_dims() == jop.T.inner_dims()


@pytest.fixture
def same_constants(monkeypatch):
    """The port prices with the reference's constants, for this test only."""
    consts, _ = j_roofline_constants()
    monkeypatch.setattr(roofline, "roofline_constants", lambda: (dict(consts), "test"))
    return consts


@pytest.mark.parametrize("batch", [1, 7, 128, 1000, 4096])
@pytest.mark.parametrize(
    "shape,s_tot,inner,n_factors,feasible",
    [
        ((2048, 16384), 11_010_048, (2048, 2048), 3, ("dense", "bsr", "fused")),
        ((512, 512), 200_000, (512,), 2, ("dense", "bsr", "fused")),
        ((64, 4096), 260_000, (64, 64, 64), 4, ("dense", "bsr")),
        ((256, 256), 4096, (), 1, ("dense", "bsr", "fused")),
    ],
)
def test_choose_backend_matches_reference(same_constants, batch, shape, s_tot, inner, n_factors, feasible):
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        kw = dict(batch=batch, shape=shape, s_tot=s_tot, inner_dims=inner,
                  n_factors=n_factors, feasible=feasible)
        mine = dispatch.choose_backend(dtype=tdt, **kw)
        ref = jdispatch.choose_backend(dtype=jdt, **kw)
        assert mine.backend == ref.backend
        assert mine.est_us.keys() == ref.est_us.keys()
        for k in ref.est_us:
            assert mine.est_us[k] == pytest.approx(ref.est_us[k], rel=1e-9)  # same closed form, float64
        assert mine.weight_bytes == ref.weight_bytes and mine.dtype == ref.dtype


def test_dispatch_for_and_forced_reports(ops_pair):
    _, op = ops_pair
    before = last_report()
    adv = op.dispatch_for(64)
    assert last_report() is before and adv.requested == "auto"
    x = torch.zeros((3, DIMS[0]))
    op.apply(x, "bsr", device=CPU)
    rep = last_report()
    assert rep.backend == "bsr" and rep.reason.startswith("forced by caller")
    with pytest.raises(ValueError, match="not feasible"):
        op.T.apply(torch.zeros((3, DIMS[-1])), "fused", device=CPU)


def test_no_card_and_no_device_raises(monkeypatch, ops_pair):
    """The device rule: with no card and no ``device=``, entry points raise
    instead of carrying on on the CPU."""
    _, op = ops_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factorize(w, FactorizeSpec(n_factors=2, block=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.apply(torch.zeros((2, DIMS[0])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaustOp.from_packed(op.to("packed").rep)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.packed_from_numpy(bridge.to_numpy(op.to("packed").rep))
    with pytest.raises(ValueError, match="CUDA"):
        op.apply(torch.zeros((2, DIMS[0])), use_kernel=True, device=CPU)


def test_packed_operator_from_reference_chain_applies():
    jpc = jc.pack_chain(jax_chain(DIMS, 16, 3, seed=8))
    op = FaustOp.from_packed(bridge.packed_from_numpy(packed_dict(jpc), device=CPU), device=CPU)
    x = np.random.default_rng(3).standard_normal((5, DIMS[0])).astype(np.float32)
    jy = JOp.from_packed(jpc).apply(jnp.asarray(x), backend="fused", use_kernel=False)
    for backend in ("fused", "bsr", "dense"):
        y = op.apply(torch.as_tensor(x), backend, device=CPU)
        assert rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
