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
def test_choose_backend_matches_reference(same_constants, monkeypatch, batch, shape, s_tot, inner, n_factors,
                                          feasible):
    """bf16: the reference's decision and estimates.  f32: the reference's
    closed form evaluated at the card's f32 peak, which the port prices
    f32 at (the reference prices every dtype at its one ``peak_flops``):
    the reference sees that peak as its ``peak_flops``, the port as its
    ``peak_flops_f32``."""
    f32_peak = roofline.load_roofline()[0]["peak_flops_f32"]
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        if tdt == torch.float32:
            monkeypatch.setattr(roofline, "roofline_constants",
                                lambda: ({**same_constants, "peak_flops_f32": f32_peak}, "test"))
            monkeypatch.setattr(jdispatch, "roofline_constants",
                                lambda: ({**same_constants, "peak_flops": f32_peak}, "test"))
        kw = dict(batch=batch, shape=shape, s_tot=s_tot, inner_dims=inner,
                  n_factors=n_factors, feasible=feasible)
        mine = dispatch.choose_backend(dtype=tdt, **kw)
        ref = jdispatch.choose_backend(dtype=jdt, **kw)
        assert mine.backend == ref.backend
        assert mine.est_us.keys() == ref.est_us.keys()
        for k in ref.est_us:
            assert mine.est_us[k] == pytest.approx(ref.est_us[k], rel=1e-9)  # same closed form, float64
        assert mine.weight_bytes == ref.weight_bytes and mine.dtype == ref.dtype


def test_f32_is_priced_at_the_ffma_peak():
    """The port's own constants: f32 operations at 67e12 FLOP/s (FFMA, the
    H100 SXM data sheet), bf16 at 989e12; a constants dict without the f32
    key prices f32 at ``peak_flops``."""
    consts, _ = roofline.roofline_constants()
    assert consts["peak_flops_f32"] == 67e12 and consts["peak_flops"] == 989e12
    kw = dict(batch=4096, shape=(2048, 16384), s_tot=11_010_048, inner_dims=(2048, 2048), n_factors=3)
    for dtype, peak in ((torch.float32, 67e12), (torch.bfloat16, 989e12)):
        rep = dispatch.choose_backend(dtype=dtype, **kw)
        flops = 2.0 * 4096 * 11_010_048
        byts = dtype.itemsize * 11_010_048 + dtype.itemsize * 4096 * (2048 + 16384)
        want = max(flops / peak, byts / consts["hbm_bw"]) * 1e6 + consts["t_launch_us"]
        assert rep.est_us["fused"] == pytest.approx(want, rel=1e-12)
    f32 = dispatch.choose_backend(dtype=torch.float32, **kw).est_us["fused"]
    assert f32 > 4096 * 2 * 11_010_048 / 67e12 * 1e6  # compute-bound at the FFMA rate


def test_bsr_backward_launch_count_is_the_plain_backwards():
    """``BSR_BWD_LAUNCHES`` is the number of kernels the bsr backward
    (``kernels/ref.py`` ``bsr_matmul_dx`` and ``bsr_matmul_dvalues``) runs
    per factor in f32: every aten call that is not a view."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ref

    class Launches(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.__name__ != "_unsafe_view.default":
                self.n += 1
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    values = torch.randn((4, 2, 8, 8), generator=g)
    in_idx = torch.randint(0, 4, (4, 2), generator=g, dtype=torch.int32)
    x, dy = torch.randn((16, 32), generator=g), torch.randn((16, 32), generator=g)
    with Launches() as mode:
        ref.bsr_matmul_dx(dy, values, in_idx, 32)
        ref.bsr_matmul_dvalues(x, dy, in_idx, (8, 8))
    assert mode.n == dispatch.BSR_BWD_LAUNCHES == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [128, 4096])
@pytest.mark.parametrize("quant", [None, ("int8", 4 * 672 * 128)])
def test_grad_pricing_of_the_bsr_backward(dtype, batch, quant):
    """Under grad, bsr over block-sparse factors pays its backward's two f32
    intermediates and launches beside the reference's terms, and the model
    then picks what the H100 measured fastest at the training-apply keys
    (PERF.md §5: fused, except f32 x at B = 4096).  Pricing f32 at the FFMA
    peak without them picked bsr at f32 x, B = 128, twice as slow."""
    consts, _ = roofline.roofline_constants()
    s_tot, gather = 11_010_048, 11_010_048 // 128
    kw = dict(batch=batch, shape=(2048, 16384), dtype=dtype, s_tot=s_tot, inner_dims=(2048, 2048),
              n_factors=3, grad=True)
    if quant is not None:
        kw.update(values_dtype=quant[0], scales_bytes=quant[1])
    ref_form = dispatch.choose_backend(**kw)
    mine = dispatch.choose_backend(bsr_gather=gather, **kw)
    peak = consts["peak_flops_f32"] if dtype == torch.float32 else consts["peak_flops"]
    elt = dtype.itemsize
    w = (1 if quant else elt) * s_tot + (quant[1] if quant else 0)
    byts = 3 * w + (4 if quant else elt) * s_tot + elt * 3 * batch * (2048 + 16384 + 2 * 4096)
    byts += 16.0 * batch * gather  # the gathered x blocks and per-block dx, f32, written and read
    want = max(6.0 * batch * s_tot / peak, byts / consts["hbm_bw"]) * 1e6
    want += (1 + dispatch.BSR_BWD_LAUNCHES) * 3 * consts["t_launch_us"]
    assert mine.est_us["bsr"] == pytest.approx(want, rel=1e-9)
    assert mine.est_us["fused"] == ref_form.est_us["fused"] and mine.est_us["dense"] == ref_form.est_us["dense"]
    assert mine.backend == ("bsr" if dtype == torch.float32 and batch == 4096 else "fused")
    if dtype == torch.float32 and batch == 128:
        assert ref_form.backend == "bsr"  # what the reference's bsr terms picked at the FFMA peak


def test_operator_supplies_the_bsr_gather(ops_pair):
    """The model's ``bsr_gather`` is ``Σ_j s_j / bn_j``: packed and block
    leaves count their stored blocks' input rows, a dense-factor chain none."""
    _, op = ops_pair
    packed = op.to("packed")
    assert op.bsr_gather() == packed.bsr_gather() == packed.s_tot // 16
    assert op.T.bsr_gather() == op.bsr_gather() and op.to("faust").bsr_gather() == 0
    rep = dispatch.dispatch(packed, 8, torch.float32, device=CPU, record=False, grad=True)
    want = dispatch.choose_backend(batch=8, shape=packed.shape, dtype=torch.float32, s_tot=packed.s_tot,
                                   inner_dims=packed.inner_dims(), n_factors=3, grad=True,
                                   bsr_gather=packed.s_tot // 16)
    assert dict(rep.est_us) == dict(want.est_us)


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
