"""Parity of the port's quantized chains (``repro_torch.core.compress``
``quantize_chain`` and the K4 path of ``packed_chain_apply``) with the JAX
reference on the CPU, where the kernel wrappers run their plain versions.

Tolerances: codes, scales and dequantized values are equal bit for bit
(both sides do one f32 division, round half to even or an RNE cast, and
one f32 multiply).  f32 applies ≤ 1e-5 of max|y| (the reference's forward
bound: the same f32 products summed in another order); bf16 applies
≤ 3e-2 (the reference's bf16 bound: activations round to bf16 between
factors).  Dispatch estimates are closed-form arithmetic on the same
constants: equal to 1e-9 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FaustOp as JOp
from repro.api import FactorizeSpec as JSpec
from repro.api import dispatch as jdispatch
from repro.api import factorize as jfactorize
from repro.core import compress as jc
from repro.kernels import ops as jops
from repro.launch.roofline import roofline_constants as j_roofline_constants
from repro_torch import bridge
from repro_torch.api import FactorizeSpec, FaustOp, dispatch, factorize, last_report
from repro_torch.core.compress import dequantize_chain, quantize_chain
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from torch_parity import jax_chain, packed_dict, rel_max_err, to_np

CPU = "cpu"
F32_TOL, BF16_TOL = 1e-5, 3e-2  # relative to max|y|; reasons in the module docstring
DIMS = (40, 72, 56, 90)  # ragged at every boundary for block 16
QDTYPES = ["int8", "fp8_e4m3", "fp8_e5m2"]
SCHEMES = ["per_block", "per_row"]
# ΔRE thresholds of the reference (benchmarks/quantized_re.py THRESHOLDS)
DRE_MAX = {"int8": 8e-3, "fp8_e4m3": 1e-1, "fp8_e5m2": 1.5e-1}


@pytest.fixture(scope="module")
def jchain():
    return jc.pack_chain(jax_chain(DIMS, 16, 3, seed=5))


def _port(jpc):
    return bridge.packed_from_numpy(packed_dict(jpc), device=CPU)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Codes as comparable integers (fp8 through its uint8 bit view)."""
    return t.view(torch.uint8).numpy() if t.dtype.is_floating_point else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _x(batch, width, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, width)).astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("qdtype", QDTYPES)
def test_quantize_matches_reference_bit_for_bit(jchain, qdtype, scheme):
    jq = jc.quantize_chain(jchain, qdtype, scheme)
    q = quantize_chain(_port(jchain), qdtype, scheme)
    assert q.qscheme == jq.qscheme == f"{qdtype}:{scheme}" and q.quantized
    assert q.values_dtype == jq.values_dtype
    np.testing.assert_array_equal(_bits(q.values), _jbits(jq.values))
    np.testing.assert_array_equal(q.scales.numpy(), np.asarray(jq.scales))
    # λ, in_idx and the plan are untouched
    assert torch.equal(q.in_idx, _port(jchain).in_idx) and q.plan == _port(jchain).plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("qdtype", QDTYPES)
def test_dequantize_matches_reference_and_round_trips(jchain, qdtype, scheme):
    jq = jc.quantize_chain(jchain, qdtype, scheme)
    q = quantize_chain(_port(jchain), qdtype, scheme)
    d = dequantize_chain(q)
    assert d.values.dtype == torch.float32 and not d.quantized
    np.testing.assert_array_equal(d.values.numpy(), np.asarray(jc.dequantize_chain(jq).values))
    # the reference's promise: quantize(dequantize(q)) == q bit for bit
    qq = quantize_chain(d, qdtype, scheme)
    np.testing.assert_array_equal(_bits(qq.values), _bits(q.values))
    assert torch.equal(qq.scales, q.scales)
    assert dequantize_chain(d) is d


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("qdtype", QDTYPES)
def test_quant_info_and_weight_bytes_match_reference(jchain, qdtype, scheme):
    jq = jc.quantize_chain(jchain, qdtype, scheme)
    q = _port(jq)
    assert q.weight_bytes == jq.weight_bytes
    assert FaustOp.from_packed(q, device=CPU).quant_info() == JOp.from_packed(jq).quant_info()
    assert FaustOp.from_packed(_port(jchain), device=CPU).quant_info() == (None, 0)
    # 1-byte codes plus f32 scales against 4-byte values
    assert q.weight_bytes < 0.5 * _port(jchain).weight_bytes


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_bridge_round_trips_quantized_chains(jchain, qdtype):
    q = _port(jc.quantize_chain(jchain, qdtype, "per_row"))
    d = bridge.to_numpy(q)
    assert d["values"].dtype == (np.int8 if qdtype == "int8" else np.uint8)
    back = bridge.packed_from_numpy(d, device=CPU)
    assert back.values.dtype == q.values.dtype and back.qscheme == q.qscheme
    np.testing.assert_array_equal(_bits(back.values), _bits(q.values))
    assert torch.equal(back.scales, q.scales) and torch.equal(back.in_idx, q.in_idx)
    with pytest.raises(ValueError, match="scales"):
        bridge.packed_from_numpy(dict(d, scales=d["scales"][:, 0]), device=CPU)  # per_block shape
    with pytest.raises(ValueError, match="qscheme"):
        bridge.packed_from_numpy(dict(d, qscheme="int4:per_row"), device=CPU)
    other = "fp8_e4m3" if qdtype == "int8" else "int8"
    with pytest.raises(TypeError, match="codes"):
        bridge.packed_from_numpy(dict(d, qscheme=f"{other}:per_row"), device=CPU)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("qdtype", QDTYPES)
def test_quantized_packed_chain_apply_matches_reference(jchain, qdtype, scheme, xdtype):
    jq = jc.quantize_chain(jchain, qdtype, scheme)
    q = _port(jq)
    x = _x(7, DIMS[0])  # odd batch, ragged features
    tdt = getattr(torch, xdtype)
    y = ops.packed_chain_apply(torch.as_tensor(x).to(tdt), q)
    jy = jops.packed_chain_apply(jnp.asarray(x, getattr(jnp, xdtype)), jq, use_kernel=False)
    assert y.dtype == tdt and y.shape == (7, DIMS[-1]) and jy.dtype == getattr(jnp, xdtype)
    tol = F32_TOL if xdtype == "float32" else BF16_TOL
    assert rel_max_err(to_np(y), np.asarray(jy, np.float32)) <= tol


@pytest.mark.parametrize("backend", ["dense", "bsr", "fused", "auto"])
@pytest.mark.parametrize("qdtype,scheme", [("int8", "per_block"), ("fp8_e4m3", "per_row"), ("fp8_e5m2", "per_block")])
def test_quantized_operator_matches_reference(jchain, qdtype, scheme, backend):
    jq = jc.quantize_chain(jchain, qdtype, scheme)
    op = FaustOp.from_packed(_port(jq), device=CPU)
    x = _x(9, DIMS[0], seed=2)
    y = op.apply(torch.as_tensor(x), backend, device=CPU)
    ref_backend = "fused" if backend == "auto" else backend  # R4: the reference's auto is no oracle
    jy = JOp.from_packed(jq).apply(jnp.asarray(x), backend=ref_backend, use_kernel=False)
    assert y.shape == (9, DIMS[-1])
    assert rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
    rep = last_report()
    assert rep.weight_bytes == jq.weight_bytes and rep.values_dtype == jq.values_dtype
    # dense and bsr see the exact f32 values, dequantized once per operator
    np.testing.assert_array_equal(to_np(op.todense()), np.asarray(JOp.from_packed(jq).todense()))
    assert op._unpacked is op._unpacked and op._unpacked.factors[0].values.dtype == torch.float32


@pytest.fixture
def same_constants(monkeypatch):
    """The port prices with the reference's constants, for this test only."""
    consts, _ = j_roofline_constants()
    monkeypatch.setattr(roofline, "roofline_constants", lambda: (dict(consts), "test"))
    return consts


@pytest.mark.parametrize("batch", [1, 128, 4096])
@pytest.mark.parametrize("values_dtype,per_row", [("int8", False), ("float8_e4m3fn", True), ("float8_e5m2", False)])
def test_choose_backend_prices_quantized_payloads_as_reference(same_constants, batch, values_dtype, per_row):
    s_tot, n_steps, blk = 11_010_048, 672, 128
    scales_bytes = 4 * n_steps * (blk if per_row else 1)
    kw = dict(batch=batch, shape=(2048, 16384), s_tot=s_tot, inner_dims=(2048, 2048), n_factors=3,
              values_dtype=values_dtype, scales_bytes=scales_bytes)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        mine = dispatch.choose_backend(dtype=tdt, **kw)
        ref = jdispatch.choose_backend(dtype=jdt, **kw)
        assert mine.backend == ref.backend and mine.est_us.keys() == ref.est_us.keys()
        for k in ref.est_us:
            assert mine.est_us[k] == pytest.approx(ref.est_us[k], rel=1e-9)  # same closed form, float64
        assert mine.weight_bytes == ref.weight_bytes == s_tot + scales_bytes
        assert mine.values_dtype == ref.values_dtype == values_dtype


def test_quantized_chain_moves_but_never_casts(jchain):
    q = _port(jc.quantize_chain(jchain, "int8", "per_block"))
    with pytest.raises(TypeError, match="quantized"):
        q.to(dtype=torch.float32)
    moved = q.to(device=CPU)
    assert moved.values.dtype == torch.int8 and moved.scales is not None and moved.qscheme == q.qscheme
    with pytest.raises(ValueError, match="already quantized"):
        quantize_chain(q)
    with pytest.raises(ValueError, match="unknown quant"):
        quantize_chain(_port(jchain), "int4")
    with pytest.raises(ValueError, match="unknown quant"):
        quantize_chain(_port(jchain), "int8", "per_col")


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_path_trains(jchain, quantized):
    """The fused path trains: its backward (K2/K3, K5 on a quantized chain;
    their plain versions here) gives the per-factor path's gradients, for
    x and for the values (the scales of codes)."""
    pc = _port(jchain)
    pc = quantize_chain(pc) if quantized else pc
    grads = {}
    for backend in ("fused", "bsr"):
        leaf = (pc.scales if quantized else pc.values).clone().requires_grad_(True)
        rep = dataclasses.replace(pc, **{"scales" if quantized else "values": leaf})
        x = torch.as_tensor(_x(4, DIMS[0])).requires_grad_(True)
        FaustOp.from_packed(rep, device=CPU).apply(x, backend, device=CPU).sum().backward()
        assert torch.isfinite(x.grad).all() and torch.isfinite(leaf.grad).all()
        grads[backend] = (x.grad, leaf.grad)
    for got, want in zip(grads["fused"], grads["bsr"]):
        assert rel_max_err(to_np(got), to_np(want)) <= F32_TOL


def test_quantized_slice_matches_reference():
    """factorize → pack → quantize → ``apply("auto")`` in the port against
    the reference's factorize → pack → quantize → fused plain apply, on
    the same W: each side's quantization error ΔRE = RE(q) − RE(f32) stays
    within the reference's threshold, and the two agree."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    x = rng.standard_normal((13, 64)).astype(np.float32)
    kw = dict(strategy="hierarchical", n_factors=3, block=8, k_first=2, k_mid=2)
    jop, _ = jfactorize(jnp.asarray(w), JSpec(**kw))
    op, _ = factorize(w, FactorizeSpec(**kw), device=CPU)
    wt = torch.as_tensor(w)
    for qdtype in QDTYPES:
        jq = JOp.from_packed(jc.quantize_chain(jop.to("packed").rep, qdtype))
        q = FaustOp.from_packed(quantize_chain(op.to("packed").rep, qdtype), device=CPU)
        y = q.apply(torch.as_tensor(x), "auto", device=CPU)
        assert y.shape == (13, 40) and torch.isfinite(y).all()
        assert rel_max_err(to_np(y), to_np(torch.as_tensor(x) @ q.todense())) <= 1e-4  # association order
        dre = float(q.rel_error_fro(wt) - op.rel_error_fro(wt))
        jdre = float(jq.rel_error_fro(jnp.asarray(w)) - jop.rel_error_fro(jnp.asarray(w)))
        assert abs(dre) <= DRE_MAX[qdtype] and abs(jdre) <= DRE_MAX[qdtype]
        # 1e-4: the factorizations agree to 1e-4 (test_torch_slice.py), and a
        # code that rounds the other way moves RE by far less
        assert dre == pytest.approx(jdre, abs=1e-4)
