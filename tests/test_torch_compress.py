"""Parity of the port's chain formats (``repro_torch.core.compress``), step
table and bridge with the JAX reference, on the same numpy arrays.

Formats are exact copies (integer tables, reshapes, concatenations), so
these comparisons are equalities, not tolerances.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.core.faust import Faust as JFaust
from repro.kernels.ops import _chain_meta_static as j_meta_static
from repro_torch import bridge
from repro_torch.core import compress as tc
from repro_torch.core.faust import Faust
from repro_torch.kernels.ops import _chain_meta_static, chain_meta
from torch_parity import blockfaust_dict, faust_dict, jax_chain, packed_dict

CPU = "cpu"


CHAINS = [((40, 72, 56), 16, 3), ((24, 24), 8, 2), ((200, 300, 260, 330, 150), 128, 2)]


@pytest.mark.parametrize("dims,blk,k", CHAINS)
def test_pack_chain_matches_reference(dims, blk, k):
    jbf = jax_chain(dims, blk, k)
    bf = bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU)
    jpc, pc = jc.pack_chain(jbf), tc.pack_chain(bf)
    assert dataclasses.asdict(pc.plan) == dataclasses.asdict(jpc.plan)
    assert pc.plan.max_blocks == jpc.plan.max_blocks and pc.plan.n_steps == jpc.plan.n_steps
    assert dataclasses.asdict(pc.plan.reverse()) == dataclasses.asdict(jpc.plan.reverse())
    assert pc.plan.reverse().reverse() == pc.plan
    np.testing.assert_array_equal(pc.values.numpy(), np.asarray(jpc.values))
    np.testing.assert_array_equal(pc.in_idx.numpy(), np.asarray(jpc.in_idx))
    back, jback = tc.unpack_chain(pc), jc.unpack_chain(jpc)
    for f, jf in zip(back.factors, jback.factors):
        np.testing.assert_array_equal(f.values.numpy(), np.asarray(jf.values))
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
        assert (f.in_features, f.out_features) == (jf.in_features, jf.out_features)
    # todense: scatter of the same f32 values, then the same chain of f32 matmuls
    np.testing.assert_allclose(bf.todense().numpy(), np.asarray(jbf.todense()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims,blk,k", CHAINS)
def test_step_table_matches_reference(dims, blk, k):
    jpc = jc.pack_chain(jax_chain(dims, blk, k))
    pc = bridge.packed_from_numpy(packed_dict(jpc), device=CPU)
    np.testing.assert_array_equal(_chain_meta_static(pc.plan), j_meta_static(jpc.plan))
    table = chain_meta(pc.plan, pc.in_idx)
    assert table.dtype == torch.int32 and table.shape == (pc.plan.n_steps, 7)
    np.testing.assert_array_equal(table[:, 0].numpy(), np.asarray(jpc.in_idx))
    np.testing.assert_array_equal(table[:, 1:].numpy(), j_meta_static(jpc.plan))


@pytest.mark.parametrize(
    "shape,bk,bn,k,zero_cols",
    [((48, 80), 8, 8, 3, ()), ((50, 70), 8, 16, 2, (0, 3)), ((64, 32), 16, 8, 6, (1,))],
)
def test_pack_dense_matches_reference(shape, bk, bn, k, zero_cols):
    """Zeroed block-columns leave fewer live blocks than k: the zero-energy
    ties must resolve to the same (lowest) block ids as ``lax.top_k``."""
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    for c in zero_cols:
        w[:, c * bn:(c + 1) * bn] = 0.0
    w[: bk, :] *= 0.0  # one dead block-row too
    jf = jc.pack_dense(jnp.asarray(w), bk, bn, k)
    f = tc.pack_dense(torch.as_tensor(w), bk, bn, k)
    np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
    np.testing.assert_array_equal(f.values.numpy(), np.asarray(jf.values))
    np.testing.assert_array_equal(f.todense().numpy(), np.asarray(jf.todense()))
    assert tc._max_blocks_per_outcol(torch.as_tensor(w), bk, bn) == jc._max_blocks_per_outcol(
        jnp.asarray(w), bk, bn
    )


@pytest.mark.parametrize(
    "a_shape,transpose,n_factors,k_resid",
    [((32, 96), False, 3, None), ((48, 48), True, 4, None), ((64, 128), False, 3, (5, 3))],
)
def test_compress_spec_matches_reference(a_shape, transpose, n_factors, k_resid):
    args = (a_shape, transpose, n_factors, 8, 8, 2, 3, k_resid, 11, 13)
    spec, jspec = tc._compress_spec(*args), jc._compress_spec(*args)
    for mine, ref in ((spec.factor_projs, jspec.factor_projs), (spec.resid_projs, jspec.resid_projs)):
        assert [(p.kind, p.params) for p in mine] == [(p.kind, p.params) for p in ref]
    assert spec.inner_dims == jspec.inner_dims
    assert (spec.n_iter_two, spec.n_iter_global) == (jspec.n_iter_two, jspec.n_iter_global)


@pytest.mark.parametrize("transpose", [False, True])
def test_faust_to_blockfaust_matches_reference(transpose):
    rng = np.random.default_rng(5)
    # block-sparse dense factors with some whole blocks zero
    shapes = [(32, 48), (32, 32)]
    mats = []
    for m, n in shapes:
        s = rng.standard_normal((m, n)).astype(np.float32)
        s[rng.random((m // 8, n // 8)).repeat(8, 0).repeat(8, 1) < 0.5] = 0.0
        mats.append(s)
    jfaust = JFaust(tuple(jnp.asarray(s) for s in mats), jnp.asarray(1.5, jnp.float32))
    faust = bridge.faust_from_numpy(faust_dict(jfaust), device=CPU)
    in_f, out_f = (45, 30) if transpose else (30, 45)
    jbf = jc._faust_to_blockfaust(jfaust, transpose, 8, 8, in_f, out_f)
    bf = tc._faust_to_blockfaust(faust, transpose, 8, 8, in_f, out_f)
    for f, jf in zip(bf.factors, jbf.factors):
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
        np.testing.assert_array_equal(f.values.numpy(), np.asarray(jf.values))
        assert (f.in_features, f.out_features) == (jf.in_features, jf.out_features)


def test_bridge_round_trips():
    jbf = jax_chain((40, 72, 56), 16, 3)
    bf = bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU)
    again = bridge.blockfaust_from_numpy(bridge.to_numpy(bf), device=CPU)
    for f, g in zip(bf.factors, again.factors):
        assert torch.equal(f.values, g.values) and torch.equal(f.in_idx, g.in_idx)
    assert float(again.lam) == float(bf.lam) == 0.75

    pc = tc.pack_chain(bf)
    pc2 = bridge.packed_from_numpy(bridge.to_numpy(pc), device=CPU)
    assert pc2.plan == pc.plan and torch.equal(pc2.values, pc.values)

    # bf16 crosses as uint16 bit views, bit-exact both ways
    jpc16 = jc.pack_chain(jax_chain((40, 72, 56), 16, 3, dtype=jnp.bfloat16))
    pc16 = bridge.packed_from_numpy(packed_dict(jpc16), device=CPU)
    assert pc16.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pc16.values.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jpc16.values).view(np.uint16),
    )
    d16 = bridge.to_numpy(pc16)
    assert d16["dtype"] == "bfloat16"
    np.testing.assert_array_equal(d16["values"], np.asarray(jpc16.values).view(np.uint16))

    f = Faust((torch.ones(3, 2), torch.eye(3)), torch.tensor(2.0))
    f2 = bridge.faust_from_numpy(bridge.to_numpy(f), device=CPU)
    assert torch.equal(f2.todense(), f.todense())


def test_bridge_rejects_out_of_range_blocks():
    d = blockfaust_dict(jax_chain((40, 72), 16, 3))
    d["factors"][0]["in_idx"] = d["factors"][0]["in_idx"].copy()
    d["factors"][0]["in_idx"][0, 0] = 99
    with pytest.raises(ValueError, match="in_idx outside"):
        bridge.blockfaust_from_numpy(d, device=CPU)


def test_faust_matches_reference():
    """The optimization-side ``Faust``: dense, apply, adjoint apply, counts."""
    rng = np.random.default_rng(9)
    mats = [rng.standard_normal(s).astype(np.float32) for s in ((12, 20), (16, 12), (8, 16))]
    mats[1][mats[1] < 0.3] = 0.0
    jf = JFaust(tuple(jnp.asarray(m) for m in mats), jnp.asarray(0.5, jnp.float32))
    f = bridge.faust_from_numpy(faust_dict(jf), device=CPU)
    from repro.core.faust import faust_flops as j_flops
    from repro_torch.core.faust import faust_flops

    assert f.shape == jf.shape == (8, 20) and f.s_tot == jf.s_tot
    assert faust_flops(f, 7) == j_flops(jf, 7) and f.rcg() == pytest.approx(jf.rcg())
    # 1e-5: the same f32 products, summed in another order
    np.testing.assert_allclose(f.todense().numpy(), np.asarray(jf.todense()), rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    np.testing.assert_allclose(f.apply(torch.as_tensor(x)).numpy(), np.asarray(jf.apply(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    np.testing.assert_allclose(f.apply_t(torch.as_tensor(y)).numpy(), np.asarray(jf.apply_t(jnp.asarray(y))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.T.todense().numpy(), np.asarray(jf.T.todense()), rtol=1e-5, atol=1e-5)
