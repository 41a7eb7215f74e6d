"""Parity of the port's fused chain backward (``repro_torch.kernels.chain_bwd``
and the autograd Functions of ``repro_torch.kernels.ops``) with the JAX
reference on the CPU, where K2/K3/K5's wrappers run their plain versions
through the same Functions and step tables the card uses.

Tolerances: the step tables are equal exactly.  f32 gradients ≤ 1e-5 of
max|g|, the reference's own ``tests/test_chain_bwd.py`` bound (the same f32
products summed in another order).  The reference's Pallas interpret path
does not run on this tree's jax (ROADMAP caveat R1), so the oracles are
``chain_bwd_ref`` and ``jax.grad`` of ``packed_chain_apply(use_kernel=False)``,
the autodiff the reference's kernels are held against.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.kernels import chain_bwd as jbwd
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.api import FaustOp, last_report
from repro_torch.core.compress import (
    BlockFaust,
    BlockSparseFactor,
    expand_scales,
    quantize_chain,
    unpack_chain,
)
from repro_torch.kernels import chain_bwd, ops
from repro_torch.layers.faust_linear import FaustLinear, FaustSpec
from repro_torch.optim import adamw
from torch_parity import jax_chain, packed_dict, rel_max_err, to_np

CPU = "cpu"
F32_TOL = 1e-5  # relative to max|g|; reason in the module docstring
# ragged at every boundary (block 16), and one chain of 128-blocks
CHAINS = {
    1: ((40, 72), 16, 3),
    2: ((40, 72, 56), 16, 3),
    3: ((40, 72, 56, 90), 16, 2),
    4: ((200, 300, 260, 330, 150), 128, 2),
}
QFORMS = [(d, s) for d in ("int8", "fp8_e4m3", "fp8_e5m2") for s in ("per_block", "per_row")]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _chains(n_factors):
    dims, blk, k = CHAINS[n_factors]
    jpc = jc.pack_chain(jax_chain(dims, blk, k, seed=10 + n_factors))
    return dims, jpc, bridge.packed_from_numpy(packed_dict(jpc), device=CPU)


@pytest.mark.parametrize("n_factors", [1, 2, 3, 4])
def test_step_tables_match_reference(n_factors):
    _, jpc, pc = _chains(n_factors)
    plan, idx = jpc.plan, np.asarray(jpc.in_idx)
    s_pre = plan.offsets[plan.n_factors - 1]
    want_d = np.concatenate([idx[::-1, None], jbwd._dgrad_meta_static(plan)], axis=1)
    want_w = np.concatenate(
        [np.concatenate([idx[:s_pre], idx[::-1]])[:, None], jbwd._wgrad_meta_static(plan)], axis=1
    )
    got_d = chain_bwd.dgrad_meta(pc.plan, pc.in_idx)
    got_w = chain_bwd.wgrad_meta(pc.plan, pc.in_idx)
    assert got_d.dtype == got_w.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_w.numpy(), want_w)


@pytest.mark.parametrize("n_factors", [1, 2, 3, 4])
def test_plain_backward_matches_chain_bwd_ref(n_factors):
    """``chain_bwd_ref`` (leading batch dims) and the kernels' plain versions
    (through the step tables) against the reference's oracle."""
    _, jpc, pc = _chains(n_factors)
    plan = pc.plan
    x = _rand((3, 5, plan.in_blocks[0] * plan.block), n_factors)
    dy = _rand((3, 5, plan.out_blocks[-1] * plan.block), 100 + n_factors)
    jdx, jdv = jbwd.chain_bwd_ref(jnp.asarray(x), jpc.values, jpc.in_idx, jnp.asarray(dy), plan=jpc.plan)
    dx, dv = chain_bwd.chain_bwd_ref(torch.as_tensor(x), pc.values, pc.in_idx, torch.as_tensor(dy), plan=plan)
    assert dx.shape == x.shape and dv.shape == pc.values.shape
    assert rel_max_err(to_np(dx), np.asarray(jdx)) <= F32_TOL
    assert rel_max_err(to_np(dv), np.asarray(jdv)) <= F32_TOL
    x2, dy2 = torch.as_tensor(x.reshape(15, -1)), torch.as_tensor(dy.reshape(15, -1))
    dx2 = chain_bwd.chain_dgrad(dy2, pc.values, chain_bwd.dgrad_meta(plan, pc.in_idx), plan=plan)
    dv2 = chain_bwd.chain_wgrad(x2, dy2, pc.values, chain_bwd.wgrad_meta(plan, pc.in_idx), plan=plan)
    assert dv2.dtype == torch.float32
    assert rel_max_err(to_np(dx2), np.asarray(jdx).reshape(15, -1)) <= F32_TOL
    assert rel_max_err(to_np(dv2), np.asarray(jdv)) <= F32_TOL


def _jax_grads(jpc, x, w, leaf):
    """jax.grad of Σ w·packed_chain_apply(use_kernel=False) wrt x and
    ``leaf`` ("values" or "scales") of the reference chain."""
    def loss(xx, t):
        pc = dataclasses.replace(jpc, **{leaf: t})
        return jnp.sum(jnp.asarray(w) * jops.packed_chain_apply(xx, pc, use_kernel=False))

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), getattr(jpc, leaf))


@pytest.mark.parametrize("n_factors", [1, 2, 3, 4])
def test_fused_grads_match_jax_grad(n_factors):
    dims, jpc, pc = _chains(n_factors)
    x = _rand((2, 7, dims[0]), n_factors)  # leading batch dims, odd batch, ragged features
    w = _rand((2, 7, dims[-1]), 50 + n_factors)
    jdx, jdv = _jax_grads(jpc, x, w, "values")
    xt = torch.as_tensor(x).requires_grad_(True)
    vt = pc.values.clone().requires_grad_(True)
    y = ops.packed_chain_apply(xt, dataclasses.replace(pc, values=vt))
    (y * torch.as_tensor(w)).sum().backward()
    assert rel_max_err(to_np(xt.grad), np.asarray(jdx)) <= F32_TOL
    assert rel_max_err(to_np(vt.grad), np.asarray(jdv)) <= F32_TOL


@pytest.mark.parametrize("qdtype,scheme", QFORMS)
@pytest.mark.parametrize("n_factors", [2, 4])
def test_quantized_fused_grads_match_jax_grad(n_factors, qdtype, scheme):
    """K5's Function: dx, and dscales = Σ_c q·dv (reduced over the block
    for per_block scales), against jax.grad of the reference's quantized
    plain path; the codes get no gradient."""
    dims, jpc, pc = _chains(n_factors)
    jq = jc.quantize_chain(jpc, qdtype, scheme)
    q = quantize_chain(pc, qdtype, scheme)
    x = _rand((9, dims[0]), n_factors)
    w = _rand((9, dims[-1]), 60 + n_factors)
    jdx, jds = _jax_grads(jq, x, w, "scales")
    xt = torch.as_tensor(x).requires_grad_(True)
    st = q.scales.clone().requires_grad_(True)
    y = ops.packed_chain_apply(xt, dataclasses.replace(q, scales=st))
    (y * torch.as_tensor(w)).sum().backward()
    assert st.grad.shape == q.scales.shape
    assert rel_max_err(to_np(xt.grad), np.asarray(jdx)) <= F32_TOL
    assert rel_max_err(to_np(st.grad), np.asarray(jds)) <= F32_TOL


@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
def test_quantized_bsr_and_dense_give_scale_grads(scheme):
    """Hazard: ``bsr``/``dense`` on a quantized leaf used a cached f32
    unpack, so a scale that requires grad got none.  Under autograd they
    unpack per call, and every backend gives the fused path's dscales."""
    _, _, pc = _chains(3)
    q = quantize_chain(pc, "int8", scheme)
    x = torch.as_tensor(_rand((6, 40), 3))
    grads = {}
    for backend in ("fused", "bsr", "dense"):
        st = q.scales.clone().requires_grad_(True)
        op = FaustOp.from_packed(dataclasses.replace(q, scales=st), device=CPU)
        with torch.no_grad():
            op.apply(x, backend, device=CPU)  # an inference apply first: fills the cache
        op.apply(x, backend, device=CPU).square().sum().backward()
        assert st.grad is not None, backend
        grads[backend] = to_np(st.grad)
    for backend in ("bsr", "dense"):
        assert rel_max_err(grads[backend], grads["fused"]) <= 1e-4  # the dense product re-associates


def _param_chain(n_factors=3):
    """A BlockFaust whose values and λ are parameters."""
    bf = unpack_chain(_chains(n_factors)[2])
    factors = tuple(
        BlockSparseFactor(torch.nn.Parameter(f.values.clone()), f.in_idx, f.in_features, f.out_features)
        for f in bf.factors
    )
    return BlockFaust(factors, torch.nn.Parameter(torch.tensor(0.75)))


@pytest.mark.parametrize("backend", ["fused", "bsr", "dense"])
def test_held_operator_sees_an_optimizer_step(backend):
    """Hazard: the fused layout was packed once per operator (a copy), so an
    operator held across optimizer steps applied stale, detached values.
    It now trains its live parameters and sees every in-place step."""
    bf = _param_chain()
    op = FaustOp.from_blockfaust(bf, device=CPU)
    x = torch.as_tensor(_rand((5, 40), 7))
    with torch.no_grad():
        op.apply(x, backend, device=CPU)  # fills the no-grad cache
    params = {f"v{i}": f.values for i, f in enumerate(bf.factors)} | {"lam": bf.lam}
    loss = op.apply(x, backend, device=CPU).square().sum()
    loss.backward()
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in params.values())
    adamw.apply_updates(adamw.AdamWConfig(lr=1e-2, warmup_steps=0), params,
                        {k: p.grad for k, p in params.items()}, adamw.init_state(params))
    with torch.no_grad():
        want = x @ bf.todense()
        got = op.apply(x, backend, device=CPU)  # the no-grad cache is rebuilt
    assert rel_max_err(to_np(got), to_np(want)) <= 1e-4, "stale values after an optimizer step"
    got = op.apply(x, backend, device=CPU)  # under autograd: from the live values
    assert rel_max_err(to_np(got), to_np(want)) <= 1e-4


def test_faust_linear_second_forward_sees_the_step():
    layer = FaustLinear(40, 56, FaustSpec(2, 16, 2), generator=torch.Generator().manual_seed(0), device=CPU)
    x = torch.as_tensor(_rand((4, 40), 8))
    y1 = layer(x, "fused")
    y1.square().sum().backward()
    params = dict(layer.named_parameters())
    adamw.apply_updates(adamw.AdamWConfig(lr=1e-2, warmup_steps=0), params,
                        {k: p.grad for k, p in params.items()}, adamw.init_state(params))
    y2 = layer(x, "fused")
    want = x @ layer.blockfaust().todense().detach()
    assert rel_max_err(to_np(y2), to_np(want)) <= 1e-4
    assert rel_max_err(to_np(y1), to_np(y2)) > 1e-4  # the step moved the output


def test_apply_detects_a_training_apply():
    bf = _param_chain(2)
    op = FaustOp.from_blockfaust(bf, device=CPU)
    x = torch.as_tensor(_rand((3, 40), 9))
    with torch.no_grad():
        op.apply(x, device=CPU)
    assert last_report().grad is False
    op.apply(x, device=CPU)  # the values require grad
    assert last_report().grad is True and last_report().as_row()["grad"] is True
    op.apply(x, device=CPU, grad=False)
    assert last_report().grad is False
    frozen = FaustOp.from_packed(_chains(2)[2], device=CPU)
    frozen.apply(x, device=CPU)
    assert last_report().grad is False
    frozen.apply(x.requires_grad_(True), device=CPU)
    assert last_report().grad is True


def test_quantized_codes_get_no_gradient():
    _, _, pc = _chains(2)
    q = quantize_chain(pc, "fp8_e4m3", "per_block")
    st = q.scales.clone().requires_grad_(True)
    x = torch.as_tensor(_rand((4, 40), 2))
    ops.packed_chain_apply(x, dataclasses.replace(q, scales=st)).sum().backward()
    assert st.grad is not None and not q.values.requires_grad
    assert torch.equal(expand_scales(st, 16), expand_scales(q.scales, 16))
