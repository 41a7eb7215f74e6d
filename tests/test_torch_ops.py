"""Parity of the port's kernel-level entry points (``repro_torch.kernels``)
with the JAX reference on the CPU, where the kernel wrappers run their
plain versions.

Tolerances: f32 paths ≤ 1e-5 of max|y| (the reference's own forward and
grad tolerance, ``tests/test_chain.py``; both sides sum the same f32
products in another order); bf16 3e-2 (the reference's bf16 bound: the
port rounds values and activations to bf16 between factors, the JAX
reference promotes against f32 values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FaustOp as JOp
from repro.core import compress as jc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain
from torch_parity import blockfaust_dict, jax_chain, packed_dict, rel_max_err, to_np

CPU = "cpu"
F32_TOL, BF16_TOL = 1e-5, 3e-2  # relative to max|y|; reasons in the module docstring

CHAINS = {
    1: ((40, 72), 16, 3),
    2: ((40, 72, 56), 16, 3),
    4: ((200, 300, 260, 330, 150), 128, 2),
}


def _x(batch, width, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, width)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_factors", [1, 2, 4])
def test_packed_chain_apply_matches_reference(n_factors, dtype):
    dims, blk, k = CHAINS[n_factors]
    jpc = jc.pack_chain(jax_chain(dims, blk, k, seed=n_factors))
    pc = bridge.packed_from_numpy(packed_dict(jpc), device=CPU)
    x = _x(7, dims[0])  # odd batch, ragged features
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    tdt = getattr(torch, dtype)

    y = ops.packed_chain_apply(torch.as_tensor(x).to(tdt), pc)
    assert y.dtype == tdt and y.shape == (7, dims[-1])
    # the step oracle on the padded input, sliced, times λ
    xp = np.pad(x, ((0, 0), (0, jpc.plan.in_blocks[0] * blk - dims[0])))
    oracle = float(jpc.lam) * np.asarray(
        jref.packed_chain_ref(jnp.asarray(xp), jpc.values, jpc.in_idx, jpc.plan)
    )[:, : dims[-1]]
    assert rel_max_err(to_np(y), oracle) <= tol  # f32: summation order; bf16: rounding between factors
    jy = JOp.from_packed(jpc).apply(jnp.asarray(x), backend="fused", use_kernel=False)
    assert rel_max_err(to_np(y), np.asarray(jy)) <= tol
    # the kernel wrapper on a CPU tensor is its plain version, bit for bit
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    xt = torch.as_tensor(xp).to(tdt)
    assert torch.equal(
        chain_matmul(xt, pc.values.to(tdt), meta, plan=pc.plan),
        chain_matmul_plain(xt, pc.values.to(tdt), meta, plan=pc.plan),
    )


@pytest.mark.parametrize("n_factors", [1, 2, 4])
def test_blockfaust_apply_and_adjoint_match_reference(n_factors):
    dims, blk, k = CHAINS[n_factors]
    jbf = jax_chain(dims, blk, k, seed=10 + n_factors)
    bf = bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU)
    x = _x(5, dims[0], seed=2)
    y = ops.blockfaust_apply(torch.as_tensor(x), bf)
    jy = jops.blockfaust_apply(jnp.asarray(x), jbf, use_kernel=False)
    assert rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
    xt = _x(5, dims[-1], seed=3)
    yt = ops.blockfaust_apply_t(torch.as_tensor(xt), bf)
    jyt = jops.blockfaust_apply_t(jnp.asarray(xt), jbf)
    assert rel_max_err(to_np(yt), np.asarray(jyt)) <= F32_TOL
    # single factor with leading batch dims
    f, jf = bf.factors[0], jbf.factors[0]
    x3 = _x(6, dims[0], seed=4).reshape(2, 3, dims[0])
    y3 = ops.bsr_apply(torch.as_tensor(x3), f)
    jy3 = jops.bsr_apply(jnp.asarray(x3), jf, use_kernel=False)
    assert y3.shape == (2, 3, dims[1])
    assert rel_max_err(to_np(y3), np.asarray(jy3)) <= F32_TOL


def _bsr_case(seed=0, o=3, k=2, bk=8, bn=16, n_in=4, batch=5):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.permutation(n_in)[:k] for _ in range(o)]), 1).astype(np.int32)
    values = rng.standard_normal((o, k, bk, bn)).astype(np.float32)
    x = rng.standard_normal((batch, n_in * bk)).astype(np.float32)
    dy = rng.standard_normal((batch, o * bn)).astype(np.float32)
    return x, values, idx, dy


@pytest.mark.parametrize("route", ["function", "bsr_apply"])
def test_bsr_grad_matches_reference_autodiff(route):
    """The kernel path's autograd.Function (its backward is the plain
    ``bsr_matmul_dx``/``_dvalues``, as the reference's custom VJP) and the
    plain path's autograd both equal JAX autodiff of ``bsr_matmul_ref``."""
    x, values, idx, dy = _bsr_case()
    jdx, jdv = jax.grad(
        lambda a, v: jnp.sum(jref.bsr_matmul_ref(a, v, jnp.asarray(idx)) * dy), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(values))
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.tensor(values, requires_grad=True)
    it = torch.as_tensor(idx)
    if route == "function":
        y = ops._BsrKernel.apply(xt, vt, it)
    else:
        from repro_torch.core.compress import BlockSparseFactor

        y = ops.bsr_apply(xt, BlockSparseFactor(vt, it, x.shape[1], values.shape[0] * 16))
    (y * torch.as_tensor(dy)).sum().backward()
    # 1e-5: the reference's grad bound; same f32 products, other summation order
    assert rel_max_err(to_np(xt.grad), np.asarray(jdx)) <= F32_TOL
    assert rel_max_err(to_np(vt.grad), np.asarray(jdv)) <= F32_TOL


def test_bsr_dx_dvalues_match_reference():
    x, values, idx, dy = _bsr_case(seed=1, bk=16, bn=8)
    dx = ref.bsr_matmul_dx(torch.as_tensor(dy), torch.as_tensor(values), torch.as_tensor(idx), x.shape[1])
    jdx = jref.bsr_matmul_dx(jnp.asarray(dy), jnp.asarray(values), jnp.asarray(idx), x.shape[1])
    assert rel_max_err(to_np(dx), np.asarray(jdx)) <= F32_TOL
    dv = ref.bsr_matmul_dvalues(torch.as_tensor(x), torch.as_tensor(dy), torch.as_tensor(idx), (16, 8))
    jdv = jref.bsr_matmul_dvalues(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(idx), (16, 8))
    assert rel_max_err(to_np(dv), np.asarray(jdv)) <= F32_TOL
    # the wrapper on CPU tensors is the plain version
    xt, vt, it = torch.as_tensor(x), torch.as_tensor(values), torch.as_tensor(idx)
    assert torch.equal(bsr_matmul(xt, vt, it), bsr_matmul_plain(xt, vt, it))


def test_use_kernel_on_cpu_raises():
    x, values, idx, _ = _bsr_case()
    from repro_torch.core.compress import BlockSparseFactor

    f = BlockSparseFactor(torch.as_tensor(values), torch.as_tensor(idx), x.shape[1], 48)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bsr_apply(torch.as_tensor(x), f, use_kernel=True)
