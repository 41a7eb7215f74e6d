"""Operator composition in the port (``op2 @ op1``, ``x @ op``, ``op @ x``,
``.T``/``.H`` through composites, ``block_diag``/``vstack``/``hstack``,
``rel_error_spec``) against the JAX reference on the CPU, on leaves built
from the same numpy arrays.

Tolerance: applies ≤ 1e-5 of max|y| against the reference's
``apply(backend="dense"|"bsr")`` (f32 products summed in another order);
the reference's fused path is not run (ROADMAP's reference caveat R1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FaustOp as JOp
from repro.api import block_diag as jblock_diag
from repro.api import hstack as jhstack
from repro.api import vstack as jvstack
from repro.core.faust import Faust as JFaust
from repro_torch import bridge
from repro_torch.api import FaustOp, block_diag, hstack, last_report, vstack
from repro_torch.core.faust import Faust
from repro_torch.kernels import ops as kops
from torch_parity import blockfaust_dict, faust_dict, jax_chain, rel_max_err, to_np

CPU = "cpu"
F32_TOL = 1e-5


def _pair_block(dims, seed, blk=8, k=2):
    jbf = jax_chain(dims, blk, k, seed=seed)
    return JOp.from_blockfaust(jbf), FaustOp.from_blockfaust(bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU), device=CPU)


def _pair_faust(dims, seed):
    """A dense-factor leaf with ``todense`` of shape (dims[-1], dims[0])."""
    rng = np.random.default_rng(seed)
    factors = tuple(rng.standard_normal((b, a)).astype(np.float32) / np.sqrt(a)
                    for a, b in zip(dims[:-1], dims[1:]))
    jf = JFaust(tuple(jnp.asarray(f) for f in factors), jnp.asarray(0.8, jnp.float32))
    return JOp.from_faust(jf), FaustOp.from_faust(bridge.faust_from_numpy(faust_dict(jf), device=CPU), device=CPU)


@pytest.fixture(scope="module")
def leaves():
    """a: 32 → 48 (block), b: 32 → 48 (block), c: 48 → 24 (Faust), p: a packed."""
    ja, a = _pair_block((32, 40, 48), 1)
    jb, b = _pair_block((32, 48, 48), 2)
    jc, c = _pair_faust((24, 36, 48), 3)
    return {"a": (ja, a), "b": (jb, b), "c": (jc, c), "p": (ja.to("packed"), a.to("packed"))}


def _build(name, L, mod):
    """The same composite from the JAX (mod=0) or the port's (mod=1) leaves."""
    a, b, c, p = (L[k][mod] for k in "abcp")
    bd, vs, hs = ((jblock_diag, jvstack, jhstack), (block_diag, vstack, hstack))[mod]
    return {
        "compose": a @ c,  # x @ A @ C: 32 → 48 → 24
        "hstack": hs([a, b, p]),
        "vstack": vs([a, b]),
        "block_diag": bd([a, c, p]),
        "gram": a.T @ a,
        "nested": hs([a @ c, b @ c]).T,
        "adjoint_stack": vs([a, b]).H,
        "deep": (a @ c) @ c.T,  # 32 → 48 → 24 → 48, flattened into one compose
    }[name]


NAMES = ["compose", "hstack", "vstack", "block_diag", "gram", "nested", "adjoint_stack", "deep"]


def _leaf_flags(op):
    if op.kind == "leaf":
        return [(op.adjoint, op.conj)]
    return [op.kind] + [f for c in op.children for f in _leaf_flags(c)]


@pytest.mark.parametrize("backend", ["dense", "bsr", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_composite_apply_matches_reference(leaves, name, backend):
    jop, op = _build(name, leaves, 0), _build(name, leaves, 1)
    assert op.shape == jop.shape and op.s_tot == jop.s_tot and op.n_factors == jop.n_factors
    assert op.rcg == pytest.approx(jop.rcg) and _leaf_flags(op) == _leaf_flags(jop)
    x = np.random.default_rng(5).standard_normal((7, op.shape[0])).astype(np.float32)
    y = op.apply(torch.as_tensor(x), backend, device=CPU)
    for jb in ("dense", "bsr"):
        jy = jop.apply(jnp.asarray(x), backend=jb, use_kernel=False)
        assert y.shape == (7, op.shape[1]) and rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
    assert rel_max_err(to_np(op.todense()), np.asarray(jop.todense())) <= F32_TOL


def test_matmul_sugar_matches_reference(leaves):
    (ja, a), (jc, c) = leaves["a"], leaves["c"]
    jop, op = ja @ jc, a @ c
    rng = np.random.default_rng(6)
    v, cols = rng.standard_normal(24).astype(np.float32), rng.standard_normal((24, 5)).astype(np.float32)
    rows = rng.standard_normal((3, 32)).astype(np.float32)
    # op @ x: todense() @ x, a vector or columns
    assert rel_max_err(to_np(op @ torch.as_tensor(v)), np.asarray(jop @ jnp.asarray(v))) <= F32_TOL
    assert rel_max_err(to_np(op @ torch.as_tensor(cols)), np.asarray(jop @ jnp.asarray(cols))) <= F32_TOL
    # x @ op: the row apply
    assert rel_max_err(to_np(torch.as_tensor(rows) @ op), np.asarray(jnp.asarray(rows) @ jop)) <= F32_TOL
    with pytest.raises(ValueError, match="compose shape mismatch"):
        a @ a
    with pytest.raises(ValueError, match=r"\(n,\) or \(n, b\)"):
        op @ torch.zeros((2, 24, 3))


def test_a_composite_dispatches_each_leaf(leaves, monkeypatch):
    """Each leaf goes through its own dispatch: a fusable leaf runs the
    fused path (K1 on the card), a Faust leaf its own, and a forced
    backend must suit every leaf."""
    a, c = leaves["a"][1], leaves["c"][1]
    calls = []
    real = kops.packed_chain_apply
    monkeypatch.setattr(kops, "packed_chain_apply", lambda *args, **kw: calls.append(1) or real(*args, **kw))
    x = torch.randn(5, 32)
    y = hstack([a, a.to("packed")]).apply(x, "fused", device=CPU)
    assert len(calls) == 2 and y.shape == (5, 96)
    calls.clear()
    (a @ c).apply(x, "auto", device=CPU)
    assert last_report().shape == c.shape  # the last leaf's decision
    with pytest.raises(ValueError, match="not feasible"):
        (a @ c).apply(x, "fused", device=CPU)
    assert (a @ c).dispatch_for(5).shape == c.shape


def test_stacks_validate_shapes_and_conversions(leaves):
    a, b, c = (leaves[k][1] for k in "abc")
    with pytest.raises(ValueError, match="equal output dims"):
        vstack([a, c])
    with pytest.raises(ValueError, match="equal input dims"):
        hstack([a, c.T])
    with pytest.raises(ValueError, match="at least one"):
        block_diag([])
    with pytest.raises(ValueError, match="collapse"):
        block_diag([a, b]).to("faust")
    with pytest.raises(ValueError, match="single representation"):
        vstack([a, b]).feasible_backends()
    # a composition collapses to one chain, as the reference's
    ja, jc = leaves["a"][0], leaves["c"][0]
    f, jf = (a @ c).to("faust"), (ja @ jc).to("faust")
    assert f.n_factors == jf.n_factors and rel_max_err(to_np(f.todense()), np.asarray(jf.todense())) <= F32_TOL
    assert "block_diag(2)" in repr(block_diag([a, b]))


def test_rel_error_spec_matches_reference(leaves):
    ja, a = leaves["a"]
    w = np.random.default_rng(7).standard_normal(a.shape).astype(np.float32)
    mine = float(a.rel_error_spec(torch.as_tensor(w)))
    ref = float(ja.rel_error_spec(jnp.asarray(w)))
    assert mine == pytest.approx(ref, rel=1e-5)  # f32 power iteration, same start and steps
    assert float(a.rel_error_spec(a.todense())) == 0.0


def test_conjugate_adjoint_of_a_complex_leaf():
    """``.H`` conjugates as well as transposes (a complex dense-factor
    leaf); ``.T`` only transposes."""
    g = torch.Generator().manual_seed(0)
    f = tuple(torch.complex(torch.randn(s, generator=g), torch.randn(s, generator=g)) for s in ((6, 5), (4, 6)))
    op = FaustOp.from_faust(Faust(f, torch.tensor(1.0 + 0.5j)), device=CPU)
    dense = op.todense()
    torch.testing.assert_close(op.H.todense(), dense.conj().T)
    torch.testing.assert_close(op.T.todense(), dense.T)
    x = torch.complex(torch.randn(3, 5, generator=g), torch.randn(3, 5, generator=g))
    for backend in ("dense", "bsr"):
        torch.testing.assert_close(op.H.apply(x, backend, device=CPU), x @ dense.conj().T)
        torch.testing.assert_close(hstack([op.H, op.T]).apply(x, backend, device=CPU),
                                   torch.cat([x @ dense.conj().T, x @ dense.T], -1))
    torch.testing.assert_close(op.H.H.todense(), dense)
