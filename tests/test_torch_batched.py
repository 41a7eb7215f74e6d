"""The port's batched factorizer (``palm4msa_batched``, warm starts,
``hierarchical_factorization_batched``, the 3-D ``factorize`` route) on
the CPU: against the port's own sequential solver, and against the JAX
reference on the same numpy arrays.

Tolerances: batched against sequential in the port: relative error
(‖A − λ∏S‖_F / ‖A‖_F) within 1e-7 per matrix, the reference's gate for
this route (``benchmarks/batch_compress.py``), supports equal and values
within the reference's own test of it (rtol 1e-5, atol 1e-6,
``tests/test_palm4msa.py``).  One loop serves both, but a batched BLAS
call need not sum as its batch-of-1 slice does (on the CPU a one-column
``bmm`` does not).  Port against reference: factors ≤ 1e-4 after 5
sweeps and RE ≤ 1e-4 after the hierarchical runs (the same f32 products
summed in another order, compounded by the iteration), supports equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FactorizeSpec as JSpec
from repro.api import factorize as jfactorize
from repro.core import hierarchical as jh
from repro.core import projections as jp
from repro_torch.api import FactorizeSpec, TargetPrep, factorize
from repro_torch.core import hierarchical as th
from repro_torch.core import palm4msa as tpalm
from repro_torch.core import projections as tp
from torch_parity import rel_max_err, to_np

CPU = "cpu"
jpalm = importlib.import_module("repro.core.palm4msa")
SEQ_RE = 1e-7  # batched against sequential in the port: |ΔRE| per matrix
SEQ_RTOL, SEQ_ATOL = 1e-5, 1e-6  # and their values
REF_TOL = 1e-4  # port against reference after 5 sweeps / a hierarchical run
KINDS = (("blockcol", dict(bm=8, bn=8, k_per_col=2)), ("splincol", dict(k=6)))
DIMS = (128, 64, 64)  # a (64, 128): S_1 (64, 128), S_2 (64, 64)


def _stack(b=3, shape=(64, 128), seed=0):
    return np.random.default_rng(seed).standard_normal((b, *shape)).astype(np.float32)


def _start(b, seed=1):
    """Per-matrix S_1 from numpy (S_1 = 0 would make the first projection
    choose among ties), S_2 = Id, λ = 1."""
    s1 = np.random.default_rng(seed).standard_normal((b, DIMS[1], DIMS[0])).astype(np.float32) * 0.1
    eye = np.broadcast_to(np.eye(DIMS[2], DIMS[1], dtype=np.float32), (b, DIMS[2], DIMS[1])).copy()
    return s1, eye


def _projs(mod):
    return tuple(mod.make_proj(k, **kw) for k, kw in KINDS)


def _close(mine, ref, tol):
    np.testing.assert_array_equal(to_np(mine) != 0, np.asarray(ref) != 0)
    assert rel_max_err(to_np(mine), np.asarray(ref)) <= tol


def _same(mine, seq):
    """A batched result against the sequential one: supports equal, values
    within the reference's batched-vs-sequential tolerance."""
    np.testing.assert_array_equal(to_np(mine) != 0, to_np(seq) != 0)
    np.testing.assert_allclose(to_np(mine), to_np(seq), rtol=SEQ_RTOL, atol=SEQ_ATOL)


def _re(a, factors, lam) -> float:
    a = torch.as_tensor(a)
    return float(torch.linalg.norm(a - lam * tpalm.product(factors)) / torch.linalg.norm(a))


@pytest.mark.parametrize("keep_best", [True, False])
def test_batched_palm_equals_sequential(keep_best):
    a = _stack()
    s1, s2 = _start(3)
    res = tpalm.palm4msa_batched(
        torch.as_tensor(a), (torch.as_tensor(s1), torch.as_tensor(s2)), None, _projs(tp), 5,
        keep_best=keep_best,
    )
    assert res.loss_history.shape == (3, 5) and res.lam.shape == (3,)
    for i in range(3):
        one = tpalm.palm4msa(
            torch.as_tensor(a[i]), (torch.as_tensor(s1[i]), torch.as_tensor(s2[i])), None,
            _projs(tp), 5, keep_best=keep_best,
        )
        for s, si in zip(res.factors, one.factors):
            _same(s[i], si)
        assert abs(_re(a[i], [s[i] for s in res.factors], res.lam[i]) - _re(a[i], one.factors, one.lam)) <= SEQ_RE
        np.testing.assert_allclose(to_np(res.loss_history[i]), to_np(one.loss_history), rtol=SEQ_RTOL)


def test_batched_palm_matches_reference():
    a = _stack()
    s1, s2 = _start(3)
    ref = jpalm.palm4msa_batched(jnp.asarray(a), (jnp.asarray(s1), jnp.asarray(s2)), None, _projs(jp), 5)
    mine = tpalm.palm4msa_batched(
        torch.as_tensor(a), (torch.as_tensor(s1), torch.as_tensor(s2)), None, _projs(tp), 5
    )
    for s, js in zip(mine.factors, ref.factors):
        _close(s, js, REF_TOL)
    np.testing.assert_allclose(to_np(mine.lam), np.asarray(ref.lam), rtol=REF_TOL)
    np.testing.assert_allclose(to_np(mine.loss_history), np.asarray(ref.loss_history), rtol=REF_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_warm_start_matches_reference(batched):
    """``init_factors=``/``init_lam=`` resume a solve: 5 cold sweeps, then 5
    warm ones from their result, on both sides."""
    a = _stack(2 if batched else 1)
    s1, s2 = _start(a.shape[0])
    if not batched:
        a, s1, s2 = a[0], s1[0], s2[0]
    jfn = jpalm.palm4msa_batched if batched else jpalm.palm4msa
    tfn = tpalm.palm4msa_batched if batched else tpalm.palm4msa
    cold_j = jfn(jnp.asarray(a), (jnp.asarray(s1), jnp.asarray(s2)), None, _projs(jp), 5)
    cold_t = tfn(torch.as_tensor(a), (torch.as_tensor(s1), torch.as_tensor(s2)), None, _projs(tp), 5)
    warm_j = jfn(jnp.asarray(a), projs=_projs(jp), n_iter=5, init_factors=cold_j.factors,
                 init_lam=cold_j.lam, init_feasible=True)
    warm_t = tfn(torch.as_tensor(a), projs=_projs(tp), n_iter=5, init_factors=cold_t.factors,
                 init_lam=cold_t.lam, init_feasible=True)
    for s, js in zip(warm_t.factors, warm_j.factors):
        _close(s, js, REF_TOL)
    np.testing.assert_allclose(to_np(warm_t.lam), np.asarray(warm_j.lam), rtol=REF_TOL)
    # a warm start from a feasible point never ends worse than it began
    assert np.all(to_np(warm_t.loss_history).min(-1) <= to_np(cold_t.loss_history).min(-1) * (1 + 1e-6))


def test_init_spellings_are_exclusive():
    a = torch.zeros((8, 8))
    f = (torch.eye(8), torch.eye(8))
    p = (tp.make_proj("id"), tp.make_proj("id"))
    with pytest.raises(ValueError, match="exactly one"):
        tpalm.palm4msa(a, f, projs=p, init_factors=f)
    with pytest.raises(ValueError, match="exactly one"):
        tpalm.palm4msa(a, projs=p)
    with pytest.raises(ValueError, match="init_lam"):
        tpalm.palm4msa(a, f, projs=p, init_lam=1.0)
    with pytest.raises(ValueError, match="init_lam="):
        tpalm.palm4msa(a, None, 2.0, p, init_factors=f)
    with pytest.raises(ValueError, match=r"\(B, m, n\)"):
        tpalm.palm4msa_batched(a, f, projs=p)


def test_palm4msa_faust_matches_reference():
    a = _stack(1, (32, 48))[0]
    projs = lambda mod: (mod.make_proj("col", k=6), mod.make_proj("global", k=400))  # noqa: E731
    jf, jhist = jpalm.palm4msa_faust(jnp.asarray(a), (48, 32, 32), projs(jp), 5)
    tf, thist = tpalm.palm4msa_faust(torch.as_tensor(a), (48, 32, 32), projs(tp), 5)
    for s, js in zip(tf.factors, jf.factors):
        _close(s, js, REF_TOL)
    np.testing.assert_allclose(to_np(thist), np.asarray(jhist), rtol=REF_TOL)


def _spec(h, P, n_iter=5):
    """A J = 3 block schedule on (64, 128): block 8, blockcol budgets."""
    return h.HierarchicalSpec(
        (P.make_proj("blockcol", bm=8, bn=8, k_per_col=3), P.make_proj("blockcol", bm=8, bn=8, k_per_col=2)),
        (P.make_proj("blockcol", bm=8, bn=8, k_per_col=4), P.make_proj("blockcol", bm=8, bn=8, k_per_col=3)),
        (64, 64), n_iter_two=n_iter, n_iter_global=n_iter,
    )


def test_batched_hierarchical_equals_sequential_and_reference():
    a = _stack(3)
    fausts, info = th.hierarchical_factorization_batched(torch.as_tensor(a), _spec(th, tp))
    jfausts, jinfo = jh.hierarchical_factorization_batched(jnp.asarray(a), _spec(jh, jp))
    assert len(fausts) == 3 and info.n_sweeps == jinfo.n_sweeps == 2 * 2 * 5
    for i, (f, jf) in enumerate(zip(fausts, jfausts)):
        seq, _ = th.hierarchical_factorization(torch.as_tensor(a[i]), _spec(th, tp))
        for s, ss, js in zip(f.factors, seq.factors, jf.factors):
            _same(s, ss)
            _close(s, js, REF_TOL)
        re = float(f.rel_error_fro(torch.as_tensor(a[i])))
        assert abs(re - float(seq.rel_error_fro(torch.as_tensor(a[i])))) <= SEQ_RE
        jre = float(jf.rel_error_fro(jnp.asarray(a[i])))
        assert abs(re - jre) <= REF_TOL
    for mine, ref in zip(info.global_losses, jinfo.global_losses):
        np.testing.assert_allclose(mine, np.asarray(ref), rtol=REF_TOL)


def test_cache_stats_count_buckets_as_the_reference():
    """A miss is a bucket's first solve in the process, a hit a later one;
    two runs of the same shapes and specs: the second is all hits."""
    a = _stack(2)
    th.reset_trace_cache()
    jh.reset_trace_cache()
    for _ in range(2):
        _, info = th.hierarchical_factorization_batched(torch.as_tensor(a), _spec(th, tp))
        _, jinfo = jh.hierarchical_factorization_batched(jnp.asarray(a), _spec(jh, jp))
        assert (info.cache.hits, info.cache.misses, info.cache.sweeps) == (
            jinfo.cache.hits, jinfo.cache.misses, jinfo.cache.sweeps)
    _, info = th.hierarchical_factorization(torch.as_tensor(a[0]), _spec(th, tp))
    assert info.cache.misses == 4 and info.cache.hits == 0  # sequential buckets are their own
    stats = th.trace_cache_stats()
    assert (stats.hits, stats.misses, stats.total) == (4, 8, 12)
    th.reset_trace_cache()
    assert th.trace_cache_stats().total == 0


@pytest.mark.parametrize("shape", [(48, 80), (80, 40)])
def test_batched_block_route_matches_reference(shape):
    """``factorize`` on a 3-D stack: one operator per matrix (the returned
    op is their block_diag), the same packed supports and RE as the
    reference's batched route, and each matrix as the port's own 2-D
    route."""
    ws = _stack(3, shape, seed=4)
    kw = dict(n_factors=3, block=8, k_first=2, k_mid=2, n_iter_two=5, n_iter_global=5)
    op, info = factorize(ws, FactorizeSpec(**kw), device=CPU)
    jop, jinfo = jfactorize(jnp.asarray(ws), JSpec(**kw))
    assert info.batched and jinfo.batched and len(info.ops) == 3
    assert op.kind == "block_diag" and op.shape == jop.shape == (3 * shape[0], 3 * shape[1])
    assert info.prep == TargetPrep(jinfo.prep.transpose, jinfo.prep.pad_in, jinfo.prep.pad_out)
    assert info.n_sweeps == jinfo.n_sweeps
    for i, (o, jo) in enumerate(zip(info.ops, jinfo.ops)):
        for f, jf in zip(o.rep.factors, jo.rep.factors):
            np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
        w = ws[i]
        assert abs(float(o.rel_error_fro(torch.as_tensor(w))) - float(jo.rel_error_fro(jnp.asarray(w)))) <= REF_TOL
        single, _ = factorize(w, FactorizeSpec(**kw), device=CPU)
        for f, sf in zip(o.rep.factors, single.rep.factors):
            assert torch.equal(f.in_idx, sf.in_idx)
            _same(f.values, sf.values)
        w_t = torch.as_tensor(w)
        assert abs(float(o.rel_error_fro(w_t)) - float(single.rel_error_fro(w_t))) <= SEQ_RE
    np.testing.assert_allclose(to_np(op.todense()), np.asarray(jop.todense()), atol=REF_TOL)


def test_batched_flag_is_validated():
    w = _stack(2, (16, 16))
    spec = dict(n_factors=2, block=8, n_iter_two=1, n_iter_global=1)
    with pytest.raises(ValueError, match="batched=True"):
        factorize(w[0], FactorizeSpec(batched=True, **spec), device=CPU)
    with pytest.raises(ValueError, match="batched=False"):
        factorize(w, FactorizeSpec(batched=False, **spec), device=CPU)
    with pytest.raises(ValueError, match=r"\(m, n\) or \(B, m, n\)"):
        factorize(w[0, 0], FactorizeSpec(**spec), device=CPU)
    _, info = factorize(w, FactorizeSpec(batched=True, **spec), device=CPU)
    assert info.batched and len(info.ops) == 2


def test_target_prep_pads_and_transposes():
    w = torch.arange(12.0).reshape(3, 4)
    prep = TargetPrep(True, 1, 0)
    out = prep.apply(w)
    assert out.shape == (4, 4) and torch.equal(out[:, :3], w.T) and torch.all(out[:, 3] == 0)
    assert torch.equal(TargetPrep().apply(w), w)


def test_two_factor_init_batched_matches_reference():
    t = _stack(2, (16, 24))
    for d, init in ((24, "warm"), (16, "warm"), (20, "warm"), (20, "paper_default")):
        (s0, t0), lam = th._two_factor_init_batched(torch.as_tensor(t), d, init)
        (js0, jt0), jlam = jh._two_factor_init_batched(jnp.asarray(t), d, init)
        np.testing.assert_array_equal(to_np(s0), np.asarray(js0))
        np.testing.assert_array_equal(to_np(t0), np.asarray(jt0))
        np.testing.assert_array_equal(to_np(lam), np.asarray(jlam))


def test_palm_route_batched_matches_reference():
    """``strategy="palm4msa"`` on a stack: the flat solve per matrix."""
    a = _stack(2, (32, 48), seed=5)
    kinds = (("col", dict(k=6)), ("global", dict(k=400)))
    spec = lambda mod, S: S(strategy="palm4msa", projs=tuple(mod.make_proj(k, **kw) for k, kw in kinds),  # noqa: E731
                            dims=(48, 32, 32), n_iter=5)
    op, info = factorize(a, spec(tp, FactorizeSpec), device=CPU)
    jop, jinfo = jfactorize(jnp.asarray(a), spec(jp, JSpec))
    assert info.loss_history.shape == (2, 5) and info.n_sweeps == jinfo.n_sweeps == 5
    np.testing.assert_allclose(to_np(info.loss_history), np.asarray(jinfo.loss_history), rtol=REF_TOL)
    for f, jf in zip(info.fausts, jinfo.fausts):
        for s, js in zip(f.factors, jf.factors):
            _close(s, js, REF_TOL)
    np.testing.assert_allclose(to_np(op.todense()), np.asarray(jop.todense()), atol=REF_TOL)
