"""The port's remaining projections, sparse coding (``core/dictionary.py``)
and the ``meg`` / ``palm4msa`` / ``dictionary`` strategies against the JAX
reference on the CPU, on the same numpy arrays.

Tolerances: projections are selections, so supports are equal and values
within rtol 1e-6 / atol 1e-7 (one f32 renormalization apart); OMP's
supports equal and its least-squares codes within 1e-5 of max|Γ|; the
other solvers and the patch utilities within 1e-5 (f32 sums in another
order); factorizations after 5 sweeps (or a hierarchical run of them)
within 1e-4 and equal supports, as ``test_torch_batched.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FactorizeSpec as JSpec
from repro.api import factorize as jfactorize
from repro.core import dictionary as jd
from repro.core import hierarchical as jh
from repro.core import projections as jp
from repro_torch.api import FactorizeSpec, factorize
from repro_torch.core import dictionary as td
from repro_torch.core import hierarchical as th
from repro_torch.core import projections as tp
from torch_parity import rel_max_err, to_np

CPU = "cpu"
REF_TOL = 1e-4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _proj_close(mine, ref):
    np.testing.assert_array_equal(to_np(mine) != 0, np.asarray(ref) != 0)
    np.testing.assert_allclose(to_np(mine), np.asarray(ref), rtol=1e-6, atol=1e-7)


SUPPORT = np.random.default_rng(7).random((32, 48)) < 0.2
CELLS = np.random.default_rng(8).integers(-1, 10, (32, 48))
PROJ_CASES = [
    ("support", lambda m: m.proj_support, dict(support=SUPPORT)),
    ("triu", lambda m: m.proj_triu, dict()),
    ("diag", lambda m: m.proj_diag, dict()),
    ("block", lambda m: m.proj_block_topk, dict(bm=8, bn=8, n_blocks=5)),
    ("piecewise", lambda m: m.proj_piecewise_const, dict(cell_ids=CELLS, n_cells=10, s=4)),
]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind,fn,kw", PROJ_CASES, ids=[c[0] for c in PROJ_CASES])
def test_projection_matches_reference(kind, fn, kw, normalize):
    x = _rand((32, 48))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = fn(jp)(jnp.asarray(x), normalize=normalize, **jkw)
    _proj_close(fn(tp)(torch.as_tensor(x), normalize=normalize, **tkw), ref)
    if kind in ("support", "block"):  # the reference's make_proj kinds
        _proj_close(tp.make_proj(kind, **kw)(torch.as_tensor(x)), jp.make_proj(kind, **kw)(jnp.asarray(x)))
    else:
        _proj_close(tp.make_proj(kind, **kw)(torch.as_tensor(x)), fn(jp)(jnp.asarray(x), **jkw))
    if kind == "diag":  # square: the reference takes jnp.diag's path
        sq = _rand((24, 24), 3)
        _proj_close(tp.proj_diag(torch.as_tensor(sq)), jp.proj_diag(jnp.asarray(sq)))


@pytest.mark.parametrize("kind,kw", [
    ("global", dict(k=37)), ("col", dict(k=3)), ("row", dict(k=5)), ("splincol", dict(k=2)),
    ("blockrow", dict(bm=8, bn=8, k_per_row=2)), ("blockcol", dict(bm=8, bn=4, k_per_col=3)),
    ("block", dict(bm=8, bn=8, n_blocks=5)), ("support", dict(support=SUPPORT)), ("triu", {}),
    ("diag", {}), ("piecewise", dict(cell_ids=CELLS, n_cells=10, s=4)),
])
def test_projection_of_a_stack_is_per_matrix(kind, kw):
    """Every projection takes ``(B, m, n)`` and projects each matrix alone:
    the batched solver projects a stack in one call."""
    xs = torch.as_tensor(_rand((3, 32, 48), 5))
    proj = tp.make_proj(kind, **kw)
    out = proj(xs)
    for i in range(3):
        assert torch.equal(out[i], proj(xs[i]))


def test_array_specs_compare_and_hash_by_value():
    a = tp.make_proj("support", support=SUPPORT)
    b = tp.make_proj("support", support=SUPPORT.copy())
    c = tp.make_proj("support", support=~SUPPORT)
    d = tp.make_proj("support", support=torch.as_tensor(SUPPORT))
    assert a == b == d and hash(a) == hash(b) == hash(d) and a != c
    assert len({a, b, c, d}) == 2
    x = torch.as_tensor(_rand((32, 48)))
    assert torch.equal(a(x), b(x))
    with pytest.raises(TypeError, match="number or an array"):
        tp.make_proj("global", k="3")


def test_meg_style_spec_matches_reference():
    for kw in (dict(), dict(rho=0.5, big_p=900.0, rightmost_col_sparse=False)):
        mine = th.meg_style_spec(30, 200, 4, k=5, s=120, n_iter_two=7, n_iter_global=9, **kw)
        ref = jh.meg_style_spec(30, 200, 4, k=5, s=120, n_iter_two=7, n_iter_global=9, **kw)
        for field in ("inner_dims", "n_iter_two", "n_iter_global", "alpha", "power_iters", "init"):
            assert getattr(mine, field) == getattr(ref, field)
        for mp, rp in zip(mine.factor_projs + mine.resid_projs, ref.factor_projs + ref.resid_projs):
            assert (mp.kind, mp.params) == (rp.kind, rp.params)
        assert mine.n_factors == ref.n_factors == 4


def _leadfield(m, n, seed=0):
    """A MEG-like gain matrix (sensors on a cap, dipoles in a shell),
    numpy only, as ``benchmarks/common.py``'s stand-in."""
    rng = np.random.default_rng(seed)
    phi, theta = rng.uniform(0, 2 * np.pi, m), rng.uniform(0, 0.45 * np.pi, m)
    sensors = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    r = rng.uniform(0.5, 0.85, n) ** (1 / 3) * 0.85
    sp, st = rng.uniform(0, 2 * np.pi, n), np.arccos(rng.uniform(-1, 1, n))
    sources = r[:, None] * np.stack([np.sin(st) * np.cos(sp), np.sin(st) * np.sin(sp), np.cos(st)], 1)
    moments = rng.standard_normal((n, 3))
    moments /= np.linalg.norm(moments, axis=1, keepdims=True)
    diff = sensors[:, None, :] - sources[None, :, :]
    gain = np.einsum("mns,ns->mn", diff, moments) / (np.linalg.norm(diff, axis=-1) ** 3 + 1e-3)
    return (gain / np.abs(gain).max()).astype(np.float32)


def _fausts_close(fausts, jfausts, tol=REF_TOL):
    for f, jf in zip(fausts, jfausts):
        for s, js in zip(f.factors, jf.factors):
            np.testing.assert_array_equal(to_np(s) != 0, np.asarray(js) != 0)
            assert rel_max_err(to_np(s), np.asarray(js)) <= tol


def test_meg_strategy_matches_reference():
    g = _leadfield(24, 160)
    kw = dict(strategy="meg", n_factors=3, k=4, s=96, n_iter_two=5, n_iter_global=5)
    op, info = factorize(g, FactorizeSpec(**kw), device=CPU)
    jop, jinfo = jfactorize(jnp.asarray(g), JSpec(**kw))
    _fausts_close(info.fausts, jinfo.fausts)
    assert abs(float(op.rel_error_fro(torch.as_tensor(g))) - float(jop.rel_error_fro(jnp.asarray(g)))) <= REF_TOL
    assert op.s_tot == jop.s_tot and info.n_sweeps == jinfo.n_sweeps
    # and the default s = 4m
    _, info4 = factorize(g, FactorizeSpec(strategy="meg", n_factors=3, k=4, n_iter_two=1, n_iter_global=1),
                         device=CPU)
    assert dict(info4.hier_spec.factor_projs[1].params)["k"] == 96


def test_flat_palm4msa_strategy_matches_reference():
    a = _rand((32, 48), 2)
    kinds = (("col", dict(k=6)), ("global", dict(k=400)))
    spec = lambda m, S: S(strategy="palm4msa", projs=tuple(m.make_proj(k, **kw) for k, kw in kinds),  # noqa: E731
                          dims=(48, 32, 32), n_iter=5)
    op, info = factorize(a, spec(tp, FactorizeSpec), device=CPU)
    jop, jinfo = jfactorize(jnp.asarray(a), spec(jp, JSpec))
    assert not info.batched and info.loss_history.shape == (5,)
    _fausts_close(info.fausts, jinfo.fausts)
    np.testing.assert_allclose(to_np(info.loss_history), np.asarray(jinfo.loss_history), rtol=REF_TOL)
    with pytest.raises(ValueError, match="projs and spec.dims"):
        factorize(a, FactorizeSpec(strategy="palm4msa"), device=CPU)


def _dict_spec(h, P, m, n_iter=5):
    return h.HierarchicalSpec(
        (P.make_proj("col", k=3), P.make_proj("col", k=3)),
        (P.make_proj("global", k=int(1.4 * m * m)), P.make_proj("global", k=int(0.7 * m * m))),
        (m, m), n_iter_two=n_iter, n_iter_global=n_iter,
    )


def test_dictionary_strategy_matches_reference():
    """Fig. 11 on a 16 × 32 dictionary learned from 200 signals: the FAµST
    dictionary, its codes and the run record as the reference's."""
    m, n, l = 16, 32, 200
    rng = np.random.default_rng(3)
    d0 = rng.standard_normal((m, n)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=0, keepdims=True)
    y = rng.standard_normal((m, l)).astype(np.float32)
    jg0 = jd.omp(jnp.asarray(y), jnp.asarray(d0), 3)
    g0 = td.omp(torch.as_tensor(y), torch.as_tensor(d0), 3)
    op, info = factorize(d0, FactorizeSpec(
        strategy="dictionary", hier=_dict_spec(th, tp, m), dict_y=y, dict_gamma0=g0,
        dict_sparse_coding=lambda yy, dd: td.omp(yy, dd, 3)), device=CPU)
    jop, jinfo = jfactorize(jnp.asarray(d0), JSpec(
        strategy="dictionary", hier=_dict_spec(jh, jp, m), dict_y=jnp.asarray(y), dict_gamma0=jg0,
        dict_sparse_coding=lambda yy, dd: jd.omp(yy, dd, 3)))
    _fausts_close(info.fausts, jinfo.fausts)
    np.testing.assert_array_equal(to_np(info.gamma) != 0, np.asarray(jinfo.gamma) != 0)
    assert rel_max_err(to_np(info.gamma), np.asarray(jinfo.gamma)) <= REF_TOL
    np.testing.assert_allclose(info.hierarchical.global_losses, jinfo.hierarchical.global_losses, rtol=REF_TOL)
    assert info.n_sweeps == jinfo.n_sweeps and op.shape == (m, n)
    with pytest.raises(ValueError, match="dict_y"):
        factorize(d0, FactorizeSpec(strategy="dictionary"), device=CPU)
    with pytest.raises(ValueError, match="batched"):
        factorize(np.stack([d0, d0]), FactorizeSpec(strategy="dictionary"), device=CPU)


def test_omp_supports_equal_the_reference():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((20, 48)).astype(np.float32)
    y = rng.standard_normal((20, 300)).astype(np.float32)
    for k in (1, 4, 7):
        ref = np.asarray(jd.omp(jnp.asarray(y), jnp.asarray(d), k))
        mine = to_np(td.omp(torch.as_tensor(y), torch.as_tensor(d), k))
        np.testing.assert_array_equal(mine != 0, ref != 0)
        assert (mine != 0).sum(0).max() <= k
        assert rel_max_err(mine, ref) <= 1e-5
    # a custom adjoint for the selection step
    mine = td.omp(torch.as_tensor(y), torch.as_tensor(d), 4, rmatvec=lambda r: torch.as_tensor(d).T @ r)
    np.testing.assert_array_equal(to_np(mine) != 0, np.asarray(jd.omp(jnp.asarray(y), jnp.asarray(d), 4)) != 0)


def test_ista_iht_and_thresholds_match_reference():
    rng = np.random.default_rng(5)
    d = (rng.standard_normal((20, 40)) / np.sqrt(20)).astype(np.float32)
    y = rng.standard_normal((20, 30)).astype(np.float32)
    jmv, jrmv = (lambda x: jnp.asarray(d) @ x), (lambda r: jnp.asarray(d).T @ r)
    tmv, trmv = (lambda x: torch.as_tensor(d) @ x), (lambda r: torch.as_tensor(d).T @ r)
    ref = jd.ista(jnp.asarray(y), jmv, jrmv, 40, 0.1, 0.2, n_iter=30)
    assert rel_max_err(to_np(td.ista(torch.as_tensor(y), tmv, trmv, 40, 0.1, 0.2, n_iter=30)), np.asarray(ref)) <= 1e-5
    ref = jd.iht(jnp.asarray(y), jmv, jrmv, 40, 5, 0.2, n_iter=30)
    mine = td.iht(torch.as_tensor(y), tmv, trmv, 40, 5, 0.2, n_iter=30)
    np.testing.assert_array_equal(to_np(mine) != 0, np.asarray(ref) != 0)
    assert rel_max_err(to_np(mine), np.asarray(ref)) <= 1e-5
    x = _rand((40, 30), 6)
    np.testing.assert_array_equal(to_np(td.hard_threshold_topk(torch.as_tensor(x), 3)),
                                  np.asarray(jd.hard_threshold_topk(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(to_np(td.soft_threshold(torch.as_tensor(x), 0.5)),
                                  np.asarray(jd.soft_threshold(jnp.asarray(x), 0.5)))


def test_mod_dictionary_learning_matches_reference():
    rng = np.random.default_rng(6)
    y = rng.standard_normal((16, 120)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jdict, jgamma = jd.learn_dictionary_mod(jnp.asarray(y), 24, 3, 2, key)
    idx = jax.random.choice(key, 120, (24,), replace=False)  # the reference's draw
    tdict, tgamma = td.learn_dictionary_mod(torch.as_tensor(y), 24, 3, 2, torch.as_tensor(np.array(idx)))
    assert tdict.shape == (16, 24) and tgamma.shape == (24, 120)
    assert rel_max_err(to_np(tdict), np.asarray(jdict)) <= REF_TOL
    np.testing.assert_array_equal(to_np(tgamma) != 0, np.asarray(jgamma) != 0)
    assert rel_max_err(to_np(tgamma), np.asarray(jgamma)) <= REF_TOL
    np.testing.assert_allclose(to_np(torch.linalg.norm(tdict, dim=0)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 3])
def test_patches_round_trip_as_the_reference(stride):
    img = _rand((20, 17), 7) * 50 + 100
    ref = jd.extract_patches(jnp.asarray(img), 5, stride)
    mine = td.extract_patches(torch.as_tensor(img), 5, stride)
    np.testing.assert_array_equal(to_np(mine), np.asarray(ref))
    back_ref = jd.reconstruct_from_patches(ref, img.shape, 5, stride)
    back = td.reconstruct_from_patches(mine, img.shape, 5, stride)
    assert rel_max_err(to_np(back), np.asarray(back_ref)) <= 1e-6
    noisy = img + _rand(img.shape, 8)
    assert float(td.psnr(torch.as_tensor(noisy), torch.as_tensor(img))) == pytest.approx(
        float(jd.psnr(jnp.asarray(noisy), jnp.asarray(img))), rel=1e-5)
