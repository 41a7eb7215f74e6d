"""Parity of the port's streaming refresh (``repro_torch.streaming``:
``StreamingFaust``, ``classify_swap``, ``hot_swap`` with its guard,
``quantized_swap``, ``refreshed_chain``) with the JAX reference on the CPU.

Targets and chains are made with numpy (or by the reference) and cross
through ``repro_torch.bridge``.  Tolerances: tracked operators within
1e-5 relative Frobenius error of the reference's on the reference's drift
trace (the same f32 solves summed in another order), with equal actions
and sweep counts; quantized codes and scales bit for bit; served tokens
equal.  The sketches draw their probes from a ``torch.Generator``, not
from JAX keys, so a drift or swap estimate is held against the exact
relative error within the sketch's spread, and its decisions against the
reference's where the margin is clear.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FactorizeSpec as JFactorizeSpec
from repro.configs import get_smoke as jget_smoke
from repro.core import compress as jcompress
from repro.core import hadamard_matrix as jhadamard
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import LMExecutor as JLMExecutor
from repro.streaming import StreamingConfig as JStreamingConfig
from repro.streaming import StreamingFaust as JStreamingFaust
from repro.streaming import swap as jswap
from repro_torch import bridge
from repro_torch.api import FactorizeSpec, FaustOp, autotune
from repro_torch.configs import get_smoke
from repro_torch.core.compress import pack_chain, quantize_chain
from repro_torch.core.hierarchical import hadamard_matrix
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models.lm import LM
from repro_torch.runtime import faults
from repro_torch.runtime.engine import Engine, LMExecutor
from repro_torch.runtime.server import Server
from repro_torch.streaming import StreamingConfig, StreamingFaust, classify_swap, hot_swap
from repro_torch.streaming import swap
from torch_parity import blockfaust_dict, jax_chain, packed_dict

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
RE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _private_solve_buckets():
    """Each test starts with no solve bucket seen, in both packages, and
    leaves the process's bucket sets as it found them (and no backend
    quarantined by the reference's engines): the reference's own tests
    count misses in the same process (``tests/test_streaming.py`` expects
    its drift trace's first warm sweep to miss)."""
    from repro.core import hierarchical as jh
    from repro_torch.core import hierarchical as th

    saved = [(m, set(m._SEEN_BUCKETS), dataclasses.replace(m._GLOBAL_STATS)) for m in (jh, th)]
    for m, _, _ in saved:
        m._SEEN_BUCKETS.clear()
    yield
    from repro.api import autotune as jautotune

    jautotune.clear_quarantine()  # the reference's engines may have quarantined a backend
    for m, seen, stats in saved:
        m._SEEN_BUCKETS.clear()
        m._SEEN_BUCKETS.update(seen)
        m._GLOBAL_STATS.hits, m._GLOBAL_STATS.misses, m._GLOBAL_STATS.sweeps = stats.hits, stats.misses, stats.sweeps


def _port_chain(jbf):
    return bridge.blockfaust_from_numpy(blockfaust_dict(jbf), device=CPU)


def _rel_fro(a, dense) -> float:
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - np.asarray(dense, np.float64)) / np.linalg.norm(a))


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def _rotation(n, i, j, theta):
    r = np.eye(n, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    r[i, i] = r[j, j] = c
    r[i, j], r[j, i] = -s, s
    return r


def _drift_trace(n=16, steps=5, theta=0.02, seed=7):
    """tests/test_streaming.py's trace: per step a small plane rotation of
    a Hadamard target plus 3 sparse additive perturbations."""
    rng = np.random.default_rng(seed)
    a = np.asarray(jhadamard(n), dtype=np.float32)
    trace = []
    for _ in range(steps):
        i, j = rng.choice(n, size=2, replace=False)
        a = _rotation(n, int(i), int(j), theta) @ a
        for _ in range(3):
            r, c = rng.integers(0, n, size=2)
            a[r, c] += theta * rng.standard_normal()
        trace.append(a.copy())
    return trace


def _pair_track(a0, spec_kw, cfg_kw):
    jsf = JStreamingFaust.track(jnp.asarray(a0), JFactorizeSpec(**spec_kw), JStreamingConfig(**cfg_kw))
    sf = StreamingFaust.track(torch.as_tensor(np.array(a0)), FactorizeSpec(**spec_kw), StreamingConfig(**cfg_kw), device=CPU)
    assert sf.cold_sweeps == jsf.cold_sweeps
    return jsf, sf


def test_tracks_drift_trace_like_reference():
    """On the reference's drift trace the port's tracker takes the same
    actions and sweeps, and its operator's RE against each snapshot is the
    reference's within 1e-5; the warm sweeps fill one solve bucket."""
    h = np.asarray(jhadamard(16), np.float32)
    np.testing.assert_array_equal(hadamard_matrix(16, device=CPU).numpy(), h)
    spec = dict(strategy="hadamard", n_iter_two=30, n_iter_global=30)
    jsf, sf = _pair_track(h, spec, dict(n_iter_update=10, skip_below=1e-4))
    for a_t in _drift_trace():
        jrec, rec = jsf.update(jnp.asarray(a_t)), sf.update(torch.as_tensor(a_t))
        assert (rec.action, rec.sweeps, rec.step) == (jrec.action, jrec.sweeps, jrec.step) == ("sweep", 10, rec.step)
        re, jre = _rel_fro(a_t, sf.op.todense().numpy()), _rel_fro(a_t, jsf.op.todense())
        assert abs(re - jre) <= RE_TOL and re < 0.1
        # the sketch against the exact RE, within its spread
        assert 0.5 * re <= rec.re_est <= 2.0 * re
    assert (sf.sweeps_total, sf.sweeps_saved()) == (jsf.sweeps_total, jsf.sweeps_saved())
    assert (sf.trace_stats.misses, sf.trace_stats.hits, sf.trace_stats.sweeps) == (1, 4, 50)
    assert (jsf.trace_stats.misses, jsf.trace_stats.hits) == (1, 4)


@pytest.mark.parametrize("case", ["skip", "sweep", "full"])
def test_budget_controller_routes_like_reference(case):
    h = np.asarray(jhadamard(16), np.float32)
    spec = dict(strategy="hadamard", n_iter_two=10, n_iter_global=10)
    cfg, target = {
        "skip": (dict(skip_below=1e-3), h),
        "sweep": (dict(skip_below=1e-4, n_iter_update=3), _rotation(16, 0, 1, 0.05) @ h),
        "full": (dict(full_above=0.5), np.random.default_rng(5).normal(size=(16, 16)).astype(np.float32)),
    }[case]
    jsf, sf = _pair_track(h, spec, cfg)
    jrec, rec = jsf.update(jnp.asarray(target)), sf.update(torch.as_tensor(target))
    assert (rec.action, rec.sweeps) == (jrec.action, jrec.sweeps)
    assert rec.action == case
    assert abs(_rel_fro(target, sf.op.todense().numpy()) - _rel_fro(target, jsf.op.todense())) <= RE_TOL


def test_block_route_publishes_blockfaust_like_reference():
    """A block-route tracker stays a deployment chain across updates, with
    the reference's support and RE."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    w1 = w + 0.01 * rng.normal(size=w.shape).astype(np.float32)
    spec = dict(strategy="hierarchical", n_factors=2, block=8, k_first=4, k_mid=4, n_iter_two=8, n_iter_global=8)
    jsf, sf = _pair_track(w, spec, dict(full_above=2.0))
    bf0 = sf.blockfaust
    jrec, rec = jsf.update(jnp.asarray(w1)), sf.update(torch.as_tensor(w1))
    assert rec.action == jrec.action == "sweep"
    bf1 = sf.blockfaust
    assert bf1 is not None and bf1.s_tot == bf0.s_tot == jsf.blockfaust.s_tot
    assert (bf1.in_features, bf1.out_features) == (16, 32) or (bf1.in_features, bf1.out_features) == (32, 16)
    for f, jf in zip(bf1.factors, jsf.blockfaust.factors):
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
    assert abs(_rel_fro(w1, bf1.todense().numpy()) - _rel_fro(w1, jsf.blockfaust.todense())) <= RE_TOL


def test_track_rejects_flat_strategies_and_bad_shapes():
    h = hadamard_matrix(8, device=CPU)
    with pytest.raises(ValueError, match="hierarchical-family"):
        StreamingFaust.track(h, FactorizeSpec(strategy="palm4msa"), device=CPU)
    with pytest.raises(ValueError, match="one \\(m, n\\) target"):
        StreamingFaust.track(torch.zeros((2, 8, 8)), FactorizeSpec(), device=CPU)


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def _perturb(bf, eps=0.01):
    return dataclasses.replace(bf, factors=tuple(dataclasses.replace(f, values=f.values * (1.0 + eps))
                                                 for f in bf.factors))


def _move_support(bf):
    f0 = bf.factors[0]
    moved = dataclasses.replace(f0, in_idx=(f0.in_idx + 1) % (f0.in_features // f0.bk))
    return dataclasses.replace(bf, factors=(moved,) + bf.factors[1:])


CLASSIFY = {
    "identical": (lambda b: b, "values_only"),
    "values": (_perturb, "values_only"),
    "moved_support": (_move_support, "repack"),
    "other_k": (lambda b: jax_chain((32, 32, 32), 8, 3, seed=4), "repack"),
    "chain_length": (lambda b: jax_chain((32, 32, 32, 32), 8, 2, seed=5), ValueError),
    "shape": (lambda b: jax_chain((64, 64, 64), 8, 2, seed=6), ValueError),
}


@pytest.mark.parametrize("case", list(CLASSIFY))
def test_classify_swap_matches_reference(case):
    make, want = CLASSIFY[case]
    jold = jax_chain((32, 32, 32), 8, 2, seed=3)
    jnew = make(jold)
    old, new = _port_chain(jold), _port_chain(jnew)
    if want is ValueError:
        with pytest.raises(ValueError, match="chain length|shape|feature dims"):
            jswap.classify_swap(jold, jnew)
        with pytest.raises(ValueError, match="chain length|shape|feature dims"):
            classify_swap(old, new)
    else:
        assert classify_swap(old, new) == jswap.classify_swap(jold, jnew) == want


def test_guard_threshold_env(monkeypatch):
    for env, want in (("", None), ("off", None), ("1", 0.5), ("0.25", 0.25)):
        monkeypatch.setenv("REPRO_SWAP_GUARD", env)
        assert swap._guard_threshold(None) == jswap._guard_threshold(None) == want
    assert swap._guard_threshold(0.3) == 0.3 and swap._guard_threshold(False) is None


# ---------------------------------------------------------------------------
# Hot-swap into a live engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(k):
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), faust_unembed=JSpec(2, 16, k), tie_embeddings=False)
    return jcfg, jlm.init_model(jax.random.PRNGKey(0), jcfg)


def _model(k=2):
    jcfg, params = _params(k)
    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_unembed=FaustSpec(2, 16, k), tie_embeddings=False)
    model = LM(cfg, device=CPU)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device=CPU), strict=True)
    return cfg, model


PROMPTS = [np.random.default_rng(1).integers(1, 100, size=8) for _ in range(4)]


def _engine(k=2):
    cfg, model = _model(k)
    eng = Engine(LMExecutor(model, max_len=24, n_slots=2))
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new_tokens=8, rid=f"r{i}")
    return eng


def _jengine():
    jcfg, params = _params(2)
    eng = JEngine(JLMExecutor(jcfg, params, max_len=24, n_slots=2))
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new_tokens=8, rid=f"r{i}")
    return eng


def _first_wave(eng):
    while eng.stats.completed < 2:
        eng.step()
    assert eng.n_pending == 2


def test_values_only_swap_token_exact_mid_stream():
    """A values-only swap published mid-stream: the requests admitted
    after it equal an engine that served the new chain from the start, and
    the reference doing the same swap."""
    eng, jeng = _engine(), _jengine()
    old = eng.executor.unembed_blockfaust()
    new, jnew = _perturb(old), _perturb(jeng.executor.unembed_blockfaust())
    _first_wave(eng)
    _first_wave(jeng)
    report, jreport = hot_swap(eng, new), jswap.hot_swap(jeng, jnew)
    assert (report.kind, report.retrace, report.s_tot_after) == (jreport.kind, jreport.retrace, jreport.s_tot_after)
    assert report.kind == "values_only" and eng.stats.swaps == 1 and report.rel_err is None
    np.testing.assert_array_equal(old.factors[0].values.numpy() * 1.01, new.factors[0].values.numpy())
    eng.run()
    jeng.run()
    oracle = _engine()
    hot_swap(oracle, new)
    oracle.run()
    for rid in ("r0", "r1", "r2", "r3"):
        np.testing.assert_array_equal(eng.result(rid), jeng.result(rid))
    for rid in ("r2", "r3"):
        np.testing.assert_array_equal(eng.result(rid), oracle.result(rid))


def test_repack_swap_staged_keeps_serving(tmp_path, monkeypatch):
    """A staged re-pack (k 2 → 3) mid-stream: in-flight requests finish,
    the advisory operator follows the new chain, the old signature's
    measured entries are dropped, and a request admitted after the swap
    equals an engine that served the new chain from the start."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reload()
    try:
        eng = _engine()
        old = eng.executor.unembed_blockfaust()
        keys = [autotune.key_for_op(FaustOp(old), batch=b, dtype=torch.float32) for b in (1, 2)]
        for key in keys:
            autotune.record(key, {"best": "bsr", "us": {"bsr": 3.0, "fused": 7.0, "dense": 50.0}, "bt": 16})
        new = _model(3)[1].unembed.faust.blockfaust()
        new = type(new)(tuple(dataclasses.replace(f, values=f.values.detach()) for f in new.factors),
                        new.lam.detach())
        _first_wave(eng)
        report = hot_swap(eng, new)
        assert report.kind == "repack" and report.retrace and report.s_tot_after > report.s_tot_before
        assert report.invalidated == 2 and all(autotune.lookup(k) is None for k in keys)
        eng.run()
        assert eng.stats.completed == 4
        assert eng.executor.dispatch_for(2).s_tot == new.s_tot
        oracle = _engine()
        hot_swap(oracle, new)
        oracle.run()
        for rid in ("r2", "r3"):
            np.testing.assert_array_equal(eng.result(rid), oracle.result(rid))
    finally:
        autotune.reload()


def test_hot_swap_requires_faust_unembed():
    cfg = dataclasses.replace(get_smoke("gemma_2b"), n_layers=1, stages=((1, ("attn",)),))
    ex = LMExecutor(LM(cfg, device=CPU), max_len=16, n_slots=1)
    assert ex.unembed_blockfaust() is None
    chain = _port_chain(jax_chain((48, 48, 131), 16, 2))
    with pytest.raises(ValueError, match="no FAµST unembedding"):
        hot_swap(ex, chain)
    with pytest.raises(TypeError, match="cannot hot-swap"):
        hot_swap(object(), chain)


def test_server_swap_unembed():
    cfg, model = _model()
    srv = Server(model, max_len=24)
    old = srv.unembed_blockfaust()
    report = hot_swap(srv, _perturb(old, eps=0.5))  # before any generate(): no executor yet
    assert report.kind == "values_only"
    batch = {"tokens": np.stack([PROMPTS[0]])}
    out1, _ = srv.generate(batch, 4)
    report = hot_swap(srv, _perturb(old, eps=0.25))  # the cached executor swaps
    out2, _ = srv.generate(batch, 4)
    assert out1.shape == out2.shape == (1, 4)
    np.testing.assert_allclose(srv.unembed_blockfaust().factors[0].values.numpy(),
                               old.factors[0].values.numpy() * 1.25, rtol=1e-6)


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------


def test_guard_rejects_regressed_chain_byte_identical():
    """A regressed refresh attempted mid-stream is rejected before
    publication: the served tokens equal a run with no attempt, and the
    reference rejects the same candidate."""
    eng, plain = _engine(), _engine()
    old = eng.executor.unembed_blockfaust()
    bad = faults.regressed_chain(old, scale=25.0)
    classify = classify_swap(old, bad)
    _first_wave(eng)
    report = hot_swap(eng, bad, guard=0.5)
    assert classify == report.kind == "values_only"
    assert not report.accepted and report.rel_err > 0.5 and "exceeds guard" in report.reject_reason
    assert eng.stats.swap_rejects == 1 and eng.stats.swaps == 0
    assert eng.executor.unembed_blockfaust().factors[0].values.data_ptr() == old.factors[0].values.data_ptr()
    eng.run()
    plain.run()
    for rid in ("r0", "r1", "r2", "r3"):
        np.testing.assert_array_equal(eng.result(rid), plain.result(rid))
    jold = jax_chain((48, 48, 131), 16, 2, seed=2)
    jreport = jswap.hot_swap(_FakeServing(jold), jfaults.regressed_chain(jold, scale=25.0), guard=0.5)
    assert not jreport.accepted and jreport.rel_err > 0.5


def test_guard_rejects_nan_chain():
    eng = _engine()
    report = hot_swap(eng, faults.regressed_chain(eng.executor.unembed_blockfaust(), nan=True), guard=0.5)
    assert not report.accepted and "non-finite" in report.reject_reason and eng.stats.swap_rejects == 1


class _FakeServing:
    """A minimal reference hot_swap target."""

    def __init__(self, bf):
        from repro.runtime.engine import EngineStats

        self.bf, self.stats = bf, EngineStats()

    def unembed_blockfaust(self):
        return self.bf

    def swap_unembed(self, bf):
        self.bf = bf


@pytest.mark.parametrize("eps", [1e-3, 5e-2])
def test_guard_accepts_small_refresh_within_the_sketch(eps, monkeypatch):
    """An accepted refresh reports its sketched RE; it and the reference's
    sketch are each within a factor 2 of the exact relative error, and the
    guard off (the default) runs no sketch."""
    monkeypatch.delenv("REPRO_SWAP_GUARD", raising=False)
    jold = jax_chain((48, 48, 131), 16, 2, seed=8)
    rng = np.random.default_rng(11)
    jnew = dataclasses.replace(jold, factors=tuple(
        dataclasses.replace(f, values=f.values + eps * jnp.asarray(rng.standard_normal(f.values.shape), jnp.float32))
        for f in jold.factors))
    old, new = _port_chain(jold), _port_chain(jnew)
    exact = _rel_fro(old.todense().numpy(), new.todense().numpy())
    target = _FakeServing(old)
    report, jreport = hot_swap(target, new, guard=0.5), jswap.hot_swap(_FakeServing(jold), jnew, guard=0.5)
    assert report.accepted and jreport.accepted and report.kind == jreport.kind == "values_only"
    assert 0.5 * exact <= report.rel_err <= 2.0 * exact and 0.5 * exact <= jreport.rel_err <= 2.0 * exact
    assert target.bf is new and target.stats.swaps == 1
    assert hot_swap(target, new).rel_err is None


# ---------------------------------------------------------------------------
# Quantized swaps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qdtype,scheme", [("int8", "per_block"), ("int8", "per_row"), ("fp8_e4m3", "per_block")])
@pytest.mark.parametrize("refresh", ["values", "support"])
def test_quantized_swap_codes_bit_for_bit(qdtype, scheme, refresh):
    """``quantized_swap`` requantizes the refresh in the serving layout:
    codes and scales equal the reference's bit for bit, with the same
    kind and token_exact; the replacement applies on the fused path (K4's
    plain version here)."""
    jbf = jax_chain((64, 64, 96), 16, 2, seed=12)
    jnew = _perturb(jbf, 0.05) if refresh == "values" else _move_support(jbf)
    jold_q = jcompress.quantize_chain(jcompress.pack_chain(jbf), qdtype, scheme)
    old_q = quantize_chain(pack_chain(_port_chain(jbf)), qdtype, scheme)
    jnew_q, jreport = jswap.quantized_swap(jold_q, jnew)
    new_q, report = swap.quantized_swap(old_q, _port_chain(jnew))
    got, want = bridge.to_numpy(new_q), packed_dict(jnew_q)
    for name in ("values", "in_idx", "scales"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    assert got["qscheme"] == want["qscheme"] == f"{qdtype}:{scheme}"
    assert (report.kind, report.token_exact, report.retrace, report.requantized) == \
        (jreport.kind, jreport.token_exact, jreport.retrace, True)
    x = torch.randn((3, 64), generator=torch.Generator().manual_seed(0))
    y = FaustOp.from_packed(new_q, device=CPU).apply(x, "fused", device=CPU)
    np.testing.assert_allclose(y.numpy(), np.asarray(FaustOp.from_packed(new_q, device=CPU).apply(
        x, "dense", device=CPU)), rtol=1e-4, atol=1e-5)


def test_quantized_swap_guard_returns_incumbent():
    bf = _port_chain(jax_chain((64, 64, 96), 16, 2, seed=13))
    old_q = quantize_chain(pack_chain(bf), "int8", "per_block")
    new_q, report = swap.quantized_swap(old_q, faults.regressed_chain(bf, scale=25.0), guard=0.5)
    assert not report.accepted and report.rel_err > 0.5 and new_q is old_q
    with pytest.raises(ValueError, match="not quantized"):
        swap.requantize_like(pack_chain(bf), bf)
    with pytest.raises(ValueError, match="already quantized"):
        swap.requantize_like(old_q, old_q)


def test_regressed_chain_keeps_support():
    """The port's regressed chain: same support, values blown up (or one
    NaN), deterministic in its seed."""
    bf = _port_chain(jax_chain((32, 32, 32), 8, 2, seed=14))
    a, b = faults.regressed_chain(bf, seed=3), faults.regressed_chain(bf, seed=3)
    assert classify_swap(bf, a) == "values_only"
    for fa, fb, f in zip(a.factors, b.factors, bf.factors):
        assert torch.equal(fa.values, fb.values) and fa.values.dtype == f.values.dtype
    assert torch.isnan(faults.regressed_chain(bf, nan=True).factors[0].values).any()


def test_refreshed_chain_takes_the_serving_dtypes():
    rng = np.random.default_rng(15)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    sf = StreamingFaust.track(torch.as_tensor(w), FactorizeSpec(strategy="hierarchical", n_factors=2, block=8,
                                                                k_first=2, k_mid=2, n_iter_two=4, n_iter_global=4),
                              device=CPU)
    like = sf.blockfaust.to(dtype=torch.bfloat16)
    chain = swap.refreshed_chain(sf, like)
    assert all(f.values.dtype == torch.bfloat16 for f in chain.factors) and chain.lam.dtype == like.lam.dtype
    with pytest.raises(ValueError, match="not a deployment BlockFaust"):
        swap.refreshed_chain(StreamingFaust.track(hadamard_matrix(8, device=CPU),
                                                  FactorizeSpec(strategy="hadamard", n_iter_two=2,
                                                                n_iter_global=2), device=CPU), like)
