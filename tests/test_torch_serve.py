"""Parity of the port's serving slice (``repro_torch.models.lm`` prefill
and decode, ``runtime.engine.LMExecutor`` + ``Engine``,
``runtime.server.Server``, ``launch.serve``) with the JAX reference on the
CPU, at gemma-2b smoke size in f32.

Parameters are made by the reference's ``init_model`` and carried across
by ``repro_torch.bridge``; prompts are made with numpy.  Logits are held
within 1e-5 of max|logits| (the same f32 products summed in another
order); caches within the same; greedy tokens, slot schedules and the
engine's counters must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro.runtime import engine as jengine
from repro.runtime.server import Server as JServer
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models import lm
from repro_torch.models.lm import LM
from repro_torch.runtime import engine
from repro_torch.runtime.server import Server
from torch_parity import kv_caches_dict, rel_max_err, to_np

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
TOL = 1e-5  # relative to max|logits|


@pytest.fixture(autouse=True)
def _clean_reference_quarantine():
    """The reference's engine may demote a FAµST apply and quarantine its
    backend process-wide; leave no quarantine to the reference's own tests
    that share the worker."""
    yield
    from repro.api import autotune as jautotune

    jautotune.clear_quarantine()
VARIANTS = {"tied": None, "faust_unembed": (2, 16, 2)}


@functools.lru_cache(maxsize=None)
def _pair(variant: str, seed: int = 0):
    """(reference cfg, reference params, port cfg, port LM) on the same
    parameters."""
    spec = VARIANTS[variant]
    extra = {} if spec is None else {"tie_embeddings": False}
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), faust_unembed=None if spec is None else JSpec(*spec), **extra)
    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_unembed=None if spec is None else FaustSpec(*spec),
                              **extra)
    params = jlm.init_model(jax.random.PRNGKey(seed), jcfg)
    model = LM(cfg, device=CPU)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device=CPU), strict=True)
    return jcfg, params, cfg, model


def _prompts(lengths, seed, vocab=131):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _close(got, want, tol=TOL):
    assert rel_max_err(to_np(got) if isinstance(got, torch.Tensor) else got, np.asarray(want)) <= tol


def _same_caches(caches, jcaches, cfg):
    got, _ = bridge.kv_caches_to_numpy(caches, cfg)
    want, _ = kv_caches_dict(jcaches)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g["pos"], w["pos"])
            for name in ("k", "v"):
                _close(g[name], w[name])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant):
    """``prefill`` (last position's logits, filled caches) and three
    ``decode_step``s, each against the reference within 1e-5."""
    jcfg, params, cfg, model = _pair(variant)
    b, s, max_len = 2, 8, 16
    tokens = np.stack(_prompts([s, s], 1))
    jcaches = jlm.make_caches(jcfg, b, max_len, dtype=jnp.float32)
    caches = lm.make_caches(cfg, b, max_len, dtype=torch.float32, device=CPU)
    jlogits, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(torch.as_tensor(tokens), caches)
    assert logits.shape == (b, 1, cfg.vocab) and logits.dtype == torch.float32
    _close(logits, jlogits)
    _same_caches(caches, jcaches, cfg)
    for step in range(3):
        tok = np.asarray(jlm.greedy_token(jlogits))
        np.testing.assert_array_equal(lm.greedy_token(logits).numpy(), tok)
        jlogits, jcaches = jlm.decode_step(params, jcfg, jnp.asarray(tok[:, -1:]), jcaches)
        with torch.no_grad():
            logits, caches = model.decode_step(torch.as_tensor(np.array(tok[:, -1:])), caches)
        _close(logits, jlogits)
        _same_caches(caches, jcaches, cfg)
        np.testing.assert_array_equal(caches[0].pos.numpy(), np.asarray(jlm._first_cache_pos(jcaches)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_stream_token_identical(variant):
    """A 12-token greedy stream, prefill then decode, equal token for token."""
    jcfg, params, cfg, model = _pair(variant)
    tokens = np.stack(_prompts([5], 2))
    jcaches = jlm.make_caches(jcfg, 1, 20, dtype=jnp.float32)
    caches = lm.make_caches(cfg, 1, 20, dtype=torch.float32, device=CPU)
    jlogits, jcaches = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(tokens)}, jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(torch.as_tensor(tokens), caches)
    want, got = [], []
    for _ in range(12):
        jt, t = np.asarray(jlm.greedy_token(jlogits)), lm.greedy_token(logits)
        want.append(jt[0, -1])
        got.append(int(t[0, -1]))
        jlogits, jcaches = jlm.decode_step(params, jcfg, jnp.asarray(jt[:, -1:]), jcaches)
        with torch.no_grad():
            logits, caches = model.decode_step(t[:, -1:], caches)
    assert got == [int(w) for w in want]


def test_cache_slots_gather_scatter_match_reference():
    """A pool carried across by the bridge: gathering and scattering rows
    by slot gives the reference's pool; a bf16 pool crosses as bits."""
    jcfg, _, cfg, _ = _pair("tied")
    rng = np.random.default_rng(3)
    jpool = jlm.make_caches(jcfg, 4, 6, dtype=jnp.bfloat16)
    jpool = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) if a.dtype == jnp.bfloat16
        else jnp.asarray(rng.integers(0, 6, a.shape), a.dtype), jpool)
    tree, dtype = kv_caches_dict(jpool)
    assert dtype == "bfloat16"
    pool = bridge.kv_caches_from_numpy(tree, cfg, dtype=dtype, device=CPU)
    assert len(pool) == cfg.n_layers and pool[0].k.dtype == torch.bfloat16
    back, back_dtype = bridge.kv_caches_to_numpy(pool, cfg)
    assert back_dtype == "bfloat16"
    for bs, ts in zip(back, tree):
        for b_, t_ in zip(bs, ts):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(b_[name], t_[name])
    idx = np.asarray([3, 1], np.int32)
    jlive = jlm.gather_cache_slots(jpool, jnp.asarray(idx))
    live = lm.gather_cache_slots(pool, torch.as_tensor(idx, dtype=torch.int64))
    got, _ = bridge.kv_caches_to_numpy(live, cfg)
    want, _ = kv_caches_dict(jlive)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(g[name], w[name])
    jlive2 = jax.tree_util.tree_map(lambda a: a + jnp.asarray(1, a.dtype), jlive)
    live2 = bridge.kv_caches_from_numpy(kv_caches_dict(jlive2)[0], cfg, dtype="bfloat16", device=CPU)
    jpool = jlm.scatter_cache_slots(jpool, jlive2, jnp.asarray(idx))
    pool = lm.scatter_cache_slots(pool, live2, torch.as_tensor(idx, dtype=torch.int64))
    got, _ = bridge.kv_caches_to_numpy(pool, cfg)
    want, _ = kv_caches_dict(jpool)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(g[name], w[name])


# ---------------------------------------------------------------------------
# Engine traces against the reference's engine
# ---------------------------------------------------------------------------


class _Log:
    """Executor proxy that logs the slots of every prefill and decode."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill_forward(self, slot, prompt, extras):
        self.calls.append(("prefill", slot, len(prompt)))
        return self.inner.prefill_forward(slot, prompt, extras)

    def decode_forward(self, slots, tokens):
        self.calls.append(("decode", tuple(int(s) for s in slots)))
        return self.inner.decode_forward(slots, tokens)


def _trace_staggered(eng, prompts, budgets):
    rids = [eng.submit(prompts[0], budgets[0])]
    eng.step()
    rids.append(eng.submit(prompts[1], budgets[1]))
    eng.step()
    rids.append(eng.submit(prompts[2], budgets[2]))
    eng.run()
    return rids


def _trace_all_at_once(eng, prompts, budgets):
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run()
    return rids


def _trace_evict(eng, prompts, budgets):
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.step()
    eng.step()
    assert eng.evict(rids[0])
    eng.run()
    return rids


# (trace, variant, seed, prompt lengths, budgets, n_slots, max_len):
# tests/test_engine_sim.py's three real-model traces, and a re-admission
# whose prompt + generated is ragged above attn_chunk (8): a prefill of
# the aligned prefix, then a replay through decode
TRACES = {
    "staggered_arrivals": (_trace_staggered, "tied", 1, (6, 6, 4), (5, 3, 4), 3, 16),
    "early_finish_slot_reuse": (_trace_all_at_once, "faust_unembed", 8, (5, 5, 5, 6), (2, 6, 4, 3), 3, 16),
    "eviction_readmission": (_trace_evict, "tied", 12, (5, 4), (6, 4), 2, 20),
    "ragged_reprefill": (_trace_evict, "faust_unembed", 13, (7, 12), (9, 4), 2, 24),
}


def _stats(es):
    return (es.steps, es.admitted, es.completed, es.evicted, es.tokens_decoded, dict(es.occupancy),
            es.retries, es.failed, es.quarantined)


@pytest.mark.parametrize("trace", list(TRACES))
def test_engine_trace_matches_reference(trace):
    drive, variant, seed, lengths, budgets, n_slots, max_len = TRACES[trace]
    jcfg, params, cfg, model = _pair(variant)
    prompts = _prompts(lengths, seed)
    jex = _Log(jengine.LMExecutor(jcfg, params, max_len, n_slots=n_slots))
    ex = _Log(engine.LMExecutor(model, max_len, n_slots=n_slots))
    jeng, eng = jengine.Engine(jex), engine.Engine(ex)
    jrids, rids = drive(jeng, prompts, budgets), drive(eng, prompts, budgets)
    assert rids == jrids
    for r in rids:
        np.testing.assert_array_equal(eng.result(r), jeng.result(r))
    assert ex.calls == jex.calls  # the slot schedule
    assert _stats(eng.stats) == _stats(jeng.stats)
    if trace == "ragged_reprefill":
        assert any(op == "prefill" and n > cfg.attn_chunk and n % cfg.attn_chunk for op, _, n in
                   [c for c in ex.calls if c[0] == "prefill"])
    if variant == "faust_unembed":
        reps = eng.stats.dispatch_per_step
        assert len(reps) == eng.stats.steps and {r.batch for r in reps} == set(eng.stats.occupancy)
        assert eng.stats.faust_dispatch is not None and eng.stats.demotions == 0


def test_server_sample_matches_reference():
    """``Server._sample``: the last position's argmax, ``(B, 1)`` int32,
    whatever an earlier position holds."""
    logits = np.random.default_rng(5).standard_normal((3, 2, 131)).astype(np.float32)
    logits[:, 0, 7] = 100.0  # a distractor at an earlier position
    srv, jsrv = Server.__new__(Server), JServer.__new__(JServer)
    srv.cfg, jsrv.cfg = _pair("tied")[2], _pair("tied")[0]
    got, want = srv._sample(torch.as_tensor(logits)), jsrv._sample(jnp.asarray(logits))
    assert got.shape == (3, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_executor_row_finite_and_sample():
    """The NaN guard's device-side reduction and the greedy sample."""
    _, _, cfg, model = _pair("tied")
    ex = engine.LMExecutor(model, 8, n_slots=2)
    logits = torch.zeros((3, 1, 5))
    logits[0, 0, 2] = 1.0
    logits[1, 0, 4] = 2.0
    logits[2, 0, 1] = float("nan")
    np.testing.assert_array_equal(ex.row_finite(logits), [True, True, False])
    np.testing.assert_array_equal(ex.sample(logits[:2]), [[2], [4]])
    assert ex.sample(logits).dtype == np.int32


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_server_generate_matches_reference(variant):
    jcfg, params, cfg, model = _pair(variant)
    tokens = np.stack(_prompts([6, 6, 6], 4))
    jgen, jstats = JServer(jcfg, params, max_len=12).generate({"tokens": jnp.asarray(tokens)}, 5)
    srv = Server(model, max_len=12)
    gen, stats = srv.generate({"tokens": tokens}, 5)
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    assert gen.shape == (3, 5) and gen.dtype == np.int32
    assert stats.tokens_decoded == jstats.tokens_decoded == 15
    assert stats.decode_s > 0 and stats.tokens_per_s > 0
    assert (stats.faust_dispatch is None) == (jstats.faust_dispatch is None)
    gen2, _ = srv.generate({"tokens": torch.as_tensor(tokens)}, 5)  # the cached executor, tensor input
    np.testing.assert_array_equal(gen2, gen)


def test_launch_serve_smoke_runs_on_cpu(capsys):
    gen, stats = launch_serve.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu", "--batch", "2",
                                    "--prompt-len", "12", "--new-tokens", "3"])
    assert gen.shape == (2, 3) and stats.tokens_decoded == 6
    assert "generated shape: (2, 3)" in capsys.readouterr().out
