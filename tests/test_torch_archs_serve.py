"""Parity of the serving path of the port's partial-rotary,
sliding-window and MoE architectures (chatglm3-6b, nemotron-4-15b,
gemma3-27b, granite-moe-3b, llama4-maverick) with the JAX reference on the
CPU, at each one's smoke size in f32: prefill and decode, greedy streams,
caches of two capacities across the bridge, ``LMExecutor`` + ``Engine``,
``Server`` and ``launch.serve``.

Parameters are made by the reference's ``init_model`` and carried across
by ``repro_torch.bridge``; prompts are made with numpy.  Logits and
caches are held within 1e-5 of max|y| (the same f32 products summed in
another order); greedy tokens, cache positions, slot schedules and the
engine's counters must be equal.  gemma3's smoke window is 16 tokens: its
prefills and decodes run past it, through the banded form and the ring
caches.  The MoE smoke configs route drop-free (capacity factor E/k), so
a sequence routes as its tokens one by one do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.runtime import engine as jengine
from repro.runtime.server import Server as JServer
from repro_torch import bridge
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.runtime import engine
from repro_torch.runtime.server import Server
from torch_parity import SLICE10_ARCHS as ARCHS
from torch_parity import arch_pair as _pair
from torch_parity import arch_tokens as _tokens
from torch_parity import caches_dict, rel_max_err, to_np

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jsteps(arch: str):
    """The reference's prefill and decode step, jitted for ``arch``'s
    smoke config."""
    jcfg = _pair(arch)[0]
    prefill = jax.jit(lambda p, tokens, caches: jlm.prefill(p, jcfg, {"tokens": tokens}, caches))
    decode = jax.jit(lambda p, tokens, caches: jlm.decode_step(p, jcfg, tokens, caches))
    return prefill, decode


def _close(got, want, tol=TOL):
    got = to_np(got) if isinstance(got, torch.Tensor) else got
    assert rel_max_err(got, np.asarray(want)) <= tol


def _same_caches(caches, jcaches, cfg):
    got, _ = bridge.caches_to_numpy(caches, cfg)
    want, _ = caches_dict(jcaches)
    for gs, ws in zip(got, want, strict=True):
        for g, w in zip(gs, ws, strict=True):
            np.testing.assert_array_equal(g["pos"], w["pos"])
            for name in ("k", "v"):
                assert g[name].shape == w[name].shape
                _close(g[name], w[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` of 40 tokens (gemma3: banded, its ring caches rolled)
    and three ``decode_step``s: logits and caches against the
    reference's."""
    jcfg, params, cfg, model = _pair(arch)
    b, s, max_len = 2, 40, 48
    tokens = _tokens(cfg, b, s, seed=2)
    jprefill, jdecode = _jsteps(arch)
    jcaches = jlm.make_caches(jcfg, b, max_len, dtype=jnp.float32)
    caches = lm.make_caches(cfg, b, max_len, dtype=torch.float32, device=CPU)
    jlogits, jcaches = jprefill(params, jnp.asarray(tokens), jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(torch.as_tensor(tokens), caches)
    assert logits.shape == (b, 1, cfg.vocab)
    _close(logits, jlogits)
    _same_caches(caches, jcaches, cfg)
    for _ in range(3):
        tok = np.asarray(jlm.greedy_token(jlogits))
        np.testing.assert_array_equal(lm.greedy_token(logits).numpy(), tok)
        jlogits, jcaches = jdecode(params, jnp.asarray(tok[:, -1:]), jcaches)
        with torch.no_grad():
            logits, caches = model.decode_step(torch.as_tensor(np.array(tok[:, -1:])), caches)
        _close(logits, jlogits)
        _same_caches(caches, jcaches, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_token_identical(arch):
    """A 24-token greedy stream after a 6-token prompt, equal token for
    token (gemma3's decode goes past its window of 16 and wraps the ring)."""
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens(cfg, 1, 6, seed=3)
    jprefill, jdecode = _jsteps(arch)
    jcaches = jlm.make_caches(jcfg, 1, 32, dtype=jnp.float32)
    caches = lm.make_caches(cfg, 1, 32, dtype=torch.float32, device=CPU)
    jlogits, jcaches = jprefill(params, jnp.asarray(tokens), jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(torch.as_tensor(tokens), caches)
    want, got = [], []
    for _ in range(24):
        jt, t = np.asarray(jlm.greedy_token(jlogits)), lm.greedy_token(logits)
        want.append(int(jt[0, -1]))
        got.append(int(t[0, -1]))
        jlogits, jcaches = jdecode(params, jnp.asarray(jt[:, -1:]), jcaches)
        with torch.no_grad():
            logits, caches = model.decode_step(t[:, -1:], caches)
    assert got == want
    if cfg.window is not None:
        assert 6 + 24 > cfg.window and int(caches[0].pos[0]) > caches[0].capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_make_caches_capacities_and_bridge_round_trip(arch):
    """Each layer's capacity is the reference's (``min(window, cache_len)``
    for ``"local"``); a bf16 pool of two capacities crosses the bridge both
    ways bit for bit."""
    jcfg, _, cfg, _ = _pair(arch)
    jpool = jlm.make_caches(jcfg, 3, 24, dtype=jnp.bfloat16)
    pool = lm.make_caches(cfg, 3, 24, dtype=torch.bfloat16, device=CPU)
    want_caps = [c.k.shape[3] for stage in jpool for c in stage for _ in range(c.k.shape[0])]
    kinds = cfg.layer_kinds()
    caps = [c.capacity for c in pool]
    assert caps == [lm.cache_capacity(cfg, kind, 24) for kind in kinds]
    assert sorted(caps) == sorted(want_caps)
    assert len(set(caps)) == (2 if "local" in kinds else 1)
    rng = np.random.default_rng(4)
    jpool = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) if a.dtype == jnp.bfloat16
        else jnp.asarray(rng.integers(0, 30, a.shape), a.dtype), jpool)
    tree, dtype = caches_dict(jpool)
    pool = bridge.caches_from_numpy(tree, cfg, dtype=dtype, device=CPU)
    assert [c.capacity for c in pool] == caps
    back, back_dtype = bridge.caches_to_numpy(pool, cfg)
    assert back_dtype == "bfloat16"
    for bs, ts in zip(back, tree, strict=True):
        for b_, t_ in zip(bs, ts, strict=True):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(b_[name], t_[name])


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


def _trace(eng, prompts, budgets):
    """Staggered arrivals, an eviction and its re-admission (a ragged
    re-prefill above attn_chunk, replayed through decode), slot reuse."""
    rids = [eng.submit(prompts[0], budgets[0])]
    eng.step()
    rids.append(eng.submit(prompts[1], budgets[1]))
    eng.step()
    eng.step()
    assert eng.evict(rids[0])
    rids.append(eng.submit(prompts[2], budgets[2]))
    eng.run()
    return rids


def _stats(es):
    return (es.steps, es.admitted, es.completed, es.evicted, es.tokens_decoded, dict(es.occupancy),
            es.retries, es.failed, es.quarantined)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_trace_matches_reference(arch):
    """``LMExecutor`` + ``Engine`` against the reference's on one trace
    (pool layers of two capacities for gemma3, whose streams pass its
    window): tokens, the slot schedule and the counters equal."""
    jcfg, params, cfg, model = _pair(arch, arch in ("gemma3_27b", "granite_moe_3b"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (6, 12, 9)]
    budgets = (20, 6, 8)
    jex = _Log(jengine.LMExecutor(jcfg, params, 40, n_slots=2))
    ex = _Log(engine.LMExecutor(model, 40, n_slots=2))
    jeng, eng = jengine.Engine(jex), engine.Engine(ex)
    jrids, rids = _trace(jeng, prompts, budgets), _trace(eng, prompts, budgets)
    assert rids == jrids
    for r in rids:
        np.testing.assert_array_equal(eng.result(r), jeng.result(r))
    assert ex.calls == jex.calls
    assert _stats(eng.stats) == _stats(jeng.stats)
    assert any(c[0] == "prefill" and c[2] > cfg.attn_chunk and c[2] % cfg.attn_chunk for c in ex.calls)
    assert [c.capacity for c in ex.pool] == [lm.cache_capacity(cfg, k, 40) for k in cfg.layer_kinds()]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_and_launch_serve_match_reference(arch, capsys):
    """``Server.generate`` against the reference's, and ``launch.serve
    --arch`` on the smoke config."""
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens(cfg, 3, 6, seed=6)
    jgen, _ = JServer(jcfg, params, max_len=24).generate({"tokens": jnp.asarray(tokens)}, 18)
    gen, stats = Server(model, max_len=24).generate({"tokens": tokens}, 18)
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    assert stats.tokens_decoded == 54
    gen, stats = launch_serve.main(["--arch", arch, "--smoke", "--device", CPU, "--batch", "2", "--prompt-len", "16",
                                    "--new-tokens", "3"])
    assert gen.shape == (2, 3) and stats.tokens_decoded == 6
    assert "generated shape: (2, 3)" in capsys.readouterr().out


