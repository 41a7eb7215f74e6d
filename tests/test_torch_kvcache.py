"""Parity of the port's KV caches and decode attention
(``repro_torch.layers.attention``) with the JAX reference on the CPU.

Inputs are made with numpy from seeds and cross as they are; attention
parameters come from the reference's ``attn_init``.  Tolerances are the
reference's own in ``tests/test_attention.py``: rtol 2e-4 / atol 2e-5
against the reference, decode against full attention 2e-3 / 2e-4.  Cache
writes and positions are exact (equal arrays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers.param import split_annotations
from repro_torch.layers import attention as attn
from repro_torch.layers.attention import AttnSpec, Attention, KVCache

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 2e-5
DEC_RTOL, DEC_ATOL = 2e-3, 2e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jcache(k, v, pos):
    return jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32))


def _cache(k, v, pos):
    return KVCache(torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(np.asarray(pos, np.int32)))


def _same_cache(got: KVCache, want):
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def _filled(b, kh, cap, d, seed):
    return _rand((b, kh, cap, d), seed), _rand((b, kh, cap, d), seed + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_init(dtype):
    got = attn.kv_cache_init(3, 5, 2, 4, dtype=getattr(torch, dtype), device="cpu")
    want = jattn.kv_cache_init(3, 5, 2, 4, dtype=getattr(jnp, dtype))
    assert got.capacity == want.capacity == 5
    assert got.k.dtype == getattr(torch, dtype) and got.pos.dtype == torch.int32
    for name in ("k", "v", "pos"):
        assert tuple(getattr(got, name).shape) == tuple(getattr(want, name).shape)
        assert not getattr(got, name).any()


@pytest.mark.parametrize("pos", [[0, 3, 7], [5, 11, 2], 6], ids=["per_row", "wrapped", "scalar"])
def test_kv_cache_update_decode(pos):
    """A per-row scatter at pos % cap (rows wrap past the capacity); a
    scalar pos writes one slot for every row.  The input cache is left as
    it was."""
    b, kh, cap, d = 3, 2, 6, 4
    k, v = _filled(b, kh, cap, d, 1)
    k_new, v_new = _rand((b, 1, kh, d), 3), _rand((b, 1, kh, d), 4)
    cache = _cache(k, v, pos)
    got = attn.kv_cache_update_decode(cache, torch.as_tensor(k_new), torch.as_tensor(v_new))
    want = jattn.kv_cache_update_decode(_jcache(k, v, pos), jnp.asarray(k_new), jnp.asarray(v_new))
    _same_cache(got, want)
    np.testing.assert_array_equal(cache.k.numpy(), k)  # functional


@pytest.mark.parametrize("pos", [[0, 3, 4, 9, 13], 6, 0], ids=["per_row", "scalar_wrapped", "scalar_empty"])
def test_kv_cache_positions(pos):
    """Unrolled ring positions: wrapped rows, rows never written (a reused
    slot's stale entries sit past pos) and a shared pos."""
    b = len(pos) if isinstance(pos, list) else 1
    k, v = _filled(b, 1, 4, 2, 5)
    got = attn.kv_cache_positions(_cache(k, v, pos))
    want = jattn.kv_cache_positions(_jcache(k, v, pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,cap", [(5, 8), (8, 8), (13, 4), (11, 3)], ids=["short", "full", "ring", "ring_ragged"])
def test_kv_cache_prefill(s, cap):
    """Fill from a prefill sequence; with S > cap the ring buffer keeps the
    last cap tokens at slot p % cap (the roll branch)."""
    b, kh, d = 2, 2, 4
    k0, v0 = _filled(b, kh, cap, d, 7)
    k_seq, v_seq = _rand((b, s, kh, d), 8), _rand((b, s, kh, d), 9)
    got = attn.kv_cache_prefill(_cache(k0, v0, [1, 2]), torch.as_tensor(k_seq), torch.as_tensor(v_seq))
    want = jattn.kv_cache_prefill(_jcache(k0, v0, [1, 2]), jnp.asarray(k_seq), jnp.asarray(v_seq))
    _same_cache(got, want)


@pytest.mark.parametrize("h,kh", [(4, 1), (4, 2), (6, 6)])
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention(h, kh, window):
    """Per-row query positions over per-row unrolled cache positions, with
    a reused slot's stale rows and a wrapped ring."""
    b, cap, d = 3, 5, 8
    q = _rand((b, 1, h, d), 10)
    k, v = _filled(b, kh, cap, d, 11)
    pos = np.asarray([2, 5, 8], np.int32)  # tokens seen after this step's write
    kvp = jattn.kv_cache_positions(_jcache(k, v, pos))
    qp = (pos - 1)[:, None]
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_position=jnp.asarray(qp),
                                  kv_positions=kvp, window=window)
    got = attn.decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                q_position=torch.as_tensor(qp), kv_positions=torch.as_tensor(np.array(kvp)),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decode_attention_shared_position():
    """Batch-free positions (a shared pos) broadcast over the rows."""
    b, h, kh, cap, d = 2, 4, 2, 6, 8
    q = _rand((b, 1, h, d), 12)
    k, v = _filled(b, kh, cap, d, 13)
    qp, kvp = np.asarray([3]), np.arange(cap)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_position=jnp.asarray(qp),
                                  kv_positions=jnp.asarray(kvp))
    got = attn.decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                q_position=torch.as_tensor(qp), kv_positions=torch.as_tensor(kvp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _attn_pair(d_model, h, kh, hd, seed=9):
    params, _ = split_annotations(jattn.attn_init(jax.random.PRNGKey(seed), d_model, h, kh, hd))
    mod = Attention(d_model, AttnSpec(h, kh, hd), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    return params, mod


@pytest.mark.parametrize("cap", [24, 32])
def test_prefill_then_decode(cap):
    """attn_prefill and attn_decode against the reference step by step
    (caches equal), and prefill + decode against full attention over the
    whole sequence (the reference's own check)."""
    jspec, spec = jattn.AttnSpec(4, 2, 8), AttnSpec(4, 2, 8)
    params, mod = _attn_pair(16, 4, 2, 8)
    b, s_total, s_prefill = 2, 24, 16
    x = _rand((b, s_total, 16), 14)
    full = attn.attn_train(mod, torch.as_tensor(x), spec, chunk=8)
    jcache = jattn.kv_cache_init(b, cap, 2, 8, dtype=jnp.float32)
    cache = attn.kv_cache_init(b, cap, 2, 8, dtype=torch.float32, device="cpu")
    jy, jcache = jattn.attn_prefill(params, jnp.asarray(x[:, :s_prefill]), jspec, jcache, chunk=8)
    y, cache = attn.attn_prefill(mod, torch.as_tensor(x[:, :s_prefill]), spec, cache, chunk=8)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.detach().numpy(), full[:, :s_prefill].detach().numpy(), rtol=RTOL, atol=ATOL)
    for t in range(s_prefill, s_total):
        jy, jcache = jattn.attn_decode(params, jnp.asarray(x[:, t:t + 1]), jspec, jcache)
        y, cache = attn.attn_decode(mod, torch.as_tensor(x[:, t:t + 1]), spec, cache)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(y.detach().numpy(), full[:, t:t + 1].detach().numpy(),
                                   rtol=DEC_RTOL, atol=DEC_ATOL)
        np.testing.assert_allclose(cache.k.detach().numpy(), np.asarray(jcache.k), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


def test_decode_rows_at_independent_positions():
    """Rows of one decode batch at different positions, one of them a
    reused slot whose stale entries (from an earlier occupant) lie past its
    pos: each row matches the reference and its own single-row decode."""
    jspec, spec = jattn.AttnSpec(4, 1, 8), AttnSpec(4, 1, 8)
    params, mod = _attn_pair(16, 4, 1, 8, seed=3)
    k, v = _filled(3, 1, 10, 8, 15)  # every slot holds stale garbage
    pos = np.asarray([4, 0, 7], np.int32)
    x = _rand((3, 1, 16), 16)
    jy, jc = jattn.attn_decode(params, jnp.asarray(x), jspec, _jcache(k, v, pos))
    y, c = attn.attn_decode(mod, torch.as_tensor(x), spec, _cache(k, v, pos))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):  # the new entries come out of a projection and rope
        np.testing.assert_allclose(getattr(c, name).detach().numpy(), np.asarray(getattr(jc, name)),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))
    for r in range(3):
        yr, _ = attn.attn_decode(mod, torch.as_tensor(x[r:r + 1]), spec, _cache(k[r:r + 1], v[r:r + 1], pos[r:r + 1]))
        np.testing.assert_allclose(yr.detach().numpy(), y[r:r + 1].detach().numpy(), rtol=RTOL, atol=ATOL)
