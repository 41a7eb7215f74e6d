"""Parity of the port's mamba2 / SSD block (``repro_torch.layers.mamba2``)
with the JAX reference (``repro.layers.mamba2``) on the CPU: the causal
conv, the segment sums, the chunked SSD against the reference's function
and the sequential oracle of ``tests/test_mamba_moe.py``, and the block in
train, prefill and decode with its gradients.

Inputs are made with numpy from a seed; the block's parameters are the
reference's ``mamba2_init`` carried across as tensors.  f32 results are
held within 1e-5 of max|y| (the same f32 products summed in another
order), against the float64 oracle within the reference test's 2e-4.  In
bf16 the block follows the reference's rounding points: within 3e-2 of
max|y| of the reference's bf16 run, and its recurrent decode within 3e-2
of its chunked form (f32: 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import mamba2 as jm
from repro.layers.param import split_annotations
from repro_torch.layers import mamba2 as tm
from test_mamba_moe import ssd_sequential_oracle
from torch_parity import rel_max_err, tensor, to_np

jax.config.update("jax_platform_name", "cpu")
TOL = 1e-5
ORACLE_TOL = 2e-4  # tests/test_mamba_moe.py's against the float64 oracle
BF16_TOL = 3e-2


def _close(got, want, tol=TOL):
    got = to_np(got) if isinstance(got, torch.Tensor) else got
    assert rel_max_err(got, np.asarray(want, np.float32)) <= tol


def _spec(g: int = 1, chunk: int = 8):
    spec = tm.Mamba2Spec(d_model=64, d_state=16, headdim=32, expand=2, chunk=chunk, n_groups=g)
    return spec, jm.Mamba2Spec(**dataclasses.asdict(spec))


def _block(spec, jspec, dtype=torch.float32):
    """(reference params, port ``Mamba2``) on ``mamba2_init(PRNGKey(0))``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params, _ = split_annotations(jm.mamba2_init(jax.random.PRNGKey(0), jspec, jdt))
    m = tm.Mamba2(spec, generator=torch.Generator().manual_seed(0), dtype=dtype, device="cpu")
    m.load_state_dict({k: tensor(v) for k, v in params.items()}, strict=True)
    return params, m


def test_spec_and_init_match_reference():
    """Derived sizes, parameter shapes and dtypes (``a_log``, ``d_skip``,
    ``dt_bias`` f32 in a bf16 block), the deterministic vectors, and
    ``dt_bias`` the inverse softplus of a dt in [1e-3, 1e-1]."""
    spec, jspec = _spec(g=2)
    assert (spec.d_inner, spec.n_heads, spec.conv_dim) == (jspec.d_inner, jspec.n_heads, jspec.conv_dim)
    jp, _ = split_annotations(jm.mamba2_init(jax.random.PRNGKey(0), jspec, jnp.bfloat16))
    m = tm.Mamba2(spec, generator=torch.Generator().manual_seed(3), dtype=torch.bfloat16, device="cpu")
    sd = m.state_dict()
    assert sorted(sd) == sorted(jp)
    for k, v in jp.items():
        assert tuple(sd[k].shape) == v.shape, k
        assert (sd[k].dtype == torch.float32) == (v.dtype == jnp.float32), k
    for k in ("a_log", "d_skip", "conv_b", "norm_w"):
        np.testing.assert_allclose(to_np(sd[k]), np.asarray(jp[k], np.float32), rtol=1e-6)
    dt = torch.nn.functional.softplus(sd["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("history", [False, True], ids=["zeros", "history"])
def test_causal_conv_matches_reference_and_a_direct_loop(history):
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 12), (4, 12), (12,)))
    prev = rng.standard_normal((2, 3, 12)).astype(np.float32) if history else None
    want = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None if prev is None else jnp.asarray(prev))
    got = tm.causal_conv(*map(torch.as_tensor, (x, w, b)), None if prev is None else torch.as_tensor(prev))
    _close(got, want)
    xp = np.concatenate([np.zeros((2, 3, 12), np.float32) if prev is None else prev, x], axis=1)
    loop = np.stack([sum(xp[:, t + i] * w[i] for i in range(4)) + b for t in range(9)], axis=1)
    _close(got, loop)


def test_segsum_matches_reference_and_a_direct_sum():
    log_a = -np.abs(np.random.default_rng(2).standard_normal((3, 2, 7))).astype(np.float32)
    got = to_np(tm.segsum(torch.as_tensor(log_a)))
    want = np.asarray(jm._segsum(jnp.asarray(log_a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=TOL * np.abs(want[fin]).max())
    for i in range(7):
        for j in range(7):
            ref = log_a[..., j + 1:i + 1].sum(-1) if j <= i else -np.inf
            np.testing.assert_allclose(got[..., i, j], ref, atol=1e-5)


def _ssd_inputs(g: int, init: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    bs, s, h, p, n = 2, 16, 4, 8, 16
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = (rng.standard_normal((bs, s, g, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bs, s, g, n)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((bs, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, b, c, s0


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference_and_oracle(chunk, g, init):
    """``y`` and the final state against ``ssd_chunked`` of the reference
    (within 1e-5) and the float64 sequential recurrence (within 2e-4)."""
    x, dt, a, b, c, s0 = _ssd_inputs(g, init)
    y, final = tm.ssd_chunked(*map(torch.as_tensor, (x, dt, a, b, c)), chunk,
                              None if s0 is None else torch.as_tensor(s0))
    jy, jfinal = jm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk,
                                None if s0 is None else jnp.asarray(s0))
    assert y.dtype == final.dtype == torch.float32
    _close(y, jy)
    _close(final, jfinal)
    oy, ofinal = ssd_sequential_oracle(x, dt, a, b, c, s0)
    np.testing.assert_allclose(to_np(y), oy, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    np.testing.assert_allclose(to_np(final), ofinal, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_ssd_rejects_a_ragged_length():
    """A sequence longer than the chunk must be a multiple of it, as the
    reference asserts."""
    x, dt, a, b, c, _ = _ssd_inputs(1, False)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tm.ssd_chunked(*map(torch.as_tensor, (x[:, :12], dt[:, :12], a, b[:, :12], c[:, :12])), 8)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*map(jnp.asarray, (x[:, :12], dt[:, :12], a, b[:, :12], c[:, :12])), 8)


def _same_cache(got, want, tol=TOL):
    for name in ("conv", "ssm"):
        assert getattr(got, name).dtype == tensor(getattr(want, name)).dtype, name
        _close(getattr(got, name), np.asarray(getattr(want, name), np.float32), tol)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    assert got.pos.dtype == torch.int32


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba2_apply_matches_reference(mode, g):
    """Outputs and every ``MambaCache`` field: train over 32 tokens (four
    chunks), prefills of 32 and of 2 tokens (shorter than the conv
    history), and two decode steps after each prefill."""
    spec, jspec = _spec(g)
    params, m = _block(spec, jspec)
    x = np.random.default_rng(3).standard_normal((2, 34, 64)).astype(np.float32)
    with torch.no_grad():
        if mode == "train":
            y, cache = tm.mamba2_apply(m, torch.as_tensor(x[:, :32]), spec)
            jy, _ = jm.mamba2_apply(params, jnp.asarray(x[:, :32]), jspec)
            assert cache is None
            _close(y, jy)
            return
        for s in (32, 2):
            cache = tm.mamba_cache_init(2, spec, torch.float32, "cpu")
            y, cache = tm.mamba2_apply(m, torch.as_tensor(x[:, :s]), spec, cache)
            jy, jcache = jm.mamba2_apply(params, jnp.asarray(x[:, :s]), jspec,
                                         jm.mamba_cache_init(2, jspec, jnp.float32))
            _close(y, jy)
            _same_cache(cache, jcache)
            if mode == "decode":
                for t in (s, s + 1):
                    y, cache = tm.mamba2_apply(m, torch.as_tensor(x[:, t:t + 1]), spec, cache, decode=True)
                    jy, jcache = jm.mamba2_apply(params, jnp.asarray(x[:, t:t + 1]), jspec, jcache, decode=True)
                    _close(y, jy)
                    _same_cache(cache, jcache)


def test_mamba2_grads_match_jax_grad():
    """Every parameter's gradient and the input's, of a weighted sum of
    the train output over 24 tokens (three chunks), against ``jax.grad``."""
    spec, jspec = _spec(2)
    params, m = _block(spec, jspec)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    wt = rng.standard_normal((2, 24, 64)).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jm.mamba2_apply(p, x, jspec)[0] * wt), argnums=(0, 1)))(
        params, jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    (tm.mamba2_apply(m, tx, spec)[0] * torch.as_tensor(wt)).sum().backward()
    _close(tx.grad, jgx)
    for name, p in m.named_parameters():
        _close(p.grad, jgp[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_recurrent_decode_follows_the_chunked_form(dtype):
    """Decoding 32 tokens one at a time from an empty cache gives the
    chunked train output: within 1e-5 of max|y| in f32, 3e-2 in bf16; the
    bf16 chunked output within 3e-2 of the reference's bf16 run."""
    spec, jspec = _spec(2)
    params, m = _block(spec, jspec, dtype)
    jx = jnp.asarray(np.random.default_rng(5).standard_normal((2, 32, 64)), jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    x = tensor(jx)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    with torch.no_grad():
        y, _ = tm.mamba2_apply(m, x, spec)
        cache = tm.mamba_cache_init(2, spec, dtype, "cpu")
        steps = []
        for t in range(32):
            yt, cache = tm.mamba2_apply(m, x[:, t:t + 1], spec, cache, decode=True)
            steps.append(yt)
    assert y.dtype == dtype and cache.ssm.dtype == torch.float32 and cache.conv.dtype == dtype
    _close(torch.cat(steps, dim=1), to_np(y), tol)
    _close(y, np.asarray(jm.mamba2_apply(params, jx, jspec)[0], np.float32), tol)
