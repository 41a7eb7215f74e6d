"""Parity of the port's MoE layer (``repro_torch.layers.moe``) and banded
sliding-window attention (``layers.attention.banded_attention_ref``) with
the JAX reference on the CPU.

Routing is integer bookkeeping on the same f32 probabilities: ``slot_src``
and ``dest`` must be equal, the weights and the aux loss within 1e-6
relative (the same f32 softmax, summed in another order).  Layer outputs
and gradients in f32 are held within 1e-5 of max|y| (the same products
summed in another order).  The reference's own MoE cases
(``tests/test_mamba_moe.py``) are taken against the port with the
reference's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers import moe as jmoe
from repro.layers.param import split_annotations
from repro_torch import bridge
from repro_torch.layers import attention
from repro_torch.layers.moe import MoE, MoESpec, capacity_per_group, route
from torch_parity import rel_max_err, to_np

jax.config.update("jax_platform_name", "cpu")
F32_TOL = 1e-5
ROUTE_TOL = 1e-6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jspec(spec: MoESpec) -> jmoe.MoESpec:
    return jmoe.MoESpec(**dataclasses.asdict(spec))


def _pair(spec: MoESpec, d: int, seed: int = 0):
    """The reference's ``moe_init`` params (numpy tree) and a port
    :class:`MoE` loaded with them."""
    params, _ = split_annotations(jmoe.moe_init(jax.random.PRNGKey(seed), d, _jspec(spec)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    m = MoE(d, spec, generator=torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in bridge.flatten_tree(tree).items()}, strict=True)
    return params, m


# (E, k, capacity factor, groups, tokens per group, drops): drop-free at
# E/k, granite's and llama4's published factor, a tight one
ROUTES = {
    "top2_dropfree": (5, 2, 2.5, 3, 16, False),
    "top8_of_40_cf1.25": (40, 8, 1.25, 2, 64, True),
    "top1_of_8_cf1.25": (8, 1, 1.25, 4, 24, True),
    "top2_tight": (6, 2, 0.5, 2, 40, True),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_matches_reference(case):
    e, k, cf, g, t, drops = ROUTES[case]
    spec = MoESpec(n_experts=e, top_k=k, d_ff=8, capacity_factor=cf)
    logits = _rand((g, t, e), 1)
    want = jmoe.route(jnp.asarray(logits), _jspec(spec))
    got = route(torch.as_tensor(logits), spec)
    np.testing.assert_array_equal(got.slot_src.numpy(), np.asarray(want.slot_src))
    np.testing.assert_array_equal(got.dest.numpy(), np.asarray(want.dest))
    assert rel_max_err(to_np(got.weights), np.asarray(want.weights)) <= ROUTE_TOL
    assert float(got.aux_loss) == pytest.approx(float(want.aux_loss), rel=ROUTE_TOL)
    c = capacity_per_group(t, spec)
    assert c == jmoe.capacity_per_group(t, _jspec(spec))
    assert bool((got.dest == e * c).any()) == drops


def test_route_ties_keep_the_lowest_expert():
    """Equal probabilities: ``lax.top_k``'s order (lowest expert first),
    and a stable argsort of the expert ids fills each expert's slots in
    token order."""
    spec = MoESpec(n_experts=4, top_k=2, d_ff=8, capacity_factor=1.0)
    logits = np.zeros((1, 6, 4), np.float32)
    logits[0, 3, 2] = 1.0
    want = jmoe.route(jnp.asarray(logits), _jspec(spec))
    got = route(torch.as_tensor(logits), spec)
    np.testing.assert_array_equal(got.dest.numpy(), np.asarray(want.dest))
    np.testing.assert_array_equal(got.slot_src.numpy(), np.asarray(want.slot_src))
    assert got.dest[0, 0].item() == 0 and got.dest[0, 1].item() == capacity_per_group(6, spec)


def test_route_replays_given_experts(monkeypatch):
    """``route`` looks ``top_experts`` up when it is called, so replacing
    it replays other choices (the card's teacher-forced check does): the
    router's own choice reproduces ``route`` exactly; another choice keeps
    the router's probabilities of those experts, renormalized."""
    from repro_torch.layers import moe

    spec = MoESpec(n_experts=6, top_k=2, d_ff=8, capacity_factor=3.0)
    logits = torch.as_tensor(_rand((2, 10, 6), 8))
    own = route(logits, spec)
    c = capacity_per_group(10, spec)
    top_e = (own.dest // c).reshape(2, 10, 2)
    for choice in (top_e, torch.flip(top_e, dims=[0]).contiguous()):
        monkeypatch.setattr(moe, "top_experts", lambda probs, k, choice=choice: choice)
        r = route(logits, spec)
        probs = torch.softmax(logits, dim=-1).gather(-1, choice)
        torch.testing.assert_close(r.weights, probs / probs.sum(-1, keepdim=True), rtol=0, atol=0)
        assert torch.equal((r.dest // c).reshape(2, 10, 2), choice)
        if choice is top_e:
            for a, b in zip(own, r):
                assert torch.equal(a, b)


def test_route_weights_normalized_and_capacity_respected():
    """The reference's case: weights sum to 1, every kept slot points at a
    valid token (or the pad row), no two (token, k) pairs share a slot."""
    spec = MoESpec(n_experts=6, top_k=2, d_ff=16, capacity_factor=1.5)
    g, t = 3, 40
    r = route(torch.as_tensor(_rand((g, t, spec.n_experts), 0)), spec)
    np.testing.assert_allclose(r.weights.sum(-1).numpy(), 1.0, rtol=1e-5)
    c = capacity_per_group(t, spec)
    slot_src, dest = r.slot_src.numpy(), r.dest.numpy()
    assert slot_src.shape == (g, spec.n_experts * c)
    assert (slot_src >= 0).all() and (slot_src <= t).all()
    for gi in range(g):
        d = dest[gi][dest[gi] < spec.n_experts * c]
        assert len(np.unique(d)) == len(d)


def test_moe_matches_dense_when_dropfree_top_all():
    """The reference's case: top_k = n_experts with room for every token
    is the dense mixture Σ_e softmax_e(router)·FFN_e(x)."""
    e, d = 3, 12
    spec = MoESpec(n_experts=e, top_k=e, d_ff=8, capacity_factor=float(e) * 2, act="swiglu")
    _, m = _pair(spec, d)
    x = torch.as_tensor(_rand((2, 10, d), 1))
    with torch.no_grad():
        y, _ = m(x)
        probs = torch.softmax(x @ m.router, dim=-1)
        up = torch.einsum("bsd,edf->besf", x, m.w_up)
        gate = torch.nn.functional.silu(torch.einsum("bsd,edf->besf", x, m.w_gate))
        ye = torch.einsum("besf,efd->besd", gate * up, m.w_down)
        want = torch.einsum("bse,besd->bsd", probs, ye)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_moe_drops_overflow_tokens():
    """The reference's case: capacity 1 and every token routed to expert
    0, so only the first token gets a contribution (the rest read the
    zero pad row)."""
    spec = MoESpec(n_experts=2, top_k=1, d_ff=4, capacity_factor=0.01)
    d = 6
    _, m = _pair(spec, d, seed=2)
    with torch.no_grad():
        m.router.zero_()
        m.router[:, 0] = 10.0
    x = torch.as_tensor(np.abs(_rand((1, 8, d), 3)) + 0.1)
    with torch.no_grad():
        y, _ = m(x)
    assert capacity_per_group(8, spec) == 1
    norms = np.linalg.norm(y.numpy()[0], axis=-1)
    assert norms[0] > 1e-6
    np.testing.assert_allclose(norms[1:], 0.0, atol=1e-6)


def test_moe_aux_loss_uniform_is_one():
    """The reference's case: uniform routing gives aux ≈ 1 (Switch's
    normalization)."""
    spec = MoESpec(n_experts=4, top_k=1, d_ff=4, router_aux_coef=1.0)
    logits = _rand((1, 64, 4), 4, scale=1e-4)
    assert 0.8 < float(route(torch.as_tensor(logits), spec).aux_loss) < 1.3


@pytest.mark.parametrize("shared", [0, 24])
@pytest.mark.parametrize("act,cf", [("swiglu", 1.0), ("gelu", 4.0)])
def test_moe_apply_and_grads_match_reference(shared, act, cf):
    """``moe_apply`` (y and the weighted aux) with and without the shared
    expert, with drops (cf 1) and without, and the gradient of every
    parameter and of x."""
    d = 16
    spec = MoESpec(n_experts=4, top_k=2, d_ff=12, act=act, capacity_factor=cf, shared_expert_ff=shared)
    params, m = _pair(spec, d, seed=5)
    x = _rand((3, 9, d), 6)
    w = _rand((3, 9, d), 7)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, _jspec(spec))
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = m(xt)
    (torch.sum(y * torch.as_tensor(w)) + aux).backward()
    assert rel_max_err(to_np(y), np.asarray(jy)) <= F32_TOL
    assert aux.item() == pytest.approx(float(jaux), rel=ROUTE_TOL)
    assert rel_max_err(to_np(xt.grad), np.asarray(jgx)) <= F32_TOL
    jflat = bridge.flatten_tree(jax.tree_util.tree_map(np.asarray, jgp))
    assert set(jflat) == {n for n, _ in m.named_parameters()}
    for name, p in m.named_parameters():
        assert rel_max_err(to_np(p.grad), jflat[name]) <= F32_TOL, name


def test_bf16_moe_keeps_an_f32_router():
    """In a bf16 layer the router stays f32 (the reference's
    ``dense_init(..., dtype=float32)``); the expert weights are bf16 with
    the init's standard deviations."""
    spec = MoESpec(n_experts=8, top_k=1, d_ff=64, shared_expert_ff=32)
    m = MoE(128, spec, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    assert m.router.dtype == torch.float32 and m.w_up.dtype == m.w_down.dtype == torch.bfloat16
    assert m.shared.w_up.dtype == torch.bfloat16
    assert float(m.w_up.detach().float().std()) == pytest.approx(128**-0.5, rel=0.05)
    assert float(m.w_down.detach().float().std()) == pytest.approx(64**-0.5, rel=0.05)
    jparams, _ = split_annotations(jmoe.moe_init(jax.random.PRNGKey(0), 16, _jspec(spec), jnp.bfloat16))
    assert jparams["router"].dtype == jnp.float32 and jparams["w_up"].dtype == jnp.bfloat16
    x = torch.randn((2, 3, 128), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = m(x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32 and torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# Banded sliding-window attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mult", [1, 2, 3])
@pytest.mark.parametrize("chunk", [4, 8])
def test_banded_attention_matches_reference_and_windowed_flash(mult, chunk):
    """S ∈ {window, 2·window, 3·window} with chunk < window: the port's
    banded form against the reference's, and against the port's chunked
    softmax over every key with the window's mask."""
    window, b, kh, g, d = 16, 2, 2, 2, 8
    s = window * mult
    q, k, v = _rand((b, s, kh * g, d), 1), _rand((b, s, kh, d), 2), _rand((b, s, kh, d), 3)
    scale = 0.3
    want = jattn.banded_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, scale=scale,
                                      chunk=chunk)
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    got = attention.banded_attention_ref(qt, kt, vt, window=window, scale=scale, chunk=chunk)
    assert got.shape == (b, s, kh * g, d)
    assert rel_max_err(to_np(got), np.asarray(want)) <= F32_TOL
    pos = torch.arange(s)
    flash = attention.flash_attention_ref(qt, kt, vt, q_positions=pos, kv_positions=pos, causal=True,
                                          window=window, scale=scale, chunk=chunk)
    assert rel_max_err(to_np(got), to_np(flash)) <= F32_TOL


def test_local_attention_takes_the_reference_branches():
    """``attn_train`` of a windowed spec: banded where the window is
    shorter than the sequence, the masked chunked softmax where it is
    not; both against the reference's ``attn_train``, with qk-norm and
    partial rotary."""
    d_model = 32
    spec = attention.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, rope_base=100.0, rotary_dim=4, window=8,
                              qk_norm=True, scale=0.4)
    jspec = jattn.AttnSpec(**dataclasses.asdict(spec))
    params, _ = split_annotations(jattn.attn_init(jax.random.PRNGKey(0), d_model, 4, 2, 8, True, jnp.float32))
    params = {**params, "q_norm": jnp.asarray(_rand((8,), 4, 0.1)), "k_norm": jnp.asarray(_rand((8,), 5, 0.1))}
    att = attention.Attention(d_model, spec, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                              device="cpu")
    att.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()}, strict=True)
    for s in (8, 24):
        x = _rand((2, s, d_model), 6 + s)
        want = jattn.attn_train(params, jnp.asarray(x), jspec, chunk=4)
        with torch.no_grad():
            got = attention.attn_train(att, torch.as_tensor(x), spec, chunk=4)
        assert rel_max_err(to_np(got), np.asarray(want)) <= F32_TOL, s
