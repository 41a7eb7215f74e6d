"""Parity of the port's training slice (``repro_torch.layers``, ``models``,
``optim``, ``data``, ``runtime``, ``launch.train`` and grad-priced dispatch)
with the JAX reference on the CPU.

Parameters are made by the reference (``init_model`` and the layer inits,
through ``split_annotations``) and carried across as numpy by
``repro_torch.bridge``; inputs are made with numpy.  Tolerances: f32
forwards and gradients ≤ 1e-5 of max|y| per tensor (the same f32 products
summed in another order; attention's exp and the tanh GELU differ by an
ulp or two); batches equal bit for bit (the same numpy generator); one
AdamW update ≤ 1e-6 relative (f32 arithmetic in another order); the
3-step loss trajectory ≤ 1e-4 relative (three updates compound the
differences of the forward and the backward).  Dispatch estimates are
closed-form arithmetic on the same constants: equal to 1e-9 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import dispatch as jdispatch
from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jpipe
from repro.layers import attention as jattn
from repro.layers import embedding as jemb
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.layers.faust_linear import faust_linear_apply, faust_linear_init
from repro.layers.param import split_annotations
from repro.launch.roofline import roofline_constants as j_roofline_constants
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch import bridge
from repro_torch.api import dispatch
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import pipeline
from repro_torch.launch import roofline
from repro_torch.launch import train as launch_train
from repro_torch.layers import attention, embedding, mlp, norms, rope
from repro_torch.layers.faust_linear import FaustLinear, FaustSpec
from repro_torch.models.lm import LM
from repro_torch.optim import adamw, compression
from repro_torch.runtime import trainer
from torch_parity import rel_max_err, to_np

CPU = "cpu"
F32_TOL = 1e-5  # relative to max|y| per tensor; reasons in the module docstring
KEY = jax.random.PRNGKey(0)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree(annotated):
    """The reference's init output as a numpy tree."""
    values, _ = split_annotations(annotated)
    return jax.tree_util.tree_map(np.asarray, values)


def _load(module, tree):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in bridge.flatten_tree(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _gen():
    return torch.Generator().manual_seed(0)


def _jgrads(fn, params, x):
    """Reference gradients of Σ fn(params, x)·w wrt params and x."""
    w = jnp.asarray(_rand(np.shape(fn(params, x)), 99))
    return jax.grad(lambda p, xx: jnp.sum(fn(p, xx) * w), argnums=(0, 1), allow_int=True)(params, x), w


def _check_grads(module, xt, jgp, jgx):
    assert rel_max_err(to_np(xt.grad), np.asarray(jgx)) <= F32_TOL
    flat = bridge.flatten_tree(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in module.named_parameters():
        assert rel_max_err(to_np(p.grad), flat[name]) <= F32_TOL, name


@pytest.mark.parametrize("backend", ["fused", "bsr", "dense"])
def test_faust_linear_matches_reference(backend):
    spec = (3, 16, 2)
    jp = _tree(faust_linear_init(KEY, 40, 72, JSpec(*spec)))
    layer = _load(FaustLinear(40, 72, FaustSpec(*spec), generator=_gen(), device=CPU, backend=backend), jp)
    x = _rand((2, 5, 40), 1)
    fn = lambda p, xx: faust_linear_apply(p, xx, JSpec(*spec), 40, 72, backend="bsr")  # noqa: E731
    (jgp, jgx), w = _jgrads(fn, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = layer(xt)
    assert rel_max_err(to_np(y), np.asarray(fn(jp, jnp.asarray(x)))) <= F32_TOL
    (y * torch.as_tensor(np.array(w))).sum().backward()
    _check_grads(layer, xt, jgp, jgx)


def test_rmsnorm_and_rope_match_reference():
    x, w = _rand((3, 7, 48), 1), _rand((48,), 2, 0.1)
    assert rel_max_err(to_np(norms.rmsnorm(torch.as_tensor(w), torch.as_tensor(x))),
                       np.asarray(jnorms.rmsnorm(jnp.asarray(w), jnp.asarray(x)))) <= F32_TOL
    p = {"scale": _rand((48,), 3, 0.1), "bias": _rand((48,), 4, 0.1)}
    assert rel_max_err(to_np(norms.layernorm({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))),
                       np.asarray(jnorms.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))) <= F32_TOL
    q = _rand((2, 9, 4, 16), 5)
    pos = np.arange(9)
    got = rope.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), base=10000.0)
    assert rel_max_err(to_np(got), np.asarray(jrope.apply_rope(jnp.asarray(q), jnp.asarray(pos)))) <= F32_TOL


@pytest.mark.parametrize("faust", [None, (2, 16, 2)])
def test_geglu_mlp_matches_reference(faust):
    jp = _tree(jmlp.mlp_init(KEY, 48, 96, "geglu", faust=None if faust is None else JSpec(*faust)))
    m = _load(mlp.MLP(48, 96, "geglu", generator=_gen(), dtype=torch.float32, device=CPU,
                      faust=None if faust is None else FaustSpec(*faust)), jp)
    x = _rand((2, 6, 48), 2)
    fn = lambda p, xx: jmlp.mlp_apply(p, xx, "geglu", None if faust is None else JSpec(*faust), 48, 96)  # noqa: E731
    (jgp, jgx), w = _jgrads(fn, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = m(xt)
    assert rel_max_err(to_np(y), np.asarray(fn(jp, jnp.asarray(x)))) <= F32_TOL
    (y * torch.as_tensor(np.array(w))).sum().backward()
    _check_grads(m, xt, jgp, jgx)
    # the tanh GELU, not torch's default erf form
    z = torch.linspace(-3, 3, 13)
    assert torch.allclose(mlp._act("geglu", z), torch.nn.functional.gelu(z, approximate="tanh"))
    assert not torch.allclose(mlp._act("geglu", z), torch.nn.functional.gelu(z))


@pytest.mark.parametrize("chunk", [8, 16])
def test_mqa_attention_matches_reference(chunk):
    spec = dict(n_heads=4, n_kv_heads=1, head_dim=16)
    jp = _tree(jattn.attn_init(KEY, 48, **spec))
    a = _load(attention.Attention(48, attention.AttnSpec(**spec), generator=_gen(), dtype=torch.float32,
                                  device=CPU), jp)
    x = _rand((2, 16, 48), 3)
    fn = lambda p, xx: jattn.attn_train(p, xx, jattn.AttnSpec(**spec), chunk)  # noqa: E731
    (jgp, jgx), w = _jgrads(fn, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = a(xt, chunk)
    assert rel_max_err(to_np(y), np.asarray(fn(jp, jnp.asarray(x)))) <= F32_TOL
    (y * torch.as_tensor(np.array(w))).sum().backward()
    _check_grads(a, xt, jgp, jgx)


@pytest.mark.parametrize("kind", ["dense", "faust", "tied"])
def test_unembedding_matches_reference(kind):
    x = _rand((2, 5, 48), 4)
    if kind == "tied":
        table = _rand((131, 48), 5)
        got = embedding.unembed_apply(None, torch.as_tensor(x), torch.as_tensor(table))
        want = jemb.unembed_apply(None, jnp.asarray(x), 48, 131, None, tied_table=jnp.asarray(table))
        assert rel_max_err(to_np(got), np.asarray(want)) <= F32_TOL
        return
    spec = None if kind == "dense" else (2, 16, 4)
    jp = _tree(jemb.unembed_init(KEY, 48, 131, None if spec is None else JSpec(*spec)))
    u = _load(embedding.Unembed(48, 131, None if spec is None else FaustSpec(*spec), generator=_gen(),
                                dtype=torch.float32, device=CPU), jp)
    fn = lambda p, xx: jemb.unembed_apply(p, xx, 48, 131, None if spec is None else JSpec(*spec))  # noqa: E731
    (jgp, jgx), w = _jgrads(fn, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = u(xt)
    assert rel_max_err(to_np(y), np.asarray(fn(jp, jnp.asarray(x)))) <= F32_TOL
    (y * torch.as_tensor(np.array(w))).sum().backward()
    _check_grads(u, xt, jgp, jgx)


VARIANTS = {
    "faust_mlp": (dict(faust_mlp=(3, 16, 2)), {}),
    "faust_unembed": (dict(faust_unembed=(2, 16, 4)), dict(tie_embeddings=False)),
}


def _cfgs(variant):
    specs, extra = VARIANTS[variant]
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), **{k: JSpec(*v) for k, v in specs.items()}, **extra)
    cfg = dataclasses.replace(get_smoke("gemma_2b"), **{k: FaustSpec(*v) for k, v in specs.items()}, **extra)
    return jcfg, cfg


def _port_lm(params, cfg):
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = LM(cfg, device=CPU)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device=CPU), strict=True)
    return model


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_loss_and_grads_match_reference(variant):
    """gemma-2b smoke ``train_loss`` and the gradient of every parameter,
    on the reference's parameters carried across by the bridge (and back)."""
    jcfg, cfg = _cfgs(variant)
    params = jlm.init_model(KEY, jcfg)
    model = _port_lm(params, cfg)
    tokens = np.asarray(jpipe.global_batch(jpipe.DataConfig(vocab=131, seq_len=16, global_batch=3), 0)["tokens"])
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jcfg, {"tokens": jnp.asarray(tokens)}), has_aux=True, allow_int=True
    )(params)
    loss, aux = model.train_loss({"tokens": torch.as_tensor(tokens)})
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=F32_TOL)
    assert aux["ce"].item() == pytest.approx(float(jloss), rel=F32_TOL)
    jflat = bridge.flatten_lm_tree(jax.tree_util.tree_map(np.asarray, jg), cfg)
    names = [n for n, _ in model.named_parameters()]
    assert names and set(names) <= set(jflat)
    for name, p in model.named_parameters():
        assert rel_max_err(to_np(p.grad), jflat[name]) <= F32_TOL, name
    tree, dtype = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert dtype is None
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), b), params, tree)
    assert jax.tree_util.tree_all(same)


def test_bf16_params_cross_as_bits():
    jcfg, cfg = _cfgs("faust_unembed")
    jcfg, cfg = dataclasses.replace(jcfg, dtype="bfloat16"), dataclasses.replace(cfg, dtype="bfloat16")
    params = jlm.init_model(KEY, jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), params
    )
    sd = bridge.lm_state_dict_from_numpy(tree, cfg, dtype="bfloat16", device=CPU)
    assert sd["embed.table"].dtype == torch.bfloat16 and sd["unembed.faust.factors.0.in_idx"].dtype == torch.int32
    back, dtype = bridge.lm_state_dict_to_numpy(sd, cfg)
    assert dtype == "bfloat16"
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a).view(b.dtype), b), tree, back)
    assert jax.tree_util.tree_all(same)


@pytest.mark.parametrize("step", [0, 3])
def test_global_batch_bit_for_bit(step):
    jcfg = jpipe.DataConfig(vocab=257, seq_len=33, global_batch=5, seed=4)
    cfg = pipeline.DataConfig(vocab=257, seq_len=33, global_batch=5, seed=4)
    want = jpipe.global_batch(jcfg, step)["tokens"]
    got = pipeline.global_batch(cfg, step)["tokens"]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    it = pipeline.DataIterator(cfg)
    for _ in range(step):
        next(it)
    assert np.array_equal(next(it)["tokens"], want)


def test_adamw_update_matches_reference():
    shapes = {"a": (7, 5), "b": (11,), "c": ()}
    params = {k: _rand(s, i) for i, (k, s) in enumerate(shapes.items())}
    grads = {k: _rand(s, 10 + i, 3.0) for i, (k, s) in enumerate(shapes.items())}
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.init_state(jp)
    tp = {k: torch.as_tensor(v).clone() for k, v in params.items()}
    tstate = adamw.init_state(tp)
    for step in range(3):  # warmup, then decay
        jg = {k: jnp.asarray(v) * (step + 1) for k, v in grads.items()}
        jp, jstate, jm = jadamw.apply_updates(jcfg, jp, jg, jstate)
        m = adamw.apply_updates(tcfg, tp, {k: torch.as_tensor(np.array(v)) for k, v in jg.items()}, tstate)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for k in params:
            assert rel_max_err(to_np(tp[k]), np.asarray(jp[k])) <= 1e-6
            assert rel_max_err(to_np(tstate.mu[k]), np.asarray(jstate.mu[k])) <= 1e-6
            assert rel_max_err(to_np(tstate.nu[k]), np.asarray(jstate.nu[k])) <= 1e-6
    assert tstate.step == int(jstate.step) == 3


def test_trainer_losses_match_jax_trainer(tmp_path):
    """Three steps of the reference's Trainer and of the port's, from the
    same parameters (the reference's ``init_model(PRNGKey(seed))``) on the
    same batches: the loss trajectories agree within 1e-4."""
    jcfg, cfg = _cfgs("faust_mlp")
    data = dict(vocab=131, seq_len=16, global_batch=4)
    opt = dict(lr=1e-3, warmup_steps=1, decay_steps=3)
    tc = dict(steps=3, checkpoint_every=1000, log_every=1000)
    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**data), jadamw.AdamWConfig(**opt),
                          jtrainer.TrainConfig(checkpoint_dir=str(tmp_path), **tc))
    jl = [h["loss"] for h in jt.run(resume=False)["history"]]
    model = _port_lm(jlm.init_model(jax.random.PRNGKey(0), jcfg), cfg)
    t = trainer.Trainer(cfg, pipeline.DataConfig(**data), adamw.AdamWConfig(**opt),
                        trainer.TrainConfig(checkpoint_dir=str(tmp_path / "port"), **tc), device=CPU)
    hist = t.run(model=model)["history"]
    tl = [h["loss"] for h in hist]
    assert len(tl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(h["skipped"] == 0.0 and h["step_time_s"] > 0 for h in hist)
    assert t.faust_dispatch is not None and t.faust_dispatch.grad


def test_microbatches_and_nan_guard(tmp_path):
    _, cfg = _cfgs("faust_mlp")
    data = pipeline.DataConfig(vocab=131, seq_len=8, global_batch=4)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    runs = {}
    for n in (1, 2):
        model = LM(cfg, seed=3, device=CPU)
        t = trainer.Trainer(cfg, data, opt, trainer.TrainConfig(steps=2, microbatches=n, checkpoint_every=99,
                                                                checkpoint_dir=str(tmp_path / str(n))), device=CPU)
        runs[n] = [h["loss"] for h in t.run(model=model)["history"]]
    np.testing.assert_allclose(runs[2], runs[1], rtol=1e-5)  # the same mean loss and gradient
    model = LM(cfg, seed=3, device=CPU)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.embed.table[0, 0] = float("nan")
    t = trainer.Trainer(cfg, data, opt, trainer.TrainConfig(steps=1, checkpoint_every=99,
                                                            checkpoint_dir=str(tmp_path / "nan")), device=CPU)
    h = t.run(model=model)["history"][0]
    assert h["skipped"] == 1.0 and not np.isfinite(h["loss"])
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k != "embed.table")


@pytest.fixture
def same_constants(monkeypatch):
    """The port prices with the reference's constants, for this test only."""
    consts, _ = j_roofline_constants()
    monkeypatch.setattr(roofline, "roofline_constants", lambda: (dict(consts), "test"))
    return consts


@pytest.mark.parametrize("batch", [1, 7, 128, 1024])
@pytest.mark.parametrize(
    "shape,s_tot,inner,n_factors,quant",
    [
        ((2048, 256000), 16_515_072, (2048,), 2, None),
        ((2048, 16384), 11_010_048, (2048, 2048), 3, None),
        ((2048, 16384), 11_010_048, (2048, 2048), 3, ("int8", 4 * 672 * 128)),
        ((256, 256), 4096, (), 1, None),
    ],
)
def test_grad_priced_choose_backend_matches_reference(same_constants, batch, shape, s_tot, inner, n_factors, quant):
    """``grad=True`` pricing: dense and bsr are the reference's formulas;
    fused is the reference's formula with the port's wgrad workspace in
    place of the reference's partial-slab spill (none at one batch tile)
    and its wgrad's two launches where the chain has intermediates."""
    c = same_constants
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        kw = dict(batch=batch, shape=shape, s_tot=s_tot, inner_dims=inner, n_factors=n_factors)
        if quant is not None:
            kw.update(values_dtype=quant[0], scales_bytes=quant[1])
        mine = dispatch.choose_backend(dtype=tdt, grad=True, **kw)
        ref = jdispatch.choose_backend(dtype=jdt, grad=True, bt=max(batch, 1), **kw)  # one tile: no spill
        assert mine.grad and ref.grad and mine.as_row()["grad"] is True
        for k in ("dense", "bsr"):
            assert mine.est_us[k] == pytest.approx(ref.est_us[k], rel=1e-9)
        elt = tdt.itemsize
        w = (1 if quant else elt) * s_tot + (quant[1] if quant else 0)
        dv = (4 if quant else elt) * s_tot
        byts = 3 * w + dv + elt * 3 * batch * sum(shape) + 16.0 * batch * sum(inner)
        want = max(10.0 * batch * s_tot / c["peak_flops"], byts / c["hbm_bw"]) * 1e6
        want += (4 if inner else 3) * c["t_launch_us"]
        assert mine.est_us["fused"] == pytest.approx(want, rel=1e-9)
        if not inner:
            assert mine.est_us["fused"] == pytest.approx(ref.est_us["fused"], rel=1e-9)
        assert mine.backend == min(mine.est_us, key=lambda k: (mine.est_us[k], dispatch._ORDER[k]))
        fwd = dispatch.choose_backend(dtype=tdt, **kw)
        assert not fwd.grad and fwd.est_us["fused"] < mine.est_us["fused"]


def test_later_slices_raise():
    """What the port does not run yet raises, one case each: a layer kind
    the reference does not have, a mesh, and the launcher's multi-GPU
    flags; an ``ssm`` layer without its ``Mamba2Spec`` is refused.  Every
    architecture of the reference is known (the registry has no ``LATER``
    list): the modality front ends run (``tests/test_torch_modality.py``),
    as do checkpoints, EF compression and recompression
    (``tests/test_torch_resilience.py``), the ``local`` and ``moe`` kinds
    and partial rotary (``tests/test_torch_archs.py``), and the ``ssm``
    and ``shared`` kinds (``tests/test_torch_ssm_archs.py``)."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch import configs

    assert not hasattr(configs, "LATER") and sorted(configs.ARCH_IDS) == sorted(JARCH_IDS)
    for arch in ("internvl2_2b", "musicgen_medium"):
        assert get_config(arch).name == get_config(arch.replace("_", "-")).name
        LM(get_smoke(arch), device=CPU)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper_large")
    cfg = get_smoke("gemma_2b")
    with pytest.raises(NotImplementedError, match="layer kinds"):
        LM(dataclasses.replace(cfg, stages=((2, ("cross",)),)), device=CPU)
    with pytest.raises(ValueError, match="Mamba2Spec"):
        LM(dataclasses.replace(cfg, stages=((2, ("ssm",)),)), device=CPU)
    data = pipeline.DataConfig(vocab=131, seq_len=8, global_batch=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        trainer.Trainer(cfg, data, tcfg=trainer.TrainConfig(checkpoint_every=999), mesh=object(), device=CPU)
    for flags in (["--mesh"], ["--multi-pod"]):
        with pytest.raises(NotImplementedError):
            launch_train.build(launch_train.parse_args(["--arch", "gemma_2b", "--smoke", "--device", "cpu", *flags]))


def test_launcher_runs_the_smoke_model_on_the_cpu(tmp_path):
    out = launch_train.main(["--arch", "gemma_2b", "--smoke", "--faust", "--steps", "2", "--batch", "2",
                             "--seq", "8", "--checkpoint-every", "99", "--checkpoint-dir", str(tmp_path),
                             "--device", "cpu"])
    hist = out["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert isinstance(out["model"].unembed.faust, FaustLinear)


_SYNCS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist", "numpy", "cpu")


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_never_syncs_the_host(monkeypatch, microbatches, compressed):
    """The step (forward, backward, EF top-k compression when on, and the
    guarded update) reads no value back to the host: every way a tensor
    reaches Python raises inside it.  On the card a read-back is a device
    synchronization that idles the device until the host enqueues the
    update."""
    _, cfg = _cfgs("faust_mlp")
    model = LM(cfg, seed=3, device=CPU)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    comp = compression.TopKConfig(0.05) if compressed else None
    step = trainer.make_train_step(model, opt, trainer.TrainConfig(microbatches=microbatches, compression=comp))
    params = dict(model.named_parameters())
    state = adamw.init_state(params)
    ef = compression.ef_topk_init(params) if compressed else None
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 131, (4, 8)))
    step({"tokens": tokens}, state, ef)  # a first step: caches built, dispatch decided

    def refuse(*a, **k):
        raise AssertionError("a tensor was read back to the host inside the train step")

    with monkeypatch.context() as m:
        for name in _SYNCS:
            m.setattr(torch.Tensor, name, refuse)
        metrics = step({"tokens": tokens}, state, ef)
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
    assert ("ef_residual_norm" in metrics) == compressed
    assert float(metrics["skipped"]) == 0.0 and int(state.step) == 2


def test_skipped_update_keeps_every_bit():
    """``ok=False`` (a non-finite loss): parameters, moments and the step
    count keep their bits; the reported lr is the schedule's."""
    params = {"w": torch.randn(5, 3), "b": torch.randn(3).to(torch.bfloat16)}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2)
    state = adamw.init_state(params)
    adamw.apply_updates(cfg, params, {k: torch.ones_like(v) for k, v in params.items()}, state)
    before = ({k: v.clone() for k, v in params.items()}, {k: v.clone() for k, v in state.mu.items()},
              {k: v.clone() for k, v in state.nu.items()}, state.step.clone())
    nan = {k: torch.full_like(v, float("nan")) for k, v in params.items()}
    m = trainer.guarded_update(cfg, params, nan, state, torch.tensor(float("nan")))
    assert float(m["skipped"]) == 1.0 and isinstance(m["skipped"], torch.Tensor)
    assert float(m["lr"]) == pytest.approx(float(adamw.schedule(cfg, 2)))
    for now, was in zip((params, state.mu, state.nu), before[:3]):
        assert all(torch.equal(now[k], was[k]) for k in was)
    assert torch.equal(state.step, before[3]) and int(state.step) == 1
    m = trainer.guarded_update(cfg, params, {k: torch.ones_like(v) for k, v in params.items()}, state,
                               torch.tensor(1.5))
    assert float(m["skipped"]) == 0.0 and int(state.step) == 2
    assert not torch.equal(params["w"], before[0]["w"])


def test_adamw_slices_keep_every_bit(monkeypatch):
    """The update runs each parameter in slices of ``UPDATE_SLICE``
    entries: slices of 7 (ragged, a 0-d λ among them) give every
    parameter and moment the bits of one pass, over three steps."""
    g = torch.Generator().manual_seed(0)
    base = {"w": torch.randn(5, 9, generator=g), "b": torch.randn(11, generator=g).to(torch.bfloat16),
            "lam": torch.tensor(0.75)}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.5)
    grads = [{k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in base.items()} for _ in range(3)]
    runs = []
    for size in (1 << 26, 7):
        monkeypatch.setattr(adamw, "UPDATE_SLICE", size)
        params = {k: v.clone() for k, v in base.items()}
        state = adamw.init_state(params)
        for gr in grads:
            m = adamw.apply_updates(cfg, params, gr, state)
        runs.append((params, state, m))
    (p1, s1, m1), (p2, s2, m2) = runs
    for a, b in ((p1, p2), (s1.mu, s2.mu), (s1.nu, s2.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(m1["grad_norm"], m2["grad_norm"]) and int(s2.step) == 3
