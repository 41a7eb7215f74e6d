"""Parity of the port's partial-rotary, sliding-window and MoE
architectures (chatglm3-6b, nemotron-4-15b, gemma3-27b, granite-moe-3b,
llama4-maverick) with the JAX reference on the CPU, at each one's smoke
size in f32: configs, parameter counts, the training forward, loss and
gradients, the trainers and checkpoints.  Their serving is held in
``tests/test_torch_archs_serve.py``.

Parameters are made by the reference's ``init_model`` and carried across
by ``repro_torch.bridge``; tokens are made with numpy.  Logits, losses
(cross entropy and the MoE aux loss) and every parameter's gradient are
held within 1e-5 of max|y| (the same f32 products summed in another
order); the 3-step loss trajectory of the trainers within 1e-4 relative
(three updates compound the differences), as for gemma-2b
(``tests/test_torch_train.py``).  gemma3's smoke window is 16 tokens: its
48-token sequences run banded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch import bridge
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.configs import base, get_config, get_smoke
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.runtime import trainer
from torch_parity import SLICE10_ARCHS as ARCHS
from torch_parity import arch_cfgs as _cfgs
from torch_parity import arch_pair as _pair
from torch_parity import arch_tokens as _tokens
from torch_parity import rel_max_err, to_np

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = to_np(got) if isinstance(got, torch.Tensor) else got
    assert rel_max_err(got, np.asarray(want)) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    """``CONFIG`` and ``smoke_config()`` carry the reference's numbers in
    every field, the sharding policies included; the
    registry resolves every alias."""
    for mine, ref in ((get_config(arch), jget_config(arch)), (get_smoke(arch), jget_smoke(arch))):
        want = dataclasses.asdict(ref)
        assert dataclasses.asdict(mine) == want
        assert mine.layer_kinds() == ref.layer_kinds()
    from repro.configs import ALIASES as JALIASES
    from repro_torch.configs import ALIASES

    for alias, name in JALIASES.items():
        assert ALIASES[alias] == name
        if name == arch:
            assert get_config(alias) == get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """``param_count``/``active_param_count`` of the full config are the
    reference's, with and without a FAµST head; a smoke model's parameter
    sizes summed over every parameter but the norms' are its
    ``stored_param_count``, which counts the FAµST head by what it stores."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert base.param_count(cfg) == jbase.param_count(jcfg)
    assert base.active_param_count(cfg) == jbase.active_param_count(jcfg)
    assert (base.active_param_count(cfg) < base.param_count(cfg)) == (cfg.moe is not None)
    for faust in (False, True):
        jcfg, cfg = _cfgs(arch, faust)
        model = LM(cfg, device=CPU)
        n = sum(p.numel() for name, p in model.named_parameters() if "norm" not in name)
        assert n == base.stored_param_count(cfg)
        assert base.param_count(cfg) == jbase.param_count(jcfg)
        if not faust:
            assert base.stored_param_count(cfg) == base.param_count(cfg)


@pytest.mark.parametrize("faust", [False, True], ids=["own_head", "faust_head"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, faust):
    """``forward_train`` logits, ``train_loss`` (loss, ce, aux) and the
    gradient of every parameter over 48 tokens (gemma3: three windows,
    banded), then the state dict back across the bridge bit for bit."""
    jcfg, params, cfg, model = _pair(arch, faust)
    tokens = _tokens(cfg, 2, 48, seed=1)
    batch = {"tokens": jnp.asarray(tokens)}
    (jloss, jmet), jg = jax.value_and_grad(lambda p: jlm.train_loss(p, jcfg, batch), has_aux=True,
                                           allow_int=True)(params)
    jlogits, _ = jlm.forward_train(params, jcfg, batch)
    with torch.no_grad():
        _close(model.forward_train(torch.as_tensor(tokens)), jlogits)
    model.zero_grad()
    loss, met = model.train_loss({"tokens": torch.as_tensor(tokens)})
    loss.backward()
    for k, want in (("loss", jloss), ("ce", jmet["ce"]), ("aux", jmet["aux"])):
        assert met[k].item() == pytest.approx(float(want), rel=TOL, abs=1e-9), k
    assert (met["aux"].item() > 0) == (cfg.moe is not None)
    jflat = bridge.flatten_lm_tree(jax.tree_util.tree_map(np.asarray, jg), cfg)
    names = [n for n, _ in model.named_parameters()]
    assert names and set(names) <= set(jflat)
    for name, p in model.named_parameters():
        assert rel_max_err(to_np(p.grad), jflat[name]) <= TOL, name
    model.zero_grad()
    tree, dtype = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert dtype is None
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), b), params, tree)
    assert jax.tree_util.tree_all(same)


@pytest.mark.parametrize("arch", ["gemma3_27b", "granite_moe_3b"])
def test_bf16_state_crosses_with_an_f32_router(arch):
    """A bf16 tree crosses leaf by leaf: bf16 leaves as bits, the MoE
    router in f32, and back again bit for bit."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs(arch))
    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a), params)
    sd = bridge.lm_state_dict_from_numpy(tree, cfg, dtype="bfloat16", device=CPU)
    model = LM(cfg, device=CPU)
    model.load_state_dict(sd, strict=True)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("moe.router") else torch.bfloat16), name
    back, dtype = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert dtype == "bfloat16"
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(lambda a, b: np.array_equal(a, b), tree, back))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_each_smoke_arch(arch, tmp_path):
    out = launch_train.main(["--arch", arch, "--smoke", "--faust", "--steps", "2", "--batch", "2", "--seq", "16",
                             "--checkpoint-every", "99", "--checkpoint-dir", str(tmp_path), "--device", CPU])
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["model"].cfg.faust_unembed is not None


_DATA = dict(vocab=101, seq_len=16, global_batch=4)
_OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=3)


def test_granite_trainer_losses_match_jax_trainer(tmp_path):
    """Three steps of the reference's Trainer and of the port's on
    granite's smoke config, from the same parameters on the same batches:
    the losses (cross entropy plus the aux loss) agree within 1e-4."""
    jcfg, cfg = _cfgs("granite_moe_3b")
    tc = dict(steps=3, checkpoint_every=1000, log_every=1000)
    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**_DATA), jadamw.AdamWConfig(**_OPT),
                          jtrainer.TrainConfig(checkpoint_dir=str(tmp_path / "ref"), **tc))
    jl = [h["loss"] for h in jt.run(resume=False)["history"]]
    model = LM(cfg, device=CPU)
    tree = jax.tree_util.tree_map(np.asarray, jlm.init_model(jax.random.PRNGKey(0), jcfg))
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device=CPU), strict=True)
    batch = jpipe.global_batch(jpipe.DataConfig(**_DATA), 0)
    with torch.no_grad():
        _, met = model.train_loss({"tokens": torch.as_tensor(np.asarray(batch["tokens"]))})
    assert met["aux"].item() > 0
    t = trainer.Trainer(cfg, pipeline.DataConfig(**_DATA), adamw.AdamWConfig(**_OPT),
                        trainer.TrainConfig(checkpoint_dir=str(tmp_path / "port"), **tc), device=CPU)
    tl = [h["loss"] for h in t.run(model=model)["history"]]
    assert len(tl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_granite_checkpoint_restores_bit_for_bit(tmp_path):
    """A granite smoke trainer saves at step 2; a fresh trainer restores
    every parameter (experts and the router included), moment and the
    step into a new model, bit for bit."""
    _, cfg = _cfgs("granite_moe_3b")

    def make(steps):
        return trainer.Trainer(cfg, pipeline.DataConfig(**_DATA), adamw.AdamWConfig(**_OPT),
                               trainer.TrainConfig(steps=steps, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                                                   log_every=1000), device=CPU)

    def snapshot(out):
        tree = trainer.state_tree(out["model"], out["opt"], out["ef"])
        return {n: t.detach().clone() for n, t in mgr_mod._leaves(tree)}

    saved = snapshot(make(2).run(resume=False))
    assert any("moe.router" in k for k in saved) and any("moe.w_down" in k for k in saved)
    out = make(2).run(model=LM(cfg, seed=7, device=CPU))
    assert out["history"] == []
    restored = snapshot(out)
    assert restored.keys() == saved.keys()
    for k in saved:
        assert torch.equal(saved[k], restored[k]), k


def test_moe_aux_and_its_grads_survive_remat():
    """Under ``remat`` (each layer under ``torch.utils.checkpoint``) the
    loss keeps every layer's aux term and the gradients are the ones
    without it, router included."""
    _, _, cfg, model = _pair("granite_moe_3b")
    tokens = torch.as_tensor(_tokens(cfg, 2, 24, seed=9))
    grads = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad()
        loss, met = model.train_loss({"tokens": tokens})
        loss.backward()
        grads[remat] = (met["aux"].item(), loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    model.cfg = cfg
    model.zero_grad()
    assert grads[True][0] > 0 and grads[True][:2] == pytest.approx(grads[False][:2], rel=1e-6)
    for name, g in grads[False][2].items():
        assert rel_max_err(to_np(grads[True][2][name]), to_np(g)) <= TOL, name
    assert grads[True][2]["layers.0.moe.router"].abs().sum() > 0
