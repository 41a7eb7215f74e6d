"""Parity of the port's mamba2 (``"ssm"``) and zamba2 (``"ssm"`` +
``"shared"``) architectures, mamba2-2.7b and zamba2-7b, with the JAX
reference on the CPU at each one's smoke size in f32: configs, parameter
counts, the training forward, loss and gradients, the trainer, the
bridge's trees (parameters, caches, train state) and checkpoints,
prefill and decode, ``LMExecutor`` + ``Engine``, ``Server`` and the
launchers; and the engine's prefill alignment, the port's one departure
from the reference in this slice.

Parameters are made by the reference's ``init_model`` and carried across
by ``repro_torch.bridge``; tokens are made with numpy.  Logits, losses,
gradients and caches are held within 1e-5 of max|y| (the same f32
products summed in another order), the 3-step trainer losses within 1e-4
relative; greedy tokens, cache positions, slot schedules and counters
must be equal.  zamba2's shared block has one parameter set: its
gradient is the sum over its occurrences, as the reference's.

The prefill alignment: the reference's engine aligns a ragged prefill to
``attn_chunk`` only, so where ``attn_chunk`` is no multiple of the SSD's
chunk (the published 512 over 256; here 16 over 8) a prompt of 12 tokens
reaches ``ssd_chunked`` and raises.  The port prefills the longest prefix
every chunked path takes (``lm.prefill_length``: 8 of 12, 16 of 20) and
replays the rest through decode, as the reference does for attention.
"""
import dataclasses
import functools

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
from repro.optim import compression as jcomp
from repro.runtime import engine as jengine
from repro.runtime import trainer as jtrainer
from repro.runtime.server import Server as JServer
from repro_torch import bridge
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.configs import base, get_config, get_smoke
from repro_torch.data import pipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.layers.attention import KVCache
from repro_torch.layers.mamba2 import MambaCache
from repro_torch.models import lm
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.runtime import engine
from repro_torch.runtime import trainer
from repro_torch.runtime.server import Server
from torch_parity import SSM_ARCHS as ARCHS
from torch_parity import arch_cfgs as _cfgs
from torch_parity import arch_pair as _pair
from torch_parity import arch_tokens as _tokens
from torch_parity import bf16_tree, caches_dict, rel_max_err, same_tree, to_np

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
TOL = 1e-5
@pytest.fixture(autouse=True)
def _clean_reference_quarantine():
    """The reference's engine may demote a FAµST apply and quarantine its
    backend process-wide; leave no quarantine to the tests that share the
    worker."""
    yield
    from repro.api import autotune as jautotune

    jautotune.clear_quarantine()


def _close(got, want, tol=TOL):
    got = to_np(got) if isinstance(got, torch.Tensor) else got
    assert rel_max_err(got, np.asarray(want)) <= tol


@functools.lru_cache(maxsize=None)
def _jsteps(arch: str, attn_chunk: int | None = None):
    """The reference's prefill and decode step for ``arch``'s smoke
    config (at ``attn_chunk`` where given), jitted."""
    jcfg = _pair(arch)[0]
    if attn_chunk is not None:
        jcfg = dataclasses.replace(jcfg, attn_chunk=attn_chunk)
    prefill = jax.jit(lambda p, tokens, caches: jlm.prefill(p, jcfg, {"tokens": tokens}, caches))
    decode = jax.jit(lambda p, tokens, caches: jlm.decode_step(p, jcfg, tokens, caches))
    return prefill, decode


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    """``CONFIG`` and ``smoke_config()`` carry the reference's numbers in
    every field, the sharding policies and the ``Mamba2Spec`` included;
    the registry serves both under their aliases, and every architecture
    of the reference is known (no ``LATER`` list is left)."""
    from repro.configs import ALIASES as JALIASES
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch import configs
    from repro_torch.configs import ALIASES, ARCH_IDS

    for mine, ref in ((get_config(arch), jget_config(arch)), (get_smoke(arch), jget_smoke(arch))):
        want = dataclasses.asdict(ref)
        assert dataclasses.asdict(mine) == want
        assert mine.layer_kinds() == ref.layer_kinds()
        assert mine.ssm.n_heads == ref.ssm.n_heads and mine.ssm.conv_dim == ref.ssm.conv_dim
    for alias, name in JALIASES.items():
        if name == arch:
            assert ALIASES[alias] == name and get_config(alias) == get_config(arch)
    assert arch in ARCH_IDS and sorted(ARCH_IDS) == sorted(JARCH_IDS) and not hasattr(configs, "LATER")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """``param_count`` is the reference's at the full and the smoke config
    (2,702,068,736 for mamba2-2.7b, 5,736,665,408 for zamba2-7b), the
    shared block counted once; a model's parameter sizes summed over every
    parameter but the norms' are its ``stored_param_count``, which counts
    each mamba block's ``conv_b`` and not its ``norm_w``."""
    want = {"mamba2_2p7b": 2_702_068_736, "zamba2_7b": 5_736_665_408}[arch]
    assert base.param_count(get_config(arch)) == jbase.param_count(jget_config(arch)) == want
    for faust in (False, True):
        jcfg, cfg = _cfgs(arch, faust)
        assert base.param_count(cfg) == jbase.param_count(jcfg)
        model = LM(cfg, device=CPU)
        n = sum(p.numel() for name, p in model.named_parameters() if "norm" not in name)
        assert n == base.stored_param_count(cfg)
        n_ssm = cfg.layer_kinds().count("ssm")
        if not faust:
            assert base.stored_param_count(cfg) - base.param_count(cfg) == n_ssm * (cfg.ssm.conv_dim - cfg.ssm.d_inner)
        shared = [k for k, _ in model.named_parameters() if k.startswith("shared.")]
        assert bool(shared) == ("shared" in cfg.layer_kinds())
        assert not any(".shared." in k for k, _ in model.named_parameters())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faust", [False, True], ids=["own_head", "faust_head"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, faust):
    """``forward_train`` logits, ``train_loss`` and the gradient of every
    parameter over 24 tokens (three SSD chunks), zamba2's shared block's
    one gradient (summed over its occurrences) included; then the state
    dict back across the bridge, the reference's tree with its empty
    ``"shared"`` stage positions, bit for bit."""
    jcfg, params, cfg, model = _pair(arch, faust)
    tokens = _tokens(cfg, 2, 24, seed=1)
    batch = {"tokens": jnp.asarray(tokens)}
    (jloss, jmet), jg = jax.value_and_grad(lambda p: jlm.train_loss(p, jcfg, batch), has_aux=True,
                                           allow_int=True)(params)
    jlogits, _ = jlm.forward_train(params, jcfg, batch)
    with torch.no_grad():
        _close(model.forward_train(torch.as_tensor(tokens)), jlogits)
    model.zero_grad()
    loss, met = model.train_loss({"tokens": torch.as_tensor(tokens)})
    loss.backward()
    for k in ("loss", "ce"):
        assert met[k].item() == pytest.approx(float(jmet[k]), rel=TOL), k
    jflat = bridge.flatten_lm_tree(jax.tree_util.tree_map(np.asarray, jg), cfg)
    names = [n for n, _ in model.named_parameters()]
    assert names and set(names) <= set(jflat)
    for name, p in model.named_parameters():
        assert rel_max_err(to_np(p.grad), jflat[name]) <= TOL, name
    if "shared" in cfg.layer_kinds():
        assert float(model.shared.attn.wq.grad.abs().sum()) > 0
    model.zero_grad()
    tree, dtype = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert dtype is None and same_tree(params, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_chunk_covers_every_chunked_path(arch):
    """``forward_train(chunk=S)`` runs attention and the SSD each as one
    chunk of the whole sequence: at 20 tokens, no multiple of ``ssm.chunk``
    8 (the default chunks raise in the SSD), its logits are the
    reference's with ``attn_chunk`` and ``ssm.chunk`` both 20."""
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens(cfg, 2, 20, seed=2)
    jcfg20 = dataclasses.replace(jcfg, attn_chunk=20, ssm=dataclasses.replace(jcfg.ssm, chunk=20))
    jlogits, _ = jlm.forward_train(params, jcfg20, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        _close(model.forward_train(torch.as_tensor(tokens), chunk=20), jlogits)
        with pytest.raises(ValueError, match="SSD chunk"):
            model.forward_train(torch.as_tensor(tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_loss_and_grads(arch):
    """Under ``remat`` (each layer, the shared block at each of its
    positions, under ``torch.utils.checkpoint``) the loss and every
    gradient are the ones without it."""
    _, _, cfg, model = _pair(arch)
    tokens = torch.as_tensor(_tokens(cfg, 2, 16, seed=9))
    out = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad()
        loss, _ = model.train_loss({"tokens": tokens})
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    model.cfg = cfg
    model.zero_grad()
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, g in out[False][1].items():
        assert rel_max_err(to_np(out[True][1][name]), to_np(g)) <= TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_state_crosses_with_f32_mamba_vectors(arch):
    """A bf16 tree crosses leaf by leaf: bf16 leaves as bits, each mamba
    block's ``a_log``, ``d_skip`` and ``dt_bias`` in f32, and back again
    bit for bit."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs(arch))
    tree = bf16_tree(jlm.init_model(jax.random.PRNGKey(0), jcfg))
    model = LM(cfg, device=CPU)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, dtype="bfloat16", device=CPU), strict=True)
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert f32 and all(n.rsplit(".", 1)[1] in ("a_log", "d_skip", "dt_bias") for n in f32)
    assert len(f32) == 3 * cfg.layer_kinds().count("ssm")
    back, dtype = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert dtype == "bfloat16" and same_tree(tree, back)


_DATA = dict(seq_len=16, global_batch=4)
_OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_losses_match_jax_trainer(arch, tmp_path):
    """Three steps of the reference's Trainer and of the port's from the
    same parameters on the same batches: losses within 1e-4 relative."""
    jcfg, cfg = _cfgs(arch)
    data = dict(vocab=cfg.vocab, **_DATA)
    tc = dict(steps=3, checkpoint_every=1000, log_every=1000)
    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**data), jadamw.AdamWConfig(**_OPT),
                          jtrainer.TrainConfig(checkpoint_dir=str(tmp_path / "ref"), **tc))
    jl = [h["loss"] for h in jt.run(resume=False)["history"]]
    model = LM(cfg, device=CPU)
    tree = jax.tree_util.tree_map(np.asarray, jlm.init_model(jax.random.PRNGKey(0), jcfg))
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device=CPU), strict=True)
    t = trainer.Trainer(cfg, pipeline.DataConfig(**data), adamw.AdamWConfig(**_OPT),
                        trainer.TrainConfig(checkpoint_dir=str(tmp_path / "port"), **tc), device=CPU)
    tl = [h["loss"] for h in t.run(model=model)["history"]]
    assert len(tl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_train_state_round_trips_through_the_bridge():
    """zamba2's bf16 trainer state from the reference (``TrainState.init``
    with EF, random moments): the shared block's moments once, the f32
    mamba vectors' moments beside the bf16 ones, and back to the
    reference's tree bit for bit."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs("zamba2_7b"))
    state = jtrainer.TrainState.init(jax.random.PRNGKey(1), jcfg, jadamw.AdamWConfig(), jcomp.TopKConfig(0.1))
    rng = np.random.default_rng(0)
    state["opt"] = state["opt"]._replace(
        mu=jax.tree_util.tree_map(lambda m: jnp.asarray(rng.standard_normal(m.shape), jnp.float32), state["opt"].mu),
        step=jnp.asarray(5, jnp.int32))
    tree = bf16_tree(state)
    sd, opt, ef = bridge.train_state_from_numpy(tree, cfg, dtype="bfloat16", device=CPU)
    model = LM(cfg, device=CPU)
    model.load_state_dict(sd, strict=True)
    names = {k for k, _ in model.named_parameters()}
    assert set(opt.mu) == set(opt.nu) == set(ef.residual) == names and int(opt.step) == 5
    assert "shared.attn.wq" in names and opt.mu["layers.0.mamba.a_log"].dtype == torch.float32
    back, dtype = bridge.train_state_to_numpy(model.state_dict(), opt, ef, cfg)
    assert dtype == "bfloat16"
    assert same_tree(tree["params"], back["params"])
    assert same_tree(tree["opt"].mu, back["opt"]["mu"]) and same_tree(tree["opt"].nu, back["opt"]["nu"])
    assert same_tree(tree["ef"].residual, back["ef"]["residual"]) and int(back["opt"]["step"]) == 5


def test_zamba2_checkpoint_holds_the_shared_block_once(tmp_path):
    """A zamba2 smoke trainer saves at step 2; the checkpoint holds the
    shared block's parameters and moments once, and a fresh trainer
    restores every tensor into a new model bit for bit."""
    _, cfg = _cfgs("zamba2_7b")
    data = pipeline.DataConfig(vocab=cfg.vocab, **_DATA)

    def make(steps):
        return trainer.Trainer(cfg, data, adamw.AdamWConfig(**_OPT),
                               trainer.TrainConfig(steps=steps, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                                                   log_every=1000), device=CPU)

    def snapshot(out):
        tree = trainer.state_tree(out["model"], out["opt"], out["ef"])
        return {n: t.detach().clone() for n, t in mgr_mod._leaves(tree)}

    saved = snapshot(make(2).run(resume=False))
    for part in ("params", "opt/mu", "opt/nu"):
        assert sum(k.startswith(f"{part}/shared.") for k in saved) == len(list(LM(cfg, device=CPU).shared.parameters()))
    assert any(k.endswith("mamba.dt_bias") for k in saved)
    out = make(2).run(model=LM(cfg, seed=7, device=CPU))
    assert out["history"] == []
    restored = snapshot(out)
    assert restored.keys() == saved.keys()
    for k in saved:
        assert torch.equal(saved[k], restored[k]), k
    assert trainer.reference_name("shared.attn.wq") == "shared/attn/wq"


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_each_smoke_arch(arch, tmp_path):
    """``launch.train --faust`` unties mamba2's head and trains two steps."""
    out = launch_train.main(["--arch", arch, "--smoke", "--faust", "--steps", "2", "--batch", "2", "--seq", "16",
                             "--checkpoint-every", "99", "--checkpoint-dir", str(tmp_path), "--device", CPU])
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["model"].cfg.faust_unembed is not None and not out["model"].cfg.tie_embeddings


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _same_caches(caches, jcaches, cfg):
    got, _ = bridge.caches_to_numpy(caches, cfg)
    want, _ = caches_dict(jcaches)
    for gs, ws in zip(got, want, strict=True):
        for g, w in zip(gs, ws, strict=True):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["pos"], w["pos"])
            for name in set(w) - {"pos"}:
                assert g[name].shape == w[name].shape and g[name].dtype == w[name].dtype
                _close(g[name], w[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` of 24 tokens (three SSD chunks) and three
    ``decode_step``s: logits and every cache (``MambaCache`` conv, state
    and pos; the shared block's ``KVCache`` per occurrence) against the
    reference's; greedy tokens equal."""
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens(cfg, 2, 24, seed=2)
    jprefill, jdecode = _jsteps(arch)
    jcaches = jlm.make_caches(jcfg, 2, 32, dtype=jnp.float32)
    caches = lm.make_caches(cfg, 2, 32, dtype=torch.float32, device=CPU)
    jlogits, jcaches = jprefill(params, jnp.asarray(tokens), jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(torch.as_tensor(tokens), caches)
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
def test_caches_cross_the_bridge_and_the_slot_pool(arch):
    """Each layer's cache type is the reference's (zamba2's pool: a
    ``MambaCache`` per ssm layer, a ``KVCache`` per shared occurrence); a
    bf16 pool crosses the bridge both ways bit for bit; gathering and
    scattering slots keep each cache's type and rows, as the reference's."""
    jcfg, _, cfg, _ = _pair(arch)
    rng = np.random.default_rng(4)
    jpool = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else jnp.asarray(rng.integers(0, 30, a.shape), a.dtype), jlm.make_caches(jcfg, 3, 24, dtype=jnp.bfloat16))
    tree, dtype = caches_dict(jpool)
    assert dtype == "bfloat16"
    pool = bridge.caches_from_numpy(tree, cfg, dtype=dtype, device=CPU)
    kinds = cfg.layer_kinds()
    assert [type(c) for c in pool] == [MambaCache if k == "ssm" else KVCache for k in kinds]
    empty = lm.make_caches(cfg, 3, 24, dtype=torch.bfloat16, device=CPU)
    assert [type(c) for c in empty] == [type(c) for c in pool]
    for e, p in zip(empty, pool):
        assert [(t.shape, t.dtype) for t in e] == [(t.shape, t.dtype) for t in p]
    back, back_dtype = bridge.caches_to_numpy(pool, cfg)
    assert back_dtype == "bfloat16" and same_tree(tree, back)
    slots = torch.tensor([2, 0])
    live = lm.gather_cache_slots(pool, slots)
    jlive = jlm.gather_cache_slots(jpool, jnp.asarray([2, 0]))
    assert [type(c) for c in live] == [type(c) for c in pool]
    assert same_tree(bridge.caches_to_numpy(live, cfg)[0], caches_dict(jlive)[0])
    jlive2 = jax.tree_util.tree_map(lambda a: a + 1, jlive)
    live2 = bridge.caches_from_numpy(caches_dict(jlive2)[0], cfg, dtype="bfloat16", device=CPU)
    lm.scatter_cache_slots(pool, live2, slots)
    jpool = jlm.scatter_cache_slots(jpool, jlive2, jnp.asarray([2, 0]))
    assert same_tree(bridge.caches_to_numpy(pool, cfg)[0], caches_dict(jpool)[0])


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
    re-prefill, replayed through decode), slot reuse."""
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
    with an eviction (zamba2 with the FAµST head): tokens, the slot
    schedule and the counters equal; the pool holds the reference's cache
    types."""
    jcfg, params, cfg, model = _pair(arch, arch == "zamba2_7b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (6, 12, 9)]
    budgets = (14, 6, 8)
    jex = _Log(jengine.LMExecutor(jcfg, params, 40, n_slots=2))
    ex = _Log(engine.LMExecutor(model, 40, n_slots=2))
    jeng, eng = jengine.Engine(jex), engine.Engine(ex)
    jrids, rids = _trace(jeng, prompts, budgets), _trace(eng, prompts, budgets)
    assert rids == jrids
    for r in rids:
        np.testing.assert_array_equal(eng.result(r), jeng.result(r))
    assert ex.calls == jex.calls
    assert _stats(eng.stats) == _stats(jeng.stats)
    assert any(c[0] == "prefill" and c[2] > cfg.ssm.chunk and c[2] % cfg.ssm.chunk for c in ex.calls)
    kinds = cfg.layer_kinds()
    assert sum(isinstance(c, MambaCache) for c in ex.pool) == kinds.count("ssm")
    assert sum(isinstance(c, KVCache) for c in ex.pool) == kinds.count("shared")


def _reference_composition(arch, prompt, budget, head: int, attn_chunk: int):
    """The reference's ``lm.prefill`` of the prompt's first ``head`` tokens,
    its rest fed through ``decode_step`` one by one, then ``budget`` greedy
    tokens."""
    jcfg, params, _, _ = _pair(arch)
    jprefill, jdecode = _jsteps(arch, attn_chunk)
    caches = jlm.make_caches(jcfg, 1, 48, dtype=jnp.float32)
    logits, caches = jprefill(params, jnp.asarray(prompt[None, :head]), caches)
    for t in prompt[head:]:
        logits, caches = jdecode(params, jnp.asarray([[t]]), caches)
    out = []
    for _ in range(budget):
        tok = np.asarray(jlm.greedy_token(logits))[:, -1:]
        out.append(int(tok[0, 0]))
        logits, caches = jdecode(params, jnp.asarray(tok), caches)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_aligns_to_the_ssd_chunk(arch):
    """With ``attn_chunk`` 16 over ``ssm.chunk`` 8 (the published 512 over
    256), the reference's ``lm.prefill`` raises on a 12-token prompt; the
    port's engine serves 12 and 20 tokens, token-equal to the reference's
    prefill of the aligned prefix (8, 16) followed by ``decode_step``s,
    and to the reference's engine at ``attn_chunk`` 8, where its own
    alignment holds."""
    jcfg, params, cfg, model = _pair(arch)
    cfg16 = dataclasses.replace(cfg, attn_chunk=16)
    assert [lm.prefill_length(cfg16, n) for n in (8, 12, 16, 20, 33)] == [8, 8, 16, 16, 32]
    assert [lm.prefill_length(cfg, n) for n in (8, 12, 20)] == [8, 8, 16]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (12, 20)]
    with pytest.raises(AssertionError):
        jlm.prefill(params, dataclasses.replace(jcfg, attn_chunk=16), {"tokens": jnp.asarray(prompts[0][None])},
                    jlm.make_caches(jcfg, 1, 48, dtype=jnp.float32))
    model16 = LM(cfg16, device=CPU)
    model16.load_state_dict(model.state_dict(), strict=True)
    ex = _Log(engine.LMExecutor(model16, 48, n_slots=2))
    eng = engine.Engine(ex)
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    got = [eng.result(r).tolist() for r in rids]
    assert [c[2] for c in ex.calls if c[0] == "prefill"] == [12, 20]
    assert eng.stats.completed == 2
    assert got == [_reference_composition(arch, p, 6, head, 16) for p, head in zip(prompts, (8, 16))]
    jeng = jengine.Engine(jengine.LMExecutor(jcfg, params, 48, n_slots=2))
    jrids = [jeng.submit(p, 6) for p in prompts]
    jeng.run()
    assert got == [jeng.result(r).tolist() for r in jrids]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_and_launch_serve_match_reference(arch, capsys):
    """``Server.generate`` against the reference's, and ``launch.serve
    --arch`` on the smoke config."""
    jcfg, params, cfg, model = _pair(arch)
    tokens = _tokens(cfg, 2, 6, seed=6)
    jgen, _ = JServer(jcfg, params, max_len=24).generate({"tokens": jnp.asarray(tokens)}, 12)
    gen, stats = Server(model, max_len=24).generate({"tokens": tokens}, 12)
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    assert stats.tokens_decoded == 24
    gen, stats = launch_serve.main(["--arch", arch, "--smoke", "--device", CPU, "--batch", "2", "--prompt-len", "12",
                                    "--new-tokens", "3"])
    assert gen.shape == (2, 3) and stats.tokens_decoded == 6
    assert "generated shape: (2, 3)" in capsys.readouterr().out
