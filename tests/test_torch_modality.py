"""Parity of the port's modality front ends with the JAX reference on the
CPU, at the smoke sizes: internvl2-2b's vision embeddings (``vision_embeds``
in place of the first ``n_vision_tokens`` positions) and musicgen-medium's
codebooks (tokens ``(B, K, S)``, K summed tables, sinusoidal positions, K
heads, logits ``(B, S, K, V)``).  Configs and counts, batches, the
training forward, loss and gradients (``embed.table (K, V, d)`` included),
prefill and decode with pool rows at different positions, ``Engine`` +
``LMExecutor`` with a replayed prompt and an eviction whose re-prefill
carries its extras, ``Server``, microbatches, the bridge's train state and
checkpoints, the recompression's selection, the stacked heads' hot-swap,
and the one departure from the reference (caveat R6: a sequence shorter
than ``n_vision_tokens``).

Parameters are made by the port (``LM(cfg, seed=0)``) and carried to the
reference's tree by ``repro_torch.bridge`` (the reference's ``init_model``
takes seconds a config on the CPU; the other direction is held by the
train-state test); tokens and embeddings are made with numpy.
Logits, losses and gradients are held within 1e-5 of max|y| in f32 (the
same products summed in another order) and 3e-2 in bf16; served tokens,
slot schedules, counters and cache positions must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
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
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base, get_config, get_smoke
from repro_torch.data import pipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.layers.faust_linear import StackedFaustLinear
from repro_torch.models import lm
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.optim.compression import TopKConfig
from repro_torch.runtime import engine, trainer
from repro_torch.runtime.server import Server
from torch_parity import arch_cfgs as _cfgs
from torch_parity import bf16_tree, caches_dict, rel_max_err, same_tree, to_np

jax.config.update("jax_platform_name", "cpu")
CPU = "cpu"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ARCHS = ["internvl2_2b", "musicgen_medium"]
_POLICIES = ("policy", "policy_decode")


@pytest.fixture(autouse=True)
def _clean_reference_quarantine():
    """The reference's engine may demote a FAµST apply and quarantine its
    backend process-wide; leave no quarantine to the tests that share the
    worker."""
    yield
    from repro.api import autotune as jautotune

    jautotune.clear_quarantine()


@functools.lru_cache(maxsize=None)
def _pair(arch: str, faust: bool = False, dtype: str = "float32"):
    """(reference cfg, reference params, port cfg, port LM on the CPU) on
    the port's parameters from seed 0, in ``dtype``, the reference's tree
    rebuilt by ``bridge.lm_state_dict_to_numpy`` (bf16 from its bits)."""
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs(arch, faust))
    model = LM(cfg, seed=0, device=CPU)
    tree, _ = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16 else a), tree)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0), jcfg)))
    return jcfg, params, cfg, model


@functools.lru_cache(maxsize=None)
def _jtrain(arch: str, faust: bool, dtype: str):
    """The reference's ``train_loss`` value and gradient with its
    ``forward_train`` logits, jitted for ``arch``'s smoke config."""
    jcfg = _pair(arch, faust, dtype)[0]

    def fn(params, batch):
        (loss, _), grads = jax.value_and_grad(lambda p: jlm.train_loss(p, jcfg, batch), has_aux=True,
                                              allow_int=True)(params)
        return loss, grads, jlm.forward_train(params, jcfg, batch)[0]

    return jax.jit(fn)


MAX_LEN = 40


@functools.lru_cache(maxsize=None)
def _jexecutor(arch: str):
    """The reference's executor (FAµST heads, 2 slots of ``MAX_LEN``),
    shared by the serving tests so that each shape compiles once; every
    prefill overwrites its slot's rows whole."""
    jcfg, params, _, _ = _pair(arch, True)
    return jengine.LMExecutor(jcfg, params, MAX_LEN, n_slots=2)


def _jserver(arch: str):
    """The reference's ``Server`` on :func:`_jexecutor`'s executor."""
    jcfg, params, _, _ = _pair(arch, True)
    server = JServer(jcfg, params, max_len=MAX_LEN)
    server._executor = _jexecutor(arch)
    return server


def _tokens(cfg, rng, b: int, s: int) -> np.ndarray:
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens, and for a vision config ``vision_embeds``, from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(cfg, rng, b, s)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = (rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _prompt(cfg, rng, n: int) -> tuple[np.ndarray, dict]:
    """One request: a prompt ``(n,)`` or ``(K, n)`` and its extras."""
    prompt = _tokens(cfg, rng, 1, n)[0]
    extras = {}
    if cfg.n_vision_tokens:
        extras["vision_embeds"] = (rng.standard_normal((cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return prompt, extras


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    got = to_np(got) if isinstance(got, torch.Tensor) else got
    assert rel_max_err(got, np.asarray(want, np.float32)) <= tol


# ---------------------------------------------------------------------------
# configs, counts, batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    """``CONFIG`` and ``smoke_config()`` carry the reference's numbers in
    every field but its sharding policies; ``param_count`` is the
    reference's (1,889,046,528 for internvl2-2b, 1,384,120,320 for
    musicgen-medium); a model's parameters but the norms' sum to its
    ``stored_param_count`` (K tables, K heads, a λ per FAµST head); the
    model with its FAµST heads moves with ``.to``."""
    for mine, ref in ((get_config(arch), jget_config(arch)), (get_smoke(arch), jget_smoke(arch))):
        want = {k: v for k, v in dataclasses.asdict(ref).items() if k not in _POLICIES}
        assert dataclasses.asdict(mine) == want
    want = {"internvl2_2b": 1_889_046_528, "musicgen_medium": 1_384_120_320}[arch]
    assert base.param_count(get_config(arch)) == jbase.param_count(jget_config(arch)) == want
    for faust in (False, True):
        jcfg, _, cfg, model = _pair(arch, faust)
        assert base.param_count(cfg) == jbase.param_count(jcfg)
        assert sum(p.numel() for n, p in model.named_parameters() if "norm" not in n) == base.stored_param_count(cfg)
    k = get_smoke(arch).n_codebooks
    assert tuple(_pair(arch)[3].embed.table.shape) == ((k,) if k > 1 else ()) + (cfg.vocab, cfg.d_model)
    moved = LM(cfg, device=CPU).to(torch.bfloat16)  # nn.Module.to: the FAµST heads' own helpers must not shadow it
    assert {p.dtype for p in moved.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_references_bit_for_bit(arch):
    """Tokens ``(B, K, S)`` for musicgen; ``vision_embeds`` drawn after the
    tokens for internvl2: every leaf's dtype, shape and bits."""
    cfg = get_smoke(arch)
    kw = dict(vocab=cfg.vocab, seq_len=12, global_batch=3, seed=4, n_codebooks=cfg.n_codebooks,
              n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model)
    for step in (0, 5):
        want = jpipe.global_batch(jpipe.DataConfig(**kw), step)
        got = pipeline.global_batch(pipeline.DataConfig(**kw), step)
        assert got.keys() == want.keys() == ({"tokens", "vision_embeds"} if cfg.n_vision_tokens else {"tokens"})
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["tokens"].shape == ((3, cfg.n_codebooks, 12) if cfg.n_codebooks > 1 else (3, 12))


# ---------------------------------------------------------------------------
# training forward, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faust,dtype", [(False, "float32"), (True, "float32"), (True, "bfloat16")],
                         ids=["dense_head-f32", "faust_head-f32", "faust_head-bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, faust, dtype):
    """``forward_train`` logits, ``train_loss`` and every parameter's
    gradient (the stacked ``embed.table`` and heads included) over 16
    positions, then the state dict back to the reference's tree bit for
    bit.  In bf16 a FAµST head's λ gradient is left to the f32 cases: it
    sums dy·y over every logit, and each row's dy sums to zero, so the
    terms cancel and the bf16 rounding of dy and y alone moves the result
    by several percent (7 % on internvl2's smoke head)."""
    jcfg, params, cfg, model = _pair(arch, faust, dtype)
    tol = TOL[dtype]
    batch = _batch(cfg, 2, 16, seed=1)
    jloss, jg, jlogits = _jtrain(arch, faust, dtype)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits = model.forward_train(tb["tokens"], vision_embeds=tb.get("vision_embeds"))
    k = cfg.n_codebooks
    assert logits.shape == ((2, 16, k, cfg.vocab) if k > 1 else (2, 16, cfg.vocab)) and logits.dtype == torch.float32
    _close(logits, jlogits, tol)
    model.zero_grad()
    loss, _ = model.train_loss(tb)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=tol)
    jflat = bridge.flatten_lm_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(()) if a.dtype == jax.dtypes.float0 else np.asarray(a, np.float32), jg), cfg)
    for name, p in model.named_parameters():
        if dtype == "bfloat16" and name.endswith("faust.lam"):
            continue
        assert rel_max_err(to_np(p.grad), jflat[name]) <= tol, name
    if k > 1:
        assert model.embed.table.grad.shape == (k, cfg.vocab, cfg.d_model)
    model.zero_grad(set_to_none=True)
    tree, _ = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    assert same_tree(bf16_tree(params), tree)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _same_pool(pool, jpool, cfg):
    got, _ = bridge.caches_to_numpy(pool, cfg)
    want, _ = caches_dict(jpool)
    for gs, ws in zip(got, want, strict=True):
        for g, w in zip(gs, ws, strict=True):
            np.testing.assert_array_equal(g["pos"], w["pos"])
            for name in ("k", "v"):
                _close(g[name], w[name], TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_rows_at_their_own_positions(arch):
    """Two slots prefilled at 9 (8 whole, one replayed) and 16 tokens, each
    with its own extras, then three decode steps of both rows together:
    logits and the pool (positions 9 and 16 onward: musicgen's sinusoid
    reads each row's own) against the reference's executor."""
    _, _, cfg, model = _pair(arch, True)
    rng = np.random.default_rng(2)
    reqs = [_prompt(cfg, rng, n) for n in (9, 16)]
    jex = _jexecutor(arch)
    ex = engine.LMExecutor(model, MAX_LEN, n_slots=2)
    for slot, (prompt, extras) in enumerate(reqs):
        _close(ex.prefill_forward(slot, prompt, extras), jex.prefill_forward(slot, prompt, extras), TOL["float32"])
    _same_pool(ex.pool, jex.pool, cfg)
    assert [int(p) for p in ex.pool[0].pos] == [9, 16]
    slots = [1, 0]
    toks = np.stack([_tokens(cfg, rng, 1, 1)[0] for _ in slots])
    for _ in range(3):
        jlogits = jex.decode_forward(slots, toks)
        logits = ex.decode_forward(slots, toks)
        _close(logits, jlogits, TOL["float32"])
        toks = ex.sample(logits)
        np.testing.assert_array_equal(toks, jex.sample(jlogits))
        assert toks.shape == ((2, cfg.n_codebooks, 1) if cfg.n_codebooks > 1 else (2, 1))
    _same_pool(ex.pool, jex.pool, cfg)
    assert [int(p) for p in ex.pool[0].pos] == [12, 19]


class _Log:
    """Executor proxy that logs every prefill's slot, length and extras'
    keys, and every decode's slots."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill_forward(self, slot, prompt, extras):
        self.calls.append(("prefill", slot, np.asarray(prompt).shape[-1], tuple(sorted(extras))))
        return self.inner.prefill_forward(slot, prompt, extras)

    def decode_forward(self, slots, tokens):
        self.calls.append(("decode", tuple(int(s) for s in slots)))
        return self.inner.decode_forward(slots, tokens)


def _trace(eng, reqs, budgets):
    """Staggered arrivals, an eviction and its re-admission (a ragged
    re-prefill, replayed through decode), slot reuse."""
    rids = [eng.submit(reqs[0][0], budgets[0], extras=reqs[0][1])]
    eng.step()
    rids.append(eng.submit(reqs[1][0], budgets[1], extras=reqs[1][1]))
    eng.step()
    eng.step()
    assert eng.evict(rids[0])
    rids.append(eng.submit(reqs[2][0], budgets[2], extras=reqs[2][1]))
    eng.run()
    return rids


def _stats(es):
    return (es.steps, es.admitted, es.completed, es.evicted, es.tokens_decoded, dict(es.occupancy),
            es.retries, es.failed, es.quarantined)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_trace_matches_reference(arch):
    """``LMExecutor`` + ``Engine`` against the reference's (FAµST heads) on
    one trace: a ragged 12-token prompt (8 prefilled, 4 replayed), an
    eviction whose re-prefill of prompt + generated carries the request's
    extras; tokens ``(n,)`` or ``(K, n)``, the slot schedule and the
    counters equal."""
    _, _, cfg, model = _pair(arch, True)
    rng = np.random.default_rng(5)
    reqs = [_prompt(cfg, rng, n) for n in (12, 8, 9)]
    budgets = (14, 6, 8)
    jex = _Log(_jexecutor(arch))
    ex = _Log(engine.LMExecutor(model, MAX_LEN, n_slots=2))
    jeng, eng = jengine.Engine(jex), engine.Engine(ex)
    jrids, rids = _trace(jeng, reqs, budgets), _trace(eng, reqs, budgets)
    assert rids == jrids
    for r, b in zip(rids, budgets):
        out = eng.result(r)
        assert out.shape == ((cfg.n_codebooks, b) if cfg.n_codebooks > 1 else (b,))
        np.testing.assert_array_equal(out, jeng.result(r))
    assert ex.calls == jex.calls
    assert _stats(eng.stats) == _stats(jeng.stats)
    prefills = [c for c in ex.calls if c[0] == "prefill"]
    assert len(prefills) == 4 and prefills[0][2] == 12 and prefills[2][:3] == ("prefill", 0, 16)  # the re-prefill
    want = ("vision_embeds",) if cfg.n_vision_tokens else ()
    assert all(c[3] == want for c in prefills)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_and_launch_serve_match_reference(arch, capsys):
    """``Server.generate`` against the reference's on a batch whose every
    non-token key (``vision_embeds``) rides on each row's request, at a
    ragged length (12: 8 prefilled, 4 replayed); ``_sample``'s shapes; and
    ``launch.serve --arch`` on the smoke config."""
    _, _, cfg, model = _pair(arch, True)
    batch = _batch(cfg, 2, 12, seed=6)
    jgen, _ = _jserver(arch).generate({k: jnp.asarray(v) for k, v in batch.items()}, 10)
    server = Server(model, max_len=MAX_LEN)
    gen, stats = server.generate(batch, 10)
    k = cfg.n_codebooks
    assert gen.shape == ((2, k, 10) if k > 1 else (2, 10))
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    assert stats.tokens_decoded == 20
    logits = torch.randn((2, 1, k, cfg.vocab) if k > 1 else (2, 1, cfg.vocab))
    assert tuple(server._sample(logits).shape) == ((2, k, 1) if k > 1 else (2, 1))
    gen, stats = launch_serve.main(["--arch", arch, "--smoke", "--device", CPU, "--batch", "2", "--prompt-len", "12",
                                    "--new-tokens", "3"])
    assert gen.shape == ((2, k, 3) if k > 1 else (2, 3)) and stats.tokens_decoded == 6
    assert f"generated shape: {gen.shape}" in capsys.readouterr().out


def test_stacked_heads_refuse_the_hot_swap():
    """musicgen's per-codebook FAµST heads: the hot-swap and the published
    chain raise ``NotImplementedError``, as the reference's swap does; the
    executor's advisory dispatch queries head 0; internvl2's single head
    still publishes its chain."""
    _, _, cfg, model = _pair("musicgen_medium", True)
    head = model.unembed.faust
    assert isinstance(head, StackedFaustLinear) and head.lam.shape == (cfg.n_codebooks,)
    with pytest.raises(NotImplementedError, match="stacked per-codebook heads"):
        engine.unembed_blockfaust(model)
    with pytest.raises(NotImplementedError, match="stacked per-codebook heads"):
        engine.swap_unembed(model, head.blockfaust(1))
    ex = engine.LMExecutor(model, 16, n_slots=2)
    with pytest.raises(NotImplementedError):
        ex.swap_unembed(head.blockfaust(0))
    with pytest.raises(NotImplementedError):
        Server(model, max_len=16).swap_unembed(head.blockfaust(0))
    assert ex._faust_op.rep.factors[0].values.data_ptr() == head.factors[0].values[0].data_ptr()
    assert ex.dispatch_for(3) is not None
    _, _, _, vlm = _pair("internvl2_2b", True)
    assert len(engine.unembed_blockfaust(vlm).factors) == 2


# ---------------------------------------------------------------------------
# training: microbatches, train state, checkpoints, recompression
# ---------------------------------------------------------------------------


_OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=3)


def _data(cfg, **kw):
    return dict(vocab=cfg.vocab, seq_len=16, global_batch=4, n_codebooks=cfg.n_codebooks,
                n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_split_every_leaf(arch):
    """Two microbatches against one on the same batch, as the reference
    splits every leaf of it: the loss and every updated parameter (a
    ``vision_embeds`` split otherwise than the tokens would show)."""
    cfg = _pair(arch)[2]
    batch = _torch_batch(pipeline.global_batch(pipeline.DataConfig(**_data(cfg)), 0))
    out = {}
    for n in (1, 2):
        model = LM(cfg, device=CPU)
        model.load_state_dict(_pair(arch)[3].state_dict())
        step = trainer.make_train_step(model, adamw.AdamWConfig(**_OPT), trainer.TrainConfig(microbatches=n))
        met = step(batch, adamw.init_state(dict(model.named_parameters())))
        out[n] = (float(met["loss"]), {k: v.detach().clone() for k, v in model.state_dict().items()})
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    for k, v in out[1][1].items():
        assert rel_max_err(to_np(out[2][1][k]), to_np(v)) <= 1e-5, k
    if cfg.n_vision_tokens:  # the image rows are not interchangeable: swapping them moves the loss
        swapped = dict(batch, vision_embeds=batch["vision_embeds"].flip(0))
        assert _pair(arch)[3].train_loss(swapped)[0].item() != pytest.approx(out[1][0], rel=1e-6)


def test_train_state_and_checkpoint_in_the_references_tree(tmp_path):
    """musicgen's bf16 trainer state with FAµST heads and EF: the
    reference's (``adamw.init_state`` and ``ef_topk_init`` of its tree,
    random moments) through the bridge
    and back bit for bit (stacked tables, heads and their moments; the
    supports' 0-d moments); then the port's trainer saves a step with that
    tree's leaves under the reference's paths, and the reference's
    manager restores it into its own state's structure, every leaf equal."""
    _, params, cfg, _ = _pair("musicgen_medium", True, "bfloat16")
    state = {"params": params, "opt": jadamw.init_state(params), "ef": jcomp.ef_topk_init(params)}
    rng = np.random.default_rng(0)
    # the supports' moments stay the reference's 0-d zeros: AdamW never moves them
    state["opt"] = state["opt"]._replace(
        mu=jax.tree_util.tree_map(lambda m, p: jnp.asarray(rng.standard_normal(m.shape), jnp.float32)
                                  if jnp.issubdtype(p.dtype, jnp.floating) else m, state["opt"].mu, state["params"]),
        step=jnp.asarray(5, jnp.int32))
    tree = bf16_tree(state)
    sd, opt, ef = bridge.train_state_from_numpy(tree, cfg, dtype="bfloat16", device=CPU)
    model = LM(cfg, device=CPU)
    model.load_state_dict(sd, strict=True)
    k = cfg.n_codebooks
    assert opt.mu["embed.table"].shape == (k, cfg.vocab, cfg.d_model)
    assert opt.mu["unembed.faust.lam"].shape == (k,) and "unembed.faust.factors.0.in_idx" not in opt.mu
    back, dtype = bridge.train_state_to_numpy(model.state_dict(), opt, ef, cfg)
    assert dtype == "bfloat16"
    assert same_tree(tree["params"], back["params"])
    assert same_tree(tree["opt"].mu, back["opt"]["mu"]) and same_tree(tree["opt"].nu, back["opt"]["nu"])
    assert same_tree(tree["ef"].residual, back["ef"]["residual"])

    t = trainer.Trainer(cfg, pipeline.DataConfig(**_data(cfg)), adamw.AdamWConfig(**_OPT),
                        trainer.TrainConfig(steps=2, checkpoint_every=2, checkpoint_dir=str(tmp_path / "run"),
                                            compression=TopKConfig(0.1), log_every=1000), device=CPU)
    out = t.run(resume=False, model=model)
    saved, _ = bridge.train_state_to_numpy(out["model"].state_dict(), out["opt"], out["ef"], cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_async(2, {"params": saved["params"], "opt": saved["opt"], "ef": saved["ef"]})
    mgr.wait()
    jm = JCheckpointManager(str(tmp_path / "ckpt"))
    assert jm.verify(2)
    target = {"params": state["params"], "opt": state["opt"]._asdict(), "ef": state["ef"]._asdict()}
    restored, _ = jm.restore(2, target)
    assert same_tree(bf16_tree(restored), {"params": saved["params"], "opt": saved["opt"], "ef": saved["ef"]})


@pytest.mark.parametrize("faust", [False, True], ids=["dense_head", "faust_head"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recompression_selects_the_references_weights(arch, faust, tmp_path):
    """The recompression's weights on the reference's default selectors:
    none for musicgen (its tables and heads are stacked, never 2-D);
    ``embed/table`` and, with a dense head, ``unembed/w`` for internvl2;
    the same set as the reference's trainer selects from its tree."""
    jcfg, params, cfg, model = _pair(arch, faust)
    t = trainer.Trainer(cfg, pipeline.DataConfig(**_data(cfg)), tcfg=trainer.TrainConfig(
        checkpoint_dir=str(tmp_path)), device=CPU)
    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**_data(cfg)), tcfg=jtrainer.TrainConfig(
        checkpoint_dir=str(tmp_path / "j")))
    got = sorted(t._recompress_weights(model))
    assert got == sorted(jt._recompress_weights(params))
    want = [] if arch == "musicgen_medium" else ["embed/table"] + ([] if faust else ["unembed/w"])
    assert got == want


# ---------------------------------------------------------------------------
# reference caveat R6
# ---------------------------------------------------------------------------


def test_short_vision_sequence_raises_where_the_reference_lengthens_it():
    """Reference caveat R6: a 5-token sequence under internvl2's 8 vision
    tokens.  The reference's ``forward_train`` returns logits of 8
    positions and its prefill leaves every cache at position 8; the port
    raises ``ValueError`` in ``forward_train``, ``train_loss``,
    ``prefill`` and ``lm.prefill_length``, and serves prompts of exactly
    8 tokens as the reference does."""
    jcfg, params, cfg, model = _pair("internvl2_2b")
    batch = _batch(cfg, 1, 5, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jlm.forward_train(params, jcfg, jbatch)
    assert jlogits.shape == (1, 8, cfg.vocab)
    _, jcaches = jlm.prefill(params, jcfg, jbatch, jlm.make_caches(jcfg, 1, 16, dtype=jnp.float32))
    assert int(np.asarray(jcaches[0][0].pos)[0, 0]) == 8
    tb = _torch_batch(batch)
    with pytest.raises(ValueError, match="shorter than the 8 vision tokens"):
        model.forward_train(tb["tokens"], vision_embeds=tb["vision_embeds"])
    with pytest.raises(ValueError, match="shorter than the 8 vision tokens"):
        model.train_loss(tb)
    with pytest.raises(ValueError, match="shorter than the 8 vision tokens"):
        model.prefill(tb["tokens"], lm.make_caches(cfg, 1, 16, dtype=torch.float32, device=CPU), tb["vision_embeds"])
    with pytest.raises(ValueError, match="vision positions"):
        lm.prefill_length(cfg, 5)
    assert [lm.prefill_length(cfg, n) for n in (8, 12, 17)] == [8, 8, 16]
    with pytest.raises(ValueError, match="needs vision_embeds"):
        model.forward_train(tb["tokens"])
    batch = _batch(cfg, 2, 8, seed=7)
    gen, _ = Server(_pair("internvl2_2b", True)[3], max_len=MAX_LEN).generate(batch, 4)
    jgen, _ = _jserver("internvl2_2b").generate({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    np.testing.assert_array_equal(gen, np.asarray(jgen))
