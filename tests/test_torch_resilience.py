"""Parity of the rest of the port's training (``repro_torch.optim.compression``,
``repro_torch.checkpoint``, the trainer's compression, checkpoints,
preemption, resume and recompression, ``bridge.train_state_*``,
``launch.roofline``'s calibration cache and ``launch.calibrate``) with the
JAX reference on the CPU.

Inputs are made with numpy; the reference's parameters and state cross
through ``repro_torch.bridge``.  Tolerances: EF top-k is selection and
f32 addition in the reference's order, so kept values and residuals are
equal bit for bit; PowerSGD's QR is LAPACK's on both sides but another
call order, so its approximation and residual are held within 1e-5 of
max|·|; trainer losses within 1e-4 relative, as the plain trainer's (three
updates compound the forward's and backward's f32 differences); resume
on the CPU bit for bit (the same operations on the same values).
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jpipe
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.runtime import trainer as jtrainer
from repro_torch import bridge
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.checkpoint.manager import CheckpointManager, CorruptCheckpointError
from repro_torch.configs import get_smoke
from repro_torch.core.projections import _topk_mask_flat
from repro_torch.data import pipeline
from repro_torch.distributed.sharding import Block
from repro_torch.launch import calibrate, roofline
from repro_torch.launch import train as launch_train
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models.lm import LM
from repro_torch.optim import adamw, compression
from repro_torch.runtime import trainer
from torch_parity import rel_max_err, to_np

CPU = "cpu"
LOSS_RTOL = 1e-4
PSGD_TOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# EF top-k and PowerSGD against the reference


def _ties(shape, seed):
    """Values of a few magnitudes only, so the k-th magnitude is tied."""
    rng = np.random.default_rng(seed)
    return (rng.choice([-2.0, -1.0, 1.0, 0.5, 2.0], size=shape)).astype(np.float32)


GRADS = {
    "f32": lambda i: {"a": _rand((16,), i), "b": _rand((7, 9), 50 + i, 3.0)},
    "bf16": lambda i: {"a": _rand((33,), i), "w": _rand((12, 10), 70 + i)},
    "ties": lambda i: {"a": _ties((40,), i), "m": _ties((6, 7), 90 + i)},
}


@pytest.mark.parametrize("kind", list(GRADS))
@pytest.mark.parametrize("ratio", [0.1, 0.25])
def test_ef_topk_matches_reference_bit_for_bit(kind, ratio):
    """Three steps: the compressed gradients (in the gradient's dtype) and
    the f32 residuals equal the reference's bit for bit, and the residual
    norm is its norm; bf16 leaves keep ``acc − kept`` taken before the
    cast; ties at the k-th magnitude go to the lowest index."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else (jnp.float32, torch.float32)
    shapes = {k: v.shape for k, v in GRADS[kind](0).items()}
    jstate = jcomp.ef_topk_init({k: jnp.zeros(s, jdt) for k, s in shapes.items()})
    state = compression.ef_topk_init({k: torch.zeros(s, dtype=tdt) for k, s in shapes.items()})
    cfg, jcfg = compression.TopKConfig(ratio), jcomp.TopKConfig(ratio)
    for step in range(3):
        g = GRADS[kind](step)
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        jc, jstate, jm = jcomp.ef_topk_compress(jcfg, jg, jstate)
        tg = {k: torch.from_numpy(np.array(_jbits(jg[k]))).view(tdt) if tdt == torch.bfloat16
              else torch.from_numpy(np.asarray(jg[k]).copy()) for k in g}
        tc, state, m = compression.ef_topk_compress(cfg, tg, state)
        for k in g:
            assert tc[k].dtype == tdt
            np.testing.assert_array_equal(_bits(tc[k]), _jbits(jc[k]))
            np.testing.assert_array_equal(state.residual[k].numpy(), np.asarray(jstate.residual[k]))
            kept = int((tc[k] != 0).sum())
            assert kept <= compression.n_kept(tc[k].numel(), ratio)
        assert float(m["ef_residual_norm"]) == pytest.approx(float(jm["ef_residual_norm"]), rel=1e-6)


def test_ef_topk_telescopes():
    """Σ compressed + final residual = Σ raw gradients (the EF identity),
    as the reference's own test states it."""
    state = compression.ef_topk_init({"w": torch.zeros(16)})
    raw, comp = np.zeros(16), np.zeros(16)
    for s in range(5):
        g = torch.from_numpy(_rand((16,), s))
        raw += g.numpy()
        c, state, _ = compression.ef_topk_compress(compression.TopKConfig(0.25), {"w": g}, state)
        comp += c["w"].numpy()
        assert int((c["w"] != 0).sum()) <= 4
    np.testing.assert_allclose(comp + state.residual["w"].numpy(), raw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 7, 20, 39])
def test_topk_selection_keeps_the_stable_sorts_set(seed, k):
    """The selection (k-th magnitude, then ties in index order) keeps the
    set of the stable sort in ``core.projections``."""
    v = torch.from_numpy(_ties((40,), seed))
    want = _topk_mask_flat(v, k)
    got = compression.topk_mask_flat(v, k)
    assert got.dtype == torch.float32 and int(got.sum()) == k
    assert torch.equal(got, want.to(torch.float32))


def test_skipped_step_keeps_the_residual():
    """``ok`` false: every residual keeps its bits."""
    state = compression.ef_topk_init({"w": torch.zeros(10)})
    compression.ef_topk_compress(compression.TopKConfig(0.2), {"w": torch.from_numpy(_rand((10,), 1))}, state)
    before = state.residual["w"].clone()
    compression.ef_topk_compress(compression.TopKConfig(0.2), {"w": torch.full((10,), float("nan"))}, state,
                                 ok=torch.tensor(False))
    assert torch.equal(state.residual["w"], before)


def test_powersgd_matches_reference():
    """Two steps with the reference's Q passed across: the approximation
    and the residual within 1e-5 of max|·| (QR's column signs may differ;
    ``P Qᵀ`` does not), uncompressed leaves passed through."""
    shapes = {"w": (32, 24), "t": (16, 4, 4), "v": (8,), "s": (3, 3)}
    cfg, jcfg = compression.PowerSGDConfig(rank=2, min_dim=4), jcomp.PowerSGDConfig(rank=2, min_dim=4)
    jparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    jstate = jcomp.powersgd_init(jax.random.PRNGKey(0), jparams, jcfg)
    q = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jstate.q.items() if np.ndim(v) == 2}
    state = compression.powersgd_init({k: torch.zeros(s) for k, s in shapes.items()}, cfg, q=q)
    assert set(state.q) == {"w", "t"}
    for step in range(2):
        g = {k: _rand(s, 10 * step + i) for i, (k, s) in enumerate(shapes.items())}
        jc, jstate, _ = jcomp.powersgd_compress(jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tc, state, _ = compression.powersgd_compress(cfg, {k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in shapes:
            assert rel_max_err(to_np(tc[k]), np.asarray(jc[k])) <= PSGD_TOL, k
            assert rel_max_err(to_np(state.residual[k]), np.asarray(jstate.residual[k])) <= PSGD_TOL, k
        np.testing.assert_array_equal(tc["v"].numpy(), g["v"])
    gen = compression.powersgd_init({"w": torch.zeros(32, 24)}, cfg, generator=torch.Generator().manual_seed(0))
    assert gen.q["w"].shape == (24, 2)


def test_compression_ratio_matches_reference():
    shapes = {"a": (100, 7), "b": (3,), "c": (1000,)}
    jp = {**{k: jnp.zeros(s) for k, s in shapes.items()}, "idx": jnp.zeros((5,), jnp.int32)}
    tp = {**{k: torch.zeros(s) for k, s in shapes.items()}, "idx": torch.zeros(5, dtype=torch.int32)}
    for r in (0.01, 0.3):
        assert compression.compression_ratio_topk(tp, compression.TopKConfig(r)) == \
            jcomp.compression_ratio_topk(jp, jcomp.TopKConfig(r))


# ---------------------------------------------------------------------------
# The checkpoint manager (mirrors tests/test_substrates.py)


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32), "h": torch.randn(4, 2).to(torch.bfloat16)}}
    for step in (1, 2, 3):
        cost = mgr.save_async(step, tree, extra={"data": {"step": step}})
        mgr.wait()
        assert cost["bytes"] == 12 * 4 + 5 * 4 + 8 * 2 and mgr.last_write_s > 0
    assert mgr.all_steps() == [2, 3]
    meta = json.loads((tmp_path / "3" / "manifest.json").read_text())
    assert meta["leaves"]["nested/h"]["dtype"] == "bfloat16"
    assert meta["leaves"]["a"]["shards"][0]["offset"] == [0, 0]
    assert (tmp_path / "3" / "nested__h@0_0.npy").exists()
    target = {"a": torch.zeros(3, 4), "nested": {"b": torch.zeros(5, dtype=torch.int32),
                                                 "h": torch.zeros(4, 2, dtype=torch.bfloat16)}}
    a = target["a"]
    out, extra = mgr.restore(3, target)
    assert out["a"] is a and extra["data"]["step"] == 3  # written in place
    for k in ("a",):
        assert torch.equal(target[k], tree[k])
    assert torch.equal(target["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(target["nested"]["h"].view(torch.int16), tree["nested"]["h"].view(torch.int16))


def test_reference_reads_the_ports_checkpoint(tmp_path):
    """Same on-disk format: the reference's manager restores a step the
    port wrote (f32 and int leaves), and verifies its hashes."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": {"i": torch.arange(4, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, tree, extra={"k": 1})
    mgr.wait()
    jm = JCheckpointManager(str(tmp_path))
    assert jm.verify(7)
    jtree, extra = jm.restore(7, {"a": jnp.zeros((2, 3)), "n": {"i": jnp.zeros(4, jnp.int32)}})
    np.testing.assert_array_equal(np.asarray(jtree["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(jtree["n"]["i"]), tree["n"]["i"].numpy())
    assert extra == {"k": 1}


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    assert mgr.all_steps() == [] and not (tmp_path / "ck").exists()  # nothing made before a save
    mgr.save_async(5, {"x": torch.zeros(2, 2)})
    mgr.wait()
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path / "ck"))
    assert mgr.latest_step() == 5


def test_checkpoint_background_write_failure_is_raised(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"x": torch.ones(2, 2)}

    def broken_save(path, data):
        raise OSError("No space left on device")

    monkeypatch.setattr(mgr_mod.np, "save", broken_save)
    mgr.save_async(1, tree)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        mgr.wait()
    mgr.save_async(2, tree)  # the next save raises a failed write too
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        mgr.save_async(3, tree)
    monkeypatch.undo()
    assert mgr.all_steps() == []
    mgr.save_async(4, tree)
    mgr.wait()
    assert mgr.all_steps() == [4]


def test_checkpoint_corruption_detected_and_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for step in (1, 2):
        mgr.save_async(step, {"a": base * step}, extra={"s": step})
        mgr.wait()
    d2 = tmp_path / "2"
    (shard,) = [f for f in os.listdir(d2) if f.endswith(".npy")]
    np.save(d2 / shard, np.full((2, 3), 7.0, np.float32))  # a valid .npy with other bytes
    assert not mgr.verify(2) and mgr.verify(1)
    target = {"a": torch.zeros(2, 3)}
    with pytest.raises(CorruptCheckpointError, match="sha256 mismatch"):
        mgr.restore(2, target)
    assert torch.equal(target["a"], torch.zeros(2, 3))  # nothing written before every shard verified
    assert mgr.latest_step() == 1 and mgr.latest_step(verified=False) == 2
    _, extra, step = mgr.restore_latest(target)
    assert step == 1 and extra["s"] == 1 and torch.equal(target["a"], base)
    os.remove(d2 / shard)
    with pytest.raises(CorruptCheckpointError, match="unreadable"):
        mgr.restore(2, target)


def test_mismatched_manifest_raises_with_the_names(tmp_path):
    """A step of another state never restores partly: missing or extra
    leaves, or another shape or dtype, raise naming them."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"params": {"w": torch.zeros(3)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}})
    mgr.wait()
    with pytest.raises(ValueError, match=r"missing \['params/v'\].*unexpected \['params/w'\]"):
        mgr.restore(1, {"params": {"v": torch.zeros(3)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}})
    with pytest.raises(ValueError, match="params/w is float32"):
        mgr.restore(1, {"params": {"w": torch.zeros(4)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}})
    step = {"step": Block((), (), (), ())}
    with pytest.raises(ValueError, match=r"params/w is float32\[3\] on disk, float32\[4\]"):
        mgr.restore(1, {"params": {"w": torch.zeros(2)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}},
                    shardings={"params": {"w": Block(("model",), (4,), (0,), (2,))}, "opt": step})


# ---------------------------------------------------------------------------
# The trainer


def _cfgs(layers=1):
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), faust_mlp=JSpec(3, 16, 2), n_layers=layers,
                               stages=((layers, ("attn",)),))
    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_mlp=FaustSpec(3, 16, 2), n_layers=layers,
                              stages=((layers, ("attn",)),))
    return jcfg, cfg


DATA = dict(vocab=131, seq_len=16, global_batch=4)
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=4)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), tree)


def test_compressed_trainer_matches_the_jax_trainer(tmp_path):
    """EF top-k at ratio 0.05: the port's trainer from the reference's
    parameters follows the reference's 4 losses within 1e-4; and from the
    reference's state after 2 steps (its own checkpoint, carried by
    ``train_state_from_numpy`` into a checkpoint of the port's, then
    resumed) the port's steps 3-4 follow the reference's."""
    jcfg, cfg = _cfgs()
    tc = dict(steps=4, checkpoint_every=2, log_every=1000)
    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**DATA), jadamw.AdamWConfig(**OPT),
                          jtrainer.TrainConfig(checkpoint_dir=str(tmp_path / "j"),
                                               compression=jcomp.TopKConfig(0.05), **tc))
    jl = [h["loss"] for h in jt.run(resume=False)["history"]]
    assert "ef_residual_norm" in jt.history[0]

    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device=CPU)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(_jnp_tree(params), cfg, device=CPU), strict=True)
    tcfg = trainer.TrainConfig(checkpoint_dir=str(tmp_path / "p"), compression=compression.TopKConfig(0.05),
                               **{**tc, "checkpoint_every": 100})
    t = trainer.Trainer(cfg, pipeline.DataConfig(**DATA), adamw.AdamWConfig(**OPT), tcfg, device=CPU)
    out = t.run(resume=False, model=model)
    tl = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert all("ef_residual_norm" in h for h in out["history"]) and out["ef"] is not None

    # the reference's state after step 2, into the port
    target = jtrainer.TrainState.init(jax.random.PRNGKey(0), jcfg, jadamw.AdamWConfig(**OPT), jcomp.TopKConfig(0.05))
    jstate, extra = JCheckpointManager(str(tmp_path / "j")).restore(2, target)
    sd, opt, ef = bridge.train_state_from_numpy(_jnp_tree(jstate), jcfg, device=CPU)
    assert set(opt.mu) == set(ef.residual) == {k for k, p in model.named_parameters()}
    assert int(opt.step) == 2
    model2 = LM(cfg, device=CPU)
    model2.load_state_dict(sd, strict=True)
    mgr = CheckpointManager(str(tmp_path / "carried"))
    mgr.save_async(2, trainer.state_tree(model2, opt, ef), extra=extra)
    mgr.wait()
    t2 = trainer.Trainer(cfg, pipeline.DataConfig(**DATA), adamw.AdamWConfig(**OPT),
                         dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "carried")), device=CPU)
    out2 = t2.run()
    hist = out2["history"]
    assert [h["step"] for h in hist] == [2, 3] and t2.resumed["step"] == 2
    np.testing.assert_allclose([h["loss"] for h in hist], jl[2:], rtol=LOSS_RTOL)

    # and back: the port's state as the reference's tree
    back, dtype = bridge.train_state_to_numpy(out2["model"].state_dict(), out2["opt"], out2["ef"], cfg)
    assert dtype is None and int(back["opt"]["step"]) == 4
    same = jax.tree_util.tree_map(lambda a, b: np.shape(a) == np.shape(b), _jnp_tree(jstate["params"]),
                                  back["params"])
    assert jax.tree_util.tree_all(same)
    for part in ("mu", "nu"):
        shapes = jax.tree_util.tree_map(lambda a, b: np.shape(a) == np.shape(b),
                                        _jnp_tree(getattr(jstate["opt"], part)), back["opt"][part])
        assert jax.tree_util.tree_all(shapes)


def test_train_state_round_trips_through_the_bridge():
    """bf16 parameters as bits, f32 moments and residuals, the step; the
    reference's scalar moments of the FAµST supports dropped on the way in
    and made again on the way out."""
    jcfg, cfg = _cfgs(2)
    jcfg, cfg = dataclasses.replace(jcfg, dtype="bfloat16"), dataclasses.replace(cfg, dtype="bfloat16")
    state = jtrainer.TrainState.init(jax.random.PRNGKey(1), jcfg, jadamw.AdamWConfig(), jcomp.TopKConfig(0.1))
    rng = np.random.default_rng(0)
    state["opt"] = state["opt"]._replace(
        mu=jax.tree_util.tree_map(
            lambda p, m: jnp.asarray(rng.standard_normal(m.shape), jnp.float32)
            if jnp.issubdtype(p.dtype, jnp.floating) else m, state["params"], state["opt"].mu),
        step=jnp.asarray(5, jnp.int32))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a).copy(), state)
    sd, opt, ef = bridge.train_state_from_numpy(tree, cfg, dtype="bfloat16", device=CPU)
    assert sd["embed.table"].dtype == torch.bfloat16 and opt.mu["embed.table"].dtype == torch.float32
    assert "layers.1.mlp.w_up.factors.0.in_idx" in sd and "layers.1.mlp.w_up.factors.0.in_idx" not in opt.mu
    assert int(opt.step) == 5 and set(ef.residual) == set(opt.mu)
    back, dtype = bridge.train_state_to_numpy(sd, opt, ef, cfg)
    assert dtype == "bfloat16"
    eq = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), tree["params"],
                                back["params"])
    assert jax.tree_util.tree_all(eq)
    eq = jax.tree_util.tree_map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), tree["opt"].mu,
                                back["opt"]["mu"])
    assert jax.tree_util.tree_all(eq) and int(back["opt"]["step"]) == 5


class _Preempted(trainer.Trainer):
    """Raises SIGTERM in-process after step ``at`` (0-based) ends."""

    at = 1

    def _heartbeat(self, step):
        super()._heartbeat(step)
        if step == self.at:
            signal.raise_signal(signal.SIGTERM)


def _tiny(tmp, steps=4, cls=trainer.Trainer, **kw):
    _, cfg = _cfgs()
    tcfg = trainer.TrainConfig(steps=steps, checkpoint_dir=str(tmp), log_every=1000,
                               compression=compression.TopKConfig(0.1), **kw)
    return cls(cfg, pipeline.DataConfig(**DATA), adamw.AdamWConfig(**OPT), tcfg, device=CPU)


def _snapshot(out):
    tree = trainer.state_tree(out["model"], out["opt"], out["ef"])
    return {n: t.detach().clone() for n, t in mgr_mod._leaves(tree)}


def test_preempt_and_resume_reproduce_the_uninterrupted_run(tmp_path):
    """4 steps against 2, a SIGTERM (save and stop), and a fresh trainer
    resuming for steps 2-3: the same losses and the same final parameters,
    moments and EF residual, bit for bit; the signal handlers are put
    back afterwards."""
    before = signal.getsignal(signal.SIGTERM)
    full = _tiny(tmp_path / "a", checkpoint_every=100).run(resume=False)
    t1 = _tiny(tmp_path / "b", checkpoint_every=100, cls=_Preempted)
    first = t1.run(resume=False)
    assert signal.getsignal(signal.SIGTERM) is before
    assert [h["step"] for h in first["history"]] == [0, 1] and t1.ckpt.all_steps() == [2]
    assert t1.saves[0]["step"] == 2 and t1.saves[0]["bytes"] > 0
    t2 = _tiny(tmp_path / "b", checkpoint_every=100)
    rest = t2.run()
    assert [h["step"] for h in rest["history"]] == [2, 3] and t2.resumed["step"] == 2
    losses = [h["loss"] for h in first["history"] + rest["history"]]
    assert losses == [h["loss"] for h in full["history"]]
    a, b = _snapshot(full), _snapshot(rest)
    assert a.keys() == b.keys() and any(k.startswith("ef/") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_restores_in_place_and_rejects_another_models_state(tmp_path):
    """The restored state is bit for bit the saved one, written into the
    live tensors; a checkpoint of another state in the directory (as a
    reference checkpoint at the shared default path would be) raises
    naming the leaves."""
    t = _tiny(tmp_path, steps=2, checkpoint_every=2)
    saved = _snapshot(t.run(resume=False))
    t2 = _tiny(tmp_path, steps=2)
    model = LM(t2.cfg, device=CPU)
    table = model.embed.table
    out = t2.run(model=model)
    assert out["history"] == [] and out["model"].embed.table is table
    b = _snapshot(out)
    assert all(torch.equal(saved[k], b[k]) for k in saved)
    mgr = CheckpointManager(str(tmp_path / "ref"))
    mgr.save_async(3, {"params": {"embed/table": torch.zeros(2)}})
    mgr.wait()
    with pytest.raises(ValueError, match="missing"):
        _tiny(tmp_path / "ref").run()


def test_compressed_step_guards_the_residual():
    """A non-finite loss skips the step and keeps every residual's bits."""
    _, cfg = _cfgs()
    model = LM(cfg, seed=3, device=CPU)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    tcfg = trainer.TrainConfig(compression=compression.TopKConfig(0.1))
    step = trainer.make_train_step(model, opt, tcfg)
    params = dict(model.named_parameters())
    state, ef = adamw.init_state(params), compression.ef_topk_init(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 131, (4, 8)))
    m = step({"tokens": tokens}, state, ef)
    assert float(m["skipped"]) == 0.0 and float(m["ef_residual_norm"]) > 0
    before = {k: v.clone() for k, v in ef.residual.items()}
    with torch.no_grad():
        model.embed.table[0, 0] = float("nan")
    m = step({"tokens": tokens}, state, ef)
    assert float(m["skipped"]) == 1.0
    assert all(torch.equal(ef.residual[k], v) for k, v in before.items())


def test_recompress_hook_matches_the_reference_expectations(tmp_path):
    """``recompress_every=2`` on the tied smoke model (the reference's
    ``test_trainer_recompress_hook``): ticks at steps 1 and 3, the tracker
    keyed ``embed/table``, a cold track then one warm ``sweep`` of 2
    sweeps, the record on the heartbeat; and the reference tracks the same
    keys."""
    from repro.streaming.online import StreamingConfig as JStreamingConfig

    from repro_torch.streaming.online import StreamingConfig

    jcfg, cfg = _cfgs()
    jcfg, cfg = dataclasses.replace(jcfg, faust_mlp=None), dataclasses.replace(cfg, faust_mlp=None)
    common = dict(steps=4, checkpoint_every=100, log_every=100, recompress_every=2)
    t = trainer.Trainer(cfg, pipeline.DataConfig(**DATA), adamw.AdamWConfig(lr=1e-3),
                        trainer.TrainConfig(checkpoint_dir=str(tmp_path), heartbeat_path=str(tmp_path / "hb.json"),
                                            recompress_cfg=StreamingConfig(n_iter_update=2, full_above=2.0),
                                            **common), device=CPU)
    out = t.run(resume=False)
    recs = [h for h in out["history"] if "recompress_re" in h]
    assert [h["step"] for h in recs] == [1, 3] and all(np.isfinite(h["recompress_re"]) for h in recs)
    assert list(t.streaming) == ["embed/table"]
    sf = t.streaming["embed/table"]
    assert [r.action for r in sf.history] == ["sweep"] and sf.history[0].sweeps == 2
    hb = json.loads((tmp_path / "hb.json").read_text())
    assert hb["recompress"]["step"] == 3 and list(hb["recompress"]["weights"]) == ["embed/table"]
    assert hb["recompress"]["weights"]["embed/table"]["action"] == "sweep"

    jt = jtrainer.Trainer(jcfg, jpipe.DataConfig(**DATA), jadamw.AdamWConfig(lr=1e-3),
                          jtrainer.TrainConfig(checkpoint_dir=str(tmp_path / "j"), **common,
                                               recompress_cfg=JStreamingConfig(n_iter_update=2, full_above=2.0)))
    jt.run(resume=False)
    assert list(jt.streaming) == list(t.streaming)


def test_recompression_never_tracks_a_layers_weight(tmp_path):
    """Untied, with a dense unembedding and every selector matching the
    layers' names too: only ``embed/table`` and ``unembed/w`` are tracked,
    as the reference (whose stacked layer weights are 3-D) tracks."""
    _, cfg = _cfgs(2)
    cfg = dataclasses.replace(cfg, faust_mlp=None, tie_embeddings=False)
    targets = ("unembed", "embed/table", "attn", "mlp", "w_up", "layers")
    t = trainer.Trainer(cfg, pipeline.DataConfig(**DATA), adamw.AdamWConfig(lr=1e-3),
                        trainer.TrainConfig(checkpoint_dir=str(tmp_path), recompress_targets=targets), device=CPU)
    picked = t._recompress_weights(LM(cfg, device=CPU))
    assert sorted(picked) == ["embed/table", "unembed/w"]
    assert trainer.reference_name("layers.0.mlp.w_up") is None
    assert trainer.reference_name("unembed.faust.factors.0.values") == "unembed/faust/factors/0/values"


def test_launcher_resumes_and_compresses(tmp_path):
    args = ["--arch", "gemma_2b", "--smoke", "--batch", "2", "--seq", "8", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2", "--compress-grads", "0.1"]
    out = launch_train.main([*args, "--steps", "2"])
    assert len(out["history"]) == 2 and "ef_residual_norm" in out["history"][0]
    out = launch_train.main([*args, "--steps", "3", "--resume"])
    assert [h["step"] for h in out["history"]] == [2]
    with pytest.raises(ValueError, match="RANK"):  # --mesh joins the launcher's group: no launcher here
        launch_train.build(launch_train.parse_args([*args, "--mesh"]))
    assert launch_train.build(launch_train.parse_args([*args, "--multi-pod"])).mesh is None  # as the reference's


# ---------------------------------------------------------------------------
# The roofline calibration cache and the calibration script


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "roofline.json"
    monkeypatch.setenv("REPRO_TORCH_ROOFLINE", str(path))
    roofline.reload()
    yield path
    monkeypatch.undo()
    roofline.reload()


def test_cache_keys_fall_back_one_by_one(cache):
    builtin = dict(roofline._BUILTIN)
    assert roofline.roofline_constants() == (builtin, roofline.BUILTIN_SOURCE)  # no file
    cache.write_text(json.dumps({"peak_flops": 5e14, "peak_flops_f32": -1, "hbm_bw": "fast",
                                 "t_launch_us": True, "link_bw": float("inf")}))
    consts, src = roofline.reload()
    assert consts == {**builtin, "peak_flops": 5e14} and src == f"measured:{cache}"
    cache.write_text("[1, 2]")
    assert roofline.reload() == (builtin, roofline.BUILTIN_SOURCE)
    cache.write_text("{not json")
    assert roofline.reload() == (builtin, roofline.BUILTIN_SOURCE)


@pytest.mark.parametrize("value", ["builtin", "off", "0", ""])
def test_builtin_sentinels(monkeypatch, tmp_path, value):
    monkeypatch.setenv("REPRO_TORCH_ROOFLINE", value)
    assert roofline.reload() == (roofline._BUILTIN, roofline.BUILTIN_SOURCE)
    with pytest.raises(ValueError, match="sentinel"):
        calibrate.write({"peak_flops": 1.0})
    monkeypatch.undo()
    roofline.reload()


def test_constants_reload_on_mtime(cache, monkeypatch):
    """A rewritten cache is read again once ``RECHECK_S`` has passed (no
    ``reload()`` call); within it no apply pays a stat; a new path is read
    at once."""
    cache.write_text(json.dumps({"hbm_bw": 1e12}))
    assert roofline.reload()[0]["hbm_bw"] == 1e12
    cache.write_text(json.dumps({"hbm_bw": 2e12}))
    os.utime(cache, ns=(os.stat(cache).st_atime_ns, os.stat(cache).st_mtime_ns + 10**9))
    stats = []
    real = os.stat
    monkeypatch.setattr(roofline.os, "stat", lambda *a, **k: stats.append(a) or real(*a, **k))
    for _ in range(100):
        assert roofline.roofline_constants()[0]["hbm_bw"] == 1e12
    assert stats == []
    monkeypatch.setattr(roofline, "RECHECK_S", 0.0)
    assert roofline.roofline_constants()[0]["hbm_bw"] == 2e12 and len(stats) == 1
    monkeypatch.setattr(roofline, "RECHECK_S", 1e9)
    other = cache.with_name("other.json")
    other.write_text(json.dumps({"hbm_bw": 3e12}))
    monkeypatch.setenv("REPRO_TORCH_ROOFLINE", str(other))
    assert roofline.roofline_constants()[0]["hbm_bw"] == 3e12
    assert roofline.DEFAULT_CACHE.parent.name == "build"


def test_calibration_is_the_cards_and_fills_the_table(cache, tmp_path, monkeypatch):
    """Calibration refuses the CPU; ``write`` makes a record the dispatch
    source at once; ``--autotune`` fills forward and grad keys."""
    from repro_torch.api import autotune, dispatch

    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.measure_hbm_bw(device="cpu")
    calibrate.write({"peak_flops": 1e12, "meta": {"device": "test"}})
    rep = dispatch.choose_backend(batch=8, shape=(64, 64), s_tot=1024, inner_dims=(), n_factors=1,
                                  dtype=torch.bfloat16)
    assert rep.roofline == f"measured:{cache}"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "ROUND_BUDGET_S", 0.0)
    assert calibrate.parse_cases("64,128,2,2,16; 32,32,1,1,16") == ((64, 128, 2, 2, 16), (32, 32, 1, 1, 16))
    with pytest.raises(ValueError, match="5-tuples"):
        calibrate.parse_cases("1,2,3")
    assert calibrate.main(["--autotune", "--cases", "64,128,2,2,16", "--batch", "8", "--device", "cpu"]) == 0
    table = json.loads((tmp_path / "table.json").read_text())["entries"]
    assert sorted(k.split("|")[5] for k in table) == ["fwd", "grad"]
    autotune.reload()
