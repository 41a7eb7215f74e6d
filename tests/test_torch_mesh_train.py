"""The language model trained on a mesh (``distributed/sharding.py``,
``distributed/layout.py``, ``layers/param.py``, ``models/lm.py``'s sharded
path, ``runtime/trainer.py`` with ``mesh=``, ``checkpoint/manager.py``'s
sharded checkpoints, ``launch/train.py --mesh`` and
``distributed/pipeline.py``) against the JAX reference.

* Specs, in this process: the port's ``resolve_param_pspecs`` over its
  axes table against the reference's over ``lm.param_axes`` for every
  config at full width on three meshes (the reference's stacked
  ``"layers"`` axis dropped), and the edge cases of
  ``tests/test_sharding.py`` (which cannot collect: reference caveat R3).
* Training: four CPU processes on ``gloo`` (``tests/torch_mesh_train_worker.py``,
  one run for the module), a 2 × 2 ``("data", "model")`` mesh, f32.  Two
  steps of four smoke configs (gemma-2b with a FAµST head, granite-moe-3b,
  mamba2-2.7b, musicgen-medium) from the same parameters and batches as
  the reference's unsharded ``Trainer`` (its ``init_model`` patched to
  return the port's initial parameters): losses and parameters within
  1e-4 of it (relative; parameters relative to each tensor's max|·|, as
  ``tests/test_torch_train.py`` holds slice 3), and within 1e-5 of the
  port's unsharded ``Trainer`` (the same f32 products summed in another
  order across ranks).
* The pipeline: eight processes, pod 4 × data 2, against the sequential
  oracle and the reference's ``pipeline_apply`` (a subprocess on eight
  host devices, as ``tests/test_pipeline.py`` runs it) at ``rtol=2e-4,
  atol=2e-5``; its backward (``dx`` and each stage's parameter gradients)
  against ``jax.grad`` of the sequential oracle and the port's sequential
  walk under ``torch.autograd``, at the same tolerances.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec

import torch_mesh_train_worker as worker
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jshd
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import AbstractMesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import pipeline_bubble_fraction
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.layers.param import param_axes, param_shapes
from repro_torch.models.lm import LM
from repro_torch.optim.compression import TopKConfig
from torch_parity import rel_max_err

jax.config.update("jax_platform_name", "cpu")

REF_TOL = 1e-4  # against the reference's unsharded Trainer (module docstring)
PORT_TOL = 1e-5  # against the port's unsharded Trainer
WORLD, PIPE_WORLD = 4, 8
RUN_TIMEOUT_S = 300
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
VOCAB = 128  # the head's 16 out-blocks (block 8) split over the model axis
CASES = {"gemma_2b": dict(faust_unembed=(2, 8, 2), tie_embeddings=False, vocab=VOCAB),
         "granite_moe_3b": {}, "mamba2_2p7b": {}, "musicgen_medium": {}}
DATA = dict(seq_len=16, global_batch=4)
# lr 1e-4: Adam's first steps move each entry by about ±lr whatever the
# size of its gradient, so an entry whose gradient is near zero carries its
# summation-order noise into the parameter at the scale of lr (at 1e-3 the
# port's own unsharded trainer is 1.7e-5 of max|wv| from the reference's)
OPT = dict(lr=1e-4, warmup_steps=1, decay_steps=3)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

_REF_TREES: dict = {}


def _ref_tree(arch):
    """The reference's axes and abstract parameters of ``arch`` at full width
    (cached for the module)."""
    if arch not in _REF_TREES:
        jcfg = jget_config(arch)
        _REF_TREES[arch] = (jcfg, jlm.param_axes(jcfg), jlm.abstract_params(jcfg))
    return _REF_TREES[arch]


def _flat_specs(tree, cfg) -> dict:
    """The reference's spec tree as ``{port state dict key: spec}``, each
    stage's leading ``"layers"`` entry dropped."""
    flat, stacked = {}, {}

    def walk(t, path):
        if isinstance(t, PartitionSpec):
            if path[0] == "stages":
                stacked[tuple(path[1:3])] = {**stacked.get(tuple(path[1:3]), {}), ".".join(path[3:]): tuple(t)}
            else:
                flat[".".join(path)] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [str(k)])
        else:
            for i, v in enumerate(t):
                walk(v, path + [str(i)])

    walk(tree, [])
    layer = 0
    for si, (repeat, unit) in enumerate(cfg.stages):
        for _ in range(repeat):
            for pos in range(len(unit)):
                for rest, spec in stacked.get((str(si), str(pos)), {}).items():
                    assert spec[0] is None  # "layers" is replicated in every policy
                    flat[f"layers.{layer}.{rest}"] = spec[1:]
                layer += 1
    return flat


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    """Every parameter's spec at full width equals the reference's
    ``resolve_param_pspecs`` under the config's own policy."""
    shape, names = MESHES[mesh]
    jcfg, axes, abstract = _ref_tree(arch)
    want = _flat_specs(jshd.resolve_param_pspecs(axes, abstract, JAbstractMesh(shape, names), jcfg.policy), jcfg)
    cfg = get_config(arch)
    got = shd.resolve_param_pspecs(param_axes(cfg), param_shapes(cfg), AbstractMesh(shape, names), cfg.policy)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_batch_axes_match_reference(mesh):
    """The axes the rows split over, for every config's policy."""
    from repro_torch.models.lm import batch_axes

    shape, names = MESHES[mesh]
    for arch in ARCH_IDS:
        want = jtrainer._fit_batch_axes(jget_config(arch), JAbstractMesh(shape, names))
        assert (batch_axes(get_config(arch).policy, AbstractMesh(shape, names)) or None) == want, arch


def test_param_table_is_the_state_dict():
    """The table's shapes are the model's, for every smoke config with
    and without FAµST projections."""
    for arch in ARCH_IDS:
        for extra in ({}, dict(faust_unembed=FaustSpec(2, 8, 2), tie_embeddings=False),
                      dict(faust_mlp=FaustSpec(2, 8, 2))):
            cfg = dataclasses.replace(get_smoke(arch), **extra)
            sd = LM(cfg, device="cpu").state_dict()
            assert param_shapes(cfg) == {k: tuple(v.shape) for k, v in sd.items()}, arch


FIT_CASES = [
    (None, 16), ("model", 16), (("data", "model"), 16), ("model", 6), (("data", "model"), 4), ("pod", 16),
    (("pod", "model"), 16), (("model",), 16),
]


@pytest.mark.parametrize("ax,dim", FIT_CASES)
def test_fit_axes_edge_cases(ax, dim):
    """``tests/test_sharding.py``'s ``_fit_axes`` cases on a 2 × 4 mesh:
    absent axes dropped, a product that does not divide replicated, a
    1-tuple unwrapped; as the reference's."""
    want = jshd._fit_axes(ax, dim, JAbstractMesh((2, 4), ("data", "model")))
    assert shd._fit_axes(ax, dim, AbstractMesh((2, 4), ("data", "model"))) == want


RESOLVE_CASES = [
    (("embed", "mlp"), (8, 16), ("data", "model")),
    (("embed", "mlp"), (8, 6), ("data", None)),
    (("mlp", "vocab"), (16, 16), ("model", None)),
    (("heads", None), (8, 16), (None, None)),
    (None, (8, 16), ()),
]


@pytest.mark.parametrize("axes,shape,spec", RESOLVE_CASES)
def test_resolve_pspecs_edge_cases(axes, shape, spec):
    """``tests/test_sharding.py``'s ``resolve_param_pspecs`` cases: a
    dimension the axes do not divide replicated, a mesh axis at most once
    (first wins), unmapped and ``None`` names, a leaf without axes."""
    jmesh = JAbstractMesh((2, 4), ("data", "model"))
    want = jshd.resolve_param_pspecs({"w": axes}, {"w": np.zeros(shape, np.float32)}, jmesh, jshd.ShardingPolicy())
    got = shd.resolve_param_pspecs({"w": axes}, {"w": shape}, AbstractMesh((2, 4), ("data", "model")),
                                   shd.ShardingPolicy())
    assert got["w"] == tuple(want["w"]) == spec


def test_shard_act_and_use_rules():
    """Outside ``use_rules`` ``shard_act`` returns its input itself; the
    rules nest and the outer ones come back on exit; inside, one name a
    dimension."""
    x = torch.zeros(2, 3, 4)
    assert shd.shard_act(x, "batch", "seq", None) is x
    outer, inner = AbstractMesh((2, 2), ("data", "model")), AbstractMesh((4,), ("data",))
    with shd.use_rules(outer, shd.ShardingPolicy()):
        assert shd._current().mesh is outer
        assert shd.shard_act(x, "batch", "seq", None) is x
        with pytest.raises(AssertionError):
            shd.shard_act(x, "batch", None)
        with shd.use_rules(inner, get_config("gemma_2b").policy):
            assert shd._current().mesh is inner and shd._current().policy.seq == "model"
        assert shd._current().mesh is outer
        with shd.use_rules(None, None):
            assert shd._current() is None
    assert shd._current() is None


def test_block_layout():
    """``tree_named_sharding``: a dimension over two axes is cut row-major
    in the spec's order; every rank's block has the spec's shape."""

    class Rank(AbstractMesh):
        def __init__(self, coord):
            super().__init__((2, 2, 2), ("pod", "data", "model"))
            self.coord = coord

    specs = {"w": (("pod", "data"), "model"), "b": ()}
    shapes = {"w": (8, 6), "b": (5,)}
    for p in range(2):
        for d in range(2):
            for m in range(2):
                blocks = shd.tree_named_sharding(specs, shapes, Rank({"pod": p, "data": d, "model": m}))
                assert blocks["w"].offset == ((2 * p + d) * 2, m * 3) and blocks["w"].shape == (2, 3)
                assert blocks["b"].whole and blocks["b"].offset == (0,)
                assert blocks["w"].axes == ("pod", "data", "model")


# ---------------------------------------------------------------------------
# Training on the mesh (four ranks)
# ---------------------------------------------------------------------------


def _cfgs(arch):
    extra = dict(CASES[arch])
    head = extra.pop("faust_unembed", None)
    jcfg = dataclasses.replace(jget_smoke(arch), **extra, **({"faust_unembed": JSpec(*head)} if head else {}))
    cfg = dataclasses.replace(get_smoke(arch), **extra, **({"faust_unembed": FaustSpec(*head)} if head else {}))
    return jcfg, cfg


def _data(cfg) -> dict:
    return dict(vocab=cfg.vocab, n_codebooks=cfg.n_codebooks, n_vision_tokens=cfg.n_vision_tokens,
                d_model=cfg.d_model, **DATA)


def _inputs() -> dict:
    cases = {}
    for arch in CASES:
        _, cfg = _cfgs(arch)
        cases[arch] = {"cfg": cfg, "state": LM(cfg, seed=0, device="cpu").state_dict(), "data": _data(cfg)}
    return {"cases": cases, "opt": OPT, "ef": TopKConfig(0.1)}


def _reference_run(arch, state, tmp, steps=2):
    """The reference's unsharded ``Trainer`` from the port's initial
    parameters: (losses, gradient norms, {port key: parameter})."""
    jcfg, cfg = _cfgs(arch)
    tree, _ = bridge.lm_state_dict_to_numpy(state, cfg)
    real = jlm.init_model
    jlm.init_model = lambda key, c: jax.tree_util.tree_map(jnp.asarray, tree)
    try:
        t = jtrainer.Trainer(jcfg, jpipe.DataConfig(**_data(cfg)), jadamw.AdamWConfig(**OPT),
                             jtrainer.TrainConfig(steps=steps, checkpoint_every=1000, log_every=1000,
                                                  checkpoint_dir=str(tmp)))
        out = t.run(resume=False)
    finally:
        jlm.init_model = real
    params = jax.tree_util.tree_map(np.asarray, out["state"]["params"])
    flat = bridge.flatten_lm_tree(params, jcfg)
    return ([h["loss"] for h in out["history"]], [h["grad_norm"] for h in out["history"]],
            {k: v for k, v in flat.items() if not k.endswith("in_idx")})


def _spawn(target, world, folder, inputs) -> list:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(folder / "rendezvous"), str(inputs), str(folder)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, folder, prefix) -> list:
    try:
        for p in procs:
            p.join(RUN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = folder / f"{prefix}{r}.pt"
        assert path.exists(), f"rank {r} saved nothing (exit code {p.exitcode})"
        res = torch.load(path, weights_only=False)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    return results


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every scenario of ``torch_mesh_train_worker`` on four ranks, and the
    reference's trainers meanwhile: (inputs, results per rank, reference
    runs, folder)."""
    folder = tmp_path_factory.mktemp("mesh_train")
    inp = _inputs()
    torch.save(inp, folder / "inputs.pt")
    procs = _spawn(worker.run, WORLD, folder, folder / "inputs.pt")
    try:
        ref = {arch: _reference_run(arch, inp["cases"][arch]["state"], folder / f"ref_{arch}") for arch in CASES}
    finally:
        results = _join(procs, folder, "rank")
    return inp, results, ref, folder


def _assemble(results, get) -> dict:
    """Whole parameters from every rank's blocks; replicas must agree."""
    out = {}
    for res in results:
        for k, b in get(res).items():
            whole = out.setdefault(k, np.full(b["global_shape"], np.nan, np.float32))
            sl = tuple(slice(o, o + n) for o, n in zip(b["offset"], b["value"].shape))
            seen = whole[sl]
            assert np.isnan(seen).all() or np.array_equal(seen, b["value"]), f"{k}: replicas differ"
            whole[sl] = b["value"]
    for k, v in out.items():
        assert not np.isnan(v).all(), k
    return out


def _close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        assert rel_max_err(got[k], want[k]) <= tol, (k, rel_max_err(got[k], want[k]))


def _same_losses(results, get):
    first = get(results[0])
    assert all(get(r) == first for r in results[1:])
    return first


@pytest.mark.parametrize("arch", list(CASES))
def test_mesh_trainer_matches_reference(mesh_run, arch):
    """Two steps on the 2 × 2 mesh: the same losses on every rank, within
    ``REF_TOL`` of the reference's unsharded trainer and ``PORT_TOL`` of the
    port's; the parameters (assembled from the ranks' blocks) likewise."""
    _, results, ref, _ = mesh_run
    losses = _same_losses(results, lambda r: r["configs"][arch]["losses"])
    ref_losses, ref_norms, ref_params = ref[arch]
    np.testing.assert_allclose(losses, ref_losses, rtol=REF_TOL)
    plain = results[0]["configs"][arch]["unsharded"]
    np.testing.assert_allclose(losses, plain["losses"], rtol=PORT_TOL)
    norms = _same_losses(results, lambda r: r["configs"][arch]["grad_norm"])
    np.testing.assert_allclose(norms, ref_norms, rtol=REF_TOL)
    np.testing.assert_allclose(norms, plain["grad_norm"], rtol=PORT_TOL)
    params = _assemble(results, lambda r: r["configs"][arch]["blocks"])
    _close(params, ref_params, REF_TOL)
    _close(params, plain["params"], PORT_TOL)


@pytest.mark.parametrize("arch", list(CASES))
def test_rank_holds_its_blocks(mesh_run, arch):
    """Each rank's parameters have its spec's block shape (the reference's
    specs on a 2 × 2 mesh) at the offset of its coordinates; the state a
    rank holds is less than the whole."""
    _, results, _, _ = mesh_run
    jcfg, cfg = _cfgs(arch)
    jm = JAbstractMesh((2, 2), ("data", "model"))
    tree = jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0), jcfg))
    want = _flat_specs(jshd.resolve_param_pspecs(jlm.param_axes(jcfg), tree, jm, jcfg.policy), jcfg)
    shapes = param_shapes(cfg)
    for res in results:
        blocks = res["configs"][arch]["blocks"]
        coord = res["mesh"]["coord"]
        for k, b in blocks.items():
            spec = want[k] + (None,) * (len(shapes[k]) - len(want[k]))
            assert b["value"].shape == shd.block_shape(spec, shapes[k], AbstractMesh((2, 2), ("data", "model"))), k
            for o, n, ax in zip(b["offset"], b["value"].shape, spec):
                assert o == (coord[ax] * n if ax else 0), (k, spec)
        sb = res["configs"][arch]["state_bytes"]
        assert sb["rank"] < sb["whole"]
    assert results[0]["configs"][arch]["collectives"]["param_gather"] > 0


def test_mesh_trainer_layouts(mesh_run):
    """gemma-2b and musicgen split the sequence over ``model`` (K/V
    gathered), granite's MoE gathers its rows whole, mamba2 (TP) gathers
    no sequence."""
    _, results, _, _ = mesh_run
    coll = {arch: results[0]["configs"][arch]["collectives"] for arch in CASES}
    for arch in ("gemma_2b", "musicgen_medium"):
        assert coll[arch]["seq_gather"] == 2 * 2 * 2  # K and V, two layers, two steps
    assert coll["granite_moe_3b"]["seq_gather"] == 3 * 2 * 2  # K, V and the MoE input
    assert coll["mamba2_2p7b"]["seq_gather"] == 0
    assert all(c["seq_reduce_scatter"] == c["seq_gather"] for c in coll.values())


def _gemma(results, key):
    return results[0]["gemma"][key], [r["gemma"][key] for r in results]


def test_ef_selects_as_unsharded(mesh_run):
    """EF top-k over each whole leaf: the residual (what was not kept) has
    its zeros where the unsharded trainer's has them, and its values."""
    _, results, _, _ = mesh_run
    _same_losses(results, lambda r: r["gemma"]["ef"]["losses"])
    plain = results[0]["gemma"]["ef"]["unsharded"]
    resid = _assemble(results, lambda r: {k: {**b, "value": r["gemma"]["ef"]["ef"][k]}
                                          for k, b in r["gemma"]["ef"]["blocks"].items()})
    for k, want in plain["ef"].items():
        assert np.array_equal(resid[k] == 0, want == 0), k
    _close(resid, plain["ef"], PORT_TOL)
    np.testing.assert_allclose(results[0]["gemma"]["ef"]["losses"], plain["losses"], rtol=PORT_TOL)


@pytest.mark.parametrize("key", ["clip", "micro"])
def test_clip_and_microbatches_as_unsharded(mesh_run, key):
    """A clip that binds (grad_clip 1e-3) and two microbatches: losses,
    norms and parameters as the unsharded trainer's."""
    _, results, _, _ = mesh_run
    run = results[0]["gemma"][key]
    plain = run["unsharded"]
    np.testing.assert_allclose(run["losses"], plain["losses"], rtol=PORT_TOL)
    np.testing.assert_allclose(run["grad_norm"], plain["grad_norm"], rtol=PORT_TOL)
    if key == "clip":
        assert min(plain["grad_norm"]) > 1e-3
    _close(_assemble(results, lambda r: r["gemma"][key]["blocks"]), plain["params"], PORT_TOL)


def test_nan_step_skipped_on_every_rank(mesh_run):
    """A NaN in the embedding table: every rank skips the step, and every
    other parameter keeps its bits."""
    inp, results, _, _ = mesh_run
    assert all(r["gemma"]["nan"]["skipped"] == [1.0] for r in results)
    params = _assemble(results, lambda r: r["gemma"]["nan"]["blocks"])
    state = inp["cases"]["gemma_2b"]["state"]
    for k, v in params.items():
        if k != "embed.table":
            assert np.array_equal(v, state[k].numpy()), k


def test_recompression_on_the_mesh(mesh_run):
    """A recompression tick tracks the embedding table gathered whole:
    the same record on every rank, the same RE as unsharded."""
    _, results, _, _ = mesh_run
    logs = [r["gemma"]["recompress"]["log"] for r in results]
    rec = logs[0]["weights"]["embed/table"]
    assert rec["action"] == "init"
    assert all(lg["weights"]["embed/table"]["re"] == rec["re"] for lg in logs)
    np.testing.assert_allclose(results[0]["gemma"]["recompress"]["losses"],
                               results[0]["gemma"]["recompress"]["unsharded"]["losses"], rtol=PORT_TOL)


def test_sigterm_stops_every_rank(mesh_run):
    """SIGTERM on rank 2 during step 1: every rank stops after step 1 and
    saves step 2."""
    _, results, _, _ = mesh_run
    for r in results:
        p = r["preempt"]
        assert p["steps"] == [0, 1] and p["saved"] == [1, 2] and p["on_disk"] == [1, 2]


@pytest.mark.parametrize("where", ["(4, 1)", "(1, 4)", "unsharded"])
def test_elastic_resume(mesh_run, where):
    """The 2 × 2 step-2 checkpoint resumed on a 4 × 1 and a 1 × 4 mesh and
    on one process: the third step's loss is the uninterrupted run's."""
    _, results, _, _ = mesh_run
    want = results[0]["preempt"]["uninterrupted"]
    np.testing.assert_allclose(results[0]["preempt"]["losses"], want[:2], rtol=PORT_TOL)
    key = {"(4, 1)": (4, 1), "(1, 4)": (1, 4), "unsharded": "unsharded"}[where]
    runs = [r["preempt"][key] for r in results] if key != "unsharded" else [results[0]["preempt"]["unsharded"]]
    for run in runs:
        assert run["resumed"] == 2 and run["steps"] == [2]
        np.testing.assert_allclose(run["losses"], want[2:], rtol=PORT_TOL)
    if key != "unsharded":
        shapes = [r["preempt"][key]["shapes"]["embed.table"] for r in results]
        assert shapes == [(VOCAB // key[1], 48 // key[0])] * 4  # vocab → model, embed → data


def test_reference_reads_sharded_checkpoint(mesh_run):
    """The reference's ``CheckpointManager.restore`` reads the four ranks'
    step-1 shards to the arrays the port's unsharded restore assembles."""
    _, _, _, folder = mesh_run
    ckpt = folder / "preempt"
    manifest = json.loads((ckpt / "1" / "manifest.json").read_text())
    assert any(len(m["shards"]) > 1 for m in manifest["leaves"].values())
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    target = {}
    for name, m in manifest["leaves"].items():
        node = target
        *head, last = name.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = torch.zeros(m["shape"], dtype=dtypes[m["dtype"]])
    port, _ = CheckpointManager(str(ckpt)).restore(1, target)
    jtarget = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.numpy().dtype), port)
    ref, extra = JCheckpointManager(str(ckpt)).restore(1, jtarget)
    assert extra["data"] == {"step": 1}
    flat_port = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), port))
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jax.tree_util.tree_leaves(ref), flat_port))


def test_corrupted_shard_falls_back(mesh_run):
    """A corrupted shard of step 2: every rank resumes from step 1."""
    _, results, _, _ = mesh_run
    assert results[0]["preempt"]["corrupted"].startswith("params__layers.1.attn.wq@")
    assert all(r["preempt"]["fallback"] == {"resumed": 1, "steps": [1]} for r in results)


def test_planted_kv_fault_fails(mesh_run):
    """Keys and values left ungathered under the sequence split (each
    chunk attends only to itself): the loss check fails."""
    _, results, ref, _ = mesh_run
    bad = results[0]["planted"]["losses"]
    ref_losses = ref["gemma_2b"][0]
    assert not np.allclose(bad, ref_losses, rtol=REF_TOL)


def test_refusals(mesh_run):
    """``launch.train --mesh`` on four ranks raises the production mesh's
    ``ValueError``; an SSD under a sequence split raises naming the config."""
    _, results, _, _ = mesh_run
    for r in results:
        assert "needs 256 ranks; the group has 4" in r["refusals"]["launcher"]
        assert "mamba2-2.7b" in r["refusals"]["ssd_split"] and "SSD" in r["refusals"]["ssd_split"]


# ---------------------------------------------------------------------------
# The pipeline (eight ranks)
# ---------------------------------------------------------------------------

PIPE_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
inp = np.load(sys.argv[1])
mesh = jax.make_mesh((4, 2), ("pod", "data"))
with mesh:
    y = jax.jit(lambda p, x: pipeline_apply(lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, x, mesh=mesh,
                                            axis="pod", n_microbatches=int(inp["n_micro"])))(
        {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}, jnp.asarray(inp["x"]))
np.save(sys.argv[2], np.asarray(y))
"""


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    n_stages, d, b = 4, 16, 24
    inp = {"w": (rng.standard_normal((n_stages, d, d)) / np.sqrt(d)).astype(np.float32),
           "b": (0.1 * rng.standard_normal((n_stages, d))).astype(np.float32),
           "x": rng.standard_normal((b, d)).astype(np.float32), "n_micro": np.int64(6),
           "gy": rng.standard_normal((b, d)).astype(np.float32)}
    np.savez(folder / "inputs.npz", **inp)
    procs = _spawn(worker.run_pipeline, PIPE_WORLD, folder, folder / "inputs.npz")
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ref = subprocess.run([sys.executable, "-c", PIPE_REF, str(folder / "inputs.npz"), str(folder / "ref.npy")],
                             capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=root)
    finally:
        results = _join(procs, folder, "pipe")
    assert ref.returncode == 0, ref.stderr
    return inp, results, np.load(folder / "ref.npy")


def test_pipeline_matches_oracle_and_reference(pipe_run):
    """pod 4 × data 2, 6 microbatches of 4: every rank's result equals the
    sequential oracle and the reference's pipeline."""
    inp, results, ref = pipe_run
    oracle = inp["x"]
    for s in range(4):
        oracle = np.tanh(oracle @ inp["w"][s] + inp["b"][s])
    assert sorted((r["coord"]["pod"], r["coord"]["data"]) for r in results) == [(p, d) for p in range(4)
                                                                                for d in range(2)]
    for r in results:
        np.testing.assert_allclose(r["y"], oracle, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["y"], ref, rtol=2e-4, atol=2e-5)


def _stage(w, b, h, tanh):
    return tanh(h @ w + b)


def test_pipeline_backward_matches_jax_grad(pipe_run):
    """The backward of ``Σ y · gy`` on every rank: ``dx`` and the rank's stage
    row of ``dw``/``db`` (the other rows zero), the rows gathered over pod,
    against ``jax.grad`` of the reference's sequential oracle."""
    inp, results, _ = pipe_run

    def loss(w, b, x):
        for s in range(4):
            x = _stage(w[s], b[s], x, jnp.tanh)
        return jnp.sum(x * inp["gy"])

    dw, db, dx = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(inp["w"]), jnp.asarray(inp["b"]), jnp.asarray(inp["x"]))
    for r in results:
        pod = r["coord"]["pod"]
        np.testing.assert_allclose(r["dx"], np.asarray(dx), rtol=2e-4, atol=2e-5)
        others = [s for s in range(4) if s != pod]
        assert not r["dw"][others].any() and not r["db"][others].any()
    gathered = {k: np.stack([next(r[k][s] for r in results if r["coord"]["pod"] == s) for s in range(4)])
                for k in ("dw", "db")}
    np.testing.assert_allclose(gathered["dw"], np.asarray(dw), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gathered["db"], np.asarray(db), rtol=2e-4, atol=2e-5)


def test_pipeline_backward_matches_sequential_walk(pipe_run):
    """The same gradients against the port's sequential stage walk under
    ``torch.autograd`` in one process, f32."""
    inp, results, _ = pipe_run
    w, b, x = (torch.as_tensor(inp[k]).requires_grad_() for k in ("w", "b", "x"))
    h = x
    for s in range(4):
        h = _stage(w[s], b[s], h, torch.tanh)
    (h * torch.as_tensor(inp["gy"])).sum().backward()
    for r in results:
        pod = r["coord"]["pod"]
        np.testing.assert_allclose(r["dx"], x.grad.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["dw"][pod], w.grad[pod].numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["db"][pod], b.grad[pod].numpy(), rtol=2e-4, atol=2e-5)


def test_bubble_fraction():
    assert abs(pipeline_bubble_fraction(4, 6) - 3 / 9) < 1e-12
