"""Tensor parallelism on the ``model`` axis (``distributed/sharding.py``
``compute_axes``, ``distributed/layout.py``'s split collectives, the
vocab-parallel cross entropy, pick and lookup, ``models/lm.py``
``split_plan``, attention on a rank's heads, the dense MLP on its hidden
columns, the FAµST head on its out-blocks, ``LMExecutor`` over a split
vocabulary) against the JAX reference.

* The split decision, in this process: for every config at full width ×
  its training and decode policies × three meshes, the parameters the
  port computes in blocks are those whose reference spec (the reference's
  ``resolve_param_pspecs``) places the output dimension on the axes the
  policy's activation name gives (the reference's ``_fit_axes``); a
  FAµST head splits only into whole blocks of the vocabulary, else raises.
* Training: four CPU processes on ``gloo`` (``tests/torch_tp_worker.py``,
  one run for the module) on 2 × 2 and 1 × 4 under ``TP_POLICY``, f32:
  the smoke gemma3-27b with a FAµST head (vocabulary 128: 16 out-blocks
  split over ``model``; 1 × 4 runs GQA's group map, 2 KV heads on 4
  ranks), chatglm3-6b and nemotron-4-15b (whose vocabularies of 123 and
  119 stay whole).  Each rank's loss and every parameter's gradient
  within ``REF_TOL`` of ``jax.grad`` of the reference's unsharded
  ``train_loss`` on the same parameters and within ``PORT_TOL`` of the
  port's unsharded one; every split weight computed with as the rank's
  block only.
* A greedy pick over a vocabulary split four ways, with ties, against
  ``torch.argmax``; the smoke gemma-2b served on 2 × 2 under its decode
  policy (MLP and vocabulary split, attention whole) against the
  unsharded engine's tokens.
"""
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import torch_tp_worker as worker
from repro.configs import get_smoke as jget_smoke
from repro.distributed import sharding as jshd
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.compress import BlockFaust
from repro_torch.distributed import AbstractMesh
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import chain_sharded
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.layers.param import param_axes, param_shapes
from repro_torch.models import lm
from repro_torch.runtime.engine import Engine, LMExecutor
from test_torch_mesh_train import MESHES, _flat_specs, _ref_tree
from torch_parity import rel_max_err

jax.config.update("jax_platform_name", "cpu")

REF_TOL = 1e-4  # against jax.grad of the reference's unsharded train_loss
PORT_TOL = 1e-5  # against the port's unsharded train_loss: the same f32 products summed in another order
WORLD = 4
RUN_TIMEOUT_S = 240
SEQ = 4096  # the training policies' sequence split is fitted to train_4k's length
CASES = {"gemma3_27b": dict(faust_unembed=(2, 8, 2), vocab=128), "chatglm3_6b": {}, "nemotron4_15b": {}}
SERVE_VOCAB = 128


# ---------------------------------------------------------------------------
# The split decision against the reference's specs
# ---------------------------------------------------------------------------

# (state dict suffix, output dimension, activation name, the config field the activation's size is)
_COLUMNS = (("attn.wq", 1, "heads_act", "n_heads"), ("mlp.w_up", 1, "mlp_act", "d_ff"),
            ("mlp.w_gate", 1, "mlp_act", "d_ff"))
_ROWS = {"attn.wo": "attn.wq", "mlp.w_down": "mlp.w_up"}


def _want_keep(cfg, jcfg, specs: dict, jmesh, policy, avoid, serving: bool = False, rows=()) -> dict:
    """The parameters computed in blocks, from the reference's specs and
    ``_fit_axes``: each named output dimension whose spec entry is the
    activation's fitted axes (none of ``avoid``), its row partner with it;
    ``wk``/``wv`` where their entry is the query heads' too; a mamba
    block's ``out_proj`` rows and ``norm_w`` where their entry is its
    heads' (``heads_act`` in training, ``"model"`` in serving: the
    reference's ``cache_shardings``); a MoE layer's three expert weights
    where ``w_up``'s ``experts`` entry is ``experts_act``'s axes fitted to
    the experts' count, else where its ``mlp`` entry is ``mlp_act``'s
    fitted to ``moe.d_ff`` (avoiding only ``rows``, the batch axes: it
    routes whole rows); the head's and a 2-D table's vocabulary."""

    def fit(act, size):
        return shd.axes_tuple(jshd._fit_axes(getattr(policy, act) if act else "model", size, jmesh))

    def axes_of(name, dim, act, size, avoid=avoid):
        have = shd.axes_tuple(specs[name][dim] if dim < len(specs[name]) else None)
        if not have or have != fit(act, size) or set(have) & set(avoid):
            return ()
        return have

    keep = {}
    kinds = cfg.layer_kinds()
    prefixes = [f"layers.{i}." for i, k in enumerate(kinds) if k in ("attn", "local", "moe")]
    prefixes += ["shared."] if "shared" in kinds else []
    for p in prefixes:
        for suffix, dim, act, field in _COLUMNS:
            name = p + suffix
            if name in specs and (suffix.startswith("attn") or not cfg.faust_mlp):
                a = axes_of(name, dim, act, getattr(cfg, field))
                if a:
                    keep[name] = a
        for row, col in _ROWS.items():
            if p + col in keep:
                keep[p + row] = keep[p + col]
        if p + "attn.wq" in keep:
            for name in (p + "attn.wk", p + "attn.wv"):
                if axes_of(name, 1, "heads_act", cfg.n_kv_heads) == keep[p + "attn.wq"]:
                    keep[name] = keep[p + "attn.wq"]
    for i, kind in enumerate(kinds):
        p = f"layers.{i}."
        if kind == "moe":
            names = [p + "moe.w_up"] + ([p + "moe.w_gate"] if p + "moe.w_gate" in specs else [])
            a = axes_of(p + "moe.w_up", 0, "experts_act", cfg.moe.n_experts, rows)
            if a:
                assert all(shd.axes_tuple(specs[n][0]) == a for n in names + [p + "moe.w_down"])
            else:
                a = axes_of(p + "moe.w_up", 2, "mlp_act", cfg.moe.d_ff, rows)
                assert not a or all(shd.axes_tuple(specs[n][2]) == a for n in names)
                assert not a or shd.axes_tuple(specs[p + "moe.w_down"][1]) == a
            if a and any(jmesh.shape[x] > 1 for x in a):
                keep.update(dict.fromkeys(names + [p + "moe.w_down"], a))
        if kind == "ssm":
            a = axes_of(f"layers.{i}.mamba.out_proj", 0, None if serving else "heads_act", cfg.ssm.n_heads)
            if a and any(jmesh.shape[x] > 1 for x in a):
                keep.update(dict.fromkeys((f"layers.{i}.mamba.out_proj", f"layers.{i}.mamba.norm_w"), a))
    if cfg.n_codebooks == 1:
        a = axes_of("embed.table", 0, "vocab_act", cfg.vocab)
        if a:
            keep["embed.table"] = a
        if "unembed.w" in specs:
            a = axes_of("unembed.w", 1, "vocab_act", cfg.vocab)
            if a:
                keep["unembed.w"] = a
    return keep


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("which", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_decision_matches_reference_specs(arch, which, mesh):
    """``split_plan`` at full width under the config's training or decode
    policy: the kept parameters and their axes as the reference's specs
    give them; under ``CP_POLICY`` and the granite and llama4 policies
    only the MoE layers split in training (over the sequence's axes, a
    split of their own), and the decode policies split no attention heads
    (a mamba block's heads and a MoE layer's experts or columns split in
    serving too)."""
    shape, names = MESHES[mesh]
    jcfg, axes, abstract = _ref_tree(arch)
    jmesh = JAbstractMesh(shape, names)
    specs = _flat_specs(jshd.resolve_param_pspecs(axes, abstract, jmesh, jcfg.policy), jcfg)
    cfg = get_config(arch)
    policy = cfg.policy if which == "train" else cfg.decode_policy()
    amesh = AbstractMesh(shape, names)
    batch = tuple(a for a in shd.axes_tuple(policy.batch) if a in amesh.shape)
    seq = shd.axes_tuple(shd._fit_axes(policy.seq, SEQ, amesh)) if which == "train" else ()
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), param_shapes(cfg), amesh, cfg.policy),
                                     param_shapes(cfg), amesh)
    plan = lm.split_plan(cfg, blocks, amesh, policy, batch + seq, serving=which == "decode")
    want = _want_keep(cfg, jcfg, specs, jmesh, policy, batch + seq, serving=which == "decode", rows=batch)
    assert (plan.keep if plan is not None else {}) == want
    if which == "train" and policy.seq is not None:
        assert plan is None or (plan.tp is None and all(".moe." in k for k in plan.keep)
                                and all(s == lm.LayerSplit(moe=s.moe) for s in plan.layers.values()))
    if which == "decode":
        assert plan is None or all(s.heads is None for s in plan.layers.values())


@pytest.mark.parametrize("vocab,splits", [(112, True), (108, False)])
def test_faust_head_splits_only_into_whole_blocks(vocab, splits):
    """The smoke gemma3 with a FAµST head (blocks of 8) on a 1 × 2 mesh
    under ``TP_POLICY``: a vocabulary of 112 splits into two ranges of 7
    whole out-blocks, the dense head's blocks of 56; one of 108 (14
    out-blocks, 54 columns a rank) would give rank 0 the columns 0–55 and
    start rank 1's at 54, so both the model's plan and the chain's raise."""
    cfg = dataclasses.replace(_cfgs("gemma3_27b")[1], vocab=vocab)
    amesh = AbstractMesh((1, 2), ("data", "model"))
    shapes = param_shapes(cfg)
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), shapes, amesh, cfg.policy), shapes,
                                     amesh)
    avoid = tuple(a for a in shd.axes_tuple(cfg.policy.batch) if a in amesh.shape)
    bf = lm.LM(cfg, seed=0, device="cpu").unembed.faust.blockfaust()
    half = BlockFaust(tuple(dataclasses.replace(f, values=f.values[:f.values.shape[0] // 2]) for f in bf.factors),
                      bf.lam)
    assert all(blocks[f"unembed.faust.factors.{i}.values"].shape[0] == f.values.shape[0]
               for i, f in enumerate(half.factors))
    if splits:
        plan = lm.split_plan(cfg, blocks, amesh, cfg.policy, avoid)
        assert plan.head and plan.vocab_start == 0
        assert {k for k in plan.keep if k.startswith("unembed.")} == {f"unembed.faust.factors.{i}.values"
                                                                      for i in range(len(bf.factors))}
        assert chain_sharded.split_plan(half, amesh, "model").mode == "model"
    else:
        with pytest.raises(ValueError, match="whole-block"):
            lm.split_plan(cfg, blocks, amesh, cfg.policy, avoid)
        with pytest.raises(ValueError, match="whole-block"):
            chain_sharded.split_plan(half, amesh, "model")


def test_compute_axes_edge_cases():
    """An activation that names other axes, a size the axes do not
    divide, an avoided axis, an axis of one rank: no split."""
    m = AbstractMesh((2, 4), ("data", "model"))
    pol = shd.ShardingPolicy()
    assert shd.compute_axes("mlp", "model", 16, pol, m) == ("model",)
    assert shd.compute_axes("mlp", "model", 6, pol, m) == ()
    assert shd.compute_axes("mlp", "model", 16, pol, m, avoid=("model",)) == ()
    assert shd.compute_axes("mlp", "model", 16, dataclasses.replace(pol, mlp_act=None), m) == ()
    assert shd.compute_axes("embed", "data", 16, pol, m) == ()
    assert shd.compute_axes("vocab", "model", 16, pol, AbstractMesh((8, 1), ("data", "model"))) == ()


# ---------------------------------------------------------------------------
# Training on four ranks
# ---------------------------------------------------------------------------


def _cfgs(arch):
    extra = dict(CASES[arch])
    head = extra.pop("faust_unembed", None)
    jcfg = dataclasses.replace(jget_smoke(arch), **extra, **({"faust_unembed": JSpec(*head)} if head else {}))
    cfg = dataclasses.replace(get_smoke(arch), **extra, **({"faust_unembed": FaustSpec(*head)} if head else {}))
    return jcfg, cfg


def _serve_cfg():
    return dataclasses.replace(get_smoke("gemma_2b"), vocab=SERVE_VOCAB)


def _inputs() -> dict:
    cases = {}
    for arch in CASES:
        _, cfg = _cfgs(arch)
        cases[arch] = {"cfg": cfg, "state": lm.LM(cfg, seed=0, device="cpu").state_dict()}
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 16)).astype(np.float32)
    rows[0, [5, 9]] = 9.0  # a tie across two ranks' blocks
    rows[1, [2, 3, 14]] = 9.0  # within a block, and across
    rows[2, [12, 15]] = 9.0  # within the last block
    rows[3, :] = 1.0  # all tied
    scfg = _serve_cfg()
    return {"cases": cases, "tokens": rng.integers(0, 100, (4, 16)).astype(np.int64), "pick_rows": rows,
            "serve": {"cfg": scfg, "state": lm.LM(scfg, seed=0, device="cpu").state_dict(),
                      "prompts": worker.prompts(SERVE_VOCAB, 4)}}


def _reference_grads(arch, state, tokens) -> tuple[float, dict]:
    jcfg, cfg = _cfgs(arch)
    tree, _ = bridge.lm_state_dict_to_numpy(state, cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (loss, _), g = jax.value_and_grad(lambda p: jlm.train_loss(p, jcfg, {"tokens": jnp.asarray(tokens)}),
                                      has_aux=True, allow_int=True)(params)
    flat = bridge.flatten_lm_tree(jax.tree_util.tree_map(np.asarray, g), cfg)
    return float(loss), {k: v for k, v in flat.items() if not k.endswith("in_idx")}


def _port_grads(case, tokens) -> tuple[float, dict]:
    model = lm.LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    loss, _ = model.train_loss({"tokens": torch.as_tensor(tokens)})
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _serve_unsharded(case) -> list:
    model = lm.LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    engine = Engine(LMExecutor(model, worker.MAX_LEN, worker.N_SLOTS))
    rids = [engine.submit(p, b) for p, b in zip(case["prompts"], worker.BUDGETS)]
    engine.run()
    return [engine.result(r) for r in rids]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Every scenario of ``torch_tp_worker`` on four ranks, and the
    reference's and the port's unsharded runs meanwhile."""
    folder = tmp_path_factory.mktemp("tensor_parallel")
    inp = _inputs()
    torch.save(inp, folder / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(folder / "rendezvous"), str(folder / "inputs.pt"),
                                                  str(folder)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {arch: _reference_grads(arch, inp["cases"][arch]["state"], inp["tokens"]) for arch in CASES}
        port = {arch: _port_grads(inp["cases"][arch], inp["tokens"]) for arch in CASES}
        served = _serve_unsharded(inp["serve"])
    finally:
        for p in procs:
            p.join(RUN_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = folder / f"rank{r}.pt"
        assert path.exists(), f"rank {r} saved nothing (exit code {p.exitcode})"
        res = torch.load(path, weights_only=False)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    return inp, results, ref, port, served


def _assemble(results, key) -> dict:
    """Whole gradients from every rank's blocks; ranks holding the same
    block hold the same bits."""
    out = {}
    for res in results:
        for k, b in res["grads"][key]["grads"].items():
            whole = out.setdefault(k, np.full(b["global_shape"], np.nan, np.float32))
            sl = tuple(slice(o, o + n) for o, n in zip(b["offset"], b["value"].shape))
            assert np.isnan(whole[sl]).all() or np.array_equal(whole[sl], b["value"]), f"{k}: replicas differ"
            whole[sl] = b["value"]
    assert not any(np.isnan(v).any() for v in out.values())
    return out


_RUNS = [(shape, arch) for shape in worker.MESHES for arch in CASES]
_IDS = [f"{shape[0]}x{shape[1]}-{arch}" for shape, arch in _RUNS]


@pytest.mark.parametrize("shape,arch", _RUNS, ids=_IDS)
def test_loss_and_grads_match_reference(tp_run, shape, arch):
    """The loss on every rank, and every parameter's gradient assembled
    from the ranks' blocks (split or replicated), against ``jax.grad`` of
    the reference's unsharded ``train_loss`` and the port's unsharded
    gradients."""
    _, results, ref, port, _ = tp_run
    key = (shape, arch)
    losses = {r["grads"][key]["loss"] for r in results}
    assert len(losses) == 1
    (loss,) = losses
    assert loss == pytest.approx(ref[arch][0], rel=REF_TOL)
    assert loss == pytest.approx(port[arch][0], rel=PORT_TOL)
    got = _assemble(results, key)
    assert set(got) == set(port[arch][1]) and set(got) <= set(ref[arch][1])
    for k, v in got.items():
        assert rel_max_err(v, ref[arch][1][k]) <= REF_TOL, (k, rel_max_err(v, ref[arch][1][k]))
        assert rel_max_err(v, port[arch][1][k]) <= PORT_TOL, (k, rel_max_err(v, port[arch][1][k]))


@pytest.mark.parametrize("shape,arch", _RUNS, ids=_IDS)
def test_rank_computes_with_its_blocks(tp_run, shape, arch):
    """Every split weight a module computed with is the rank's block (its
    output dimension over ``model``, the rest gathered); every other
    weight whole.  The heads, the MLP and (gemma3) the vocabulary split;
    1 × 4 reads gemma3's and chatglm3's 2 KV heads and nemotron's 2 whole,
    2 × 2 keeps their blocks."""
    inp, results, _, _, _ = tp_run
    cfg = inp["cases"][arch]["cfg"]
    shapes = param_shapes(cfg)
    n = shape[1]
    for res in results:
        run = res["grads"][(shape, arch)]
        plan = run["plan"]
        assert plan["axes"] == ("model",)
        assert plan["head"] == plan["embed"] == (arch == "gemma3_27b")
        assert len(plan["layers"]) == cfg.n_layers
        kv_kept = cfg.n_kv_heads % n == 0
        for k, got in run["computed"].items():
            want = list(shapes[k])
            if k in plan["keep"]:
                dim = 0 if k.endswith(("attn.wo", "mlp.w_down", "embed.table", ".values")) else 1
                want[dim] //= n
            assert tuple(got) == tuple(want), (k, got, want)
        assert all((k in plan["keep"]) == kv_kept for k in run["computed"] if k.endswith(("attn.wk", "attn.wv")))
        assert any(k.endswith("mlp.w_up") for k in plan["keep"])


def test_collectives_of_the_split(tp_run):
    """On 2 × 2, gemma3: one column-parallel backward and one row-parallel
    forward a split module, the cross entropy's two all-reduces, the FAµST
    head's crossing boundary gathered (and reduce-scattered back) once."""
    inp, results, _, _, _ = tp_run
    cfg = inp["cases"]["gemma3_27b"]["cfg"]
    for res in results:
        calls = res["grads"][((2, 2), "gemma3_27b")]["counts"]["calls"]
        assert calls["tp_output"] == 2 * cfg.n_layers + 1  # attention and MLP a layer, the lookup
        assert calls["tp_input_grad"] == 2 * cfg.n_layers + 1  # the same, and the head
        assert calls["vocab_ce"] == 2
        assert calls["head_boundary_gather"] == calls["head_boundary_reduce_scatter"] == 1


def test_split_greedy_pick_breaks_ties_as_argmax(tp_run):
    """Rows split four ways with ties across and within blocks: the pick
    on every rank is ``torch.argmax`` of the whole rows."""
    inp, results, _, _, _ = tp_run
    want = torch.argmax(torch.as_tensor(inp["pick_rows"]), dim=-1).tolist()
    assert want[:4] == [5, 2, 12, 0]
    assert all(r["pick"]["picks"] == want for r in results)


def test_decode_policy_serves_split_mlp_and_vocabulary(tp_run):
    """The smoke gemma-2b on 2 × 2 under its decode policy: the MLP's
    hidden columns and the (tied) vocabulary split, attention whole; the
    engine's tokens on every rank are the unsharded engine's."""
    inp, results, _, _, served = tp_run
    cfg = inp["serve"]["cfg"]
    for res in results:
        s = res["serve"]
        assert s["plan"]["head"] and s["plan"]["embed"] and not s["plan"]["heads"]
        assert len(s["plan"]["mlp"]) == cfg.n_layers
        assert len(s["tokens"]) == len(served)
        for got, want in zip(s["tokens"], served):
            np.testing.assert_array_equal(got, want)
        assert s["counts"]["calls"]["tp_output"] > 0 and s["counts"]["calls"]["vocab_pick"] > 0
