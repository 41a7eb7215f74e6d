"""The MoE experts on the rank's block (``distributed/sharding.py``
``compute_axes`` for ``experts`` and a MoE weight's ``mlp``,
``models/lm.py`` ``split_plan`` over the ``"moe"`` layers and
``Layer._moe``, ``layers/moe.py`` ``moe_apply(split=)``,
``distributed/layout.py`` ``SeqSplit.scatter`` and ``part_value``) against
the JAX reference.

* The split decision, in this process: for both MoE configs at full width
  × their training and decode policies × three meshes, the expert weights
  split where the reference's ``resolve_param_pspecs`` puts them: expert
  parallel where ``w_up``'s ``experts`` entry is ``experts_act``'s axes
  fitted to the experts' count (llama4-maverick, and granite-moe-3b's 40
  experts on a 2-wide ``model`` axis), else each expert's width (granite
  on a 16-wide one, 40 % 16 ≠ 0); in training over the sequence's axes, a
  split of its own.
* Training: four CPU processes on ``gloo`` (``tests/torch_moe_split_worker.py``,
  one run for the module) on 2 × 2 and 1 × 4, f32: the smoke llama4 under
  ``LLAMA4_POLICY`` (expert parallel on the sequence group, top-1, the
  shared expert), the smoke granite under ``GRANITE_POLICY`` (5 experts:
  the width split) and a granite of 4 experts, top-2, capacity factor
  1.25 (expert parallel with top-k > 1 and dropped tokens).  Each rank's
  loss and every parameter's gradient within ``REF_TOL`` of ``jax.grad``
  of the reference's unsharded ``train_loss`` on the same parameters and
  within ``PORT_TOL`` of the port's unsharded one; the rank's expert
  products on its slots or columns only; the aux loss's gradient counted
  on every rank, and a router gradient not summed over the split, fail
  the check.
* Serving: both smoke models on 2 × 2 under their decode policies, through
  prefills, decode steps and an eviction with its re-prefill, give the
  unsharded engine's tokens.
"""
import dataclasses
import math
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import torch_moe_split_worker as worker
from repro.configs import get_smoke as jget_smoke
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.distributed import AbstractMesh
from repro_torch.distributed import sharding as shd
from repro_torch.layers.moe import capacity_per_group
from repro_torch.layers.param import param_axes, param_shapes
from repro_torch.models import lm
from repro_torch.runtime.engine import Engine, LMExecutor
from test_torch_mesh_train import MESHES, _flat_specs, _ref_tree
from torch_parity import rel_max_err
from torch_ssm_split_worker import prompts

jax.config.update("jax_platform_name", "cpu")

REF_TOL = 1e-4  # against jax.grad of the reference's unsharded train_loss
PORT_TOL = 1e-5  # against the port's unsharded train_loss: the same f32 products summed in another order
WORLD = 4
RUN_TIMEOUT_S = 240
SEQ = 4096
# the smoke MoE models, and granite with 4 experts, top-2, at the published
# capacity factor: expert parallel with top-k > 1, and tokens dropped
CASES = {"llama4": ("llama4_maverick", {}), "granite": ("granite_moe_3b", {}),
         "granite_ep": ("granite_moe_3b", {"n_experts": 4, "top_k": 2, "capacity_factor": 1.25})}
SERVED = ("llama4", "granite")
MOE_ARCHS = ("llama4_maverick", "granite_moe_3b")


# ---------------------------------------------------------------------------
# The split decision against the reference's specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("which", ["train", "decode"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_split_decision_matches_reference_specs(arch, which, mesh):
    """Every MoE layer at full width: expert parallel (``E/n`` experts a
    rank from ``index·E/n``, whole width) where the reference's spec puts
    ``w_up``'s experts on ``experts_act``'s fitted axes, else the width
    split (every expert, ``ff/n`` columns from ``index·ff/n``) where it
    puts their ``mlp`` on ``mlp_act``'s; the three weights kept, the
    router read in part; in training the split is over the sequence's
    axes and no other module splits (``tp`` None)."""
    shape, names = MESHES[mesh]
    jcfg, axes, abstract = _ref_tree(arch)
    jmesh = JAbstractMesh(shape, names)
    specs = _flat_specs(jshd.resolve_param_pspecs(axes, abstract, jmesh, jcfg.policy), jcfg)
    cfg = get_config(arch)
    policy = cfg.policy if which == "train" else cfg.decode_policy()
    amesh = AbstractMesh(shape, names)
    batch = lm.batch_axes(policy, amesh)
    seq = shd.axes_tuple(shd._fit_axes(policy.seq, SEQ, amesh)) if which == "train" else ()
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), param_shapes(cfg), amesh, cfg.policy),
                                     param_shapes(cfg), amesh)
    plan = lm.split_plan(cfg, blocks, amesh, policy, batch + seq, serving=which == "decode")
    m = cfg.moe
    ep = shd.axes_tuple(specs["layers.0.moe.w_up"][0])
    want = ep if ep == shd.axes_tuple(jshd._fit_axes(policy.experts_act, m.n_experts, jmesh)) else ()
    width = () if want else shd.axes_tuple(specs["layers.0.moe.w_up"][2])
    assert want or width == shd.axes_tuple(jshd._fit_axes(policy.mlp_act, m.d_ff, jmesh))
    a = want or width
    n = math.prod(shape[names.index(x)] for x in a)
    assert arch != "llama4_maverick" or want
    assert arch != "granite_moe_3b" or bool(want) == (m.n_experts % shape[names.index("model")] == 0)
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        split = plan.layers[p].moe
        assert split.tp.axes == a and split.tp.n == n and split.tp.index == 0
        if want:
            assert (split.experts, split.expert_lo, split.ff, split.ff_lo) == (m.n_experts // n, 0, m.d_ff, 0)
        else:
            assert (split.experts, split.expert_lo, split.ff, split.ff_lo) == (m.n_experts, 0, m.d_ff // n, 0)
        assert {k: v for k, v in plan.keep.items() if k.startswith(p)} == dict.fromkeys(
            (p + "moe.w_up", p + "moe.w_gate", p + "moe.w_down"), a)
        assert {k for k in plan.partial if k.startswith(p)} == {p + "moe.router"}
    if which == "train":
        assert seq == a and plan.tp is None and plan.moe.axes == a
    else:
        assert plan.tp.axes == a and plan.moe is plan.tp


def test_moe_compute_axes():
    """``experts`` answers to ``experts_act`` fitted to the experts' count,
    a MoE weight's ``mlp`` to ``mlp_act`` fitted to ``moe.d_ff``."""
    m = AbstractMesh((2, 4), ("data", "model"))
    pol = shd.ShardingPolicy()
    assert shd.compute_axes("experts", "model", 8, pol, m) == ("model",)
    assert shd.compute_axes("experts", "model", 6, pol, m) == ()
    assert shd.compute_axes("experts", "model", 8, dataclasses.replace(pol, experts_act=None), m) == ()
    assert shd.compute_axes("experts", "model", 8, pol, m, avoid=("model",)) == ()
    assert shd.compute_axes("mlp", "model", 512, pol, m) == ("model",)


# ---------------------------------------------------------------------------
# Training and serving on four ranks
# ---------------------------------------------------------------------------


def _cfgs(case):
    arch, moe = CASES[case]
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


def _inputs() -> dict:
    cases = {}
    for case in CASES:
        _, cfg = _cfgs(case)
        cases[case] = {"cfg": cfg, "state": lm.LM(cfg, seed=0, device="cpu").state_dict()}
    rng = np.random.default_rng(5)
    serve = {case: {**cases[case], "prompts": prompts(cases[case]["cfg"].vocab, 7)} for case in SERVED}
    return {"cases": cases, "tokens": rng.integers(0, 90, (4, 16)).astype(np.int64), "serve": serve}


def _reference_grads(case, state, tokens) -> tuple[float, dict]:
    jcfg, cfg = _cfgs(case)
    tree, _ = bridge.lm_state_dict_to_numpy(state, cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (loss, _), g = jax.value_and_grad(lambda p: jlm.train_loss(p, jcfg, {"tokens": jnp.asarray(tokens)}),
                                      has_aux=True, allow_int=True)(params)
    return float(loss), bridge.flatten_lm_tree(jax.tree_util.tree_map(np.asarray, g), cfg)


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
    return [engine.result(r) for r in worker.drive(engine, case["prompts"])]


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    """Every scenario of ``torch_moe_split_worker`` on four ranks, and the
    reference's and the port's unsharded runs meanwhile."""
    folder = tmp_path_factory.mktemp("moe_split")
    inp = _inputs()
    torch.save(inp, folder / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(folder / "rendezvous"), str(folder / "inputs.pt"),
                                                  str(folder)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {case: _reference_grads(case, inp["cases"][case]["state"], inp["tokens"]) for case in CASES}
        port = {case: _port_grads(inp["cases"][case], inp["tokens"]) for case in CASES}
        served = {case: _serve_unsharded(inp["serve"][case]) for case in SERVED}
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


def _assemble(runs) -> dict:
    """Whole gradients from every rank's blocks; ranks holding the same
    block hold the same bits."""
    out = {}
    for run in runs:
        for k, b in run["grads"].items():
            whole = out.setdefault(k, np.full(b["global_shape"], np.nan, np.float32))
            sl = tuple(slice(o, o + n) for o, n in zip(b["offset"], b["value"].shape))
            assert np.isnan(whole[sl]).all() or np.array_equal(whole[sl], b["value"]), f"{k}: replicas differ"
            whole[sl] = b["value"]
    assert not any(np.isnan(v).any() for v in out.values())
    return out


def _worst(got: dict, want: dict) -> float:
    return max(rel_max_err(v, want[k]) for k, v in got.items())


_RUNS = [(shape, case) for shape in worker.MESHES for case in CASES]
_IDS = [f"{shape[0]}x{shape[1]}-{case}" for shape, case in _RUNS]


@pytest.mark.parametrize("shape,case", _RUNS, ids=_IDS)
def test_loss_and_grads_match_reference(moe_run, shape, case):
    """The loss on every rank, and every parameter's gradient assembled
    from the ranks' blocks, against ``jax.grad`` of the reference's
    unsharded ``train_loss`` and the port's unsharded gradients."""
    _, results, ref, port, _ = moe_run
    runs = [r["grads"][(shape, case)] for r in results]
    losses = {run["loss"] for run in runs}
    assert len(losses) == 1
    (loss,) = losses
    assert loss == pytest.approx(ref[case][0], rel=REF_TOL)
    assert loss == pytest.approx(port[case][0], rel=PORT_TOL)
    got = _assemble(runs)
    assert set(got) == set(port[case][1]) and set(got) <= set(ref[case][1])
    for k, v in got.items():
        assert rel_max_err(v, ref[case][1][k]) <= REF_TOL, (k, rel_max_err(v, ref[case][1][k]))
        assert rel_max_err(v, port[case][1][k]) <= PORT_TOL, (k, rel_max_err(v, port[case][1][k]))


@pytest.mark.parametrize("shape,case", _RUNS, ids=_IDS)
def test_rank_runs_its_slots_or_columns(moe_run, shape, case):
    """Each MoE layer splits over ``model`` (the sequence's axis, so no
    other module splits): under expert parallelism the rank's expert
    products run on its ``E/n`` experts' ``(E/n)·C`` slots of the whole
    rows, from expert ``index·E/n``; under the width split on every
    expert's slots and its ``ff/n`` columns; the expert weights computed
    with are those blocks, the router whole."""
    inp, results, _, _, _ = moe_run
    cfg = inp["cases"][case]["cfg"]
    m, shapes, n = cfg.moe, param_shapes(cfg), shape[1]
    ep = m.n_experts % n == 0
    el, fl = (m.n_experts // n, m.d_ff) if ep else (m.n_experts, m.d_ff // n)
    b, s = inp["tokens"].shape[0] // shape[0], inp["tokens"].shape[1]
    c = capacity_per_group(s, m)
    layers = [f"layers.{i}." for i in range(cfg.n_layers)]
    for res in results:
        run = res["grads"][(shape, case)]
        r = run["coord"]["model"]
        assert run["plan"]["tp"] is None
        want = (("model",), el, r * el, m.d_ff, 0) if ep else (("model",), el, 0, fl, r * fl)
        assert run["plan"]["moe"] == dict.fromkeys(layers, want)
        ups = [p for p in run["products"] if p[0] == "becd,edf->becf"]
        assert len(ups) == 2 * cfg.n_layers  # w_up and w_gate a layer
        assert all(p[1] == (b, el, c, cfg.d_model) and p[2] == (el, cfg.d_model, fl) for p in ups)
        for k, got in run["computed"].items():
            if ".moe." not in k or ".shared." in k:
                continue
            want = list(shapes[k])
            if not k.endswith("router"):
                if ep:
                    want[0] //= n
                else:
                    want[1 if k.endswith("w_down") else 2] //= n
            assert tuple(got) == tuple(want), (k, got, want)


def test_collectives_of_the_moe_split(moe_run):
    """On 2 × 2, llama4 (expert parallel on the sequence group): each MoE
    layer gathers its input over the positions and reduce-scatters its
    output back (an all-gather backward), and nothing else splits."""
    inp, results, _, _, _ = moe_run
    layers = inp["cases"]["llama4"]["cfg"].n_layers
    for res in results:
        calls = res["grads"][((2, 2), "llama4")]["counts"]["calls"]
        assert calls["moe_combine"] == calls["moe_combine_grad"] == layers
        assert calls["moe_input_grad"] == calls["tp_output"] == calls["tp_input_grad"] == 0


@pytest.mark.parametrize("fault", ["planted_aux", "planted_router"])
def test_planted_faults_fail(moe_run, fault):
    """The aux loss's gradient counted whole on every rank of the split
    (its value still divided), or the router's gradient left at the
    rank's own experts' part: the loss is still the unsharded one, but the
    gradients leave the port's unsharded ones by far more than
    ``PORT_TOL``."""
    _, results, _, port, _ = moe_run
    _, case = worker.PLANTED
    runs = [r[fault] for r in results]
    assert runs[0]["loss"] == pytest.approx(port[case][0], rel=PORT_TOL)
    assert _worst(_assemble(runs), port[case][1]) > 100 * PORT_TOL


def test_capacity_drops_tokens():
    """The top-2 granite of 4 experts at capacity factor 1.25 drops tokens
    on the module's batch, so the split's dropped pairs are exercised."""
    from repro_torch.layers.moe import route

    inp = _inputs()
    case = inp["cases"]["granite_ep"]
    model = lm.LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    x = model.embed.table[torch.as_tensor(inp["tokens"])].float()
    r = route(x @ model.layers[0].moe.router, case["cfg"].moe)
    assert int((r.dest == case["cfg"].moe.n_experts * capacity_per_group(x.shape[1], case["cfg"].moe)).sum()) > 0


@pytest.mark.parametrize("case", SERVED)
def test_decode_policy_serves_the_split_moe(moe_run, case):
    """The smoke model on 2 × 2 under its decode policy: every token of
    the trace (prefills, decode steps, an eviction and its re-prefill) the
    unsharded engine's, on every rank; llama4's experts split over
    ``model`` (4 of 8 a rank), granite's 5 experts by width (16 of 32
    columns); the partial outputs summed over ``model``."""
    inp, results, _, _, served = moe_run
    m = inp["serve"][case]["cfg"].moe
    for res in results:
        s = res["serve"][case]
        r = s["coord"]["model"]
        if m.n_experts % 2 == 0:
            assert s["moe"] == (("model",), m.n_experts // 2, r * m.n_experts // 2, m.d_ff, 0)
        else:
            assert s["moe"] == (("model",), m.n_experts, 0, m.d_ff // 2, r * m.d_ff // 2)
        assert len(s["w_up"]) == 1 and s["w_up"][0][0] == s["moe"][1] and s["w_up"][0][2] == s["moe"][3]
        assert len(s["tokens"]) == len(served[case])
        for got, want in zip(s["tokens"], served[case]):
            np.testing.assert_array_equal(got, want)
        assert s["counts"]["calls"]["moe_combine"] > 0 and s["counts"]["calls"]["moe_combine_grad"] == 0
