"""The SSM on the rank's heads (``distributed/sharding.py`` ``compute_axes``
for ``inner_flat``, ``models/lm.py`` ``split_plan`` over the ``"ssm"``
layers, ``layers/mamba2.py`` ``mamba2_apply(split=)`` with the gated norm's
sum over the split, ``distributed/layout.py`` ``TPSplit.total``, a
``MambaCache`` of the rank's heads in ``LMExecutor(mesh=)`` and
``launch/steps.py`` ``cache_shardings``) against the JAX reference.

* The split decision, in this process: for every config at full width ×
  its training and decode policies × three meshes, a mamba block computes
  in blocks exactly where the reference's ``resolve_param_pspecs`` puts
  ``out_proj``'s rows on the axes ``_fit_axes`` gives its heads (the
  policy's ``heads_act`` in training, ``"model"`` in serving, as the
  reference's ``cache_shardings``), and the port's ``cache_shardings``
  puts a ``MambaCache``'s heads where the reference's does; a rank whose
  heads straddle a state group raises.
* Training: four CPU processes on ``gloo`` (``tests/torch_ssm_split_worker.py``,
  one run for the module) on 2 × 2 and 1 × 4 under ``TP_POLICY``, f32:
  the smoke mamba2-2.7b, zamba2-7b (its shared block split too) and a
  mamba2 of two state groups.  Each rank's loss and every parameter's
  gradient within ``REF_TOL`` of ``jax.grad`` of the reference's
  unsharded ``train_loss`` on the same parameters and within ``PORT_TOL``
  of the port's unsharded one; the SSD on ``H/n`` heads; the gated norm's
  backward sum dropped (the planted fault) fails the check.
* Serving: both smoke models on 2 × 2 under ``DECODE_POLICY``, through
  prefills, decode steps and an eviction with its re-prefill, give the
  unsharded engine's tokens, each ``MambaCache`` at the rank's heads.
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

import torch_ssm_split_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs import base as jbase
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, base, get_config, get_smoke
from repro_torch.distributed import AbstractMesh
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
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
SEQ = 4096
# the smoke SSM models, and mamba2 with two state groups (4 heads: each
# rank of 2 × 2 reads its own group, two ranks of 1 × 4 share one)
CASES = {"mamba2_2p7b": ("mamba2_2p7b", {}), "zamba2_7b": ("zamba2_7b", {}),
         "mamba2_g2": ("mamba2_2p7b", {"n_groups": 2})}
SERVED = ("mamba2_2p7b", "zamba2_7b")


def _sizes(names, shape) -> dict:
    return dict(zip(names, shape))


def _norm(ax, sizes) -> tuple:
    """``ax``'s axes of more than one rank."""
    return tuple(a for a in shd.axes_tuple(ax) if sizes[a] > 1)


# ---------------------------------------------------------------------------
# The split decision and the cache's heads against the reference's specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("which", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ssm_split_decision_matches_reference_specs(arch, which, mesh):
    """``split_plan`` at full width: a mamba block's heads split over
    ``A`` exactly where the reference's spec puts ``out_proj``'s rows on
    ``A``, the axes ``_fit_axes`` gives its heads (``heads_act`` in
    training, ``"model"`` in serving), none of them the rows' or of one
    rank; then ``out_proj`` and ``norm_w`` are kept, ``in_proj``, the conv
    and the per-head vectors read in part, and the rank computes ``H/n``
    heads."""
    shape, names = MESHES[mesh]
    jcfg, axes, abstract = _ref_tree(arch)
    jmesh = JAbstractMesh(shape, names)
    specs = _flat_specs(jshd.resolve_param_pspecs(axes, abstract, jmesh, jcfg.policy), jcfg)
    cfg = get_config(arch)
    policy = cfg.policy if which == "train" else cfg.decode_policy()
    amesh = AbstractMesh(shape, names)
    sizes = _sizes(names, shape)
    avoid = tuple(a for a in shd.axes_tuple(policy.batch) if a in amesh.shape)
    seq = shd.axes_tuple(shd._fit_axes(policy.seq, SEQ, amesh)) if which == "train" else ()
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), param_shapes(cfg), amesh, cfg.policy),
                                     param_shapes(cfg), amesh)
    plan = lm.split_plan(cfg, blocks, amesh, policy, avoid + seq, serving=which == "decode")
    prefixes = [f"layers.{i}." for i, k in enumerate(cfg.layer_kinds()) if k == "ssm"]
    if not prefixes:
        assert plan is None or plan.ssm is None
        return
    heads = cfg.ssm.n_heads
    fit = shd.axes_tuple(jshd._fit_axes(policy.heads_act if which == "train" else "model", heads, jmesh))
    for p in prefixes:
        have = shd.axes_tuple(specs[p + "mamba.out_proj"][0])
        want = have if have and have == fit and not set(have) & set(avoid + seq) and _norm(have, sizes) else ()
        split = None if plan is None or p not in plan.layers else plan.layers[p].ssm
        assert (split is not None) == bool(want), (p, have, fit)
        if split is None:
            assert plan is None or p + "mamba.out_proj" not in plan.keep
            continue
        n = math.prod(sizes[a] for a in want)
        assert split.tp.axes == want and split.heads == heads // n and split.head_lo == 0
        assert {k: plan.keep[k] for k in plan.keep if k.startswith(p)} == {p + "mamba.out_proj": want,
                                                                           p + "mamba.norm_w": want}
        assert {k for k in plan.partial if k.startswith(p)} == {p + "mamba." + k for k in (
            "in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias")}
    if which == "train" and policy.seq is not None:
        assert plan is None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if "ssm" in get_config(a).layer_kinds()])
def test_mamba_cache_heads_where_the_reference_puts_them(arch, mesh):
    """The port's ``cache_shardings`` of decode_32k and long_500k: each
    ``MambaCache``'s rows and heads over the reference's axes (its
    ``steps.py`` ``_fit_axes("model", n_heads, mesh)``), the block
    ``(B/r, H/n, P, N)``; the conv history the rank's channels over the
    same axes (the reference keeps it whole: ROADMAP caveat R11)."""
    shape, names = MESHES[mesh]
    sizes = _sizes(names, shape)
    cfg, jcfg = get_config(arch), jget_config(arch)
    m = cfg.ssm
    for cell in ("decode_32k", "long_500k"):
        sc = base.SHAPES[cell]
        got = steps.cache_shardings(cfg, AbstractMesh(shape, names), cfg.decode_policy(), sc)
        want = jsteps.cache_shardings(jcfg, JAbstractMesh(shape, names), jcfg.decode_policy(), jbase.SHAPES[cell])
        jm = [c for stage in want for c in stage if type(c).__name__ == "MambaCache"]
        mine = [c for c in got if type(c).__name__ == "MambaCache"]
        assert len(mine) == cfg.layer_kinds().count("ssm") and jm
        js = tuple(jm[0].ssm.spec)[1:]  # the stacked layout's leading repeat axis dropped
        heads = _norm(js[1], sizes)
        n = math.prod(sizes[a] for a in heads)
        rows = math.prod(sizes[a] for a in _norm(js[0], sizes))
        groups = max(m.n_heads // n // (m.n_heads // m.n_groups), 1)  # the state groups a rank's heads read
        for c in mine:
            assert [_norm(ax, sizes) for ax in c.ssm.spec] == [_norm(js[0], sizes), heads, (), ()]
            assert c.ssm.shape == (sc.global_batch // rows, m.n_heads // n, m.headdim, m.d_state)
            assert _norm(c.conv.spec[2], sizes) == heads
            assert c.conv.shape[2] == m.d_inner // n + 2 * groups * m.d_state


def _ssm_cfg(n_heads, n_groups, expand=2, headdim=32):
    cfg = get_smoke("mamba2_2p7b")
    d = n_heads * headdim // expand
    spec = dataclasses.replace(cfg.ssm, d_model=d, n_groups=n_groups, expand=expand, headdim=headdim)
    return dataclasses.replace(cfg, d_model=d, ssm=spec, n_heads=n_heads, n_kv_heads=n_heads, head_dim=headdim)


@pytest.mark.parametrize("n_heads,n_groups,n_model,ok", [(6, 2, 3, False), (6, 2, 2, True), (6, 3, 6, True),
                                                         (8, 4, 2, True), (8, 2, 8, True)])
def test_a_rank_straddling_a_state_group_raises(n_heads, n_groups, n_model, ok):
    """6 heads in 2 groups of 3 on 3 ranks: a rank's 2 heads straddle a
    group boundary, as GQA's straddle, and the plan raises; whole groups
    a rank, or heads within one, split."""
    cfg = _ssm_cfg(n_heads, n_groups)
    amesh = AbstractMesh((1, n_model), ("data", "model"))
    shapes = param_shapes(cfg)
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), shapes, amesh, cfg.policy), shapes,
                                     amesh)
    if not ok:
        with pytest.raises(ValueError, match="straddle"):
            lm.split_plan(cfg, blocks, amesh, cfg.policy, ("data",))
        return
    split = lm.split_plan(cfg, blocks, amesh, cfg.policy, ("data",)).ssm
    rep = n_heads // n_groups
    assert split.heads == n_heads // n_model and split.groups == max(split.heads // rep, 1)


def test_ssm_heads_stay_whole_where_they_do_not_divide():
    """5 heads on a 2-wide ``model`` axis: ``_fit_axes`` drops the axis
    for the heads, so the block computes whole, as before."""
    cfg = _ssm_cfg(5, 1)
    amesh = AbstractMesh((2, 2), ("data", "model"))
    shapes = param_shapes(cfg)
    blocks = shd.tree_named_sharding(shd.resolve_param_pspecs(param_axes(cfg), shapes, amesh, cfg.policy), shapes,
                                     amesh)
    plan = lm.split_plan(cfg, blocks, amesh, cfg.policy, ("data",))
    assert plan is None or plan.ssm is None
    assert shd.compute_axes("inner_flat", "model", 5, cfg.policy, amesh) == ()
    assert shd.compute_axes("inner_flat", "model", 4, cfg.policy, amesh) == ("model",)
    assert shd.compute_axes("inner_flat", "model", 4, cfg.decode_policy(), amesh) == ()
    assert shd.compute_axes("inner_flat", "model", 4, cfg.decode_policy(), amesh, serving=True) == ("model",)


# ---------------------------------------------------------------------------
# Training and serving on four ranks
# ---------------------------------------------------------------------------


def _cfgs(case):
    arch, ssm = CASES[case]
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    if ssm:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, **ssm))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))
    return jcfg, cfg


def _inputs() -> dict:
    cases = {}
    for case in CASES:
        _, cfg = _cfgs(case)
        cases[case] = {"cfg": cfg, "state": lm.LM(cfg, seed=0, device="cpu").state_dict()}
    rng = np.random.default_rng(5)
    serve = {arch: {**cases[arch], "prompts": worker.prompts(cases[arch]["cfg"].vocab, 7)} for arch in SERVED}
    return {"cases": cases, "tokens": rng.integers(0, 90, (4, 16)).astype(np.int64), "serve": serve}


def _reference_grads(case, state, tokens) -> tuple[float, dict]:
    jcfg, cfg = _cfgs(case)
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


def _serve_unsharded(case) -> dict:
    model = lm.LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    ex = LMExecutor(model, worker.MAX_LEN, worker.N_SLOTS)
    engine = Engine(ex)
    rids = worker.drive(engine, case["prompts"])
    return {"tokens": [engine.result(r) for r in rids],
            "mamba_bytes": sum(t.numel() * t.element_size() for c in ex.pool if type(c).__name__ == "MambaCache"
                               for t in c)}


@pytest.fixture(scope="module")
def ssm_run(tmp_path_factory):
    """Every scenario of ``torch_ssm_split_worker`` on four ranks, and the
    reference's and the port's unsharded runs meanwhile."""
    folder = tmp_path_factory.mktemp("ssm_split")
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
        served = {arch: _serve_unsharded(inp["serve"][arch]) for arch in SERVED}
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


_RUNS = [(shape, case) for shape in worker.MESHES for case in CASES]
_IDS = [f"{shape[0]}x{shape[1]}-{case}" for shape, case in _RUNS]


@pytest.mark.parametrize("shape,case", _RUNS, ids=_IDS)
def test_loss_and_grads_match_reference(ssm_run, shape, case):
    """The loss on every rank, and every parameter's gradient assembled
    from the ranks' blocks, against ``jax.grad`` of the reference's
    unsharded ``train_loss`` and the port's unsharded gradients."""
    _, results, ref, port, _ = ssm_run
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
def test_rank_computes_its_heads(ssm_run, shape, case):
    """Every SSD a rank runs is on ``H/n`` heads and leaves a ``(B, H/n,
    P, N)`` state; ``out_proj`` and ``norm_w`` are computed with as the
    rank's block, ``in_proj`` and the conv whole (read in part); the rank
    computes heads ``[r·H/n, (r+1)·H/n)`` of its index ``r`` over
    ``model`` and the groups they read."""
    inp, results, _, _, _ = ssm_run
    cfg = inp["cases"][case]["cfg"]
    m, shapes, n = cfg.ssm, param_shapes(cfg), shape[1]
    hl, rep = m.n_heads // n, m.n_heads // m.n_groups
    b = inp["tokens"].shape[0] // shape[0]
    for res in results:
        run = res["grads"][(shape, case)]
        r = run["coord"]["model"]
        assert run["plan"]["axes"] == ("model",)
        assert run["plan"]["ssm"] == (hl, r * hl, max(hl // rep, 1), r * hl // rep)
        assert run["plan"]["ssm_layers"] == sorted(f"layers.{i}." for i, k in enumerate(cfg.layer_kinds())
                                                   if k == "ssm")
        assert run["ssd"] and all(s == (hl, (b, hl, m.headdim, m.d_state)) for s in run["ssd"])
        for k, got in run["computed"].items():
            if ".mamba." not in k:
                continue
            want = list(shapes[k])
            if k.endswith(("out_proj", "norm_w")):
                want[0] //= n
            assert tuple(got) == tuple(want), (k, got, want)


def test_collectives_of_the_ssm_split(ssm_run):
    """On 2 × 2, mamba2: one column-parallel backward, one row-parallel
    forward and one norm sum each way a mamba block; its vocabulary of 97
    stays whole."""
    inp, results, _, _, _ = ssm_run
    layers = inp["cases"]["mamba2_2p7b"]["cfg"].n_layers
    for res in results:
        calls = res["grads"][((2, 2), "mamba2_2p7b")]["counts"]["calls"]
        assert calls["tp_input_grad"] == calls["tp_output"] == layers
        assert calls["tp_norm"] == calls["tp_norm_grad"] == layers
        assert calls["vocab_ce"] == 0


def test_planted_norm_fault_fails(ssm_run):
    """The gated norm's backward sum over the split dropped: the loss is
    still the unsharded one (the forward is intact), but the gradients
    leave the port's unsharded ones by far more than ``PORT_TOL``."""
    _, results, _, port, _ = ssm_run
    shape, case = worker.PLANTED
    runs = [r["planted"] for r in results]
    assert runs[0]["loss"] == pytest.approx(port[case][0], rel=PORT_TOL)
    got = _assemble(runs)
    worst = max(rel_max_err(v, port[case][1][k]) for k, v in got.items())
    assert worst > 100 * PORT_TOL, worst


@pytest.mark.parametrize("arch", SERVED)
def test_decode_policy_serves_the_ssm_on_the_ranks_heads(ssm_run, arch):
    """The smoke model on 2 × 2 under its decode policy: every token of
    the trace (prefills, decode steps, an eviction and its re-prefill) the
    unsharded engine's, on every rank; each rank's ``MambaCache`` holds
    its ``H/2`` heads' ``(B, H/2, P, N)`` state and its conv channels,
    under half the unsharded pool's mamba bytes a row."""
    inp, results, _, _, served = ssm_run
    cfg = inp["serve"][arch]["cfg"]
    m = cfg.ssm
    n_local = worker.N_SLOTS // 2
    for res in results:
        s = res["serve"][arch]
        assert s["ssm"] == (("model",), m.n_heads // 2, s["coord"]["model"] * m.n_heads // 2)
        assert len(s["tokens"]) == len(served[arch]["tokens"])
        for got, want in zip(s["tokens"], served[arch]["tokens"]):
            np.testing.assert_array_equal(got, want)
        mamba = [shapes for kind, shapes in s["pool"] if kind == "MambaCache"]
        assert len(mamba) == cfg.layer_kinds().count("ssm")
        conv = m.d_inner // 2 + 2 * m.n_groups * m.d_state
        assert all(sh == [(n_local, m.d_conv - 1, conv), (n_local, m.n_heads // 2, m.headdim, m.d_state),
                          (n_local,)] for sh in mamba)
        per_row = s["mamba_bytes"] / n_local
        assert per_row < 0.55 * served[arch]["mamba_bytes"] / worker.N_SLOTS
        assert s["counts"]["calls"]["tp_norm"] > 0 and s["counts"]["calls"]["tp_norm_grad"] == 0
