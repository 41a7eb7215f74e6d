"""The report (``configs/base.py``'s shape cells, ``launch/specs.py``,
``launch/steps.py``, ``launch/step_cost.py``, ``launch/roofline.py``'s
``collective_stats``/``roofline_terms``, ``launch/dryrun.py``,
``launch/report.py``) against the JAX reference.

* Shape cells, specs (``jax.eval_shape`` of the reference's), per-rank
  parameter blocks on the production meshes (the reference's
  ``resolve_param_pspecs`` on an ``AbstractMesh``), the cache layout, the
  model flops and parameter counts, and the report's arithmetic, in this
  process.
* The counts: ``StepCost``'s matmul flops on the smoke gemma-2b against the
  dot_general flops of the reference's jaxpr (scan bodies times their
  length) exactly; stacked matmuls; a FAµST head's flops against a hand
  count from its stored blocks.
* The dry run against a real run: four CPU processes on ``gloo``
  (``tests/torch_report_worker.py``) run each case's step on a 2 × 2 mesh
  on real tensors, and this process runs the same ranks' steps on fake
  tensors (``launch/mesh.py`` ``abstract_rank``): flops, launches and
  collectives (by operator and by purpose, calls and bytes) equal; bytes
  of device memory within 5 % (``test_fake_run_predicts_real_run``).
"""
import dataclasses
import json
import math
import multiprocessing

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.extend import core as jcore
from jax.sharding import AbstractMesh as JAbstractMesh

import torch_report_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs import base as jbase
from repro.distributed import sharding as jshd
from repro.launch import report as jreport
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.configs import base
from repro_torch.distributed import AbstractMesh
from repro_torch.distributed.sharding import axes_tuple
from repro_torch.launch import dryrun, report, roofline, specs, steps
from repro_torch.launch.mesh import abstract_rank, release
from repro_torch.launch.step_cost import StepCost
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models.lm import LM, SPLIT_KV_KINDS
from test_torch_mesh_train import _flat_specs, _ref_tree

jax.config.update("jax_platform_name", "cpu")

MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# held at full width; the other five at smoke width (the 60 s budget)
FULL = ("gemma_2b", "gemma3_27b", "llama4_maverick", "mamba2_2p7b", "zamba2_7b")
WORLD = 4
RUN_TIMEOUT_S = 120
ARCH_CELLS = [(a, c) for a in ARCH_IDS for c in base.cells_for(get_config(a))]


# ---------------------------------------------------------------------------
# Shape cells, specs, blocks, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_cells_match_reference(arch):
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert base.cells_for(get_config(arch)) == jbase.cells_for(jget_config(arch))


def _same_struct(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch,cell", ARCH_CELLS)
def test_specs_match_reference(arch, cell):
    """``batch_specs`` and ``cache_specs`` (meta tensors) have the shapes
    and dtypes of the reference's ``ShapeDtypeStruct``\\ s; the reference
    stacks each stage's caches on a leading repeat axis, the port keeps
    one per layer."""
    cfg, jcfg, sc = get_config(arch), jget_config(arch), base.SHAPES[cell]
    got, want = specs.batch_specs(cfg, sc), jspecs.batch_specs(jcfg, jbase.SHAPES[cell])
    assert got.keys() == want.keys()
    for k in want:
        _same_struct(got[k], want[k])
        assert got[k].device.type == "meta"
    if sc.kind == "train":
        return
    caches, jcaches = specs.cache_specs(cfg, sc), jspecs.cache_specs(jcfg, jbase.SHAPES[cell])
    layer = 0
    for (repeat, unit), stage in zip(cfg.stages, jcaches, strict=True):
        for r in range(repeat):
            for u in range(len(unit)):
                c, jc = caches[layer + r * len(unit) + u], stage[u]
                assert type(c).__name__ == type(jc).__name__
                for t, jt in zip(c, jc, strict=True):
                    _same_struct(t, jax.ShapeDtypeStruct(jt.shape[1:], jt.dtype))
        layer += repeat * len(unit)
    assert layer == len(caches)


def _flat_shapes(abstract, jcfg) -> dict:
    """The reference's abstract parameters as ``{port key: (shape, dtype)}``
    (each stage's leading repeat axis dropped)."""
    flat, stacked = {}, {}

    def walk(t, path):
        if hasattr(t, "shape") and hasattr(t, "dtype"):
            if path[0] == "stages":
                stacked.setdefault(tuple(path[1:3]), {})[".".join(path[3:])] = (tuple(t.shape[1:]), t.dtype)
            else:
                flat[".".join(path)] = (tuple(t.shape), t.dtype)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [str(k)])
        else:
            for i, v in enumerate(t):
                walk(v, path + [str(i)])

    walk(abstract, [])
    layer = 0
    for si, (repeat, unit) in enumerate(jcfg.stages):
        for _ in range(repeat):
            for pos in range(len(unit)):
                for rest, sd in stacked.get((str(si), str(pos)), {}).items():
                    flat[f"layers.{layer}.{rest}"] = sd
                layer += 1
    return flat


def _arch_cfgs(arch):
    if arch in FULL:
        return get_config(arch), *_ref_tree(arch)
    jcfg = jget_smoke(arch)
    return get_smoke(arch), jcfg, jlm.param_axes(jcfg), jlm.abstract_params(jcfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_blocks_match_reference(arch, mesh):
    """Every parameter's block on a rank, and so the argument bytes of the
    parameters and AdamW's f32 moments, equal the reference's
    ``resolve_param_pspecs`` on ``AbstractMesh(shape, names)``."""
    shape, names = MESHES[mesh]
    cfg, jcfg, axes, abstract = _arch_cfgs(arch)
    jmesh = JAbstractMesh(shape, names)
    want_specs = _flat_specs(jshd.resolve_param_pspecs(axes, abstract, jmesh, jcfg.policy), jcfg)
    want_shapes = _flat_shapes(abstract, jcfg)
    blocks = steps.param_shardings(cfg, AbstractMesh(shape, names))
    assert blocks.keys() == want_specs.keys()
    sizes = dict(zip(names, shape))
    got_bytes = want_bytes = 0
    for name, blk in blocks.items():
        gshape, dtype = want_shapes[name]
        assert blk.global_shape == gshape
        spec = tuple(want_specs[name]) + (None,) * (len(gshape) - len(want_specs[name]))
        want_block = tuple(n // math.prod(sizes[a] for a in axes_tuple(ax)) for n, ax in zip(gshape, spec))
        assert blk.shape == want_block, name
        elt = jnp.dtype(dtype).itemsize
        got_bytes += math.prod(blk.shape) * (elt + 8)
        want_bytes += math.prod(want_block) * (elt + 8)
    assert got_bytes == want_bytes


def test_dry_run_argument_bytes_are_the_blocks():
    """The dry run's parameter and optimizer bytes for gemma-2b on 16 × 16
    are the blocks' (parameters in their dtypes, two f32 moments each and
    the step count)."""
    mesh = abstract_rank(*MESHES["16x16"])
    try:
        cfg = get_config("gemma_2b")
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode(allow_non_fake_inputs=True):
            model, opt = steps.abstract_train_state(cfg, mesh)
            dtypes = {k: p.dtype for k, p in model.named_parameters()}
            params = sum(p.numel() * p.element_size() for p in model.parameters())
            moments = sum(t.numel() * t.element_size() for t in (*opt.mu.values(), *opt.nu.values()))
    finally:
        release()
    blocks = steps.param_shardings(cfg, AbstractMesh(*MESHES["16x16"]))
    assert params == sum(math.prod(b.shape) * dtypes[k].itemsize for k, b in blocks.items())
    assert moments == sum(math.prod(b.shape) * 8 for b in blocks.values())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_layout(mesh):
    """The trainer and a prefill take the whole batch on every rank; a
    decode step's tokens are the rank's rows over the decode policy's
    batch axes (the reference's ``batch_shardings`` of the same policy)."""
    shape, names = MESHES[mesh]
    cfg, jcfg = get_config("internvl2_2b"), jget_config("internvl2_2b")
    amesh, jmesh = AbstractMesh(shape, names), JAbstractMesh(shape, names)
    batch = specs.batch_specs(cfg, base.SHAPES["train_4k"])
    for k, blk in steps.batch_shardings(cfg, amesh, cfg.policy, batch).items():
        assert blk.whole and blk.shape == tuple(batch[k].shape)
    dec = specs.batch_specs(cfg, base.SHAPES["decode_32k"])
    got = steps.batch_shardings(cfg, amesh, cfg.decode_policy(), dec, kind="decode")["tokens"]
    want = jsteps.batch_shardings(jcfg, jmesh, jcfg.decode_policy(),
                                  jspecs.batch_specs(jcfg, jbase.SHAPES["decode_32k"]))["tokens"]
    sizes = dict(zip(names, shape))
    assert _norm(got.spec[0], sizes) == _norm(tuple(want.spec)[0], sizes)
    assert got.shape == (128 // math.prod(sizes[a] for a in _norm(got.spec[0], sizes)), 1)


def _norm(ax, sizes) -> tuple:
    return tuple(a for a in axes_tuple(ax) if sizes[a] > 1)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_layout_against_reference(arch, mesh):
    """Rows over the decode policy's batch axes and a global-attention
    cache's positions over its ``kv_seq`` axes, as the reference's
    ``cache_shardings``; a sliding-window ring's positions and a mamba
    state's heads stay whole in the port where the reference splits them
    (ROADMAP caveat R11)."""
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in ("decode_32k", "long_500k"):
        sc = base.SHAPES[cell]
        got = steps.cache_shardings(cfg, AbstractMesh(shape, names), cfg.decode_policy(), sc)
        want = jsteps.cache_shardings(jcfg, JAbstractMesh(shape, names), jcfg.decode_policy(), jbase.SHAPES[cell])
        kinds, layer = cfg.layer_kinds(), 0
        for (repeat, unit), stage in zip(cfg.stages, want, strict=True):
            for r in range(repeat):
                for u, kind in enumerate(unit):
                    c, jc = got[layer + r * len(unit) + u], stage[u]
                    assert kinds[layer + r * len(unit) + u] == kind
                    for blk, js in zip(c, jc, strict=True):
                        jspec = tuple(js.spec)[1:] + (None,) * (len(blk.spec) + 1 - len(js.spec))
                        mine = [_norm(ax, sizes) for ax in blk.spec]
                        ref = [_norm(ax, sizes) for ax in jspec]
                        assert mine[0] == ref[0]  # rows
                        if kind in SPLIT_KV_KINDS:
                            assert mine == ref
                        else:  # R11: whole where the reference splits positions (a ring) or heads (SSM)
                            assert all(m == () for m in mine[1:])
            layer += repeat * len(unit)


# ---------------------------------------------------------------------------
# Model flops, parameter counts, the report's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,cell", ARCH_CELLS)
def test_model_flops_and_counts_match_reference(arch, cell):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert base.param_count(cfg) == jbase.param_count(jcfg)
    assert base.active_param_count(cfg) == jbase.active_param_count(jcfg)
    assert report.model_flops(arch, cell) == jreport.model_flops(arch, cell)


RECORD = {"n_devices": 256, "cell": "train_4k", "_arch_id": "gemma_3", "dtype": "bfloat16",
          "cost": {"flops": 8.3e13, "bytes": 1.2e12}, "collectives": {"total_bytes": 1.3e10},
          "memory": {"argument_bytes": 1.0e8, "peak_bytes": 2.25e10, "fits_card": True}}


@pytest.mark.parametrize("arch,cell", [("gemma_2b", "train_4k"), ("llama4_maverick", "decode_32k"),
                                       ("mamba2_2p7b", "long_500k"), ("musicgen_medium", "prefill_32k")])
def test_analyze_matches_reference(arch, cell, monkeypatch):
    """``analyze`` equals the reference's ``report.analyze`` on the same
    record at the same constants (the reference's priced at the port's
    H100 ones)."""
    consts, _ = roofline.roofline_constants()
    for name, key in (("PEAK_FLOPS", "peak_flops"), ("HBM_BW", "hbm_bw"), ("LINK_BW", "link_bw")):
        monkeypatch.setattr(jreport, name, consts[key])
    rec = {**RECORD, "_arch_id": arch, "cell": cell}
    jrec = {"n_devices": rec["n_devices"], "cell": cell, "_arch_id": arch,
            "hlo_cost": dict(rec["cost"]), "collectives": rec["collectives"],
            "memory_analysis": {"argument_size_in_bytes": int(rec["memory"]["argument_bytes"]),
                                "temp_size_in_bytes": int(rec["memory"]["peak_bytes"] - rec["memory"]["argument_bytes"])}}
    got, want = report.analyze(rec, consts), jreport.analyze(jrec)
    for k in ("compute_s", "memory_s", "collective_s", "roofline_fraction", "model_flops", "useful_flops_ratio",
              "mem_bytes_per_dev"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["dominant"] == want["dominant"]


def test_collective_stats_form():
    counted = {"by_op": {"all-gather": 10, "all-reduce": 4}, "count": {"all-gather": 2, "all-reduce": 1},
               "by_purpose": {"param_gather": {"count": 2, "bytes": 10}}}
    st = roofline.collective_stats(counted)
    assert st == {"total_bytes": 14, "by_op": {"all-gather": 10, "reduce-scatter": 0, "all-reduce": 4}, "count": 3,
                  "by_purpose": counted["by_purpose"]}


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------


def _jaxpr_dot_flops(j) -> int:
    """dot_general flops of a jaxpr, every sub-jaxpr counted, a scan's body
    times its length."""
    total = 0
    for e in j.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            total += 2 * math.prod(e.outvars[0].aval.shape) * math.prod(lhs[i] for i in lc)
        mult = e.params.get("length", 1) if e.primitive.name == "scan" else 1
        for v in e.params.values():
            for s in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(s, jcore.ClosedJaxpr):
                    total += mult * _jaxpr_dot_flops(s.jaxpr)
                elif isinstance(s, jcore.Jaxpr):
                    total += mult * _jaxpr_dot_flops(s)
    return total


def test_matmul_flops_equal_reference_jaxpr():
    """The smoke gemma-2b at b = 2, s = 32: forward and forward + backward
    matmul flops equal the reference jaxpr's dot_general flops exactly."""
    jcfg = jget_smoke("gemma_2b")
    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    tokens = jnp.zeros((2, 32), jnp.int32)
    loss = lambda p: jlm.train_loss(p, jcfg, {"tokens": tokens})[0]  # noqa: E731
    want_fwd = _jaxpr_dot_flops(jax.make_jaxpr(loss)(params).jaxpr)
    want_all = _jaxpr_dot_flops(jax.make_jaxpr(jax.grad(loss, allow_int=True))(params).jaxpr)
    assert (want_fwd, want_all) == (7_358_464, 22_075_392)
    model = LM(get_smoke("gemma_2b"), seed=0, device="cpu")
    with StepCost() as fwd:
        out, _ = model.train_loss({"tokens": torch.zeros((2, 32), dtype=torch.int32)})
    with StepCost() as bwd:
        out.backward()
    assert fwd.matmul_flops == want_fwd
    assert fwd.matmul_flops + bwd.matmul_flops == want_all


def test_stacked_matmuls_count_each():
    """Eight matmuls, one after the other or stacked in one batched
    product, count eight times one (the reference's trip-count rule)."""
    a, b = torch.randn(8, 64, 32), torch.randn(8, 32, 16)
    with StepCost() as one:
        a[0] @ b[0]
    with StepCost() as loop:
        for i in range(8):
            a[i] @ b[i]
    with StepCost() as stacked:
        torch.bmm(a, b)
    assert one.matmul_flops == 2 * 64 * 32 * 16
    assert loop.matmul_flops == stacked.matmul_flops == 8 * one.matmul_flops
    assert loop.flops == stacked.flops == 8 * one.flops


def test_faust_head_flops_are_the_kernels_formula():
    """A FAµST head (untied, ``FaustSpec(2, 16, 4)``) counts 2·rows·(stored
    entries) for K1 and K2 and three times that for K3, from its chain's
    stored blocks, whatever plain path runs on the CPU."""
    cfg = dataclasses.replace(get_smoke("gemma_2b"), vocab=2048, faust_unembed=FaustSpec(2, 16, 4),
                              tie_embeddings=False)
    model = LM(cfg, seed=0, device="cpu")
    stored = sum(f.values.numel() for f in model.unembed.faust.factors)
    rows = 2 * 32
    with StepCost() as sc:
        loss, _ = model.train_loss({"tokens": torch.zeros((2, 32), dtype=torch.int32)})
        loss.backward()
    assert sc.launches == {"K1": 1, "K2": 1, "K3": 1}
    assert sc.kernel_flops == {"K1": 2 * rows * stored, "K2": 2 * rows * stored, "K3": 6 * rows * stored}


# ---------------------------------------------------------------------------
# The dry run against a real run
# ---------------------------------------------------------------------------


def _cases() -> dict:
    faust = dataclasses.replace(get_smoke("gemma_2b"), vocab=128, faust_unembed=FaustSpec(2, 8, 2),
                                tie_embeddings=False)
    return {
        "train_faust": (faust, base.ShapeCell("t", "train", 16, 4)),
        "train_moe": (get_smoke("granite_moe_3b"), base.ShapeCell("t", "train", 16, 4)),
        "prefill": (faust, base.ShapeCell("p", "prefill", 32, 2)),
        "decode": (faust, base.ShapeCell("d", "decode", 32, 4)),
    }


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("report")
    torch.save(_cases(), folder / "cases.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(folder / "rendezvous"), str(folder / "cases.pt"),
                                                  str(folder))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RUN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(WORLD):
        path = folder / f"rank{r}.json"
        assert path.exists(), f"rank {r} saved nothing (exit code {procs[r].exitcode})"
        res = json.loads(path.read_text())
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    return results


@pytest.mark.parametrize("case", list(_cases()))
def test_fake_run_predicts_real_run(real_run, case):
    """Each rank's dry run on fake tensors counts what the real 2 × 2 run
    counted: flops, matmul and kernel flops, bytes, launches, and the
    collectives by operator and by purpose (calls and bytes)."""
    cfg, cell = _cases()[case]
    for r, real in enumerate(real_run):
        mesh = abstract_rank((2, 2), ("data", "model"), r)
        try:
            fake = dryrun.dry_run(cfg, cell, mesh)
        finally:
            release()
        got = json.loads(json.dumps(fake))  # the record as the worker saved it
        want = real[case]
        for k in ("flops", "matmul_flops", "kernel_flops"):
            assert got["cost"][k] == want["cost"][k], (r, k)
        # bytes within 5 %: gloo copies a collective's result into its output
        # on wait (a copy_ the fake group, as NCCL, does not make), and
        # whether torch folds a batched matmul into one mm follows the
        # operands' strides, which the meta kernels and the CPU's lay out
        # differently (the flops are the same)
        assert got["cost"]["bytes"] == pytest.approx(want["cost"]["bytes"], rel=0.05), r
        assert got["launches"] == want["launches"]
        assert got["collectives"] == want["collectives"]
        assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    if case.startswith("train_faust"):
        assert got["launches"] == {"K1": 1, "K2": 1, "K3": 1}
        assert got["collectives"]["by_purpose"]["param_gather"]["count"] > 0


def test_moe_serves_on_a_split_cache(real_run):
    """A MoE layer served on a mesh whose decode policy splits the caches'
    positions routes its rows whole: the smoke granite-moe-3b's prefill
    and decode logits on 2 × 2 equal the whole model's (the dry run of
    granite's and llama4's prefill_32k and decode_32k found the MoE
    gathering its input over the cache's split)."""
    for res in real_run:
        m = res["moe_serve"]
        assert m["kv_local"] == 16
        assert m["prefill"] <= 1e-5 and m["decode"] <= 1e-5, m
