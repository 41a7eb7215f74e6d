"""The port's FAµST operator on a mesh (``kernels/chain_sharded.py``,
``distributed/``, ``fused_sharded`` through the operator, dispatch,
``factorize``, streaming, ``FaustLinear`` and ``Server``) against the JAX
reference.

* Planning, in this process: the port's ``plan_shard`` on an
  ``AbstractMesh`` against the reference's on ``jax.sharding.AbstractMesh``
  (summaries, segments, plans, link bytes) on three meshes and five chains.
* Execution: four CPU processes on ``gloo`` (``tests/torch_mesh_worker.py``,
  rendezvous through a file under the module's temporary folder), one run
  of every scenario for the whole module, each scenario asserted by its
  own tests here, against the reference's single-device applies
  (``blockfaust_apply(use_kernel=False)``, ``packed_chain_apply`` and
  their ``jax.grad``) within the reference's sharded gate (``PARITY``
  1e-6, ``tests/test_sharded_apply.py``) forward and 1e-5 for gradients.
"""
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import torch_mesh_worker
from repro.configs import get_smoke as jget_smoke
from repro.core.compress import BlockFaust as JBlockFaust
from repro.core.compress import BlockSparseFactor as JFactor
from repro.core.compress import pack_chain as jpack_chain
from repro.core.compress import quantize_chain as jquantize_chain
from repro.kernels import chain_sharded as jcs
from repro.kernels.ops import blockfaust_apply as jblockfaust_apply
from repro.kernels.ops import packed_chain_apply as jpacked_chain_apply
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.layers.faust_linear import faust_linear_apply
from repro.models import lm as jlm
from repro.runtime.server import Server as JServer
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.distributed import AbstractMesh, make_debug_mesh, make_production_mesh
from repro_torch.kernels import chain_sharded as cs
from repro_torch.layers.faust_linear import FaustLinear, FaustSpec
from repro_torch.models.lm import LM
from torch_parity import blockfaust_dict, packed_dict

jax.config.update("jax_platform_name", "cpu")

PARITY = 1e-6  # the reference's gate: sharded == single-device (forward)
GRAD_TOL = 1e-5
WORLD = 4
RUN_TIMEOUT_S = 240
MESHES = ((2, 2), (1, 4), (4, 1))
VOCAB = 128  # the smoke model's vocabulary, cut from 131 so the head's 16 out-blocks split over the model axis


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _chain_dict(layout, seed: int, lam: float = 1.1, idx_fn=None) -> dict:
    """A chain of ``layout`` = ((in, out, blk, k), ...) from numpy
    ``seed``, as the bridge's dict; ``idx_fn(j, ob, ib, k, rng)`` may give
    a factor's support."""
    rng = np.random.default_rng(seed)
    factors = []
    for j, (in_f, out_f, blk, k) in enumerate(layout):
        ib, ob = -(-in_f // blk), -(-out_f // blk)
        idx = idx_fn(j, ob, ib, k, rng) if idx_fn else np.sort(
            np.stack([rng.permutation(ib)[:k] for _ in range(ob)]), axis=1)
        values = rng.standard_normal((ob, k, blk, blk)).astype(np.float32) / np.sqrt(k * blk)
        factors.append({"values": values, "in_idx": idx.astype(np.int32), "in_features": in_f, "out_features": out_f})
    return {"factors": factors, "lam": lam, "dtype": None}


def _local_idx(j, ob, ib, k, rng, n_model=2):
    """Every out-block reads input blocks of its own model shard (two
    shards): ``tests/test_sharded_apply.py``'s local-support chain."""
    per = ob // n_model
    return np.stack([np.sort(rng.choice(per, size=min(k, per), replace=False)) + (o // per) * per for o in range(ob)])


CHAINS = {
    # (4, 4, 6) blocks of 8, every boundary crossing: the reference's _chain
    "crossing": _chain_dict(((32, 32, 8, 2), (32, 48, 8, 2)), 0),
    "local": _chain_dict(((32, 32, 8, 2), (32, 32, 8, 2), (32, 32, 8, 2)), 3, lam=1.0, idx_fn=_local_idx),
    # 6 out-blocks: model-sharded on two model ranks, replicated on four
    "six_blocks": _chain_dict(((32, 48, 8, 2), (48, 48, 8, 2)), 5),
    "ragged": _chain_dict(((32, 32, 8, 2), (32, 44, 8, 2)), 6),
    # blocks 8 then 16: no packed layout, the per-factor apply
    "nonfusable": _chain_dict(((32, 32, 8, 2), (32, 64, 16, 2)), 7),
}


def _jchain(d: dict) -> JBlockFaust:
    factors = tuple(JFactor(jnp.asarray(f["values"]), jnp.asarray(f["in_idx"]), f["in_features"], f["out_features"])
                    for f in d["factors"])
    return JBlockFaust(factors, jnp.asarray(d["lam"], jnp.float32))


def _x(name: str, seed: int = 11) -> np.ndarray:
    in_f = CHAINS[name]["factors"][0]["in_features"]
    return np.random.default_rng(seed).standard_normal((3, 5, in_f)).astype(np.float32)


def _out_features(name: str) -> int:
    return CHAINS[name]["factors"][-1]["out_features"]


def _g(name: str) -> np.ndarray:
    return np.random.default_rng(12).standard_normal((3, 5, _out_features(name))).astype(np.float32)


# -- planning, in process ------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CHAINS))
def test_plan_shard_matches_reference(name, shape):
    """Summary, every segment's factors, gather and ``ChainPlan``, and the
    link bytes, equal to the reference's on an abstract mesh."""
    names = ("data", "model")
    want = jcs.plan_shard(_jchain(CHAINS[name]), JAbstractMesh(shape, names))
    got = cs.plan_shard(bridge.blockfaust_from_numpy(CHAINS[name], device="cpu"), AbstractMesh(shape, names))
    assert got.summary() == want.summary()
    assert got.data_spec == want.data_spec and got.model_axis == want.model_axis
    assert [(s.factors, s.gather_in, dataclasses.asdict(s.plan)) for s in got.segments] == \
           [(s.factors, s.gather_in, dataclasses.asdict(s.plan)) for s in want.segments]
    for b in (1, 10, 4096):
        for itemsize in (2, 4):
            assert got.collective_bytes(b, itemsize) == want.collective_bytes(b, itemsize)
            assert cs.ici_bytes(b, itemsize, got.n_batch_shards, got.n_model, got.crossing_feats) == \
                   jcs.ici_bytes(b, itemsize, want.n_batch_shards, want.n_model, want.crossing_feats)


def test_plan_cache_follows_the_support():
    """A cached plan serves the same support; an in-place change of an
    ``in_idx`` (a swap that moves the support) plans again."""
    bf = bridge.blockfaust_from_numpy(CHAINS["local"], device="cpu")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    plan = cs.plan_shard(bf, mesh)
    assert plan.crossing_feats == () and cs.plan_shard(bf, mesh) is plan
    bf.factors[1].in_idx[0, 0] = 3  # out-block 0 now reads block 3, the other shard's
    assert cs.plan_shard(bf, mesh).crossing_feats == (32,)


def test_meshes_need_their_ranks():
    """A mesh is over the default group, of the right size."""
    with pytest.raises(ValueError, match="init_process_group"):
        make_debug_mesh(2, 2)
    with pytest.raises(ValueError, match="init_process_group"):
        make_production_mesh(multi_pod=True)
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    with pytest.raises(ValueError, match="distinct name"):
        AbstractMesh((2, 2), ("data", "data"))


def test_engine_records_its_executors_mesh():
    """``EngineStats.mesh_axes`` is the executor's mesh, ``{axis: size}``,
    and None off a mesh."""
    from engine_sim import FakeClock, SimExecutor
    from repro_torch.runtime.engine import Engine

    sim = SimExecutor(n_slots=1, max_len=16)
    assert Engine(sim, clock=FakeClock(tick=0.001)).stats.mesh_axes is None
    sim.mesh = AbstractMesh((2, 2), ("data", "model"))
    assert Engine(sim, clock=FakeClock(tick=0.001)).stats.mesh_axes == {"data": 2, "model": 2}


# -- the process group ---------------------------------------------------------


def _lm_pair():
    """(reference cfg, params, port cfg, port state dict): gemma-2b's smoke
    config at ``VOCAB`` with a FAµST head (2 factors, block 8, k 2), the
    reference's parameters carried across."""
    extra = dict(tie_embeddings=False, vocab=VOCAB)
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), faust_unembed=JSpec(2, 8, 2), **extra)
    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_unembed=FaustSpec(2, 8, 2), **extra)
    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device="cpu"), strict=True)
    return jcfg, params, cfg, model.state_dict()


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    jq = jquantize_chain(jpack_chain(_jchain(CHAINS["crossing"])), "int8", "per_block")
    layer = FaustLinear(48, 64, FaustSpec(2, 8, 2), generator=torch.Generator().manual_seed(0), device="cpu")
    w = (rng.standard_normal((32, 64)) / np.sqrt(32)).astype(np.float32)
    jcfg, params, cfg, state = _lm_pair()
    return {
        "chains": CHAINS,
        "x": {n: _x(n) for n in CHAINS},
        "g": {n: _g(n) for n in CHAINS},
        "qchain": packed_dict(jq),
        "w": w,
        "w1": w + 0.01 * rng.standard_normal(w.shape).astype(np.float32),
        "wx": rng.standard_normal((6, 32)).astype(np.float32),
        "layer": layer.state_dict(),
        "layer_x": rng.standard_normal((7, 48)).astype(np.float32),
        "layer_g": rng.standard_normal((7, 64)).astype(np.float32),
        "lm_cfg": cfg,
        "lm_state": state,
        "tokens": rng.integers(0, VOCAB, (3, 6)).astype(np.int32),
        "_ref": (jcfg, params, jq),
    }


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every scenario of ``torch_mesh_worker`` on four ranks: (inputs, one
    result dict per rank).  The group always ends: each rank leaves it
    in a ``finally``, and a rank still alive at the time limit is
    killed."""
    folder = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    ref = inp.pop("_ref")
    torch.save(inp, folder / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_worker.run,
                         args=(r, WORLD, str(folder / "rendezvous"), str(folder / "inputs.pt"), str(folder)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RUN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(WORLD):
        path = folder / f"rank{r}.pt"
        assert path.exists(), f"rank {r} saved nothing (exit code {procs[r].exitcode})"
        res = torch.load(path, weights_only=False)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        results.append(res)
    inp["_ref"] = ref
    return inp, results


def _same_on_every_rank(results, get):
    first = get(results[0])
    for res in results[1:]:
        other = get(res)
        if isinstance(first, list):
            assert len(first) == len(other) and all(np.array_equal(a, b) for a, b in zip(first, other))
        else:
            np.testing.assert_array_equal(other, first)
    return first


def _jgrads(name, x, g):
    """The reference's single-device apply and its gradients wrt x, every
    factor's values and λ."""
    bf = _jchain(CHAINS[name])

    def loss(x, vals, lam):
        factors = tuple(dataclasses.replace(f, values=v) for f, v in zip(bf.factors, vals))
        return jnp.sum(jblockfaust_apply(x, JBlockFaust(factors, lam), use_kernel=False) * g)

    vals = tuple(f.values for f in bf.factors)
    y = jblockfaust_apply(jnp.asarray(x), bf, use_kernel=False)
    dx, dv, dlam = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), vals, bf.lam)
    return y, dx, dv, dlam


def test_mesh_coordinates(mesh_run):
    _, results = mesh_run
    coords = [(r["mesh"]["coord"]["data"], r["mesh"]["coord"]["model"]) for r in results]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["mesh"]["shape"] == {"data": 2, "model": 2} for r in results)


@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_forward_matches_reference(mesh_run, name):
    """Every chain (model-sharded, local, replicated, ragged, per factor)
    with leading batch dims and 15 rows: the same result on every rank,
    within ``PARITY`` of the reference's single-device apply."""
    inp, results = mesh_run
    y = _same_on_every_rank(results, lambda r: r["chains"][name]["y"])
    want = jblockfaust_apply(jnp.asarray(inp["x"][name]), _jchain(CHAINS[name]), use_kernel=False)
    assert y.shape == want.shape
    assert _rel(y, want) <= PARITY


@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_dx(mesh_run, name):
    """x's gradient: summed over the model ranks, rows gathered over data."""
    inp, results = mesh_run
    dx = _same_on_every_rank(results, lambda r: r["chains"][name]["dx"])
    _, want, _, _ = _jgrads(name, inp["x"][name], inp["g"][name])
    assert _rel(dx, want) <= GRAD_TOL


@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_dvalues(mesh_run, name):
    """Every factor's values gradient: summed over the data ranks, shards
    gathered over model."""
    inp, results = mesh_run
    dv = _same_on_every_rank(results, lambda r: r["chains"][name]["dvalues"])
    _, _, want, _ = _jgrads(name, inp["x"][name], inp["g"][name])
    for got, w in zip(dv, want):
        assert _rel(got, w) <= GRAD_TOL


@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_dlam(mesh_run, name):
    """λ's gradient: summed over the mesh."""
    inp, results = mesh_run
    dlam = _same_on_every_rank(results, lambda r: r["chains"][name]["dlam"])
    _, _, _, want = _jgrads(name, inp["x"][name], inp["g"][name])
    assert abs(dlam - float(want)) <= GRAD_TOL * abs(float(want))


def test_segments_launch_once_and_gather_only_at_crossings(mesh_run):
    """Model mode: one K1 a segment a rank forward, one K2 and one K3 a
    segment backward; a boundary all-gather (and its reduce-scatter) only
    at crossing boundaries, none for the local-support chain; the
    replicated chain one K1 a rank; the per-factor chain no K1."""
    _, results = mesh_run
    for res in results:
        for name, r in res["chains"].items():
            s = r["summary"]
            crossings = len(s["crossing_feats"])
            assert r["collectives"]["boundary_gather"] == crossings, name
            assert r["grad_collectives"]["boundary_reduce_scatter"] == crossings, name
            if s["mode"] == "model":
                assert r["calls"] == {"chain_matmul": s["n_segments"], "chain_dgrad": 0, "chain_wgrad": 0}, name
                assert r["grad_calls"] == dict.fromkeys(("chain_matmul", "chain_dgrad", "chain_wgrad"),
                                                        s["n_segments"]), name
            elif s["fusable"]:
                assert r["calls"]["chain_matmul"] == 1 and r["grad_calls"]["chain_wgrad"] == 1, name
            else:
                assert r["calls"]["chain_matmul"] == 0, name
        local = res["chains"]["local"]
        assert local["summary"]["n_segments"] == 1 and local["summary"]["crossing_feats"] == ()
        assert local["collectives"]["boundary_gather"] == 0 and local["calls"]["chain_matmul"] == 1
        assert res["chains"]["crossing"]["summary"]["mode"] == "model"
        assert res["chains"]["ragged"]["summary"]["mode"] == "replicated"


def test_sharded_int8_chain(mesh_run):
    """The int8 chain (codes, per-block scales) on the mesh: K4 per
    segment; forward, dx and dscales against the reference's dequantizing
    apply and its gradients."""
    inp, results = mesh_run
    _, _, jq = inp["_ref"]
    x, g = jnp.asarray(inp["x"]["crossing"]), jnp.asarray(inp["g"]["crossing"])

    def loss(x, scales):
        return jnp.sum(jpacked_chain_apply(x, dataclasses.replace(jq, scales=scales), use_kernel=False) * g)

    want = jpacked_chain_apply(x, jq, use_kernel=False)
    dx, dscales = jax.grad(loss, argnums=(0, 1))(x, jq.scales)
    y = _same_on_every_rank(results, lambda r: r["quantized"]["y"])
    assert _rel(y, want) <= PARITY
    assert _rel(_same_on_every_rank(results, lambda r: r["quantized"]["dx"]), dx) <= GRAD_TOL
    assert _rel(_same_on_every_rank(results, lambda r: r["quantized"]["dscales"]), dscales) <= GRAD_TOL
    assert all(r["quantized"]["calls"]["chain_matmul"] == 2 for r in results)  # two segments


def test_dispatch_reports_on_the_mesh(mesh_run):
    """``auto`` prices ``fused_sharded`` with the plan that runs; the
    report carries the mesh, the boundary bytes (the reference's count)
    and the result gather's; a forced ``fused`` runs on one rank's card."""
    _, results = mesh_run
    plan = cs.plan_shard(bridge.blockfaust_from_numpy(CHAINS["crossing"], device="cpu"),
                         AbstractMesh((2, 2), ("data", "model")))
    for res in results:
        forced = res["dispatch"]["fused_sharded"]
        assert forced["backend"] == "fused_sharded" and forced["requested"] == "fused_sharded"
        assert dict(forced["mesh_shape"]) == {"data": 2, "model": 2}
        assert forced["collective_bytes"] == plan.collective_bytes(15, 4) > 0
        assert forced["gather_bytes"] == plan.gather_bytes(15, 48, 4) > 0
        assert "fused_sharded" in forced["est_us"] and "sharded plan: model, 2 segment(s)" in forced["reason"]
        auto = res["dispatch"]["auto"]
        assert auto["requested"] == "auto" and auto["backend"] in auto["est_us"]
        assert auto["mesh_shape"] == forced["mesh_shape"]
        assert res["dispatch"]["fused"]["backend"] == "fused"
    assert len({r["dispatch"]["auto"]["backend"] for r in results}) == 1


def test_composite_leaves_dispatch_on_the_mesh(mesh_run):
    """``with_sharding`` on an ``hstack`` reaches every leaf; each leaf
    runs on the mesh (the crossing leaf's one boundary gather) and the
    result equals the reference's."""
    inp, results = mesh_run
    x = jnp.asarray(inp["x"]["crossing"])
    want = jnp.concatenate([jblockfaust_apply(x, _jchain(CHAINS[n]), use_kernel=False) for n in ("crossing", "local")],
                           axis=-1)
    y = _same_on_every_rank(results, lambda r: r["dispatch"]["composite"])
    assert _rel(y, want) <= PARITY
    assert _rel(_same_on_every_rank(results, lambda r: r["dispatch"]["composite_auto"]), want) <= PARITY
    for res in results:
        assert res["dispatch"]["composite_leaves"] == [True, True]
        assert res["dispatch"]["composite_collectives"]["boundary_gather"] == 1
        assert res["dispatch"]["composite_report"]["mesh_shape"] is not None


def test_factorize_on_the_mesh(mesh_run):
    """Rank 0 factorizes; every rank holds its chain bit for bit, equal
    to the unsharded ``factorize``; the operator carries its shard."""
    inp, results = mesh_run
    chain = _same_on_every_rank(results, lambda r: r["factorize"]["chain"])
    _same_on_every_rank(results, lambda r: r["factorize"]["faust"])
    assert all(np.array_equal(a, b) for a, b in zip(chain, results[0]["factorize"]["plain_chain"]))
    assert all(r["factorize"]["shard"] for r in results)
    y = _same_on_every_rank(results, lambda r: r["factorize"]["y"])
    assert y.shape == (6, 64) and np.isfinite(y).all()


def test_streaming_refresh_is_replaced_on_the_mesh(mesh_run):
    """A tracker on the mesh: every rank publishes rank 0's refresh,
    sharded, equal to the unsharded tracker's on rank 0."""
    _, results = mesh_run
    chain = _same_on_every_rank(results, lambda r: r["streaming"]["chain"])
    r0 = results[0]["streaming"]
    assert all(np.array_equal(a, b) for a, b in zip(chain, r0["plain_chain"]))
    assert {r["streaming"]["action"] for r in results} == {r0["plain_action"]} == {"sweep"}
    assert all(r["streaming"]["shard"] for r in results)


def test_faust_linear_with_shard(mesh_run):
    """``FaustLinear.forward(shard=)``: forward and gradients against the
    reference's ``faust_linear_apply`` and its ``jax.grad``."""
    inp, results = mesh_run
    state = inp["layer"]
    p = {"factors": [{"values": jnp.asarray(state[f"factors.{i}.values"].numpy()),
                      "in_idx": jnp.asarray(state[f"factors.{i}.in_idx"].numpy())} for i in range(2)],
         "lam": jnp.asarray(state["lam"].numpy())}
    x, g = jnp.asarray(inp["layer_x"]), jnp.asarray(inp["layer_g"])

    def loss(p, x):
        return jnp.sum(faust_linear_apply(p, x, JSpec(2, 8, 2), 48, 64, backend="bsr", use_kernel=False) * g)

    want = faust_linear_apply(p, x, JSpec(2, 8, 2), 48, 64, backend="bsr", use_kernel=False)
    dp, dx = jax.grad(loss, argnums=(0, 1), allow_int=True)(p, x)
    assert _rel(_same_on_every_rank(results, lambda r: r["faust_linear"]["y"]), want) <= PARITY
    assert _rel(_same_on_every_rank(results, lambda r: r["faust_linear"]["dx"]), dx) <= GRAD_TOL
    dv = _same_on_every_rank(results, lambda r: r["faust_linear"]["dvalues"])
    for i in range(2):
        assert _rel(dv[i], dp["factors"][i]["values"]) <= GRAD_TOL
    dlam = _same_on_every_rank(results, lambda r: r["faust_linear"]["dlam"])
    assert abs(dlam - float(dp["lam"])) <= GRAD_TOL * abs(float(dp["lam"]))
    assert all(r["faust_linear"]["calls"]["chain_matmul"] == 2 for r in results)


def test_server_on_the_mesh(mesh_run):
    """``Server(mesh=)`` with the head sharded: greedy tokens equal to the
    reference's ``Server`` on the same parameters and to the port's
    unsharded ``Server``, the same on every rank; the head ran
    ``fused_sharded`` (two segments a forward); ``mesh_axes``."""
    inp, results = mesh_run
    jcfg, params, _ = inp["_ref"]
    jgen, _ = JServer(jcfg, params, max_len=12).generate({"tokens": jnp.asarray(inp["tokens"])}, 5)
    gen = _same_on_every_rank(results, lambda r: r["serve"]["gen"])
    np.testing.assert_array_equal(gen, np.asarray(jgen))
    np.testing.assert_array_equal(results[0]["serve"]["plain_gen"], gen)
    for res in results:
        s = res["serve"]
        assert s["mesh_axes"] == {"data": 2, "model": 2} and s["backend"] == "fused_sharded"
        assert s["calls"]["chain_matmul"] > 0 and s["calls"]["chain_matmul"] % 2 == 0
        assert s["collectives"]["boundary_gather"] == s["calls"]["chain_matmul"] // 2


def test_autotune_on_the_mesh_agrees(mesh_run):
    """``apply(autotune=True)`` on the mesh: every rank records the same
    entry (the slowest rank's times), keyed by the mesh."""
    _, results = mesh_run
    entries = [r["autotune"]["entries"] for r in results]
    assert all(e == entries[0] for e in entries) and len(entries[0]) == 1
    (key, (best, us)), = entries[0].items()
    assert "|mesh:data2xmodel2|" in key and "fused_sharded" in us and best in us


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["1x4", "4x1"])
def test_other_meshes(mesh_run, shape):
    """The crossing chain on 1 × 4 (four model ranks) and 4 × 1 (the
    batch over four data ranks, weights replicated): forward and
    gradients against the reference."""
    inp, results = mesh_run
    got = [r["other_meshes"][shape] for r in results]
    y, dx, dv, dlam = _jgrads("crossing", inp["x"]["crossing"], inp["g"]["crossing"])
    assert _rel(_same_on_every_rank(got, lambda r: r["y"]), y) <= PARITY
    assert _rel(_same_on_every_rank(got, lambda r: r["dx"]), dx) <= GRAD_TOL
    for a, b in zip(_same_on_every_rank(got, lambda r: r["dvalues"]), dv):
        assert _rel(a, b) <= GRAD_TOL
    assert abs(got[0]["dlam"] - float(dlam)) <= GRAD_TOL * abs(float(dlam))
