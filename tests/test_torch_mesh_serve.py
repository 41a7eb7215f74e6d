"""The language model served on a mesh under its decode policy
(``runtime/engine.py`` ``LMExecutor(mesh=)`` with a model ``LM.shard_``
split, ``runtime/server.py`` ``Server(mesh=)``, ``layers/attention.py``'s
split caches and ``decode_attention_split``) against the JAX reference.

Four CPU processes on ``gloo`` (``tests/torch_mesh_serve_worker.py``, one
run for the module) serve gemma-2b's smoke config (2 layers,
``attn_chunk`` 8, f32) with a FAµST head, on the reference's parameters
carried across by the bridge, on a 2 × 2, 1 × 4 and 4 × 1 ``("data",
"model")`` mesh under ``DECODE_POLICY`` (rows over ``data``, the caches'
positions over ``model``) and on 2 × 2 under ``DECODE_LONG_POLICY`` (rows
whole, positions over both axes).  The test process runs the reference's
unsharded ``Engine(LMExecutor)`` and ``Server`` on the same trace: the
greedy tokens must be equal and the same on every rank, the last decode
step's logits within 1e-5.
"""
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_serve_worker as worker
from repro.configs import get_smoke as jget_smoke
from repro.layers.faust_linear import FaustSpec as JSpec
from repro.models import lm as jlm
from repro.runtime import engine as jengine
from repro.runtime.server import Server as JServer
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.layers.attention import KVCache, decode_attention, kv_cache_positions
from repro_torch.layers.faust_linear import FaustSpec
from repro_torch.models.lm import LM
from torch_parity import arch_cfgs

jax.config.update("jax_platform_name", "cpu")

WORLD = 4
RUN_TIMEOUT_S = 240
LOGITS_TOL = 1e-5  # f32, against the reference's decode logits
ATTN_TOL = 1e-6  # f32, the split decode attention against the whole-cache function
VOCAB = 128  # the head's 16 out-blocks (block 8) split over the model axis


def _gemma_pair():
    """(reference cfg, params, port cfg, port state dict): gemma-2b's smoke
    config at ``VOCAB`` with a FAµST head (2 factors, block 8, k 2)."""
    extra = dict(tie_embeddings=False, vocab=VOCAB)
    jcfg = dataclasses.replace(jget_smoke("gemma_2b"), faust_unembed=JSpec(2, 8, 2), **extra)
    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_unembed=FaustSpec(2, 8, 2), **extra)
    params = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(bridge.lm_state_dict_from_numpy(tree, cfg, device="cpu"), strict=True)
    return jcfg, params, cfg, model.state_dict()


def _prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in worker.LENGTHS]


def _attention_inputs() -> dict:
    """A cache of 24 positions (one KV head, four query heads, D 16), rows
    at positions 3, 24 and 14: the last token in the first block, the last
    and a middle one."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(3, 1, 4, 16), "k": f(3, 1, 24, 16), "v": f(3, 1, 24, 16),
            "pos": np.array([3, 24, 14], np.int32), "window": None}


def _inputs():
    jcfg, params, cfg, state = _gemma_pair()
    j3cfg, cfg3 = arch_cfgs("gemma3_27b")
    state3 = LM(cfg3, seed=0, device="cpu").state_dict()
    tree3, _ = bridge.lm_state_dict_to_numpy(state3, cfg3)
    rng = np.random.default_rng(9)
    inp = {
        "gemma": {"cfg": cfg, "state": state, "prompts": _prompts(VOCAB, 21)},
        "gemma3": {"cfg": cfg3, "state": state3, "prompts": _prompts(cfg3.vocab, 22)},
        "server_tokens": rng.integers(0, VOCAB, (4, 6)).astype(np.int32),
        "embed_tokens": rng.integers(0, VOCAB, 12).astype(np.int64),
        "attention": _attention_inputs(),
    }
    return inp, {"gemma": (jcfg, params), "gemma3": (j3cfg, jax.tree_util.tree_map(jnp.asarray, tree3))}


def _reference_engine(jcfg, params, prompts) -> dict:
    """The reference's unsharded engine on the trace: every request's
    tokens and every decode step's logits."""
    ex = jengine.LMExecutor(jcfg, params, worker.MAX_LEN, n_slots=worker.N_SLOTS)
    steps, decode = [], ex.decode_forward

    def logged(slots, tokens):
        logits = decode(slots, tokens)
        steps.append(np.asarray(logits))
        return logits

    ex.decode_forward = logged
    eng = jengine.Engine(ex)
    rids = worker.drive(eng, prompts, list(worker.BUDGETS))
    return {"tokens": [np.asarray(eng.result(r)) for r in rids], "logits": steps}


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """Every scenario of ``torch_mesh_serve_worker`` on four ranks, and the
    reference's runs meanwhile: (inputs, results per rank, reference)."""
    folder = tmp_path_factory.mktemp("mesh_serve")
    inp, ref_params = _inputs()
    torch.save(inp, folder / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(folder / "rendezvous"), str(folder / "inputs.pt"),
                                                  str(folder)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jcfg, params = ref_params["gemma"]
        ref = {**_reference_engine(jcfg, params, inp["gemma"]["prompts"]),
               "gemma3": _reference_engine(*ref_params["gemma3"], inp["gemma3"]["prompts"])["tokens"],
               "server": np.asarray(JServer(jcfg, params, max_len=12).generate(
                   {"tokens": jnp.asarray(inp["server_tokens"])}, 5)[0])}
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
    return inp, results, ref


def _same_tokens(results, get) -> list:
    first = get(results[0])
    for res in results[1:]:
        other = get(res)
        assert len(other) == len(first) and all(np.array_equal(a, b) for a, b in zip(first, other))
    return first


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_tokens_match_reference(serve_run, mesh):
    """Every request ends done, with the greedy tokens of the reference's
    unsharded engine on the same parameters and trace, on every rank."""
    _, results, ref = serve_run
    assert all(r["meshes"][mesh]["states"] == ["done"] for r in results)
    tokens = _same_tokens(results, lambda r: r["meshes"][mesh]["tokens"])
    assert len(tokens) == len(ref["tokens"])
    for got, want in zip(tokens, ref["tokens"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_decode_logits_match_reference(serve_run, mesh):
    """Every decode step's logits (the replays' too), their rows and
    vocabulary blocks assembled from the ranks, within ``LOGITS_TOL`` of
    the reference's; ranks that hold the same rows and block hold the
    same bits."""
    _, results, ref = serve_run
    assert len({len(r["meshes"][mesh]["logits"]) for r in results}) == 1
    assert len(results[0]["meshes"][mesh]["logits"]) == len(ref["logits"])
    for i, want in enumerate(ref["logits"]):
        got = np.full(want.shape, np.nan, np.float32)
        for res in results:
            local, rows, start = res["meshes"][mesh]["logits"][i]
            cols = slice(start, start + local.shape[-1])
            for row, value in zip(rows, local):
                seen = got[row][..., cols]
                assert np.isnan(seen).all() or np.array_equal(seen, value), "replicas differ"
                got[row][..., cols] = value
        assert not np.isnan(got).any(), f"step {i}: a row no rank holds"
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL * np.abs(want).max())


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_rank_holds_its_rows_and_positions(serve_run, mesh):
    """Each rank's pool: its rows over the decode policy's batch axes and
    its block of the positions over ``kv_seq``, at its coordinates."""
    inp, results, _ = serve_run
    (n_data, n_model), policy = worker.MESHES[mesh]
    long = policy == "long"
    rows = worker.N_SLOTS if long else worker.N_SLOTS // n_data
    blocks = n_data * n_model if long else n_model
    cfg = inp["gemma"]["cfg"]
    for res in results:
        m = res["meshes"][mesh]
        assert m["rows"] == (() if long or n_data == 1 else ("data",))
        assert len(m["pool"]) == cfg.n_layers
        for k, v, pos in m["pool"]:
            assert k == v == (rows, cfg.n_kv_heads, worker.MAX_LEN // blocks, cfg.head_dim)
            assert pos == (rows,)
        c = m["coord"]
        index = c["data"] * n_model + c["model"] if long else c["model"]
        assert m["kv"] == (None if blocks == 1 else (index * worker.MAX_LEN // blocks, worker.MAX_LEN // blocks))


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_collectives_of_the_placement(serve_run, mesh):
    """A split cache merges over its group and split rows gather their
    tokens, never the logits; a rank with no live row in a step idles on
    a row of its own (it happens in this trace wherever rows split) and
    still joins the step; the weights are gathered every forward."""
    _, results, _ = serve_run
    (n_data, n_model), policy = worker.MESHES[mesh]
    long = policy == "long"
    for res in results:
        m = res["meshes"][mesh]
        calls, moved = m["counts"]["calls"], m["counts"]["bytes"]
        assert calls["param_gather"] > 0
        assert (calls["kv_merge"] > 0) == (long or n_model > 1)
        split_rows = not long and n_data > 1
        assert (calls["row_gather"] > 0) == split_rows
        if split_rows:  # one int32 token and one flag a live row a gather, never a (B, V) row
            assert moved["row_gather"] <= calls["row_gather"] * worker.N_SLOTS * 2 * 4
    idle = [res["meshes"][mesh]["idle_steps"] for res in results]
    if not long and n_data > 1:
        assert max(idle) > 0
    else:
        assert idle == [0] * WORLD
    # every rank took the same engine steps, idle or not
    assert len({res["meshes"][mesh]["steps"] for res in results}) == 1


def test_skipped_merge_changes_the_tokens(serve_run):
    """The planted fault: each rank attends over its own block only (the
    log-sum-exp merge skipped); the tokens leave the sound run's on the
    same parameters (their attention made loud: the worker's
    ``PLANTED_GAIN``)."""
    _, results, _ = serve_run
    planted = results[0]["planted"]
    assert planted["states"] == ["done"]
    assert any(not np.array_equal(a, b) for a, b in zip(planted["tokens"], planted["sound"]))


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_split_decode_attention_matches_whole(serve_run, n_blocks):
    """``decode_attention_split`` over 2 and 4 blocks of the positions
    within ``ATTN_TOL`` of the whole-cache function (f32), rows whose last
    position lies in the first block, the last block and between."""
    inp, results, _ = serve_run
    a = inp["attention"]
    k, v, pos = torch.as_tensor(a["k"]), torch.as_tensor(a["v"]), torch.as_tensor(a["pos"])
    want = decode_attention(torch.as_tensor(a["q"]), k, v, q_position=pos[:, None].long() - 1,
                            kv_positions=kv_cache_positions(KVCache(k, v, pos))).numpy()
    shape = (2, 2) if n_blocks == 2 else (1, 4)
    for res in results:
        got = res["split_attention"][shape]
        np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL * np.abs(want).max())


def test_gemma3_local_layers_serve_whole_rings(serve_run):
    """gemma3's smoke config on 2 × 2: its sliding-window rings stay whole
    on every rank of their rows (ROADMAP caveat R11), its global layer's
    cache is split; the tokens equal the reference's on every rank."""
    inp, results, ref = serve_run
    cfg = inp["gemma3"]["cfg"]
    tokens = _same_tokens(results, lambda r: r["gemma3"]["tokens"])
    for got, want in zip(tokens, ref["gemma3"]):
        np.testing.assert_array_equal(got, want)
    for res in results:
        shapes = [c[0] for c in res["gemma3"]["pool"]]
        for kind, shape in zip(cfg.layer_kinds(), shapes):
            cap = min(cfg.window, worker.MAX_LEN) if kind == "local" else worker.MAX_LEN // 2
            assert shape == (worker.N_SLOTS // 2, cfg.n_kv_heads, cap, cfg.head_dim), kind
        assert res["gemma3"]["counts"]["calls"]["kv_merge"] > 0


def test_server_on_a_sharded_model(serve_run):
    """``Server(mesh=)`` on the model split on 2 × 2, four rows (two a data
    rank): the reference ``Server``'s tokens on every rank."""
    _, results, ref = serve_run
    gen = _same_tokens(results, lambda r: list(r["server"]["gen"]))
    np.testing.assert_array_equal(np.stack(gen), ref["server"])
    for res in results:
        assert res["server"]["mesh_axes"] == {"data": 2, "model": 2}
        assert res["server"]["rows"] == ("data",)


def test_executor_refuses_another_mesh():
    """A model split on one mesh cannot be served on another, or off it."""
    from repro_torch.distributed import AbstractMesh
    from repro_torch.runtime.engine import LMExecutor

    _, _, cfg, state = _gemma_pair()
    model = LM(cfg, device="cpu")
    model.blocks, model.mesh = {}, AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="another mesh"):
        LMExecutor(model, 8, 2, mesh=AbstractMesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match="another mesh"):
        LMExecutor(model, 8, 2)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_embedding_read_in_place(serve_run, shape):
    """Serving reads the split embedding table in place (each rank's
    vocabulary block, zeros elsewhere, summed, the feature blocks
    gathered): every rank's rows, of its own tokens and count, bit for bit
    the whole table's."""
    _, results, _ = serve_run
    for rank, res in enumerate(results):
        got = res["embedding"][shape]
        assert got["equal"] and got["calls"] > 0
        assert got["shape"] == (rank + 1, 3, 48)
