"""The model-compression drivers (``core/compress.py``: ``compress_layers``,
``compress_model``), a ``FaustLinear`` built from a compressed chain
(``FaustLinear.from_blockfaust``, ``blockfaust_to_state_dict``,
``swap_unembed``'s construction), ``bridge.lm_key_to_name`` and the small
helpers (``spectral_norm_batched``, ``dense_flops``,
``clip_by_global_norm``, ``host_slice``) against the JAX reference on the
CPU, on arrays made with numpy from a seed.

* Chains against the reference's at slice 7's tolerance: supports equal,
  values within 1e-4 of max|·|, λ and the relative error within 1e-4 (the
  same f32 products summed in another order, compounded by the sweeps).
* ``compress_model``: the reference's stacked tree is the port's state
  dict, carried across by ``bridge.lm_state_dict_to_numpy``; every
  reference key maps through ``bridge.lm_key_to_name`` to a port name.
* ``mesh=``: four ``gloo`` ranks (``tests/torch_compress_worker.py``), a
  2 × 2 ``("data", "model")`` mesh; every chain equal to the unsharded
  call's bit for bit.
* A model with installed chains against the reference's ``forward_train``
  on the dense tree whose MLP weights are each chain's ``todense()``, f32
  within 1e-5 of max|logits|.
"""
import importlib
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_compress_worker as worker
from repro.configs import get_smoke as jget_smoke
from repro.core import lipschitz as jl
from repro.core.faust import dense_flops as jdense_flops
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.core import compress_layers, compress_model, dense_flops, spectral_norm_batched
from repro_torch.core.lipschitz import spectral_norm
from repro_torch.data import pipeline
from repro_torch.layers.faust_linear import FaustLinear, FaustSpec, blockfaust_to_state_dict
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.runtime.engine import LMExecutor
from torch_parity import rel_max_err, to_np

jax.config.update("jax_platform_name", "cpu")
jcompress = importlib.import_module("repro.core.compress")
tcompress = importlib.import_module("repro_torch.core.compress")

CPU = "cpu"
REF_TOL = 1e-4  # chains against the reference's (module docstring)
F32_TOL = 1e-5  # layers and logits in f32
KW = dict(bk=16, bn=16, n_iter_two=5, n_iter_global=5)
LAYER_NAMES = ["c[0]", "c[1]", "c[2]", "a", "b"]
MLP_NAMES = [f"layers.{i}.mlp.{w}" for i in range(2) for w in ("w_up", "w_gate", "w_down")]
MESH_WORLD = 4


def _re(bf, w) -> float:
    w = torch.as_tensor(w)
    return float(torch.linalg.norm(w - bf.todense()) / torch.linalg.norm(w))


def _jre(bf, w) -> float:
    return float(jnp.linalg.norm(w - bf.todense()) / jnp.linalg.norm(w))


def _same_chain(mine, ref, w):
    """Chain for chain: per-factor layout and supports equal, values, λ and
    the relative error against ``w`` within ``REF_TOL``."""
    assert len(mine.factors) == len(ref.factors)
    for f, jf in zip(mine.factors, ref.factors):
        assert (f.in_features, f.out_features) == (jf.in_features, jf.out_features)
        np.testing.assert_array_equal(f.in_idx.numpy(), np.asarray(jf.in_idx))
        assert rel_max_err(to_np(f.values), np.asarray(jf.values)) <= REF_TOL
    assert float(mine.lam) == pytest.approx(float(ref.lam), rel=REF_TOL)
    assert abs(_re(mine, w) - _jre(ref, jnp.asarray(w))) <= REF_TOL


# ---------------------------------------------------------------------------
# compress_layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layers_run():
    """Two 64 × 128 weights (one bucket) and a (3, 64, 64) stack through
    both packages at block 16 and 5 sweeps: (weights, reference, port)."""
    rng = np.random.default_rng(0)
    w = {"a": rng.standard_normal((64, 128)).astype(np.float32),
         "b": rng.standard_normal((64, 128)).astype(np.float32),
         "c": rng.standard_normal((3, 64, 64)).astype(np.float32)}
    ref = jcompress.compress_layers({k: jnp.asarray(v) for k, v in w.items()}, **KW)
    mine = compress_layers({k: torch.as_tensor(v) for k, v in w.items()}, device=CPU, **KW)
    return w, ref, mine


def _target(w, name):
    return w[name[0]][int(name[2])] if "[" in name else w[name]


def test_compress_layers_names_and_order(layers_run):
    """Five chains, named and ordered as the reference's: the stack's
    ``name[i]`` first (names sorted), then the bucket."""
    _, ref, mine = layers_run
    assert list(ref) == list(mine) == LAYER_NAMES


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_compress_layers_matches_reference(layers_run, name):
    w, ref, mine = layers_run
    _same_chain(mine[name], ref[name], _target(w, name))


def test_compress_layers_keeps_each_chains_own_k(layers_run):
    """A compressed chain's residual factor keeps its own block count: the
    64 × 128 chains' factors hold 2 and 4 blocks an output column."""
    _, _, mine = layers_run
    assert [f.k for f in mine["a"].factors] == [2, 4]
    assert [f.values.shape[0] for f in mine["a"].factors] == [4, 8]


def test_compress_layers_refuses_other_ranks():
    with pytest.raises(ValueError, match="2-D or"):
        compress_layers({"x": torch.zeros(2, 2, 16, 16)}, device=CPU, **KW)
    with pytest.raises(ValueError, match="square blocks"):
        compress_layers({"x": torch.zeros(16, 32)}, bk=16, bn=8, device=CPU)


# ---------------------------------------------------------------------------
# compress_model
# ---------------------------------------------------------------------------


def _tree(model, cfg):
    """The reference's parameter tree of the port's ``model``."""
    tree, _ = bridge.lm_state_dict_to_numpy(model.state_dict(), cfg)
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def gemma_run():
    """The smoke gemma-2b (2 layers, d 48, f 96) from seed 0: both packages'
    ``compress_model`` of its MLP at ``min_dim`` 16."""
    cfg = get_smoke("gemma_2b")
    model = LM(cfg, seed=0, device=CPU)
    tree = _tree(model, cfg)
    ref = jcompress.compress_model(tree, min_dim=16, select=lambda n: "mlp" in n, **KW)
    mine = compress_model(model, min_dim=16, select=lambda n: ".mlp." in n, device=CPU, **KW)
    return cfg, model, tree, ref, mine


def test_compress_model_selects_the_references_matrices(gemma_run):
    cfg, _, _, ref, mine = gemma_run
    assert sorted(bridge.lm_key_to_name(k, cfg) for k in ref) == sorted(mine) == sorted(MLP_NAMES)


@pytest.mark.parametrize("name", MLP_NAMES)
def test_compress_model_matches_reference(gemma_run, name):
    cfg, model, _, ref, mine = gemma_run
    jname = next(k for k in ref if bridge.lm_key_to_name(k, cfg) == name)
    _same_chain(mine[name], ref[jname], model.state_dict()[name].numpy())


def test_compress_model_takes_a_state_dict(gemma_run):
    """A ``{name: tensor}`` dict picks what the module's parameters pick;
    its integer tensors are not weights."""
    _, model, _, _, _ = gemma_run
    seen = {}
    real = tcompress.compress_layers
    try:
        tcompress.compress_layers = lambda w, **kw: seen.setdefault("w", w) and {}
        compress_model({**model.state_dict(), "idx": torch.zeros(32, 32, dtype=torch.int32)}, min_dim=16)
        from_dict = seen.pop("w")
        compress_model(model, min_dim=16)
    finally:
        tcompress.compress_layers = real
    assert sorted(from_dict) == sorted(seen["w"])


def _expand(names_shapes, per_layer) -> set:
    """Selected weights as one name per matrix: a stack's ``[i]`` slices."""
    out = set()
    for name, shape in names_shapes.items():
        if len(shape) == 3 or per_layer(name):
            out.update(f"{name}[{i}]" for i in range(shape[0]))
        else:
            out.add(name)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compress_model_eligibility_matches_reference(arch, monkeypatch):
    """On every smoke config at ``min_dim`` 16, the names the port selects
    are the reference's mapped: MoE experts skipped (4-D stacked, 3-D a
    layer), a top-level 3-D stack kept (musicgen's ``unembed.w[k]``)."""
    cfg = get_smoke(arch)
    model = LM(cfg, seed=0, device=CPU)
    seen = {}

    def capture(key):
        return lambda w, **kw: seen.setdefault(key, {k: tuple(v.shape) for k, v in w.items()}) and {}

    monkeypatch.setattr(jcompress, "compress_layers", capture("ref"))
    monkeypatch.setattr(tcompress, "compress_layers", capture("port"))
    jcompress.compress_model(_tree(model, cfg), min_dim=16)
    compress_model(model, min_dim=16)
    ref = {bridge.lm_key_to_name(k, cfg) for k in _expand(seen["ref"], lambda n: n.startswith("['stages']"))}
    mine = _expand(seen["port"], lambda n: False)
    assert ref == mine
    if cfg.moe is not None:
        assert not any(".moe.w_" in n for n in mine)
    if arch == "musicgen_medium":
        assert {"unembed.w[0]", "unembed.w[1]"} <= mine


def test_lm_key_to_name():
    z = get_smoke("zamba2_7b")  # stages ((2, (ssm, ssm, ssm, shared)), (1, (ssm,)))
    assert bridge.lm_key_to_name("['stages'][0][1]['mamba']['in_proj'][1]", z) == "layers.5.mamba.in_proj"
    assert bridge.lm_key_to_name("['stages'][1][0]['mamba']['out_proj'][0]", z) == "layers.8.mamba.out_proj"
    assert bridge.lm_key_to_name("['embed']['table']", z) == "embed.table"
    assert bridge.lm_key_to_name("['unembed']['w'][1]", z) == "unembed.w[1]"
    with pytest.raises(ValueError, match="whole stacked leaf"):
        bridge.lm_key_to_name("['stages'][0][0]['mamba']['in_proj']", z)


# ---------------------------------------------------------------------------
# compress_layers(mesh=) on four gloo ranks
# ---------------------------------------------------------------------------

MESH_NAMES = ["a0", "a1", "a2", "a3", "c[0]", "c[1]", "c[2]", "d", "e[0]", "e[1]", "e[2]", "e[3]"]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """A bucket of four 32 × 64 weights and a (4, 24, 32) stack (slices of
    two on each data rank), a (3, 32, 32) stack and a singleton (rank 0
    solves them), block 8: each rank's results."""
    folder = tmp_path_factory.mktemp("compress_mesh")
    rng = np.random.default_rng(3)
    inp = {f"a{i}": rng.standard_normal((32, 64)).astype(np.float32) for i in range(4)}
    inp.update(c=rng.standard_normal((3, 32, 32)).astype(np.float32),
               d=rng.standard_normal((48, 32)).astype(np.float32),
               e=rng.standard_normal((4, 24, 32)).astype(np.float32),
               x=rng.standard_normal((5, 32)).astype(np.float32))
    np.savez(folder / "inputs.npz", **inp)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, MESH_WORLD, str(folder / "rendezvous"),
                                                  str(folder / "inputs.npz"), str(folder)))
             for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
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
    return results


@pytest.mark.parametrize("name", MESH_NAMES)
def test_mesh_chains_equal_unsharded_bitwise(mesh_run, name):
    want = mesh_run[0]["unsharded"][name]
    for r in mesh_run:
        got = r["chains"][name]
        assert got["lam"] == want["lam"]
        for f, g in zip(got["factors"], want["factors"]):
            assert (f["in_features"], f["out_features"]) == (g["in_features"], g["out_features"])
            np.testing.assert_array_equal(f["in_idx"], g["in_idx"])
            np.testing.assert_array_equal(f["values"], g["values"])
    assert sorted(mesh_run[0]["chains"]) == sorted(MESH_NAMES)


def test_mesh_solves_slices_on_the_data_ranks(mesh_run):
    """The dividing bucket and stack: each data rank solved its own two
    matrices.  The uneven stack and the singleton: rank 0 alone (every
    rank entered ``factorize`` on the mesh, rank 0 then solved them)."""
    for r in mesh_run:
        local = sorted(s for s, on_mesh in r["solves"] if not on_mesh)
        want = [(2, 24, 32), (2, 32, 64)] + ([(3, 32, 32), (48, 32)] if r["coord"] == {"data": 0, "model": 0} else [])
        assert local == sorted(want), (r["coord"], local)
        assert sorted(s for s, on_mesh in r["solves"] if on_mesh) == [(3, 32, 32), (48, 32)]


def test_mesh_chains_come_back_placed(mesh_run):
    """Every chain on the mesh's device, ready for ``fused_sharded``: the
    sharded apply of one equals ``x @ todense()``."""
    for r in mesh_run:
        assert r["devices"] == ["cpu"]
        assert rel_max_err(r["sharded_apply"], r["dense_apply"]) <= F32_TOL


# ---------------------------------------------------------------------------
# FaustLinear from a compressed chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "bsr", "fused", "auto"])
def test_from_blockfaust_applies_the_chain(layers_run, backend):
    """The layer keeps each factor's ``k``, dims, support and λ, and its
    forward and ``todense()`` are the chain's."""
    _, _, mine = layers_run
    bf = mine["a"]
    layer = FaustLinear.from_blockfaust(bf, backend=backend)
    assert [f.values.shape for f in layer.factors] == [f.values.shape for f in bf.factors]
    assert (layer.in_dim, layer.out_dim, layer.spec) == (64, 128, FaustSpec(2, 16, 4))
    torch.testing.assert_close(layer.todense(), bf.todense(), rtol=0, atol=0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((7, 64)).astype(np.float32))
    with torch.no_grad():
        assert rel_max_err(to_np(layer(x)), to_np(x @ bf.todense())) <= F32_TOL


def test_from_blockfaust_holds_new_tensors(layers_run):
    """The layer's parameters are copies (a step on them leaves the chain),
    in ``dtype``; its state dict is :func:`blockfaust_to_state_dict`'s."""
    _, _, mine = layers_run
    bf = mine["b"]
    layer = FaustLinear.from_blockfaust(bf)
    sd, want = layer.state_dict(), blockfaust_to_state_dict(bf)
    assert list(sd) == list(want) == ["lam", "factors.0.values", "factors.0.in_idx", "factors.1.values",
                                      "factors.1.in_idx"]
    for k in sd:
        assert torch.equal(sd[k], want[k]) and sd[k].data_ptr() != want[k].data_ptr()
    with torch.no_grad():
        layer.factors[0].values.add_(1.0)
    assert not torch.equal(layer.factors[0].values, bf.factors[0].values)
    half = FaustLinear.from_blockfaust(bf, dtype=torch.bfloat16)
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}
    assert half.factors[0].in_idx.dtype == torch.int32
    with pytest.raises(ValueError, match="does not describe"):
        FaustLinear.from_blockfaust(bf, spec=FaustSpec(3, 16, 4))


def _install(model, chains, dtype=None):
    for name, bf in chains.items():
        layer, _, w = name.split(".")[1:]
        setattr(model.layers[int(layer)].mlp, w, FaustLinear.from_blockfaust(bf, dtype=dtype))


def test_installed_mlp_matches_reference_on_the_dense_tree(gemma_run):
    """Every MLP weight replaced by its chain (plain assignment): the state
    dict holds the chains' keys only, and the logits equal the reference's
    ``forward_train`` on the dense tree whose MLP weights are each chain's
    ``todense()`` (λ included)."""
    cfg, model, tree, _, mine = gemma_run
    installed = LM(cfg, seed=0, device=CPU)
    _install(installed, mine)
    keys = set(installed.state_dict())
    assert not keys & set(MLP_NAMES)
    assert {f"{n}.factors.{i}.{t}" for n in MLP_NAMES for i in range(2) for t in ("values", "in_idx")} | \
           {f"{n}.lam" for n in MLP_NAMES} <= keys
    dense = jax.tree_util.tree_map(lambda a: a, tree)
    for w in ("w_up", "w_gate", "w_down"):
        dense["stages"][0][0]["mlp"][w] = jnp.stack(
            [jnp.asarray(mine[f"layers.{i}.mlp.{w}"].todense().numpy()) for i in range(2)])
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jlogits, _ = jlm.forward_train(dense, jget_smoke("gemma_2b"), {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits = installed.forward_train(torch.as_tensor(tokens))
    assert rel_max_err(to_np(logits), np.asarray(jlogits)) <= F32_TOL


def test_executor_sees_an_installed_mlp(gemma_run):
    """An executor built before the assignment holds no stale per-model
    state: its prefill and decode logits equal a fresh executor's."""
    cfg, _, _, _, mine = gemma_run
    model = LM(cfg, seed=0, device=CPU)
    early = LMExecutor(model, 32, 2)
    _install(model, mine)
    fresh = LMExecutor(model, 32, 2)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, 12).astype(np.int32)
    early_out, fresh_out = ([ex.prefill_forward(0, prompt, {}), ex.decode_forward([0], np.array([[3]]))]
                            for ex in (early, fresh))
    for a, b in zip(early_out, fresh_out):
        torch.testing.assert_close(torch.as_tensor(a), torch.as_tensor(b), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the small helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 20, 30), (2, 40, 16), (1, 8, 8)])
def test_spectral_norm_batched_matches_reference(shape):
    a = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    mine = spectral_norm_batched(torch.as_tensor(a))
    np.testing.assert_allclose(mine.numpy(), np.asarray(jl.spectral_norm_batched(jnp.asarray(a))), rtol=1e-5)
    for i in range(shape[0]):
        assert float(mine[i]) == pytest.approx(float(spectral_norm(torch.as_tensor(a[i]))), rel=1e-6)
    with pytest.raises(ValueError, match="stack"):
        spectral_norm_batched(torch.as_tensor(a[0]))


@pytest.mark.parametrize("shape,batch", [((2048, 16384), 1), ((48, 96), 37)])
def test_dense_flops_matches_reference(shape, batch):
    assert dense_flops(shape, batch) == jdense_flops(shape, batch)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (0.5) and untouched (1e3) gradients and the norm against the
    reference's; a non-float tensor passes through as it is."""
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    idx = torch.arange(4, dtype=torch.int32)
    clipped, norm = adamw.clip_by_global_norm({**{k: torch.as_tensor(v) for k, v in g.items()}, "idx": idx},
                                              max_norm)
    jclipped, jnorm = jadamw.clip_by_global_norm({**{k: jnp.asarray(v) for k, v in g.items()},
                                                  "idx": jnp.arange(4, dtype=jnp.int32)}, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6)
    assert clipped["idx"] is idx and len(clipped) == 3


def test_apply_updates_clips_as_the_reference():
    """A step whose gradients are clipped (norm ≫ ``grad_clip``) against the
    reference's ``apply_updates``."""
    rng = np.random.default_rng(7)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    g = {k: 50 * rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    cfg = dict(lr=1e-2, warmup_steps=1, decay_steps=10)
    jp, _, jm = jadamw.apply_updates(jadamw.AdamWConfig(**cfg), {k: jnp.asarray(v) for k, v in p.items()},
                                     {k: jnp.asarray(v) for k, v in g.items()},
                                     jadamw.init_state({k: jnp.asarray(v) for k, v in p.items()}))
    tp = {k: torch.as_tensor(v.copy()) for k, v in p.items()}
    m = adamw.apply_updates(adamw.AdamWConfig(**cfg), tp, {k: torch.as_tensor(v) for k, v in g.items()},
                            adamw.init_state(tp))
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6) and float(m["grad_norm"]) > 1
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("host,hosts", [(0, 1), (1, 2), (3, 4)])
def test_host_slice_matches_reference(host, hosts):
    cfg = dict(vocab=97, seq_len=12, global_batch=8, seed=3, n_vision_tokens=4, d_model=8)
    mine = pipeline.host_slice(pipeline.DataConfig(**cfg), 5, host, hosts)
    ref = jpipe.host_slice(jpipe.DataConfig(**cfg), 5, host, hosts)
    assert sorted(mine) == sorted(ref) == ["tokens", "vision_embeds"]
    for k in mine:
        assert mine[k].shape[0] == 8 // hosts
        np.testing.assert_array_equal(mine[k], ref[k])
