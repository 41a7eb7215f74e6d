"""The port's measured dispatch (``repro_torch.api.autotune``): key
spelling and mode parsing held against the JAX reference, the table file,
table hits steering ``apply("auto")`` and its batch tile, and measurement
on the CPU (where the backends run their plain versions).

Every test points the table at its own ``tmp_path`` file, so no run reads
a table another run left behind.
"""
import json

import pytest
import torch

from repro.api import autotune as jautotune
from repro.core import compress as jc
from repro_torch import bridge
from repro_torch.api import FaustOp, autotune, last_report
from repro_torch.core.compress import quantize_chain
from repro_torch.kernels import ops
from repro_torch.kernels.chain import FORWARD_BT
from torch_parity import jax_chain, packed_dict

CPU = "cpu"
DIMS = (40, 72, 56, 90)


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", path)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)  # read-only mode
    autotune.reload()
    yield path
    autotune.reload()


@pytest.fixture(scope="module")
def op():
    jpc = jc.pack_chain(jax_chain(DIMS, 16, 3, seed=6))
    return FaustOp.from_packed(bridge.packed_from_numpy(packed_dict(jpc), device=CPU), device=CPU)


@pytest.mark.parametrize(
    "kw",
    [
        dict(shape=(2048, 16384), n_factors=3, s_tot=11_010_048, batch=128, dtype="float32",
             grad=False, mesh_shape=None, device="cpu"),
        dict(shape=(2048, 16384), n_factors=3, s_tot=11_010_048, batch=4000, dtype="bfloat16",
             grad=False, mesh_shape=None, device="NVIDIA H100 80GB HBM3", vq="int8:per_block"),
        dict(shape=(40, 90), n_factors=3, s_tot=5376, batch=7, dtype="float32", grad=True,
             mesh_shape=(("data", 2), ("model", 2)), device="cpu", vq="fp8_e5m2:per_row"),
        dict(shape=(256, 256), n_factors=1, s_tot=4096, batch=1, dtype="float32", grad=False,
             mesh_shape=None, device="cpu", vq=None),
    ],
)
def test_key_of_matches_reference(kw):
    assert autotune.key_of(**kw) == jautotune.key_of(**kw)


def test_bucket_batch_matches_reference():
    for b in (*range(0, 300), 4095, 4096, 4097, 1 << 20):
        assert autotune.bucket_batch(b) == jautotune.bucket_batch(b)


@pytest.mark.parametrize("value", [None, "", "0", "off", "no", "1", "on", "measure", "yes", "Off", "bogus"])
def test_mode_parsing_matches_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_AUTOTUNE", value)
    assert autotune.autotune_mode() == jautotune.autotune_mode()


def test_table_round_trips_and_degrades_to_none(table):
    assert autotune.load_table() is None and autotune.lookup("k") is None
    entry = {"best": "bsr", "us": {"bsr": 1.5, "dense": 3.0}}
    autotune.record("k", entry)
    autotune.record("k2", {"best": "dense", "us": {"dense": 2.0}})
    assert autotune.lookup("k") == entry and autotune.lookup("missing") is None
    assert set(json.loads(open(table).read())["entries"]) == {"k", "k2"}
    with open(table, "w") as f:
        f.write("{not json")
    assert autotune.reload() is None and autotune.lookup("k") is None
    with open(table, "w") as f:
        json.dump({"version": autotune.TABLE_VERSION + 1, "entries": {"k": entry}}, f)
    assert autotune.reload() is None


def _write(op, batch, entry, dtype=torch.float32):
    autotune.record(autotune.key_for_op(op, batch=batch, dtype=dtype), entry)


def test_table_hit_steers_auto_and_its_tile(table, op, monkeypatch):
    x = torch.zeros((5, DIMS[0]))
    model = op.dispatch_for(5)
    # without a table the report names the tile K1/K4 run at, FORWARD_BT
    assert model.source == "model" and model.backend == "fused" and model.bt == FORWARD_BT == 64
    _write(op, 5, {"best": "dense", "us": {"dense": 10.0, "bsr": 20.0, "fused": 30.0}, "bt": 32})
    op.apply(x, device=CPU)
    rep = last_report()
    assert (rep.backend, rep.source, rep.bt) == ("dense", "measured", 32)
    assert rep.est_us == {"dense": 10.0, "bsr": 20.0, "fused": 30.0}
    # a fused winner runs at the table's tile, unless the caller forces one
    # (the table's tile differs from FORWARD_BT, so the first apply shows it was read)
    _write(op, 5, {"best": "fused", "us": {"dense": 10.0, "bsr": 20.0, "fused": 5.0}, "bt": 16})
    seen = []
    real = ops.packed_chain_apply
    monkeypatch.setattr(ops, "packed_chain_apply", lambda *a, **k: seen.append(k["bt"]) or real(*a, **k))
    op.apply(x, device=CPU)
    op.apply(x, device=CPU, bt=32)
    assert seen == [16, 32] and last_report().bt == 32
    # another batch bucket misses: back to the model
    assert op.dispatch_for(100).source == "model"
    # off never reads the table
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    assert op.dispatch_for(5) == model


def test_hit_is_restricted_to_feasible_backends(table, op):
    _write(op, 3, {"best": "fused", "us": {"fused": 1.0, "bsr": 5.0, "dense": 9.0}})
    # the adjoint has no fused kernel, and its own key
    key_t = autotune.key_for_op(op.T, batch=3, dtype=torch.float32)
    autotune.record(key_t, {"best": "fused", "us": {"fused": 1.0, "bsr": 5.0, "dense": 9.0}})
    rep = op.T.dispatch_for(3)
    assert rep.source == "measured" and rep.backend == "bsr" and "fused" not in rep.est_us


def test_quantized_and_f32_keys_never_share_timings(table, op):
    q = FaustOp.from_packed(quantize_chain(op.rep, "int8", "per_block"), device=CPU)
    kf = autotune.key_for_op(op, batch=8, dtype=torch.float32)
    kq = autotune.key_for_op(q, batch=8, dtype=torch.float32)
    assert kq == kf + "|vq:int8:per_block"
    _write(op, 8, {"best": "dense", "us": {"dense": 1.0, "bsr": 2.0, "fused": 3.0}})
    assert op.dispatch_for(8).source == "measured" and q.dispatch_for(8).source == "model"


def test_measure_times_every_feasible_backend(table, op):
    x = torch.randn((6, DIMS[0]), generator=torch.Generator().manual_seed(0))
    entry = autotune.measure(op, x, use_kernel=False)
    assert set(entry["us"]) == set(op.feasible_backends()) and entry["best"] in entry["us"]
    assert all(v > 0 for v in entry["us"].values())
    assert "bt" not in entry  # the tile sweep runs only with the kernels
    # apply(autotune=True) measures once, records, and the same apply hits
    y = op.apply(x, device=CPU, autotune=True)
    rep = last_report()
    assert rep.source == "measured" and rep.backend == min(rep.est_us, key=rep.est_us.get)
    stamp = autotune._stamp()
    op.apply(x, device=CPU, autotune=True)
    assert autotune._stamp() == stamp  # no second measurement
    assert torch.allclose(y, x @ op.todense(), rtol=1e-4, atol=1e-5)


def test_measure_mode_measures_on_auto(table, op, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    op.apply(torch.ones((2, DIMS[0])), device=CPU)
    assert last_report().source == "measured"
    op.apply(torch.ones((2, DIMS[0])), "bsr", device=CPU)  # a forced apply neither measures nor reads
    assert last_report().source == "model"


def test_measure_lets_a_failing_backend_raise(table, op, monkeypatch):
    real = FaustOp._run_backend

    def broken(self, x, backend, use_kernel, bt):
        if backend == "bsr":
            raise RuntimeError("bsr kernel launch failed")
        return real(self, x, backend, use_kernel, bt)

    monkeypatch.setattr(FaustOp, "_run_backend", broken)
    with pytest.raises(RuntimeError, match="bsr kernel launch failed"):
        autotune.measure(op, torch.ones((2, DIMS[0])), use_kernel=False)
    with pytest.raises(RuntimeError, match="bsr kernel launch failed"):
        op.apply(torch.ones((2, DIMS[0])), device=CPU, autotune=True)
    assert autotune.load_table() is None  # nothing recorded
    assert not autotune._MEASURING


def test_decisions_are_reused_until_their_inputs_change(table, op, monkeypatch):
    from repro_torch.api import dispatch
    from repro_torch.launch import roofline

    first = op.dispatch_for(11)
    assert op.dispatch_for(11) is first and first.source == "model"
    assert op.dispatch_for(12) is not first and op.T.dispatch_for(11) is not first
    with pytest.raises(TypeError):
        first.est_us["fused"] = 0.0  # shared reports are read only
    _write(op, 11, {"best": "bsr", "us": {"dense": 3.0, "bsr": 1.0, "fused": 2.0}})
    hit = op.dispatch_for(11)
    assert hit.source == "measured" and hit.backend == "bsr"
    consts, src = roofline.roofline_constants()
    monkeypatch.setattr(roofline, "roofline_constants",
                        lambda: ({**consts, "t_launch_us": 1e6}, src))
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    slow = op.dispatch_for(11)
    assert slow.source == "model" and slow.est_us["fused"] > 1e6 > first.est_us["fused"]
    assert len(dispatch._MEMO) <= dispatch._MEMO_MAX
