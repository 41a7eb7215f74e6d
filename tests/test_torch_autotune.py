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


# ---------------------------------------------------------------------------
# Signature prefix, invalidation, grad keys and a failing backend
# ---------------------------------------------------------------------------


def test_op_key_prefix_matches_reference(op):
    from repro.api import FaustOp as JOp
    from repro.api import hstack as jhstack
    from repro_torch.api import hstack

    jpc = jc.pack_chain(jax_chain(DIMS, 16, 3, seed=6))
    jop = JOp.from_packed(jpc)
    assert autotune.op_key_prefix(op) == jautotune.op_key_prefix(jop) == f"40x90|J3|s{op.s_tot}|"
    assert autotune.op_key_prefix(op.T) == jautotune.op_key_prefix(jop.T)
    assert autotune.op_key_prefix(hstack([op, op])) == jautotune.op_key_prefix(jhstack([jop, jop]))
    assert autotune.key_for_op(op, batch=8, dtype=torch.float32).startswith(autotune.op_key_prefix(op))


def test_invalidate_removes_the_same_keys_as_the_reference(table, tmp_path, monkeypatch, op):
    prefix = autotune.op_key_prefix(op)
    entry = {"best": "bsr", "us": {"bsr": 1.0}}
    keys = [autotune.key_for_op(op, batch=b, dtype=torch.float32, grad=g) for b in (1, 8, 300) for g in (False, True)]
    keys += ["40x90|J2|s5376|b8|float32|fwd|mesh:-|cpu", "40x900|J3|s5376|b8|float32|fwd|mesh:-|cpu"]
    content = {"version": autotune.TABLE_VERSION, "entries": {k: entry for k in keys}}
    jpath = str(tmp_path / "reference.json")
    for path in (table, jpath):
        with open(path, "w") as f:
            json.dump(content, f)
    monkeypatch.setenv("REPRO_AUTOTUNE_TABLE", jpath)
    jautotune.reload()
    autotune.reload()
    assert autotune.invalidate(prefix) == jautotune.invalidate(prefix) == 6
    assert set(autotune.reload()["entries"]) == set(jautotune.reload()["entries"]) == set(keys[6:])
    assert autotune.invalidate(prefix) == 0
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(tmp_path / "missing.json"))
    autotune.reload()
    assert autotune.invalidate(prefix) == 0


@pytest.mark.parametrize("form", ["packed", "quantized", "block", "faust"])
def test_measure_under_grad_times_every_feasible_backend(table, op, form):
    """``grad=True`` times forward + backward wrt x and the operator's
    trained tensors, for every feasible backend, and leaves the operator's
    own tensors as they were."""
    leaf = {"packed": op, "quantized": FaustOp(quantize_chain(op.rep, "int8", "per_block")),
            "block": op.to("block"), "faust": op.to("faust")}[form]
    x = torch.randn((6, DIMS[0]), generator=torch.Generator().manual_seed(1))
    entry = autotune.measure(leaf, x, grad=True, use_kernel=False)
    assert set(entry["us"]) == set(leaf.feasible_backends()) and entry["ctx"]["grad"] is True
    assert all(v > 0 for v in entry["us"].values())
    assert not any(t.requires_grad for t in leaf._tensors()) and not x.requires_grad
    trained = [t for t in autotune._trainable(leaf)._tensors() if t.requires_grad]
    want = {"packed": 1, "quantized": 1, "block": 3, "faust": 3}[form]
    assert len(trained) == want and all(t.is_floating_point() for t in trained)


def test_autotuned_apply_under_grad_measures_a_grad_key(table, op):
    """``apply(autotune=True)`` in a training apply measures its ``grad``
    key, and ``auto`` then follows the measured table under grad."""
    x = torch.randn((6, DIMS[0]), generator=torch.Generator().manual_seed(2), requires_grad=True)
    y = op.apply(x, device=CPU, autotune=True)
    rep = last_report()
    key = autotune.key_for_op(op, batch=6, dtype=torch.float32, grad=True)
    assert key.split("|")[5] == "grad" and autotune.lookup(key) is not None
    assert autotune.lookup(autotune.key_for_op(op, batch=6, dtype=torch.float32)) is None
    assert rep.grad and rep.source == "measured" and rep.backend == min(rep.est_us, key=rep.est_us.get)
    y.sum().backward()
    assert torch.allclose(x.grad, op.todense().sum(1).expand(6, -1), rtol=1e-4, atol=1e-5)


def _break(monkeypatch, failing: str, calls: list):
    real = FaustOp._run_backend

    def broken(self, x, backend, use_kernel, bt):
        calls.append(backend)
        if backend == failing:
            raise RuntimeError(f"{failing} kernel launch failed")
        return real(self, x, backend, use_kernel, bt)

    monkeypatch.setattr(FaustOp, "_run_backend", broken)


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("failing", ["fused", "bsr"])
def test_auto_apply_raises_by_default(table, op, monkeypatch, env, failing):
    """No fallback hides a kernel that fails: an ``auto`` apply whose
    backend raises re-raises, whatever ``REPRO_DEGRADED`` says (the port
    has no degraded ladder, where the reference demotes), and the next
    ``auto`` apply runs the same backend again."""
    if env is None:
        monkeypatch.delenv("REPRO_DEGRADED", raising=False)
    else:
        monkeypatch.setenv("REPRO_DEGRADED", env)
    us = {"dense": 3.0, "bsr": 2.0, "fused": 1.0} if failing == "fused" else {"dense": 3.0, "bsr": 1.0, "fused": 2.0}
    _write(op, 8, {"best": failing, "us": us})
    calls: list = []
    _break(monkeypatch, failing, calls)
    x = torch.ones((8, DIMS[0]))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=f"{failing} kernel launch failed"):
            op.apply(x, device=CPU)
    assert calls == [failing, failing] and last_report().backend == failing
    assert last_report().source == "measured"


@pytest.mark.parametrize("gain,want", [(0.03, 64), (0.10, 16)])
def test_tile_sweep_keeps_the_default_tile_within_the_margin(table, op, monkeypatch, gain, want):
    """The fused sweep takes another tile only where it beats the default
    (``FORWARD_BT``) by more than ``TILE_MARGIN``; every candidate of every
    backend is timed in one interleaved call."""
    from repro_torch.kernels.chain import FORWARD_BT, SUPPORTED_BT

    seen = []

    def fake(fns, device):
        seen.append(sorted(fns))
        return {c: (100.0 * (1 - gain) if c == ("fused", 16) else 100.0) + {"dense": 50, "bsr": 20}.get(c[0], 0)
                for c in fns}

    monkeypatch.setattr(autotune, "_timeit_us", fake)
    entry = autotune.measure(op, torch.ones((8, DIMS[0])), use_kernel=True)
    assert FORWARD_BT == 64 and autotune.TILE_MARGIN == 0.05
    assert len(seen) == 1 and {c for c in seen[0] if c[0] == "fused"} == {("fused", t) for t in SUPPORTED_BT}
    assert entry["bt"] == want and entry["best"] == "fused"
    assert entry["us"]["fused"] == pytest.approx(100.0 * (1 - gain) if want == 16 else 100.0)


class _SteppedOp:
    """A stand-in leaf whose fused apply at tile ``bt`` advances a fake
    clock by ``COST[bt]`` ms, times ``SLOW`` inside contention stretches:
    calls 16-35 of every 30 after the 6 warm-up calls (in the old scheme,
    the runs of tiles 32 and 64 in every round)."""

    COST = {16: 1.10, 32: 1.03, 64: 1.00}
    SLOW = 1.5

    def __init__(self):
        self.calls, self.now = 0, 0.0

    def feasible_backends(self):
        return ["fused"]

    def clock(self):
        return self.now

    def apply(self, x, backend, *, bt, **kw):
        i = self.calls
        self.calls += 1
        slow = i >= 6 and (i - 6) % 30 >= 10
        self.now += self.COST[bt] * (self.SLOW if slow else 1.0) * 1e-3
        return x


def test_tile_sweep_keeps_the_default_tile_under_host_contention(table, monkeypatch):
    """Host contention in stretches of consecutive calls: the least of a
    few runs of back-to-back calls saw the default tile only inside the
    stretches and picked tile 16, 10 % slower; medians of single calls
    alternating across the tiles see every tile slowed alike and keep 64."""
    fake = _SteppedOp()
    monkeypatch.setattr(autotune.time, "perf_counter", fake.clock)
    entry = autotune.measure(fake, torch.ones((8, 4)), use_kernel=True)
    assert entry["bt"] == FORWARD_BT == 64
    assert entry["bt_us"]["16"] > entry["bt_us"]["64"]
    assert fake.calls <= 3 * (autotune.N_WARMUP + autotune.MAX_ROUNDS)


def test_tile_sweep_stops_at_its_time_budget(table, monkeypatch):
    """A key whose calls take 10 ms runs about ``ROUND_BUDGET_S`` of rounds,
    not ``MAX_ROUNDS``; none runs fewer than ``MIN_ROUNDS``."""
    fake = _SteppedOp()
    fake.COST = {16: 10.0, 32: 10.0, 64: 10.0}
    monkeypatch.setattr(autotune.time, "perf_counter", fake.clock)
    autotune.measure(fake, torch.ones((8, 4)), use_kernel=True)
    rounds = fake.calls // 3 - autotune.N_WARMUP
    assert autotune.MIN_ROUNDS <= rounds <= autotune.ROUND_BUDGET_S / (3 * 10e-3) + 2
    fake = _SteppedOp()
    fake.COST = {16: 1e3, 32: 1e3, 64: 1e3}
    monkeypatch.setattr(autotune.time, "perf_counter", fake.clock)
    autotune.measure(fake, torch.ones((8, 4)), use_kernel=True)
    assert fake.calls // 3 - autotune.N_WARMUP == autotune.MIN_ROUNDS
