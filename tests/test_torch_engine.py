"""The port's scheduler (``repro_torch.runtime.engine``) and fault
injection (``repro_torch.runtime.faults``) side by side with the
reference's, both driven by ``tests/engine_sim.py`` (``SimExecutor``,
``FakeClock``: numpy only, shared with the reference's tests).

Every scenario is one function of a namespace of classes (``Engine``,
``SlotAllocator``, ``FaultInjector``, ``FaultSpec``, ``InjectedFault``
and the state names) and runs once on the reference's and once on the
port's: the scripted traces of ``test_engine_sim.py``, the seeded sweeps
of ``test_engine_sched.py`` and the supervision traces of
``test_engine_faults.py``.  Each run checks the property its reference
test pins (every surviving stream equal to its closed-form oracle, ...)
and returns a summary — outputs, terminal states, every ``EngineStats``
field, the sim's call log and the injector's fire log — and the two
summaries must be equal.  The reference's degraded-dispatch tests have
no counterpart: the port has no demotion ladder.
"""
import dataclasses
import types

import numpy as np
import pytest

from engine_sim import FakeClock, SimExecutor, reference_stream
from repro.runtime import engine as jengine
from repro.runtime import faults as jfaults
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import faults as tfaults


def _ns(eng, flt):
    return types.SimpleNamespace(
        Engine=eng.Engine, SlotAllocator=eng.SlotAllocator, DONE=eng.DONE, FAILED=eng.FAILED,
        REJECTED=eng.REJECTED, TIMED_OUT=eng.TIMED_OUT, FaultInjector=flt.FaultInjector,
        FaultSpec=flt.FaultSpec, InjectedFault=flt.InjectedFault,
    )


SIDES = {"reference": _ns(jengine, jfaults), "port": _ns(tengine, tfaults)}


def _prompt(rng, n, vocab=97):
    return rng.integers(0, vocab, size=n).astype(np.int32)


def _stats(stats) -> dict:
    d = dataclasses.asdict(stats)
    for k in ("faust_dispatch", "dispatch_per_step", "mesh_axes"):
        d.pop(k, None)
    return d


def _summary(engine, sim, rids, inj=None, **extra) -> dict:
    out = {}
    for rid in rids:
        req = engine.done.get(rid)
        out[rid] = (engine.status(rid), None if req is None else req.error,
                    None if req is None or req.state != "done" else engine.result(rid).tolist())
    return {"requests": out, "stats": _stats(engine.stats), "calls": list(sim.calls),
            "fired": None if inj is None else list(inj.fired_log), **extra}


def _oracle(engine, sim, rids, prompts, budgets, skip=()):
    for rid, p, n in zip(rids, prompts, budgets):
        if rid not in skip:
            np.testing.assert_array_equal(engine.result(rid), reference_stream(p, n, sim.mix, sim.vocab))


def _sim_engine(ns, n_slots=3, max_len=64, tick=0.001, seed=0, faults=None, **kw):
    clock = FakeClock(tick=tick)
    sim = SimExecutor(n_slots=n_slots, max_len=max_len, seed=seed)
    ex = sim if faults is None else ns.FaultInjector(sim, faults=faults, clock=clock)
    if faults is not None:
        kw.setdefault("backoff_s", 0.01)
    return ns.Engine(ex, clock=clock, **kw), sim, ex, clock


# ---------------------------------------------------------------------------
# Scripted traces (tests/test_engine_sim.py)
# ---------------------------------------------------------------------------


def sim_staggered_arrivals(ns):
    engine, sim, _, clock = _sim_engine(ns, n_slots=3)
    rng = np.random.default_rng(1)
    prompts, budgets = [_prompt(rng, n) for n in (5, 3, 7)], [6, 4, 3]
    rids = [engine.submit(prompts[0], budgets[0])]
    engine.step()
    engine.step()
    clock.advance(0.5)
    rids.append(engine.submit(prompts[1], budgets[1]))
    engine.step()
    clock.advance(0.5)
    rids.append(engine.submit(prompts[2], budgets[2]))
    engine.run()
    _oracle(engine, sim, rids, prompts, budgets)
    assert set(engine.stats.occupancy) >= {2, 3}
    first = [engine.done[r].first_token_t for r in rids]
    assert first[0] < first[1] < first[2]
    return _summary(engine, sim, rids, first=first)


def sim_early_finish(ns):
    engine, sim, _, _ = _sim_engine(ns, n_slots=2)
    rng = np.random.default_rng(2)
    prompts, budgets = [_prompt(rng, 4), _prompt(rng, 6)], [2, 9]
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    order = []
    while engine.n_pending:
        order.extend(engine.step())
    _oracle(engine, sim, rids, prompts, budgets)
    assert order == rids and engine.allocator.n_free == 2
    return _summary(engine, sim, rids, order=order)


def sim_slot_reuse(ns):
    engine, sim, _, _ = _sim_engine(ns, n_slots=2)
    rng = np.random.default_rng(3)
    prompts, budgets = [_prompt(rng, n) for n in (4, 5, 3, 6, 2)], [3, 5, 2, 4, 6]
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    engine.run()
    _oracle(engine, sim, rids, prompts, budgets)
    assert engine.stats.admitted == 5 and engine.stats.completed == 5
    return _summary(engine, sim, rids)


def sim_eviction_readmission(ns):
    engine, sim, _, _ = _sim_engine(ns, n_slots=2)
    rng = np.random.default_rng(4)
    prompts, budgets = [_prompt(rng, 5), _prompt(rng, 4), _prompt(rng, 3)], [8, 6, 2]
    r0, r1 = engine.submit(prompts[0], budgets[0]), engine.submit(prompts[1], budgets[1])
    engine.step()
    engine.step()
    engine.evict(r0)
    r2 = engine.submit(prompts[2], budgets[2])
    engine.step()
    assert engine.running[r0].slot is not None
    engine.run()
    _oracle(engine, sim, [r0, r1, r2], prompts, budgets)
    assert engine.stats.evicted == 1 and engine.done[r0].n_evictions == 1
    return _summary(engine, sim, [r0, r1, r2])


def sim_determinism(ns):
    engine, sim, _, clock = _sim_engine(ns, n_slots=2, tick=0.01)
    rng = np.random.default_rng(5)
    prompts = [_prompt(rng, n) for n in (4, 6, 3)]
    rids = [engine.submit(prompts[0], 5)]
    engine.step()
    clock.advance(1.0)
    rids.append(engine.submit(prompts[1], 3))
    engine.step()
    rids.append(engine.submit(prompts[2], 4))
    engine.evict(rids[0])
    engine.run()
    return _summary(engine, sim, rids, now=clock.now)


def sim_stats_accounting(ns):
    engine, sim, _, _ = _sim_engine(ns, n_slots=2, tick=0.5)
    rng = np.random.default_rng(6)
    rids = [engine.submit(_prompt(rng, 4), 3), engine.submit(_prompt(rng, 5), 1)]
    engine.run()
    s = engine.stats
    assert s.tokens_decoded == 4 and sum(s.occupancy.values()) == s.steps
    assert s.decode_s > 0 and s.prefill_s > 0 and s.tokens_per_s > 0 and s.tpot_s[rids[1]] == 0.0
    return _summary(engine, sim, rids, tokens_per_s=s.tokens_per_s)


# ---------------------------------------------------------------------------
# Allocator and seeded sweeps (tests/test_engine_sched.py)
# ---------------------------------------------------------------------------


def alloc_lowest_free(ns):
    a = ns.SlotAllocator(4)
    got = [a.alloc(f"r{i}") for i in range(4)]
    a.free(2)
    a.free(0)
    got += [a.alloc("r4"), a.alloc("r5")]
    assert got == [0, 1, 2, 3, 0, 2] and a.n_free == 0
    with pytest.raises(RuntimeError):
        a.alloc("r6")
    a.free(1)
    with pytest.raises(ValueError):
        a.free(1)
    with pytest.raises(ValueError):
        ns.SlotAllocator(0)
    return {"got": got, "owner": [a.owner_of(s) for s in range(4)]}


def alloc_random_interleaving(ns):
    rng = np.random.default_rng(0)
    log = []
    for trial in range(20):
        n = int(rng.integers(1, 8))
        a = ns.SlotAllocator(n)
        live: dict[int, str] = {}
        for i in range(200):
            if live and (a.n_free == 0 or rng.random() < 0.5):
                slot = int(rng.choice(list(live)))
                del live[slot]
                a.free(slot)
            else:
                slot = a.alloc(f"t{trial}_r{i}")
                assert slot not in live and 0 <= slot < n
                live[slot] = f"t{trial}_r{i}"
            assert a.n_free == n - len(live)
            log.append(slot)
    return {"log": log}


def _random_trace(rng, n_req, vocab=97):
    prompts = [rng.integers(0, vocab, size=int(rng.integers(1, 9))).astype(np.int32) for _ in range(n_req)]
    budgets = [int(rng.integers(1, 7)) for _ in range(n_req)]
    gaps = [int(rng.integers(0, 4)) for _ in range(n_req)]
    return prompts, budgets, gaps


def _drive(engine, clock, prompts, budgets, gaps, rng=None, evict_p=0.0):
    rids = []

    def maybe_evict():
        if rng is not None and engine.running and rng.random() < evict_p:
            engine.evict(str(rng.choice(list(engine.running))))

    for p, b, g in zip(prompts, budgets, gaps):
        clock.advance(0.1)
        rids.append(engine.submit(p, b))
        for _ in range(g):
            if engine.n_pending:
                engine.step()
            maybe_evict()
    guard = 0
    while engine.n_pending:
        engine.step()
        maybe_evict()
        guard += 1
        assert guard < 10_000, "scheduler failed to drain"
    return rids


def _sweep(ns, seed, rng_seed, slots, max_len, n_req, evict_p):
    rng = np.random.default_rng(rng_seed)
    n_slots = int(rng.integers(*slots))
    clock = FakeClock(tick=0.001)
    sim = SimExecutor(n_slots=n_slots, max_len=max_len, seed=seed)
    engine = ns.Engine(sim, clock=clock)
    prompts, budgets, gaps = _random_trace(rng, n_req=n_req(rng))
    rids = _drive(engine, clock, prompts, budgets, gaps, rng=rng if evict_p else None, evict_p=evict_p)
    assert engine.stats.completed == len(rids) and engine.allocator.n_free == n_slots
    _oracle(engine, sim, rids, prompts, budgets)
    live: set[int] = set()
    for op, s in sim.calls:  # no freed slot is ever decoded
        if op == "prefill":
            live.add(s[0])
        elif op == "free":
            live.discard(s[0])
        else:
            assert set(s) <= live and len(set(s)) == len(s)
    if evict_p:
        assert sum(1 for op, _ in sim.calls if op == "prefill") == len(rids) + engine.stats.evicted
    return _summary(engine, sim, rids)


def sweep_complete(ns, seed):
    return _sweep(ns, seed, seed, (1, 5), 32, lambda r: int(r.integers(2, 10)), 0.0)


def sweep_evictions(ns, seed):
    return _sweep(ns, seed, 100 + seed, (1, 4), 48, lambda r: int(r.integers(3, 8)), 0.3)


def sweep_no_freed_slot(ns, seed):
    return _sweep(ns, seed, 200 + seed, (2, 5), 32, lambda r: 6, 0.2)


def eviction_readmission_explicit(ns):
    engine, sim, _, _ = _sim_engine(ns, n_slots=1, max_len=32, tick=0.01, seed=9)
    rng = np.random.default_rng(9)
    p0, p1 = _prompt(rng, 5), _prompt(rng, 3)
    r0 = engine.submit(p0, 6)
    engine.step()
    engine.step()
    engine.evict(r0)
    r1 = engine.submit(p1, 2)
    engine.run()
    _oracle(engine, sim, [r0, r1], [p0, p1], [6, 2])
    assert [s[0] for op, s in sim.calls if op == "prefill"] == [0, 0, 0]
    return _summary(engine, sim, [r0, r1])


# ---------------------------------------------------------------------------
# Supervision (tests/test_engine_faults.py)
# ---------------------------------------------------------------------------


def zero_fault_byte_identical(ns):
    """An empty injector is transparent: outputs, stats and the call log
    equal a run without one."""
    rng = np.random.default_rng(0)
    prompts, budgets = [_prompt(rng, n) for n in (5, 3, 7, 4)], [6, 4, 3, 5]
    runs = []
    for wrap in (False, True):
        engine, sim, inj, _ = _sim_engine(ns, n_slots=2, faults=() if wrap else None)
        rids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
        engine.run()
        runs.append(_summary(engine, sim, rids))
    assert runs[0] == runs[1]
    return runs[1]


def _faulted(ns, faults, prompts_spec, budgets, seed, n_slots=3, rid_first=None, **kw):
    engine, sim, inj, clock = _sim_engine(ns, n_slots=n_slots, faults=faults, **kw)
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, n) for n in prompts_spec]
    rids = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        rids.append(engine.submit(p, n, rid=rid_first if i == 0 and rid_first else None))
    engine.run()
    return engine, sim, inj, clock, rids, prompts


def transient_decode_error(ns):
    engine, sim, inj, _, rids, prompts = _faulted(
        ns, [ns.FaultSpec("step_error", step=3, op="decode", count=1)], (5, 3, 7), [8, 6, 5], 1)
    assert engine.stats.retries == 3 and engine.stats.failed == 0
    _oracle(engine, sim, rids, prompts, [8, 6, 5])
    return _summary(engine, sim, rids, inj)


def transient_prefill_error(ns):
    engine, sim, inj, _, rids, prompts = _faulted(
        ns, [ns.FaultSpec("step_error", step=1, op="prefill", count=1)], (4, 6, 3), [5, 4, 6], 2, n_slots=2)
    assert engine.stats.retries == 1
    _oracle(engine, sim, rids, prompts, [5, 4, 6])
    return _summary(engine, sim, rids, inj)


def persistent_failure(ns):
    engine, sim, inj, _, rids, prompts = _faulted(
        ns, [ns.FaultSpec("step_error", op="prefill", rid="bad", count=None)], (5, 4, 6), [6, 5, 4], 3,
        n_slots=2, rid_first="bad", retry_budget=2)
    assert engine.status("bad") == ns.FAILED and engine.stats.failed == 1 and engine.stats.retries == 2
    with pytest.raises(RuntimeError, match="retry budget"):
        engine.result("bad")
    _oracle(engine, sim, rids, prompts, [6, 5, 4], skip=("bad",))
    return _summary(engine, sim, rids, inj)


def retry_backoff(ns):
    engine, sim, inj, clock = _sim_engine(
        ns, n_slots=1, tick=0.0, faults=[ns.FaultSpec("step_error", step=0, op="prefill", count=1)], backoff_s=5.0)
    p = _prompt(np.random.default_rng(4), 4)
    rid = engine.submit(p, 3)
    t_fail = clock.now
    engine.run(max_steps=10)
    assert engine.done[rid].not_before >= t_fail + 5.0 and clock.now >= 5.0
    _oracle(engine, sim, [rid], [p], [3])
    return _summary(engine, sim, [rid], inj, now=clock.now)


def nan_quarantine(ns):
    engine, sim, inj, _, rids, prompts = _faulted(
        ns, [ns.FaultSpec("nan_logits", step=2, op="decode", rid="sick")], (5, 3, 7), [8, 8, 8], 5,
        rid_first="sick")
    assert engine.status("sick") == ns.FAILED and engine.stats.quarantined == 1
    _oracle(engine, sim, rids, prompts, [8, 8, 8], skip=("sick",))
    return _summary(engine, sim, rids, inj)


def nan_guard_off(ns):
    engine, sim, inj, _, rids, _ = _faulted(
        ns, [ns.FaultSpec("nan_logits", step=1, op="decode", rid="sick")], (5,), [4], 6, n_slots=2,
        rid_first="sick", nan_guard=False)
    assert engine.done["sick"].state == ns.DONE and engine.stats.quarantined == 0
    return _summary(engine, sim, rids, inj)


def deadline_expiry(ns):
    engine, sim, inj, _ = _sim_engine(
        ns, n_slots=1, faults=[ns.FaultSpec("slow_step", step=1, op="decode", delay_s=10.0)])
    rng = np.random.default_rng(7)
    p_slow, p_next = _prompt(rng, 5), _prompt(rng, 4)
    slow = engine.submit(p_slow, 20, ttl=1.0)
    nxt = engine.submit(p_next, 3)
    engine.run(max_steps=40)
    assert engine.status(slow) == ns.TIMED_OUT and engine.stats.timed_out == 1 and engine.n_pending == 0
    _oracle(engine, sim, [nxt], [p_next], [3])
    return _summary(engine, sim, [slow, nxt], inj)


def queued_past_deadline(ns):
    engine, sim, inj, clock = _sim_engine(ns, n_slots=1, faults=())
    rng = np.random.default_rng(8)
    long_r = engine.submit(_prompt(rng, 4), 30)
    stale = engine.submit(_prompt(rng, 3), 3, ttl=0.005)
    engine.step()
    clock.advance(1.0)
    engine.run(max_steps=60)
    assert engine.status(stale) == ns.TIMED_OUT and "shed" in engine.done[stale].error
    return _summary(engine, sim, [long_r, stale], inj)


def max_queue(ns):
    engine, sim, inj, _ = _sim_engine(ns, n_slots=1, faults=(), max_queue=2)
    rng = np.random.default_rng(9)
    rids = [engine.submit(_prompt(rng, 4), 5) for _ in range(3)]
    assert engine.status(rids[2]) == ns.REJECTED and engine.stats.rejected == 1
    with pytest.raises(RuntimeError, match="max_queue"):
        engine.result(rids[2])
    engine.run()
    return _summary(engine, sim, rids, inj)


def eviction_cap(ns):
    engine, sim, inj, _ = _sim_engine(ns, n_slots=1, faults=(), max_evictions=3)
    p, n = _prompt(np.random.default_rng(10), 4), 12
    rid = engine.submit(p, n)
    refused = 0
    for _ in range(60):
        engine.step()
        if rid in engine.running and not engine.evict(rid):
            refused += 1
        if engine.n_pending == 0:
            break
    assert engine.done[rid].n_evictions == 3 and refused > 0 and engine.stats.evicted == 3
    _oracle(engine, sim, [rid], [p], [n])
    return _summary(engine, sim, [rid], inj, refused=refused)


def requeue_age_ordered(ns):
    engine, sim, inj, clock = _sim_engine(ns, n_slots=2, faults=())
    rng = np.random.default_rng(11)
    prompts = [_prompt(rng, 4) for _ in range(3)]
    r0 = engine.submit(prompts[0], 8)
    clock.advance(0.1)
    r1 = engine.submit(prompts[1], 8)
    engine.step()
    clock.advance(0.1)
    r2 = engine.submit(prompts[2], 8)
    assert engine.evict(r1) and engine.evict(r0)
    order = [r.rid for r in engine.queue]
    assert order == [r0, r1, r2]
    engine.run()
    _oracle(engine, sim, [r0, r1, r2], prompts, [8, 8, 8])
    return _summary(engine, sim, [r0, r1, r2], inj, order=order)


def faultspec_hygiene(ns):
    with pytest.raises(ValueError, match="kind"):
        ns.FaultSpec("explode")
    with pytest.raises(ValueError, match="op"):
        ns.FaultSpec("step_error", op="sample")
    f = ns.FaultSpec("step_error", count=2)
    before = f.exhausted()
    f.fired = 2
    assert not before and f.exhausted() and not ns.FaultSpec("step_error", count=None, fired=99).exhausted()
    spec = [ns.FaultSpec("step_error", step=0, op="prefill", count=1)]
    inj_a = ns.FaultInjector(SimExecutor(2, 16), faults=spec)
    inj_b = ns.FaultInjector(SimExecutor(2, 16), faults=spec)
    inj_a.on_admit("r0", 0)
    with pytest.raises(ns.InjectedFault):
        inj_a.prefill_forward(0, np.asarray([1, 2], np.int32), {})
    assert inj_b.faults[0].fired == 0 and spec[0].fired == 0
    return {"fired_a": list(inj_a.fired_log), "owners": dict(inj_a.owners), "n_slots": inj_a.n_slots}


SCENARIOS = {f.__name__: f for f in (
    sim_staggered_arrivals, sim_early_finish, sim_slot_reuse, sim_eviction_readmission, sim_determinism,
    sim_stats_accounting, alloc_lowest_free, alloc_random_interleaving, eviction_readmission_explicit,
    zero_fault_byte_identical, transient_decode_error, transient_prefill_error, persistent_failure,
    retry_backoff, nan_quarantine, nan_guard_off, deadline_expiry, queued_past_deadline, max_queue,
    eviction_cap, requeue_age_ordered, faultspec_hygiene,
)}
SWEEPS = {"complete": (sweep_complete, 8), "evictions": (sweep_evictions, 8), "no_freed_slot": (sweep_no_freed_slot, 4)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    want = SCENARIOS[name](SIDES["reference"])
    got = SCENARIOS[name](SIDES["port"])
    assert got == want


@pytest.mark.parametrize("sweep,seed", [(k, s) for k, (_, n) in SWEEPS.items() for s in range(n)])
def test_sweep_matches_reference(sweep, seed):
    fn = SWEEPS[sweep][0]
    assert fn(SIDES["port"], seed) == fn(SIDES["reference"], seed)


def test_port_engine_stats_fields():
    """The port's ``EngineStats`` has the reference's fields (the mesh
    record too, since the port serves on a mesh), and ``demotions`` stays
    0 whatever the executor reports."""
    port = {f.name for f in dataclasses.fields(tengine.EngineStats)}
    ref = {f.name for f in dataclasses.fields(jengine.EngineStats)}
    assert port == ref
    sim = SimExecutor(n_slots=1, max_len=16)
    sim.faust_dispatch = types.SimpleNamespace(backend="bsr", demoted_from="fused")
    engine = tengine.Engine(sim, clock=FakeClock(tick=0.001))
    engine.submit(np.asarray([1, 2, 3], np.int32), 4)
    engine.run()
    assert engine.stats.demotions == 0 and engine.stats.faust_dispatch is sim.faust_dispatch
