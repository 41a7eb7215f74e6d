"""The chain dgrad's host side (K2/K5-dgrad, ``repro_torch.kernels.chain_bwd``)
and the fused apply's per-kernel batch tiles, on the CPU.

The dgrad kernel walks the factors in reverse; within factor j a work item
is (batch tile, group of input blocks, chunk of their reader lists) and
gathers, round by round, the steps the transposed step table lists for its
blocks.  These tests build :func:`dgrad_schedule` and :func:`dgrad_gather`
from a plan and an ``in_idx`` alone and hold them to: the table equals a
numpy reference; the item decoding (the kernel's own, mirrored by
``DgradSchedule.item``) covers every (batch row, input block, chunk) of
every factor exactly once and every step exactly once per batch tile, in
ascending order within each block.  The parity case runs the wrapper's
plain version (a CPU tensor) against the JAX reference's ``chain_bwd_ref``
on the same numpy arrays; f32 ≤ 1e-5·max|dx|, the reference's own bound
(the same f32 products in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.kernels import chain_bwd as jbwd
from repro_torch import bridge
from repro_torch.api import FaustOp
from repro_torch.core.compress import ChainPlan, expand_scales, quantize_chain
from repro_torch.kernels import chain_bwd, ops
from repro_torch.kernels.chain import DGRAD_BT, FORWARD_BT, MAX_FACTORS, SUPPORTED_BT, TILE_W, WGRAD_BT
from repro_torch.kernels.chain_bwd import (
    DGRAD_META_COLS,
    _check,
    _check_device,
    _check_gather,
    _gather_for,
    chain_dgrad,
    dgrad_gather,
    dgrad_meta,
    dgrad_schedule,
)
from torch_parity import jax_chain, packed_dict, rel_max_err, to_np

F32_TOL = 1e-5  # relative to max|dx|; reason in the module docstring


def _plan(dims, blk, k):
    """The ChainPlan ``pack_chain`` gives for ``dims``, block ``blk`` and k
    input blocks per output block (an int, or one per factor)."""
    ib = tuple(-(-d // blk) for d in dims[:-1])
    ob = tuple(-(-d // blk) for d in dims[1:])
    kb = tuple(min(k, i) for i in ib) if isinstance(k, int) else tuple(k)
    offs = [0]
    for o, kk in zip(ob, kb):
        offs.append(offs[-1] + o * kk)
    return ChainPlan(blk, ib, ob, kb, tuple(offs), tuple(dims[:-1]), tuple(dims[1:]))


def _random_idx(plan, seed, mode="random"):
    """An ``in_idx`` of the plan: k distinct sorted input blocks per output
    block ("random"), every slot reading input block 0 ("skew": the fan-in
    PALM supports can have, which random chains never do), or only blocks
    0 and 1 read ("unread": the other input blocks have no reader)."""
    rng = np.random.default_rng(seed)
    parts = []
    for j in range(plan.n_factors):
        ib, ob, k = plan.in_blocks[j], plan.out_blocks[j], plan.k_blocks[j]
        if mode == "skew":
            parts.append(np.zeros(ob * k, np.int32))
        elif mode == "unread":
            parts.append(np.tile(np.arange(k) % min(2, ib), ob).astype(np.int32))
        else:
            parts.append(np.sort(np.stack([rng.permutation(ib)[:k] for _ in range(ob)]), axis=1).ravel())
    return torch.as_tensor(np.concatenate(parts).astype(np.int32))


def _table_ref(plan, idx):
    """The transposed table from ``in_idx`` by numpy: per factor and input
    block, the flat steps that read it, ascending."""
    idx = np.asarray(idx)
    ptr, steps = [0], []
    for j in range(plan.n_factors):
        lo, hi = plan.offsets[j], plan.offsets[j + 1]
        for i in range(plan.in_blocks[j]):
            readers = lo + np.flatnonzero(idx[lo:hi] == i)
            steps.extend(readers.tolist())
            ptr.append(len(steps))
    return np.asarray(ptr, np.int32), np.asarray(steps, np.int32)


PHASE2 = [((40, 72, 56, 90, 33, 61, 47)[: j + 1], 16, 3) for j in (1, 2, 3, 6)] + [
    ((200, 300, 260, 330, 150)[: j + 1], 128, 3) for j in (1, 2, 4)
] + [((50, 70, 44, 61, 30, 66, 41), 24, 3), ((230, 310, 190), 100, 2)]
# the gemma-2b up-projection as factorized on the card (F_1 16x6, F_2 16x4,
# F_3 128x4 out blocks x slots, block 128) and the trainer's FAuST unembedding
UP_PROJ = ((2048, 2048, 2048, 16384), 128, (6, 4, 4))
UNEMBED = ((2048, 2048, 256000), 16, 4)
MODES = ("random", "skew", "unread")


def _assert_covers(plan, idx, batch, bt, ctas):
    ptr, steps = (t.numpy() for t in dgrad_gather(plan, torch.as_tensor(idx)))
    sched = dgrad_schedule(plan, batch, bt, ctas)
    assert sched.group * sched.blkp <= TILE_W and plan.block <= sched.blkp
    for j in range(plan.n_factors):
        base, n_in, n_groups, n_chunks = sched.factors[j]
        assert n_in == plan.in_blocks[j] and n_groups == -(-n_in // sched.group) and n_chunks >= 1
        if ctas is None or sched.n_tiles * n_groups * 2 > ctas:
            assert n_chunks == 1  # only a factor with at most half as many items as CTAs is split
        lo, hi = plan.offsets[j], plan.offsets[j + 1]
        seen_steps = np.zeros((sched.n_tiles, hi - lo), np.int64)
        seen_cells = np.zeros((batch, n_in, n_chunks), np.int64)
        for i in range(sched.items[j]):
            rows, blocks, chunk, rounds = sched.item(j, i, ptr, steps)
            assert rows.start % bt == 0 and len(rows) >= 1 and len(blocks) >= 1 and len(rounds) >= 1
            seen_cells[rows.start:rows.stop, blocks.start:blocks.stop, chunk] += 1
            for g, b in enumerate(blocks):
                got = [r[g] for r in rounds if r[g] >= 0]
                assert got == sorted(got)  # ascending: the fixed order of the sum
                assert all(idx[s] == b and lo <= s < hi for s in got)  # each step reads this block
                seen_steps[rows.start // bt, np.asarray(got, np.int64) - lo] += 1
        # each (row, input block, chunk) flushed once; each step once per batch tile
        assert (seen_cells == 1).all() and (seen_steps == 1).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(PHASE2)))
def test_schedule_covers_chains(case, mode):
    dims, blk, k = PHASE2[case]
    plan = _plan(dims, blk, k)
    idx = _random_idx(plan, case, mode).numpy()
    for batch, bt in ((1, 16), (37, 16), (37, 32), (37, 64), (130, 32)):
        for ctas in (None, 132, 1000):
            _assert_covers(plan, idx, batch, bt, ctas)


@pytest.mark.parametrize("bt", SUPPORTED_BT)
def test_schedule_covers_up_projection(bt):
    plan = _plan(*UP_PROJ)
    assert (plan.in_blocks, plan.n_steps) == ((16, 16, 16), 672)
    idx = _random_idx(plan, 3).numpy()
    for batch, ctas in ((128, 264), (128, 132), (4096, 264)):
        _assert_covers(plan, idx, batch, bt, ctas)
    # block 128: one input block per item; 16 per factor and batch tile
    sched = dgrad_schedule(plan, 128, 64, 264)
    assert sched.group == 1 and [f[2] for f in sched.factors] == [16, 16, 16]
    # B = 128 at bt 64 leaves 32 items a factor for 264 CTAs: every factor is
    # split, the reversed F_3 (32 readers a block) into 8 chunks, up to 2 readers a chunk
    assert [f[3] for f in sched.factors] == [3, 2, 8]
    assert [f[3] for f in dgrad_schedule(plan, 4096, 64, 264).factors] == [1, 1, 1]


def test_schedule_covers_unembedding():
    plan = _plan(*UNEMBED)
    assert plan.n_steps == 64512
    sched = dgrad_schedule(plan, 1024, 64, 264)
    # block 16: 8 input blocks fill one 128-column item; 256 items on 264 CTAs are not split
    assert (sched.blkp, sched.group) == (16, 8)
    assert sched.items == (16 * 16, 16 * 16) and [f[3] for f in sched.factors] == [1, 1]
    idx = _random_idx(plan, 4).numpy()
    _assert_covers(plan, idx, 48, 64, 264)


@pytest.mark.parametrize("blk", [8, 12, 24, 48, 100, 120])
def test_schedule_groups_at_odd_blocks(blk):
    plan = _plan((3 * blk + 5, 5 * blk - 3, 4 * blk + 1), blk, 2)
    assert dgrad_schedule(plan, 1, 16).group == TILE_W // (-(-blk // 16) * 16)
    idx = _random_idx(plan, blk).numpy()
    for bt in SUPPORTED_BT:
        _assert_covers(plan, idx, 37, bt, 132)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(PHASE2)))
def test_gather_table_matches_numpy(case, mode):
    """From the JAX reference's packed chain (``mode="random"``) or a
    skewed / unread ``in_idx`` of its plan."""
    dims, blk, k = PHASE2[case]
    jpc = jc.pack_chain(jax_chain(dims, blk, k, seed=case))
    pc = bridge.packed_from_numpy(packed_dict(jpc), device="cpu")
    idx = pc.in_idx if mode == "random" else _random_idx(pc.plan, case, mode)
    ptr, steps = dgrad_gather(pc.plan, idx)
    want_ptr, want_steps = _table_ref(pc.plan, idx)
    assert ptr.dtype == steps.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(steps.numpy(), want_steps)
    _check_gather(pc.plan, ptr, steps)


def test_tables_are_built_once_per_state_of_in_idx():
    """``dgrad_meta`` and the transposed table are cached by the data pointer
    and version counter of their source: a training step finds them built,
    and an in-place update of ``in_idx`` rebuilds them."""
    plan = _plan((40, 72, 56), 16, 3)
    idx = _random_idx(plan, 0)
    meta = dgrad_meta(plan, idx)
    assert dgrad_meta(plan, idx) is meta
    gather = _gather_for(plan, meta)
    assert _gather_for(plan, meta) is gather
    np.testing.assert_array_equal(gather[1].numpy(), _table_ref(plan, idx)[1])
    idx[:3] = torch.as_tensor(_random_idx(plan, 1)[:3])  # in place: the version counter moves
    meta2 = dgrad_meta(plan, idx)
    assert meta2 is not meta and torch.equal(meta2[:, 0], idx.flip(0))
    np.testing.assert_array_equal(_gather_for(plan, meta2)[1].numpy(), _table_ref(plan, idx)[1])


def _check_inputs(dtype=torch.float32, qdtype=None):
    plan = _plan((48, 32, 48), 16, 2)
    dy = torch.zeros((3, plan.out_blocks[-1] * 16), dtype=dtype)
    values = torch.zeros((plan.n_steps, 16, 16), dtype=dtype if qdtype is None else qdtype)
    meta = dgrad_meta(plan, _random_idx(plan, 0))
    scales = None if qdtype is None else torch.ones((plan.n_steps, 16))
    return dy, values, meta, plan, scales


def test_check_accepts_the_kernel_inputs():
    for dtype in (torch.float32, torch.bfloat16):
        for qdtype in (None, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
            for bt in SUPPORTED_BT:
                dy, values, meta, plan, scales = _check_inputs(dtype, qdtype)
                _check("chain_dgrad", (dy,), values, meta, plan, bt, scales, plan.n_steps, DGRAD_META_COLS)


def test_check_refuses():
    dy, values, meta, plan, scales = _check_inputs()
    args = (plan.n_steps, DGRAD_META_COLS)
    with pytest.raises(ValueError, match="bt"):
        _check("chain_dgrad", (dy,), values, meta, plan, 8, scales, *args)
    with pytest.raises(TypeError):  # f16 cotangents
        _check("chain_dgrad", (dy.half(),), values.half(), meta, plan, 16, scales, *args)
    with pytest.raises(TypeError):  # values in another dtype than dy
        _check("chain_dgrad", (dy,), values.bfloat16(), meta, plan, 16, scales, *args)
    with pytest.raises(ValueError, match="meta"):  # the wrong table, or a non-int32 one
        _check("chain_dgrad", (dy,), values, meta[:, :4].contiguous(), plan, 16, scales, *args)
    with pytest.raises(ValueError, match="meta"):
        _check("chain_dgrad", (dy,), values, meta.long(), plan, 16, scales, *args)
    ptr, steps = _gather_for(plan, meta)
    with pytest.raises(ValueError, match="transposed table"):
        _check_gather(plan, ptr[:-1], steps)
    with pytest.raises(ValueError, match="transposed table"):
        _check_gather(plan, ptr, steps.long())
    deep = _plan((16,) * (MAX_FACTORS + 2), 16, 1)
    with pytest.raises(ValueError, match="factors"):
        _check_gather(deep, *dgrad_gather(deep, torch.zeros(deep.n_steps, dtype=torch.int32)))
    dy, values, meta, plan, scales = _check_inputs(qdtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        _check("chain_dgrad", (dy,), values, meta, plan, 16, scales[:, :8].contiguous(), *args)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes CUDA tensors only
        _check_device("chain_dgrad", (dy, values, meta, scales))


def _jax_packed(dims, blk, seed):
    jpc = jc.pack_chain(jax_chain(dims, blk, 3, seed=seed))
    return jpc, bridge.packed_from_numpy(packed_dict(jpc), device="cpu")


@pytest.mark.parametrize("dims,blk", [((50, 70, 44, 61, 30, 66, 41), 24), ((40, 72, 56, 90, 33, 61, 47), 8),
                                      ((230, 310, 190, 205), 100)])
def test_dgrad_matches_reference(dims, blk):
    """J up to 6, blocks that are no power of two: the wrapper's plain
    version against ``chain_bwd_ref`` on the same arrays."""
    jpc, pc = _jax_packed(dims, blk, blk)
    rng = np.random.default_rng(blk)
    x = rng.standard_normal((9, jpc.plan.in_blocks[0] * blk)).astype(np.float32)
    dy = rng.standard_normal((9, jpc.plan.out_blocks[-1] * blk)).astype(np.float32)
    jdx, _ = jbwd.chain_bwd_ref(jnp.asarray(x), jpc.values, jpc.in_idx, jnp.asarray(dy), plan=jpc.plan)
    dx = chain_dgrad(torch.as_tensor(dy), pc.values, dgrad_meta(pc.plan, pc.in_idx), plan=pc.plan)
    assert dx.shape == x.shape and dx.dtype == torch.float32
    assert rel_max_err(to_np(dx), np.asarray(jdx)) <= F32_TOL


@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_dgrad_matches_reference(qdtype, scheme):
    """K5-dgrad's plain version on the reference's codes and scales (the same
    bits through the bridge) against ``chain_bwd_ref`` on the reference's
    dequantized values."""
    jpc, _ = _jax_packed((50, 70, 44, 61), 24, 7)
    jq = jc.quantize_chain(jpc, qdtype, scheme)
    q = bridge.packed_from_numpy(packed_dict(jq), device="cpu")
    deq = jc.dequantize_chain(jq)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, jq.plan.in_blocks[0] * 24)).astype(np.float32)
    dy = rng.standard_normal((6, jq.plan.out_blocks[-1] * 24)).astype(np.float32)
    jdx, _ = jbwd.chain_bwd_ref(jnp.asarray(x), deq.values, deq.in_idx, jnp.asarray(dy), plan=deq.plan)
    dx = chain_dgrad(torch.as_tensor(dy), q.values, dgrad_meta(q.plan, q.in_idx), plan=q.plan,
                     scales=expand_scales(q.scales, 24).contiguous())
    assert rel_max_err(to_np(dx), np.asarray(jdx)) <= F32_TOL


def _record_tiles(monkeypatch):
    """Wrap the fused apply's kernel wrappers to record the tile each gets."""
    seen = []
    for name in ("chain_matmul", "chain_dgrad", "chain_wgrad"):
        real = getattr(ops, name)

        def wrapped(*a, _real=real, _name=name, **k):
            seen.append((_name, k["bt"]))
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, wrapped)
    return seen


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_apply_runs_each_kernel_at_its_tile(monkeypatch, quantized):
    """Without a tile named, K1/K4 run at FORWARD_BT, K2/K5-dgrad at DGRAD_BT
    and K3/K5-wgrad at WGRAD_BT; a caller's tile steers the forward only."""
    _, pc = _jax_packed((40, 72, 56), 16, 3)
    if quantized:
        pc = quantize_chain(pc, "int8", "per_row")
    seen = _record_tiles(monkeypatch)
    leaf = "scales" if quantized else "values"
    t = getattr(pc, leaf).clone().requires_grad_(True)
    chain = dataclasses.replace(pc, **{leaf: t})
    x = torch.randn((5, 40), requires_grad=True)
    ops.packed_chain_apply(x, chain).sum().backward()
    assert seen == [("chain_matmul", FORWARD_BT), ("chain_dgrad", DGRAD_BT), ("chain_wgrad", WGRAD_BT)]
    seen.clear()
    ops.packed_chain_apply(x, chain, bt=32).sum().backward()
    assert seen == [("chain_matmul", 32), ("chain_dgrad", DGRAD_BT), ("chain_wgrad", WGRAD_BT)]
    assert x.grad is not None and t.grad is not None


def test_operator_apply_reports_the_forward_tile(monkeypatch):
    """Through FaustOp.apply without a measured table: the report's tile is
    the one K1 runs at."""
    _, pc = _jax_packed((40, 72, 56), 16, 3)
    op = FaustOp.from_packed(pc, device="cpu")
    seen = _record_tiles(monkeypatch)
    op.apply(torch.randn((5, 40)), "fused", device="cpu")
    assert seen == [("chain_matmul", FORWARD_BT)] and op.dispatch_for(5).bt == FORWARD_BT
