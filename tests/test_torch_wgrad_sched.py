"""The chain wgrad's host side (K3/K5-wgrad, ``repro_torch.kernels.chain_bwd``),
on the CPU.

The wgrad runs three launches: the forward recompute of factors 1..J-1 on
K1's persistent schedule, the reversed walk of factors J..2 on K2's gather
schedule, and an emission whose items are (column group of output blocks,
slot, chunk of the batch).  These tests build :func:`wgrad_schedule` from a
plan alone and hold its emission decoding (the kernel's own, mirrored by
``WgradSchedule.emit_item``) to: every stored block emitted exactly once
per chunk, every batch row in exactly one chunk, chunks of whole stages in
a fixed order (the chunk is the item's fastest index; chunk c holds rows
``[c·R, (c+1)·R)``); the recompute and the walk are K1's and K2's schedules
of the same tile.  The parity cases run the wrapper's plain version (a CPU
tensor) against the JAX reference's ``chain_bwd_ref`` on the same numpy
arrays; f32 ≤ 1e-5·max|dv|, the reference's own bound (the same f32
products in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.kernels import chain_bwd as jbwd
from repro_torch import bridge
from repro_torch.core.compress import ChainPlan, expand_scales
from repro_torch.kernels.chain import SUPPORTED_BT, TILE_W, chain_schedule
from repro_torch.kernels.chain_bwd import (
    EMIT_ROWS,
    WGRAD_META_COLS,
    _check,
    _wgather_for,
    chain_wgrad,
    dgrad_gather,
    dgrad_schedule,
    wgrad_meta,
    wgrad_schedule,
)
from torch_parity import jax_chain, packed_dict, rel_max_err, to_np

F32_TOL = 1e-5  # relative to max|dv|; reason in the module docstring


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


PHASE2 = [((40, 72, 56, 90, 33, 61, 47)[: j + 1], 16, 3) for j in (1, 2, 3, 6)] + [
    ((200, 300, 260, 330, 150)[: j + 1], 128, 3) for j in (1, 2, 4)
] + [((50, 70, 44, 61, 30, 66, 41), 24, 3), ((230, 310, 190), 100, 2)]
# the gemma-2b up-projection as factorized on the card (F_1 16x6, F_2 16x4,
# F_3 128x4 out blocks x slots, block 128) and the trainer's FAuST unembedding
UP_PROJ = ((2048, 2048, 2048, 16384), 128, (6, 4, 4))
UNEMBED = ((2048, 2048, 256000), 16, 4)


def _assert_covers(plan, batch, bt, rows, ctas):
    sched = wgrad_schedule(plan, batch, bt, rows, ctas)
    R, C = sched.chunk_rows, sched.chunks
    assert sched.group * sched.blkp <= TILE_W and plan.block <= sched.blkp
    assert R % rows == 0 and (C - 1) * R < batch <= C * R  # whole stages, no empty chunk
    # the recompute is K1's schedule without the last factor, the walk K2's
    assert sched.fwd_items == chain_schedule(plan, batch, bt).items[:-1]
    assert sched.walk == dgrad_schedule(plan, batch, bt, None if ctas is None else ctas[1])
    assert sched.walk_items == max(sched.walk.items[1:], default=1)
    seen = np.zeros((plan.n_steps, C), np.int64)
    for j in range(plan.n_factors):
        off, n_out, n_k, n_groups = sched.factors[j]
        assert (off, n_out, n_k, n_groups) == (plan.offsets[j], plan.out_blocks[j], plan.k_blocks[j],
                                               -(-plan.out_blocks[j] // sched.group))
        for i in range(sched.emit_items[j]):
            blocks, k, steps, batch_rows, chunk = sched.emit_item(j, i)
            assert chunk == i % C and batch_rows == range(chunk * R, min(batch, (chunk + 1) * R))
            assert 1 <= len(blocks) <= sched.group and len(steps) == len(blocks)
            for o, s in zip(blocks, steps):
                assert off <= s < plan.offsets[j + 1] and divmod(s - off, n_k) == (o, k)
                seen[s, chunk] += 1
    # each stored block once per chunk; the chunks partition the batch rows
    assert (seen == 1).all()
    cover = np.zeros(batch, np.int64)
    for c in range(C):
        cover[c * R:min(batch, (c + 1) * R)] += 1
    assert (cover == 1).all()
    return sched


@pytest.mark.parametrize("case", range(len(PHASE2)))
def test_emission_covers_chains(case):
    dims, blk, k = PHASE2[case]
    plan = _plan(dims, blk, k)
    for batch, bt in ((1, 16), (37, 16), (37, 64), (130, 32), (4096, 64)):
        for rows in EMIT_ROWS.values():
            for ctas in (None, (132, 264, 396), (1000, 1000, 4000)):
                _assert_covers(plan, batch, bt, rows, ctas)


@pytest.mark.parametrize("bt", SUPPORTED_BT)
def test_emission_covers_up_projection(bt):
    plan = _plan(*UP_PROJ)
    assert (plan.in_blocks, plan.n_steps) == ((16, 16, 16), 672)
    for batch in (128, 4096):
        for rows in EMIT_ROWS.values():
            sched = _assert_covers(plan, batch, bt, rows, (132, 264, 396))
            # block 128: one output block an item, one item a stored block; 672
            # items outnumber the emission's CTAs, so the batch is not cut
            assert sched.group == 1 and sched.emit_items == (96, 64, 512) and sched.chunks == 1
    # the recompute runs F_1 and F_2: 2 batch tiles x 16 column groups at B = 128, bt 64
    assert wgrad_schedule(plan, 128, 64, 32, (132, 264, 396)).fwd_items == (32, 32)


def test_emission_covers_unembedding():
    plan = _plan(*UNEMBED)
    assert plan.n_steps == 64512
    sched = wgrad_schedule(plan, 1024, 64, 64, (264, 264, 264))
    # block 16: 8 output blocks fill one 128-column item, one item per slot
    assert (sched.blkp, sched.group) == (16, 8)
    assert sched.emit_items == (16 * 4, 2000 * 4) and sched.chunks == 1
    assert sched.fwd_items == (16 * 16,) and sched.walk_items == 16 * 16
    _assert_covers(plan, 48, 64, 64, (264, 264, 264))


@pytest.mark.parametrize("blk", [8, 12, 24, 48, 100, 120])
def test_emission_groups_at_odd_blocks(blk):
    plan = _plan((3 * blk + 5, 5 * blk - 3, 4 * blk + 1), blk, 2)
    assert wgrad_schedule(plan, 1, 16, 32).group == TILE_W // (-(-blk // 16) * 16)
    for bt in SUPPORTED_BT:
        _assert_covers(plan, 37, bt, 32, (132, 264, 396))


def test_emission_cuts_a_small_chain_in_chunks():
    """Few items and many CTAs: the batch is cut into up to ⌊ctas / items⌋
    chunks of whole stages, at most one per stage of rows."""
    plan = _plan((40, 72, 56), 16, 3)  # one column group a factor, 3 slots each
    assert sum(wgrad_schedule(plan, 1, 16, 32).emit_items) == 6
    # 396 // 6 = 66 chunks asked: 63 rows each, rounded up to 2 stages of 32
    sched = _assert_covers(plan, 4096, 64, 32, (132, 264, 396))
    assert (sched.chunks, sched.chunk_rows) == (64, 64)
    assert _assert_covers(plan, 33, 64, 32, (132, 264, 396)).chunks == 2  # two stages of 32 rows
    assert _assert_covers(plan, 32, 64, 32, (132, 264, 396)).chunks == 1
    assert _assert_covers(plan, 4096, 64, 32, None).chunks == 1


def test_wgrad_tables_are_built_once_per_state_of_in_idx():
    """``wgrad_meta`` and its transposed walk table are cached by the data
    pointer and version counter of their source; an in-place update of
    ``in_idx`` rebuilds them."""
    plan = _plan((40, 72, 56, 90), 16, 3)
    rng = np.random.default_rng(0)
    parts = [np.sort(np.stack([rng.permutation(plan.in_blocks[j])[:plan.k_blocks[j]]
                               for _ in range(plan.out_blocks[j])]), axis=1).ravel() for j in range(3)]
    idx = torch.as_tensor(np.concatenate(parts).astype(np.int32))
    meta = wgrad_meta(plan, idx)
    s_pre = plan.offsets[-2]
    assert meta.shape == (s_pre + plan.n_steps, WGRAD_META_COLS) and wgrad_meta(plan, idx) is meta
    assert torch.equal(meta[:s_pre, 0], idx[:s_pre]) and torch.equal(meta[s_pre:, 0], idx.flip(0))
    gather = _wgather_for(plan, meta)
    assert _wgather_for(plan, meta) is gather
    for got, want in zip(gather, dgrad_gather(plan, idx)):
        assert torch.equal(got, want)
    idx[:2] = torch.flip(idx[:2], (0,))  # in place: the version counter moves
    assert wgrad_meta(plan, idx) is not meta


def test_check_accepts_scales_per_block_or_per_row():
    plan = _plan((48, 32, 48), 16, 2)
    x, dy = torch.zeros((3, 48)), torch.zeros((3, plan.out_blocks[-1] * 16))
    codes = torch.zeros((plan.n_steps, 16, 16), dtype=torch.int8)
    meta = wgrad_meta(plan, torch.zeros(plan.n_steps, dtype=torch.int32))
    args = (plan.offsets[-2] + plan.n_steps, WGRAD_META_COLS)
    for scales in (torch.ones((plan.n_steps, 16)), torch.ones((plan.n_steps,))):
        _check("chain_wgrad", (x, dy), codes, meta, plan, 64, scales, *args)
    with pytest.raises(ValueError, match="scales"):
        _check("chain_wgrad", (x, dy), codes, meta, plan, 64, torch.ones((plan.n_steps, 8)), *args)


def _jax_packed(dims, blk, seed):
    jpc = jc.pack_chain(jax_chain(dims, blk, 3, seed=seed))
    return jpc, bridge.packed_from_numpy(packed_dict(jpc), device="cpu")


@pytest.mark.parametrize("dims,blk", [((50, 70, 44, 61, 30, 66, 41), 24), ((40, 72, 56, 90, 33), 8),
                                      ((230, 310, 190, 205), 100), ((60, 40), 16)])
def test_wgrad_matches_reference(dims, blk):
    """J from 1 to 6, blocks that are no power of two: the wrapper's plain
    version against ``chain_bwd_ref``'s dvalues on the same arrays."""
    jpc, pc = _jax_packed(dims, blk, blk + len(dims))
    rng = np.random.default_rng(blk)
    x = rng.standard_normal((9, jpc.plan.in_blocks[0] * blk)).astype(np.float32)
    dy = rng.standard_normal((9, jpc.plan.out_blocks[-1] * blk)).astype(np.float32)
    _, jdv = jbwd.chain_bwd_ref(jnp.asarray(x), jpc.values, jpc.in_idx, jnp.asarray(dy), plan=jpc.plan)
    dv = chain_wgrad(torch.as_tensor(x), torch.as_tensor(dy), pc.values, wgrad_meta(pc.plan, pc.in_idx),
                     plan=pc.plan)
    assert dv.shape == pc.values.shape and dv.dtype == torch.float32
    assert rel_max_err(to_np(dv), np.asarray(jdv)) <= F32_TOL


@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_wgrad_matches_reference(qdtype, scheme):
    """K5-wgrad's plain version on the reference's codes and scales (as
    stored, and as rows) against ``chain_bwd_ref`` on the reference's
    dequantized values."""
    jpc, _ = _jax_packed((50, 70, 44, 61), 24, 7)
    jq = jc.quantize_chain(jpc, qdtype, scheme)
    q = bridge.packed_from_numpy(packed_dict(jq), device="cpu")
    deq = jc.dequantize_chain(jq)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, jq.plan.in_blocks[0] * 24)).astype(np.float32)
    dy = rng.standard_normal((6, jq.plan.out_blocks[-1] * 24)).astype(np.float32)
    _, jdv = jbwd.chain_bwd_ref(jnp.asarray(x), deq.values, deq.in_idx, jnp.asarray(dy), plan=deq.plan)
    meta = wgrad_meta(q.plan, q.in_idx)
    for scales in {id(s): s for s in (q.scales, expand_scales(q.scales, 24).contiguous())}.values():
        dv = chain_wgrad(torch.as_tensor(x), torch.as_tensor(dy), q.values, meta, plan=q.plan, scales=scales)
        assert rel_max_err(to_np(dv), np.asarray(jdv)) <= F32_TOL
