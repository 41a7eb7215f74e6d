"""The fused chain kernel's host-side schedule and checks (K1/K4,
``repro_torch.kernels.chain``), on the CPU.

The kernel walks the chain factor by factor; within factor j a work item
is (batch tile, column group of consecutive output blocks).  These tests
build :func:`chain_schedule` from a :class:`ChainPlan` alone and hold its
item decoding (the kernel's own, mirrored by ``ChainSchedule.item``) to
covering every step exactly once per batch tile and every output column of
every factor exactly once per batch row.  The parity case runs the chains
the card checks (J up to 6, a block that is no power of two) through the
wrapper's plain version and the JAX reference on the same numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core.compress import ChainPlan
from repro_torch.kernels import ops
from repro_torch.kernels.chain import (
    MAX_BLOCK,
    META_COLS,
    MMA_K,
    SUPPORTED_BT,
    TILE_W,
    _check,
    _check_device,
    _factor_table,
    _vec,
    chain_matmul,
    chain_schedule,
)
from torch_parity import jax_chain, packed_dict, rel_max_err, to_np


def _plan(dims, blk, k):
    """The ChainPlan ``pack_chain`` gives for ``dims``, block ``blk`` and k
    input blocks per output block (fewer where a factor has fewer)."""
    ib = tuple(-(-d // blk) for d in dims[:-1])
    ob = tuple(-(-d // blk) for d in dims[1:])
    kb = tuple(min(k, i) for i in ib) if isinstance(k, int) else tuple(k)
    offs = [0]
    for o, kk in zip(ob, kb):
        offs.append(offs[-1] + o * kk)
    return ChainPlan(blk, ib, ob, kb, tuple(offs), tuple(dims[:-1]), tuple(dims[1:]))


PHASE2 = [((40, 72, 56, 90, 33)[: j + 1], 16, 3) for j in (1, 2, 3, 4)] + [
    ((200, 300, 260, 330, 150)[: j + 1], 128, 3) for j in (1, 2, 3, 4)
]
# the gemma-2b up-projection as factorized on the card (F_1 16x6, F_2 16x4,
# F_3 128x4 out blocks x slots, block 128) and the trainer's FAuST unembedding
UP_PROJ = ((2048, 2048, 2048, 16384), 128, (6, 4, 4))
UNEMBED = ((2048, 2048, 256000), 16, 4)


def _assert_covers(plan, batch, bt):
    sched = chain_schedule(plan, batch, bt)
    assert sched.blkp % MMA_K == 0 and plan.block <= sched.blkp < plan.block + MMA_K
    assert sched.group >= 1 and sched.group * sched.blkp <= TILE_W
    assert [f[0] for f in sched.factors] == list(plan.offsets[:-1])
    tile_rows = [sched.item(0, t)[0] for t in range(sched.n_tiles)]
    assert [r for rows in tile_rows for r in rows] == list(range(batch))  # tiles partition the batch
    for j in range(plan.n_factors):
        lo, hi = plan.offsets[j], plan.offsets[j + 1]
        seen_steps = np.zeros((sched.n_tiles, hi - lo), dtype=np.int64)
        seen_blocks = np.zeros((sched.n_tiles, plan.out_blocks[j]), dtype=np.int64)
        for i in range(sched.items[j]):
            rows, blocks, slots = sched.item(j, i)
            tile = rows.start // bt
            assert rows == tile_rows[tile] and len(blocks) >= 1
            assert len(slots) == plan.k_blocks[j] and all(len(s) == len(blocks) for s in slots)
            seen_blocks[tile, blocks.start:blocks.stop] += 1
            for steps in slots:
                seen_steps[tile, np.asarray(steps) - lo] += 1
        # each step once per batch tile, each output block (so each of its
        # blk columns, and every column of the factor) once per batch row
        assert (seen_steps == 1).all() and (seen_blocks == 1).all()


@pytest.mark.parametrize("bt", SUPPORTED_BT)
@pytest.mark.parametrize("case", range(len(PHASE2)))
def test_schedule_covers_phase2_chains(case, bt):
    dims, blk, k = PHASE2[case]
    for batch in (1, 37, 130):
        _assert_covers(_plan(dims, blk, k), batch, bt)


@pytest.mark.parametrize("bt", SUPPORTED_BT)
def test_schedule_covers_up_projection(bt):
    plan = _plan(*UP_PROJ)
    assert (plan.out_blocks, plan.k_blocks, plan.n_steps) == ((16, 16, 128), (6, 4, 4), 672)
    for batch in (128, 4096):
        _assert_covers(plan, batch, bt)
    # items per factor at B = 128: 16 output blocks x 128/bt tiles, then 128 x 128/bt
    assert chain_schedule(plan, 128, bt).items == tuple(o * 128 // bt for o in plan.out_blocks)


def test_schedule_covers_unembedding():
    plan = _plan(*UNEMBED)
    assert plan.n_steps == 64512
    sched = chain_schedule(plan, 1024, 64)
    # block 16: 8 output blocks fill one 128-column item
    assert (sched.blkp, sched.group) == (16, 8)
    assert sched.items == (16 * 16, 2000 * 16)
    _assert_covers(plan, 1024, 64)
    for bt in SUPPORTED_BT:
        _assert_covers(plan, 48, bt)


@pytest.mark.parametrize("blk", [8, 12, 24, 48, 100, 120])
def test_schedule_groups_at_odd_blocks(blk):
    """Blocks that do not divide 128, or are no multiple of the MMA depth:
    the padded group still fits the 128-column tile and covers every column."""
    plan = _plan((3 * blk + 5, 5 * blk - 3, 4 * blk + 1), blk, 2)
    assert chain_schedule(plan, 1, 16).group == TILE_W // (-(-blk // MMA_K) * MMA_K)
    for bt in SUPPORTED_BT:
        _assert_covers(plan, 37, bt)


def test_factor_table_is_the_plans():
    plan = _plan(*UP_PROJ)
    assert _factor_table(plan) == ((0, 16, 6, 16), (96, 16, 4, 16), (160, 128, 4, 128))
    plan = _plan(*UNEMBED)
    assert _factor_table(plan) == ((0, 128, 4, 16), (512, 16000, 4, 2000))


def _inputs(blk, dtype, qdtype=None, n_factors=2):
    plan = _plan((3 * blk, 2 * blk, 3 * blk)[: n_factors + 1], blk, 2)
    x = torch.zeros((3, plan.in_blocks[0] * blk), dtype=dtype)
    vdtype = dtype if qdtype is None else qdtype
    values = torch.zeros((plan.n_steps, blk, blk), dtype=vdtype)
    meta = torch.zeros((plan.n_steps, META_COLS), dtype=torch.int32)
    scales = None if qdtype is None else torch.ones((plan.n_steps, blk), dtype=torch.float32)
    return x, values, meta, plan, scales


@pytest.mark.parametrize("bt", SUPPORTED_BT)
def test_check_accepts_every_block_and_tile(bt):
    for blk in range(1, MAX_BLOCK + 1):
        for dtype in (torch.float32, torch.bfloat16):
            for qdtype in (None, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
                x, values, meta, plan, scales = _inputs(blk, dtype, qdtype)
                _check(x, values, meta, plan, bt, scales)


def test_check_refuses():
    x, values, meta, plan, scales = _inputs(16, torch.float32)
    with pytest.raises(ValueError, match="bt"):
        _check(x, values, meta, plan, 8, scales)
    x, values, meta, plan, scales = _inputs(MAX_BLOCK + 1, torch.float32)
    with pytest.raises(ValueError, match="block"):
        _check(x, values, meta, plan, 16, scales)
    x, values, meta, plan, scales = _inputs(16, torch.float32, torch.int8)
    with pytest.raises(TypeError):
        _check(x.to(torch.float16), values, meta, plan, 16, scales)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel takes CUDA tensors only
        _check_device(x, values, meta, scales)


@pytest.mark.parametrize(
    "blk,dtype,qdtype,want",
    [
        (16, torch.float32, None, 1),
        (100, torch.float32, None, 1),  # 400-byte rows
        (100, torch.bfloat16, None, 0),  # 200-byte rows: L2 loads
        (8, torch.bfloat16, None, 1),
        (12, torch.bfloat16, None, 0),
        (100, torch.float32, torch.int8, 1),  # codes as flat 10,000-byte runs
        (6, torch.float32, torch.int8, 0),  # 36-byte code runs
    ],
)
def test_vec_flag(blk, dtype, qdtype, want):
    x, values, _, _, scales = _inputs(blk, dtype, qdtype)
    ws = torch.zeros((2, 3, 2 * blk), dtype=dtype)
    assert _vec(blk, (x, values, ws), scales) == want


def test_vec_flag_misaligned_view():
    x = torch.zeros(3 * 32 + 1)[1:].reshape(3, 32)  # one float past a 16-byte boundary
    assert x.data_ptr() % 16 == 4
    assert _vec(16, (x, torch.zeros((2, 16, 16)), torch.zeros(0)), None) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims,blk", [((50, 70, 44, 61, 30, 66, 41), 24), ((40, 72, 56, 90, 33, 61, 47), 8)])
def test_six_factor_chain_matches_reference(dims, blk, dtype):
    """J = 6 (each ping-pong buffer reused across factors) at a block that
    is no multiple of the MMA depth: the wrapper's plain version on CPU
    tensors against the JAX step oracle on the same arrays."""
    jpc = jc.pack_chain(jax_chain(dims, blk, 3, seed=blk))
    pc = bridge.packed_from_numpy(packed_dict(jpc), device="cpu")
    x = np.random.default_rng(blk).standard_normal((9, jpc.plan.in_blocks[0] * blk)).astype(np.float32)
    tdt = getattr(torch, dtype)
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    y = chain_matmul(torch.as_tensor(x).to(tdt), pc.values.to(tdt), meta, plan=pc.plan)
    want = np.asarray(jref.packed_chain_ref(jnp.asarray(x), jpc.values, jpc.in_idx, jpc.plan))
    # f32: the same products in another order; bf16: rounding between factors
    assert rel_max_err(to_np(y), want) <= (1e-5 if dtype == "float32" else 3e-2)
