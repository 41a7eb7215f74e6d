"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides in its body whether a card is present
(never at import: every xdist worker must collect the same tests) and
skips without one.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: f32 ≤ 1e-5 of max|y| (FFMA in another summation order); bf16
≤ 3e-2 of max|y| (activations round to bf16 between factors on both
sides, and a one-ulp difference propagates).  The quantized kernel (K4)
dequantizes f32 activations with the plain version's f32 product; with
bf16 activations it rounds x·scale to bf16 once more per term, which the
bf16 bound covers.
The backward kernels (K2, K3, K5) keep f32 inside as their plain versions
do, so bf16 differs only by the rounding of the inputs and of dx.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.api import FactorizeSpec, FaustOp, autotune, factorize, last_report
from repro_torch.core.compress import (
    BlockFaust,
    expand_scales,
    pack_chain,
    quantize_chain,
    random_block_factor,
)
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
from repro_torch.kernels.chain import (
    SUPPORTED_BT,
    chain_matmul,
    chain_matmul_plain,
    chain_matmul_q_plain,
)
from repro_torch.kernels.chain_bwd import (
    chain_dgrad,
    chain_dgrad_plain,
    chain_wgrad,
    chain_wgrad_plain,
    dgrad_meta,
    wgrad_meta,
)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}  # relative to max|y|; reasons in the module docstring


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _rel(y, ref):
    return float((y.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_factors,blk,bt", [(1, 16, 32), (3, 128, 16), (4, 128, 64), (2, 16, 32)])
def test_chain_kernel_matches_plain(dev, dtype, n_factors, blk, bt):
    dims = (200, 300, 260, 330, 150)[: n_factors + 1]
    g = torch.Generator().manual_seed(n_factors)
    bf = BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, 3, generator=g, device=dev)
        for j in range(n_factors)
    ), torch.ones((), device=dev))
    pc = pack_chain(bf).to(dtype=dtype)
    x = torch.randn((45, pc.plan.in_blocks[0] * blk), generator=g).to(dev, dtype)
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    before = chain_matmul.launches
    y = chain_matmul(x, pc.values, meta, plan=pc.plan, bt=bt)
    torch.cuda.synchronize()
    assert chain_matmul.launches == before + 1
    assert _rel(y, chain_matmul_plain(x, pc.values, meta, plan=pc.plan)) <= TOL[dtype]


# (block, J): blocks 8 to 128, one no power of two (24) and one no multiple
# of the MMA depth 16 (100); J up to 6, so each ping-pong buffer of the
# workspace is written again after the grid barrier of a later factor
GRID = [(8, 6), (16, 5), (24, 6), (64, 4), (100, 3), (128, 6)]


def _grid_chain(dev, blk, n_factors, batch, seed):
    base = (40, 72, 56, 90, 33, 61, 47) if blk <= 24 else (200, 300, 260, 330, 150, 210, 190)
    dims = base[: n_factors + 1]
    g = torch.Generator().manual_seed(seed)
    bf = BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, 3, generator=g, device=dev)
        for j in range(n_factors)
    ), torch.ones((), device=dev))
    pc = pack_chain(bf)
    x = torch.randn((batch, dims[0]), generator=g)
    x = torch.nn.functional.pad(x, (0, pc.plan.in_blocks[0] * blk - dims[0]))
    return pc, x.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 37, 4096])
@pytest.mark.parametrize("blk,n_factors", GRID)
def test_chain_kernel_grid_matches_plain(dev, blk, n_factors, batch, dtype):
    """K1 on the persistent schedule: every tile, batches below, at and far
    above one tile, ragged features."""
    pc, x = _grid_chain(dev, blk, n_factors, batch, blk + n_factors)
    values, x = pc.values.to(dtype), x.to(dtype)
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    ref = chain_matmul_plain(x, values, meta, plan=pc.plan)
    for bt in SUPPORTED_BT:
        before = chain_matmul.launches
        y = chain_matmul(x, values, meta, plan=pc.plan, bt=bt)
        torch.cuda.synchronize()
        assert chain_matmul.launches == before + 1 and y.dtype == dtype
        assert _rel(y, ref) <= TOL[dtype]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_chain_kernel_grid_matches_plain(dev, qdtype, scheme, xdtype):
    """K4 on the same grid of blocks, depths and batches (bf16 x folds the
    row scale into the staged activation: one more bf16 rounding a term)."""
    for blk, n_factors in GRID:
        for batch in (1, 37, 4096):
            pc, x = _grid_chain(dev, blk, n_factors, batch, 50 + blk + n_factors)
            q = quantize_chain(pc, qdtype, scheme)
            scales = expand_scales(q.scales, blk).contiguous()
            x = x.to(xdtype)
            meta = ops.chain_meta(q.plan, q.in_idx)
            ref = chain_matmul_q_plain(x, q.values, scales, meta, plan=q.plan)
            for bt in SUPPORTED_BT if batch == 37 else (16,):
                before = chain_matmul.q_launches
                y = chain_matmul(x, q.values, meta, plan=q.plan, bt=bt, scales=scales)
                torch.cuda.synchronize()
                assert chain_matmul.q_launches == before + 1 and y.dtype == xdtype
                assert _rel(y, ref) <= TOL[xdtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o,k,bk,bn,n_in,batch", [(6, 3, 64, 128, 9, 37), (3, 2, 32, 160, 5, 130)])
def test_bsr_kernel_matches_plain(dev, dtype, o, k, bk, bn, n_in, batch):
    g = torch.Generator().manual_seed(o)
    idx = torch.stack([torch.randperm(n_in, generator=g)[:k] for _ in range(o)])
    idx = torch.sort(idx, 1).values.to(torch.int32).to(dev)
    values = (torch.randn((o, k, bk, bn), generator=g) / math.sqrt(k * bk)).to(dev, dtype)
    x = torch.randn((batch, n_in * bk), generator=g).to(dev, dtype)
    before = bsr_matmul.launches
    y = bsr_matmul(x, values, idx)
    torch.cuda.synchronize()
    assert bsr_matmul.launches == before + 1
    assert _rel(y, bsr_matmul_plain(x, values, idx)) <= TOL[dtype]


def test_operator_backends_run_the_kernels(dev):
    w = torch.randn((256, 512), generator=torch.Generator().manual_seed(0))
    op, _ = factorize(w, FactorizeSpec(n_factors=3, block=64, k_first=2, k_mid=2), device=dev)
    x = torch.randn((70, 256), device=dev)
    dense = x @ op.todense()
    for backend, counter in (("fused", chain_matmul), ("bsr", bsr_matmul)):
        before = counter.launches
        y = op.apply(x, backend)
        torch.cuda.synchronize()
        assert counter.launches > before
        assert _rel(y, op.apply(x, backend, use_kernel=False)) <= 1e-5  # f32 FFMA vs plain: summation order
        assert _rel(y, dense) <= 1e-4  # x @ todense() associates the chain differently


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_chain_kernel_matches_plain(dev, qdtype, scheme, xdtype):
    n_factors = 1 + ["int8", "fp8_e4m3", "fp8_e5m2"].index(qdtype) + (scheme == "per_row")
    blk = 16 if n_factors % 2 else 128
    dims = (200, 300, 260, 330, 150)[: n_factors + 1]
    g = torch.Generator().manual_seed(10 + n_factors)
    bf = BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, 3, generator=g, device=dev)
        for j in range(n_factors)
    ), torch.ones((), device=dev))
    q = quantize_chain(pack_chain(bf), qdtype, scheme)
    scales = expand_scales(q.scales, blk).contiguous()
    x = torch.randn((45, q.plan.in_blocks[0] * blk), generator=g).to(dev, xdtype)
    meta = ops.chain_meta(q.plan, q.in_idx)
    ref = chain_matmul_q_plain(x, q.values, scales, meta, plan=q.plan)
    for bt in SUPPORTED_BT:
        before = chain_matmul.q_launches
        y = chain_matmul(x, q.values, meta, plan=q.plan, bt=bt, scales=scales)
        torch.cuda.synchronize()
        assert chain_matmul.q_launches == before + 1 and y.dtype == xdtype
        assert _rel(y, ref) <= TOL[xdtype]


def test_quantized_operator_runs_k4(dev):
    w = torch.randn((256, 512), generator=torch.Generator().manual_seed(2))
    op, _ = factorize(w, FactorizeSpec(n_factors=3, block=64, k_first=2, k_mid=2), device=dev)
    q = FaustOp.from_packed(quantize_chain(op.to("packed").rep, "int8"))
    x = torch.randn((70, 256), device=dev)
    before = chain_matmul.q_launches
    y = q.apply(x, "fused")
    torch.cuda.synchronize()
    assert chain_matmul.q_launches == before + 1
    assert _rel(y, q.apply(x, "fused", use_kernel=False)) <= 1e-5  # f32 FFMA vs plain: summation order
    assert _rel(y, x @ q.todense()) <= 1e-4  # x @ todense() associates the chain differently
    assert _rel(q.apply(x, "bsr"), y) <= 1e-4  # bsr runs K6 on the dequantized f32 factors


def test_measured_dispatch_on_card(dev, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)  # read-only: the table steers auto
    autotune.reload()
    w = torch.randn((256, 512), generator=torch.Generator().manual_seed(3))
    op, _ = factorize(w, FactorizeSpec(n_factors=3, block=64, k_first=2, k_mid=2), device=dev)
    x = torch.randn((40, 256), device=dev)
    op.apply(x, autotune=True)
    rep = last_report()
    entry = autotune.lookup(autotune.key_for_op(op, batch=40, dtype=torch.float32))
    assert rep.source == "measured" and entry["ctx"]["device"] == torch.cuda.get_device_name(dev)
    assert set(entry["us"]) == {"dense", "bsr", "fused"}
    assert rep.backend == min(entry["us"], key=entry["us"].get)
    assert entry["bt"] in SUPPORTED_BT and set(entry["bt_us"]) == {str(t) for t in SUPPORTED_BT}
    assert rep.bt == entry["bt"]
    autotune.reload()


def test_fused_kernel_trains(dev):
    """The fused path trains: its backward launches K2 and K3 and gives the
    bsr kernel path's input gradient."""
    w = torch.randn((128, 128), generator=torch.Generator().manual_seed(1))
    op, _ = factorize(w, FactorizeSpec(n_factors=2, block=64, k_first=1, k_mid=1), device=dev)
    grads = {}
    for backend in ("fused", "bsr"):
        x = torch.randn((4, 128), generator=torch.Generator().manual_seed(2)).to(dev).requires_grad_(True)
        before = (chain_dgrad.launches, chain_wgrad.launches)
        op.apply(x, backend).sum().backward()
        torch.cuda.synchronize()
        if backend == "fused":  # x requires grad, the values do not: dgrad only
            assert (chain_dgrad.launches, chain_wgrad.launches) == (before[0] + 1, before[1])
        assert torch.isfinite(x.grad).all()
        grads[backend] = x.grad
    assert _rel(grads["fused"], grads["bsr"]) <= 1e-5  # f32 FFMA: summation order


def _bwd_chain(dev, n_factors, blk, seed):
    dims = (200, 300, 260, 330, 150)[: n_factors + 1] if blk == 128 else (40, 72, 56, 90, 33)[: n_factors + 1]
    g = torch.Generator().manual_seed(seed)
    bf = BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, 3, generator=g, device=dev)
        for j in range(n_factors)
    ), torch.ones((), device=dev))
    pc = pack_chain(bf)
    x = torch.randn((45, pc.plan.in_blocks[0] * blk), generator=g).to(dev)
    dy = torch.randn((45, pc.plan.out_blocks[-1] * blk), generator=g).to(dev)
    return pc, x, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_factors,blk,bt", [(1, 16, 32), (3, 128, 16), (4, 128, 64), (2, 16, 32)])
def test_chain_backward_kernels_match_plain(dev, dtype, n_factors, blk, bt):
    """K2 (dx) and K3 (dvalues, f32) against their plain versions."""
    pc, x, dy = _bwd_chain(dev, n_factors, blk, 20 + n_factors)
    values, x, dy = pc.values.to(dtype), x.to(dtype), dy.to(dtype)
    dm, wm = dgrad_meta(pc.plan, pc.in_idx), wgrad_meta(pc.plan, pc.in_idx)
    before = (chain_dgrad.launches, chain_wgrad.launches)
    dx = chain_dgrad(dy, values, dm, plan=pc.plan, bt=bt)
    dv = chain_wgrad(x, dy, values, wm, plan=pc.plan, bt=bt)
    torch.cuda.synchronize()
    assert (chain_dgrad.launches, chain_wgrad.launches) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dtype and dv.dtype == torch.float32
    assert _rel(dx, chain_dgrad_plain(dy, values, dm, plan=pc.plan)) <= TOL[dtype]
    assert _rel(dv, chain_wgrad_plain(x, dy, values, wm, plan=pc.plan)) <= TOL[dtype]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_backward_kernels_match_plain(dev, qdtype, scheme, xdtype):
    """K5: K2 and K3 on codes, and dscales = Σ_c q·dv."""
    n_factors = 1 + ["int8", "fp8_e4m3", "fp8_e5m2"].index(qdtype) + (scheme == "per_row")
    pc, x, dy = _bwd_chain(dev, n_factors, 16 if n_factors % 2 else 128, 30 + n_factors)
    q = quantize_chain(pc, qdtype, scheme)
    scales = expand_scales(q.scales, q.plan.block).contiguous()
    x, dy = x.to(xdtype), dy.to(xdtype)
    dm, wm = dgrad_meta(q.plan, q.in_idx), wgrad_meta(q.plan, q.in_idx)
    for bt in SUPPORTED_BT:
        before = (chain_dgrad.q_launches, chain_wgrad.q_launches)
        dx = chain_dgrad(dy, q.values, dm, plan=q.plan, bt=bt, scales=scales)
        dv = chain_wgrad(x, dy, q.values, wm, plan=q.plan, bt=bt, scales=scales)
        torch.cuda.synchronize()
        assert (chain_dgrad.q_launches, chain_wgrad.q_launches) == (before[0] + 1, before[1] + 1)
        dv_p = chain_wgrad_plain(x, dy, q.values, wm, plan=q.plan, scales=scales)
        assert _rel(dx, chain_dgrad_plain(dy, q.values, dm, plan=q.plan, scales=scales)) <= TOL[xdtype]
        assert _rel(dv, dv_p) <= TOL[xdtype]
        ds, ds_p = (torch.sum(q.values.float() * d, dim=2) for d in (dv, dv_p))
        assert _rel(ds, ds_p) <= TOL[xdtype]


def test_training_applies_run_the_backward_kernels(dev):
    """A FaustOp training apply through fused launches K1+K2+K3 (K4+K5 on a
    quantized chain) and matches autograd of x @ op.todense()."""
    w = torch.randn((256, 512), generator=torch.Generator().manual_seed(4))
    op, _ = factorize(w, FactorizeSpec(n_factors=3, block=64, k_first=2, k_mid=2), device=dev)
    pc = op.to("packed").rep
    for chain, name in ((pc, "values"), (quantize_chain(pc, "int8"), "scales")):
        leaf = getattr(chain, name).clone().requires_grad_(True)
        top = FaustOp.from_packed(dataclasses.replace(chain, **{name: leaf}))
        x = torch.randn((70, 256), device=dev, requires_grad=True)
        before = (chain_dgrad.launches + chain_dgrad.q_launches, chain_wgrad.launches + chain_wgrad.q_launches)
        top.apply(x, "fused").square().sum().backward()
        torch.cuda.synchronize()
        assert last_report().grad
        assert (chain_dgrad.launches + chain_dgrad.q_launches,
                chain_wgrad.launches + chain_wgrad.q_launches) == (before[0] + 1, before[1] + 1)
        got = (x.grad.clone(), leaf.grad.clone())
        x.grad = leaf.grad = None
        (x @ top.todense()).square().sum().backward()
        assert _rel(got[0], x.grad) <= 1e-4 and _rel(got[1], leaf.grad) <= 1e-4  # the dense product re-associates
