"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides in its body whether a card is present
(never at import: every xdist worker must collect the same tests) and
skips without one.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: f32 ≤ 1e-5 of max|y| (FFMA in another summation order); bf16
≤ 3e-2 of max|y| (activations round to bf16 between factors on both
sides, and a one-ulp difference propagates).  The quantized kernel (K4)
dequantizes f32 activations with the plain version's f32 product; with
bf16 activations it adds no rounding to that product (per-block scales
multiply each block's exact partial, per-row ones split x·scale in three
bf16 parts), so its error stays within 1.25× the larger of K1 bf16's and
the plain version's own against itself in another summation order.
The backward kernels (K2, K3, K5) accumulate in f32 as their plain
versions do; in bf16 they also store the intermediate activations and
cotangents in bf16 (the plain versions keep them in f32), which the bf16
bound covers.
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
from repro_torch.kernels import ref as kref
from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
from repro_torch.kernels.chain import (
    SUPPORTED_BT,
    WGRAD_BT,
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
    """K4 on the same grid of blocks, depths and batches; per-block scales
    also as stored (one a block: the kernel scales each block's partial)."""
    for blk, n_factors in GRID:
        for batch in (1, 37, 4096):
            pc, x = _grid_chain(dev, blk, n_factors, batch, 50 + blk + n_factors)
            q = quantize_chain(pc, qdtype, scheme)
            scales = expand_scales(q.scales, blk).contiguous()
            x = x.to(xdtype)
            meta = ops.chain_meta(q.plan, q.in_idx)
            # per-block scales both as stored (one a block) and as rows
            for sc in (scales,) if scheme == "per_row" else (q.scales, scales):
                ref = chain_matmul_q_plain(x, q.values, sc, meta, plan=q.plan)
                for bt in SUPPORTED_BT if batch == 37 else (16,):
                    before = chain_matmul.q_launches
                    y = chain_matmul(x, q.values, meta, plan=q.plan, bt=bt, scales=sc)
                    torch.cuda.synchronize()
                    assert chain_matmul.q_launches == before + 1 and y.dtype == xdtype
                    assert _rel(y, ref) <= TOL[xdtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 37, 130, 4096])
@pytest.mark.parametrize("o,k,bk,bn,n_in", [(6, 3, 64, 128, 9), (3, 2, 32, 160, 5), (4, 2, 128, 96, 3),
                                            (3, 2, 200, 72, 4), (5, 3, 18, 36, 7)])
def test_bsr_kernel_matches_plain(dev, dtype, o, k, bk, bn, n_in, batch):
    """K6 at every tile on rectangular and ragged blocks: bn of 96 and 160
    (a slice narrower than 128 columns), bk of 32, 64 and 128, bk = 200 (a
    slot in two pieces, the second not a multiple of 16) and 18 x 36 blocks
    (rows no whole number of 16 bytes: element loads and stores)."""
    g = torch.Generator().manual_seed(o)
    idx = torch.stack([torch.randperm(n_in, generator=g)[:k] for _ in range(o)])
    idx = torch.sort(idx, 1).values.to(torch.int32).to(dev)
    values = (torch.randn((o, k, bk, bn), generator=g) / math.sqrt(k * bk)).to(dev, dtype)
    x = torch.randn((batch, n_in * bk), generator=g).to(dev, dtype)
    ref = bsr_matmul_plain(x, values, idx)
    for bt in SUPPORTED_BT:
        before = bsr_matmul.launches
        y = bsr_matmul(x, values, idx, bt=bt)
        torch.cuda.synchronize()
        assert bsr_matmul.launches == before + 1 and y.dtype == dtype
        assert _rel(y, ref) <= TOL[dtype]


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


def _dgrad_cases(dy, values, meta, plan, scales, tiles, launches):
    """K2/K5-dgrad at each tile against the plain version, and twice per
    tile with the same bits (the gather sums in a fixed order)."""
    ref = chain_dgrad_plain(dy, values, meta, plan=plan, scales=scales)
    for bt in tiles:
        before = launches()
        dx = chain_dgrad(dy, values, meta, plan=plan, bt=bt, scales=scales)
        again = chain_dgrad(dy, values, meta, plan=plan, bt=bt, scales=scales)
        torch.cuda.synchronize()
        assert launches() == before + 2 and dx.dtype == dy.dtype
        assert _rel(dx, ref) <= TOL[dy.dtype]
        assert torch.equal(dx, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 37, 4096])
@pytest.mark.parametrize("blk,n_factors", GRID)
def test_dgrad_kernel_grid_matches_plain(dev, blk, n_factors, batch, dtype):
    """K2 on its persistent gather schedule, on K1's grid: every tile at
    B = 37; small batches split the reader lists into chunks."""
    pc, _ = _grid_chain(dev, blk, n_factors, 1, 70 + blk + n_factors)
    dy = torch.randn((batch, pc.plan.out_blocks[-1] * blk), generator=torch.Generator().manual_seed(blk))
    meta = dgrad_meta(pc.plan, pc.in_idx)
    _dgrad_cases(dy.to(dev, dtype), pc.values.to(dtype), meta, pc.plan, None,
                 SUPPORTED_BT if batch == 37 else (16, 64), lambda: chain_dgrad.launches)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_dgrad_kernel_grid_matches_plain(dev, qdtype, scheme, xdtype):
    """K5-dgrad (codes dequantized once per launch) on the same grid."""
    for blk, n_factors in GRID:
        pc, _ = _grid_chain(dev, blk, n_factors, 1, 90 + blk + n_factors)
        q = quantize_chain(pc, qdtype, scheme)
        scales = expand_scales(q.scales, blk).contiguous()
        meta = dgrad_meta(q.plan, q.in_idx)
        for batch in (1, 37, 4096):
            dy = torch.randn((batch, q.plan.out_blocks[-1] * blk), generator=torch.Generator().manual_seed(batch))
            _dgrad_cases(dy.to(dev, xdtype), q.values, meta, q.plan, scales,
                         SUPPORTED_BT if batch == 37 else (16,), lambda: chain_dgrad.q_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["skewed fan-in", "unread blocks"])
@pytest.mark.parametrize("blk", [16, 128])
def test_dgrad_kernel_skewed_chains(dev, blk, chain, dtype):
    """Every output block reading input block 0 (one list of every step of
    a factor), or input blocks no step reads (flushed as zeros)."""
    pc, _ = _grid_chain(dev, blk, 4, 1, blk)
    idx = torch.zeros_like(pc.in_idx) if chain == "skewed fan-in" else torch.minimum(pc.in_idx, torch.ones_like(pc.in_idx))
    pc = dataclasses.replace(pc, in_idx=idx)
    meta = dgrad_meta(pc.plan, pc.in_idx)
    for batch in (37, 4096):
        dy = torch.randn((batch, pc.plan.out_blocks[-1] * blk), generator=torch.Generator().manual_seed(batch))
        _dgrad_cases(dy.to(dev, dtype), pc.values.to(dtype), meta, pc.plan, None, SUPPORTED_BT,
                     lambda: chain_dgrad.launches)
        q = quantize_chain(pc, "int8", "per_row")
        _dgrad_cases(dy.to(dev, dtype), q.values, meta, q.plan, expand_scales(q.scales, blk).contiguous(),
                     (16, 64), lambda: chain_dgrad.q_launches)


def _norm_err(y, ref):
    return float(torch.linalg.vector_norm(y.float().to(ref.device) - ref.float()) / torch.linalg.vector_norm(ref.float()))


@pytest.mark.parametrize("form,rows", [(("int8", "per_block"), False), (("int8", "per_block"), True),
                                       (("int8", "per_row"), True), (("fp8_e4m3", "per_block"), False),
                                       (("fp8_e4m3", "per_block"), True), (("fp8_e5m2", "per_block"), False),
                                       (("fp8_e5m2", "per_block"), True)])
def test_quantized_bf16_rounds_as_the_reference(dev, form, rows):
    """K4 with bf16 x adds no rounding to the reference's f32 dequantized
    product (chain.py:104): its error against the plain version is at most
    1.25× the larger of K1 bf16's on the same chain and batch and the plain
    version's own against itself with each factor's slots summed in the
    other order (the same f32 arithmetic, another summation order; K1's
    bf16 products are exact in f32, its floor can lie lower).  Per-block
    scales (``rows`` False) scale each block's exact x·q partial; per-row
    scales split x·scale into three bf16 parts (one bf16 rounding of
    x·scale a term fails this by a wide margin).  The
    error is ‖y − plain‖ / ‖plain‖: every kernel with bf16 outputs differs
    from its plain version by outputs that land on the other side of a
    bf16 rounding, which the norm counts; the max is one such output,
    whose size steps by 2× with its binade."""
    dims, blk = (512, 512, 512, 1024), 128
    g = torch.Generator().manual_seed(7)
    bf = BlockFaust(tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, 4, generator=g, device=dev) for j in range(3)
    ), torch.ones((), device=dev))
    pc = pack_chain(bf)
    q = quantize_chain(pc, *form)
    scales = expand_scales(q.scales, blk).contiguous() if rows else q.scales
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    x = torch.randn((1024, dims[0]), generator=g).to(dev, torch.bfloat16)
    v16 = pc.values.to(torch.bfloat16)
    ref = chain_matmul_q_plain(x, q.values, scales, meta, plan=q.plan)
    k4 = _norm_err(chain_matmul(x, q.values, meta, plan=q.plan, scales=scales), ref)
    k1 = _norm_err(chain_matmul(x, v16, meta, plan=pc.plan), chain_matmul_plain(x, v16, meta, plan=pc.plan))
    floor = _norm_err(_plain_q_slots_reversed(x, q.values, scales, meta, q.plan), ref)
    torch.cuda.synchronize()
    assert k4 <= 1.25 * max(k1, floor), {"k4": k4, "k1": k1, "floor": floor}


def _plain_q_slots_reversed(x, values, scales, meta, plan):
    """K4's plain version with each factor's slots summed last to first (in
    f32, the intermediates rounded to x's dtype as the plain version does)."""
    v = kref.dequant_values(values, scales)
    y = x
    for j in range(plan.n_factors):
        vj, ij = kref.factor_slices(v, meta[:, 0], plan, j)
        acc = sum(kref.bsr_matmul_ref(y.float(), vj[:, k:k + 1], ij[:, k:k + 1])
                  for k in reversed(range(plan.k_blocks[j])))
        y = kref._mask_tail(acc.to(x.dtype), plan.out_feats[j])
    return y


def _wgrad_cases(x, dy, values, meta, plan, scales, tiles, launches):
    """K3/K5-wgrad at each tile against the plain version, and twice per
    tile with the same bits (every sum runs in a fixed order)."""
    ref = chain_wgrad_plain(x, dy, values, meta, plan=plan, scales=scales)
    for bt in tiles:
        before = launches()
        dv = chain_wgrad(x, dy, values, meta, plan=plan, bt=bt, scales=scales)
        again = chain_wgrad(x, dy, values, meta, plan=plan, bt=bt, scales=scales)
        torch.cuda.synchronize()
        assert launches() == before + 2 and dv.dtype == torch.float32
        assert bool(torch.isfinite(dv).all()) and _rel(dv, ref) <= TOL[x.dtype]
        assert torch.equal(dv, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 37, 4096])
@pytest.mark.parametrize("blk,n_factors", GRID)
def test_wgrad_kernel_grid_matches_plain(dev, blk, n_factors, batch, dtype):
    """K3 (recompute on K1's loop, walk on K2's gather schedule, emission)
    on K1's grid: every tile at B = 37; small batches cut the emission's
    batch into chunks."""
    pc, x = _grid_chain(dev, blk, n_factors, batch, 110 + blk + n_factors)
    dy = torch.randn((batch, pc.plan.out_blocks[-1] * blk), generator=torch.Generator().manual_seed(blk + batch))
    meta = wgrad_meta(pc.plan, pc.in_idx)
    _wgrad_cases(x.to(dtype), dy.to(dev, dtype), pc.values.to(dtype), meta, pc.plan, None,
                 SUPPORTED_BT if batch == 37 else (16, WGRAD_BT), lambda: chain_wgrad.launches)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["per_block", "per_row"])
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_wgrad_kernel_grid_matches_plain(dev, qdtype, scheme, xdtype):
    """K5-wgrad (K4's recompute, K5-dgrad's walk) on the same grid, with
    per-block scales as stored and as rows."""
    for blk, n_factors in GRID:
        for batch in (1, 37, 4096):
            pc, x = _grid_chain(dev, blk, n_factors, batch, 130 + blk + n_factors)
            q = quantize_chain(pc, qdtype, scheme)
            scales = expand_scales(q.scales, blk).contiguous()
            dy = torch.randn((batch, q.plan.out_blocks[-1] * blk), generator=torch.Generator().manual_seed(batch))
            for sc in (scales,) if scheme == "per_row" else (q.scales, scales):  # as stored, and as rows
                _wgrad_cases(x.to(xdtype), dy.to(dev, xdtype), q.values, wgrad_meta(q.plan, q.in_idx), q.plan, sc,
                             SUPPORTED_BT if batch == 37 else (WGRAD_BT,), lambda: chain_wgrad.q_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["skewed fan-in", "unread blocks"])
@pytest.mark.parametrize("blk", [16, 128])
def test_wgrad_kernel_skewed_chains(dev, blk, chain, dtype):
    """Every output block reading input block 0, or input blocks no step
    reads (their cotangents are zeros; no dvalues reads them)."""
    pc, _ = _grid_chain(dev, blk, 4, 1, blk)
    idx = torch.zeros_like(pc.in_idx) if chain == "skewed fan-in" else torch.minimum(pc.in_idx, torch.ones_like(pc.in_idx))
    pc = dataclasses.replace(pc, in_idx=idx)
    meta = wgrad_meta(pc.plan, pc.in_idx)
    for batch in (37, 4096):
        g = torch.Generator().manual_seed(batch)
        x = torch.randn((batch, pc.plan.in_blocks[0] * blk), generator=g).to(dev, dtype)
        dy = torch.randn((batch, pc.plan.out_blocks[-1] * blk), generator=g).to(dev, dtype)
        _wgrad_cases(x, dy, pc.values.to(dtype), meta, pc.plan, None, SUPPORTED_BT, lambda: chain_wgrad.launches)
        q = quantize_chain(pc, "int8", "per_row")
        _wgrad_cases(x, dy, q.values, meta, q.plan, expand_scales(q.scales, blk).contiguous(), (16, WGRAD_BT),
                     lambda: chain_wgrad.q_launches)


# ---------------------------------------------------------------------------
# Slice 7: the trainer's update without a host sync, measured grad
# dispatch, the batched factorizer
# ---------------------------------------------------------------------------


def test_trainer_update_never_syncs_the_host(dev, monkeypatch):
    """The guarded AdamW update runs under ``set_sync_debug_mode("error")``:
    a read-back to the host inside it (the old ``bool(isfinite(loss))``)
    raises."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw
    from repro_torch.runtime import trainer

    real = trainer.guarded_update
    runs = []

    def strict(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs.append(out)
        return out

    monkeypatch.setattr(trainer, "guarded_update", strict)
    model = LM(get_smoke("gemma_2b"), seed=0, device=dev)
    step = trainer.make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1), trainer.TrainConfig())
    state = adamw.init_state(dict(model.named_parameters()))
    tokens = torch.randint(0, model.cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(0)).to(dev)
    for _ in range(2):
        metrics = step({"tokens": tokens}, state)
    assert len(runs) == 2 and all(v.device.type == "cuda" for v in metrics.values())
    assert float(metrics["skipped"]) == 0.0 and int(state.step) == 2 and torch.isfinite(metrics["loss"])


def test_compressed_step_never_syncs_the_host(dev, monkeypatch):
    """EF top-k compression and the guarded update run under
    ``set_sync_debug_mode("error")``: the top-k selection (``torch.topk``'s
    k-th value, ties by a cumulative count) and the guarded residual read
    nothing back to the host."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import trainer

    runs = []

    def strict(real):
        def call(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            runs.append(real.__name__)
            return out
        return call

    for name in ("ef_topk_compress", "guarded_update"):
        monkeypatch.setattr(trainer, name, strict(getattr(trainer, name)))
    model = LM(get_smoke("gemma_2b"), seed=0, device=dev)
    tcfg = trainer.TrainConfig(compression=compression.TopKConfig(0.01))
    step = trainer.make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1), tcfg)
    params = dict(model.named_parameters())
    state, ef = adamw.init_state(params), compression.ef_topk_init(params)
    tokens = torch.randint(0, model.cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(0)).to(dev)
    for _ in range(2):
        metrics = step({"tokens": tokens}, state, ef)
    assert runs == ["ef_topk_compress", "guarded_update"] * 2
    assert float(metrics["skipped"]) == 0.0 and float(metrics["ef_residual_norm"]) > 0


def test_topk_selection_on_the_card_keeps_the_stable_sorts_set(dev):
    """``topk_mask_flat`` on the card keeps the set the stable sort keeps,
    ties included, at a leaf of a million entries."""
    from repro_torch.core.projections import _topk_mask_flat
    from repro_torch.optim.compression import topk_mask_flat

    g = torch.Generator().manual_seed(0)
    v = (torch.randint(-20, 21, (1 << 20,), generator=g).float() / 4).to(dev)
    for k in (1, 10_485, 200_000):
        assert torch.equal(topk_mask_flat(v, k), _topk_mask_flat(v, k).float())


def test_checkpoint_round_trip_of_bf16_parameters_on_the_card(dev, tmp_path):
    """Save → restore of a bf16 model's parameters and f32 moments on the
    card is bit exact, written into the live tensors."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_smoke("gemma_2b"), dtype="bfloat16")
    src = LM(cfg, seed=0, device=dev)
    tree = {"params": src.state_dict(keep_vars=True),
            "opt": {"mu": {k: torch.randn(p.shape, device=dev) for k, p in src.named_parameters()}}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, tree)
    mgr.wait()
    dst = LM(cfg, seed=1, device=dev)
    target = {"params": dst.state_dict(keep_vars=True),
              "opt": {"mu": {k: torch.zeros(p.shape, device=dev) for k, p in dst.named_parameters()}}}
    table = dst.embed.table
    mgr.restore(1, target)
    assert dst.embed.table is table and table.dtype == torch.bfloat16 and table.device.type == "cuda"
    for k, t in src.state_dict().items():
        got = dst.state_dict()[k]
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           t.view(torch.int16) if t.dtype == torch.bfloat16 else t), k
    assert all(torch.equal(target["opt"]["mu"][k], v) for k, v in tree["opt"]["mu"].items())


def test_measure_under_grad_records_the_fused_tile(dev, tmp_path, monkeypatch):
    """``measure(grad=True)`` on the card: fwd+bwd per feasible backend,
    the fused forward tile swept and its winner recorded: the default tile
    (64) unless another beat it by ``TILE_MARGIN``."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(tmp_path / "t.json"))
    autotune.reload()
    g = torch.Generator().manual_seed(3)
    bf = BlockFaust(tuple(random_block_factor(a, b, 128, 128, 4, generator=g, device=dev)
                          for a, b in ((512, 512), (512, 1024))), torch.ones((), device=dev))
    op = FaustOp.from_blockfaust(bf, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((256, 512), generator=g).to(dev, dtype)
        entry = autotune.measure(op, x, grad=True, use_kernel=True)
        assert set(entry["us"]) == {"dense", "bsr", "fused"} and entry["ctx"]["grad"]
        assert entry["bt"] in SUPPORTED_BT and set(entry["bt_us"]) == {str(t) for t in SUPPORTED_BT}
        bt_us = {int(t): v for t, v in entry["bt_us"].items()}
        assert entry["bt"] == 64 or bt_us[entry["bt"]] * (1 + autotune.TILE_MARGIN) <= bt_us[64] + 1e-3
    autotune.reload()


def test_batched_factorization_equals_sequential(dev):
    """A stack of 4 (256 × 1024) through the batched route: each matrix's
    RE within 1e-5 of its own sequential run (bmm and mm may sum in other
    orders on the card), every operator applied fused against its dense
    form."""
    ws = torch.randn((4, 256, 1024), generator=torch.Generator(device=dev).manual_seed(0), device=dev) / 16
    spec = FactorizeSpec(strategy="hierarchical", n_factors=3, block=32, k_first=4, k_mid=4,
                         n_iter_two=10, n_iter_global=10)
    op, info = factorize(ws, spec, device=dev)
    assert op.kind == "block_diag" and len(info.ops) == 4
    x = torch.randn((64, 256), generator=torch.Generator().manual_seed(1)).to(dev)
    for i, o in enumerate(info.ops):
        single, _ = factorize(ws[i], spec, device=dev)
        assert abs(float(o.rel_error_fro(ws[i])) - float(single.rel_error_fro(ws[i]))) <= 1e-5
        assert _rel(o.apply(x, "fused", device=dev), x @ o.todense()) <= 1e-4


# ---------------------------------------------------------------------------
# Slice 8: serving — the FAµST head at decode batches, one decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_head_at_decode_batches_matches_plain(dev, batch):
    """The unembedding's layout (2048 → 2048 → 32000 here, block 16, k 4,
    bf16) at decode batches: K1 over the packed chain and K6 factor by
    factor against their plain versions."""
    g = torch.Generator().manual_seed(batch)
    dims = (2048, 2048, 32000)
    bf = BlockFaust(tuple(random_block_factor(dims[j], dims[j + 1], 16, 16, 4, generator=g, device=dev,
                                              dtype=torch.bfloat16) for j in range(2)), torch.ones((), device=dev))
    pc = pack_chain(bf)
    x = torch.randn((batch, 2048), generator=g).to(dev, torch.bfloat16)
    meta = ops.chain_meta(pc.plan, pc.in_idx)
    before = (chain_matmul.launches, bsr_matmul.launches)
    y = chain_matmul(x, pc.values, meta, plan=pc.plan)
    assert _rel(y, chain_matmul_plain(x, pc.values, meta, plan=pc.plan)) <= TOL[torch.bfloat16]
    h = x
    for f in bf.factors:
        h_k = bsr_matmul(h, f.values, f.in_idx)
        assert _rel(h_k, bsr_matmul_plain(h, f.values, f.in_idx)) <= TOL[torch.bfloat16]
        h = h_k
    torch.cuda.synchronize()
    assert (chain_matmul.launches, bsr_matmul.launches) == (before[0] + 1, before[1] + 2)


def test_decode_step_on_the_card_matches_the_cpu(dev):
    """gemma-2b smoke in bf16 with a FAµST unembedding: a prefill and one
    decode step of a two-slot engine pool on the card (the head through
    the kernels) against the same model's plain path on the CPU, within the
    bf16 bound of max|logits|."""
    from repro_torch.configs import get_smoke
    from repro_torch.layers.faust_linear import FaustSpec
    from repro_torch.models.lm import LM
    from repro_torch.runtime.engine import LMExecutor

    cfg = dataclasses.replace(get_smoke("gemma_2b"), dtype="bfloat16", faust_unembed=FaustSpec(2, 16, 2),
                              tie_embeddings=False)
    cpu = LM(cfg, seed=0, device="cpu")
    card = LM(cfg, seed=0, device="cpu").to(dev)
    card.load_state_dict(cpu.state_dict())
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=torch.Generator().manual_seed(n)).numpy() for n in (6, 5)]
    logits = []
    for model in (cpu, card):
        ex = LMExecutor(model, 16, n_slots=2)
        for slot, p in enumerate(prompts):
            ex.prefill_forward(slot, p, {})
        logits.append(ex.decode_forward([0, 1], [[3], [7]]).float().cpu())
    assert logits[1].shape == (2, 1, cfg.vocab)
    assert _rel(logits[1], logits[0]) <= TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# Slice 12: the modality front ends — every codebook head's kernels
# ---------------------------------------------------------------------------


def _arch_heads(arch: str, dev):
    """``arch``'s smoke model in bf16 with a FAµST head (2 factors, block
    16, k 2) on the card, and each head's packed chain: musicgen's K
    per-codebook heads, internvl2's one."""
    from repro_torch.configs import get_smoke
    from repro_torch.layers.faust_linear import FaustSpec
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_smoke(arch), dtype="bfloat16", faust_unembed=FaustSpec(2, 16, 2))
    model = LM(cfg, seed=0, device=dev)
    head = model.unembed.faust
    chains = [head.blockfaust(k) for k in range(cfg.n_codebooks)] if cfg.n_codebooks > 1 else [head.blockfaust()]
    with torch.no_grad():
        return cfg, [pack_chain(bf) for bf in chains]


@pytest.mark.parametrize("arch", ["internvl2_2b", "musicgen_medium"])
def test_every_codebook_head_matches_plain(dev, arch):
    """Each head of the smoke model's FAµST unembedding (bf16): K1 at
    B = 1, 8 and a training batch's 2 × 16 rows, K2 and K3 at those rows,
    each against its plain version; one launch per call."""
    from repro_torch.kernels.chain import DGRAD_BT

    cfg, heads = _arch_heads(arch, dev)
    assert len(heads) == max(cfg.n_codebooks, 1)
    g = torch.Generator().manual_seed(7)
    rows = 2 * 16
    for pc in heads:
        plan, values = pc.plan, pc.values
        meta = ops.chain_meta(plan, pc.in_idx)
        for b in (1, 8, rows):
            x = torch.randn((b, plan.in_features), generator=g).to(dev, torch.bfloat16)
            before = chain_matmul.launches
            y = chain_matmul(x, values, meta, plan=plan)
            torch.cuda.synchronize()
            assert chain_matmul.launches == before + 1
            assert _rel(y, chain_matmul_plain(x, values, meta, plan=plan)) <= TOL[torch.bfloat16]
        x = torch.zeros((rows, plan.in_blocks[0] * plan.block), dtype=torch.bfloat16, device=dev)
        x[:, :plan.in_features] = torch.randn((rows, plan.in_features), generator=g).to(dev)
        dy = torch.zeros((rows, plan.out_blocks[-1] * plan.block), dtype=torch.bfloat16, device=dev)
        dy[:, :plan.out_features] = torch.randn((rows, plan.out_features), generator=g).to(dev)
        dm, wm = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
        before = (chain_dgrad.launches, chain_wgrad.launches)
        dx = chain_dgrad(dy, values, dm, plan=plan, bt=DGRAD_BT)
        dv = chain_wgrad(x, dy, values, wm, plan=plan, bt=WGRAD_BT)
        torch.cuda.synchronize()
        assert (chain_dgrad.launches, chain_wgrad.launches) == (before[0] + 1, before[1] + 1)
        assert _rel(dx, chain_dgrad_plain(dy, values, dm, plan=plan)) <= TOL[torch.bfloat16]
        assert _rel(dv, chain_wgrad_plain(x, dy, values, wm, plan=plan)) <= TOL[torch.bfloat16]


def test_sharded_apply_on_a_one_rank_nccl_mesh(dev, tmp_path):
    """A 1 × 1 mesh over NCCL (world size 1): ``fused_sharded`` runs its
    collectives for real at one rank, K1 forward and K2 + K3 backward,
    each launched once and held against the plain versions on the same
    card tensors."""
    import torch.distributed as dist

    from repro_torch.api.operator import ShardSpec
    from repro_torch.distributed import make_debug_mesh

    g = torch.Generator().manual_seed(13)
    bf = BlockFaust(tuple(random_block_factor(i, o, 128, 128, 4, generator=g, device=dev)
                          for i, o in ((1024, 1024), (1024, 4096))), torch.ones((), device=dev))
    x = torch.randn((96, 1024), generator=g).to(dev)
    dy = torch.randn((96, 4096), generator=g).to(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        op = FaustOp(bf).with_sharding(ShardSpec(make_debug_mesh(1, 1, device=dev)))
        grads = {}
        for kernel in (True, False):
            pc = pack_chain(bf)
            leaf = pc.values.detach().clone().requires_grad_(True)
            top = FaustOp(dataclasses.replace(pc, values=leaf), shard=op.shard)
            xg = x.clone().requires_grad_(True)
            chain_matmul.launches = chain_dgrad.launches = chain_wgrad.launches = 0
            y = top.apply(xg, "fused_sharded", use_kernel=kernel)
            (y * dy).sum().backward()
            torch.cuda.synchronize()
            grads[kernel] = (y.detach(), xg.grad, leaf.grad)
            want = (1, 1, 1) if kernel else (0, 0, 0)
            assert (chain_matmul.launches, chain_dgrad.launches, chain_wgrad.launches) == want
        for got, ref in zip(grads[True], grads[False]):
            assert _rel(got, ref) <= TOL[torch.float32]
    finally:
        dist.destroy_process_group()


def test_mesh_trainer_on_a_one_rank_nccl_mesh(dev, tmp_path):
    """``Trainer(mesh=)`` on a 1 × 1 NCCL mesh (world size 1), the smoke
    gemma-2b with its FAµST head on ``fused``: two f32 steps with one K1,
    K2 and K3 a step, the losses of the unsharded trainer within 1e-5,
    and a sharded save that the unsharded trainer resumes."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.layers.faust_linear import FaustSpec
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(get_smoke("gemma_2b"), faust_unembed=FaustSpec(2, 8, 2), tie_embeddings=False,
                              vocab=128)
    data = DataConfig(vocab=128, seq_len=16, global_batch=4)
    opt = AdamWConfig(lr=1e-4, warmup_steps=1, decay_steps=3)

    def run(mesh, folder, steps=2, resume=False):
        model = LM(cfg, seed=0, device=dev)
        model.unembed.faust.backend = "fused"
        t = Trainer(cfg, data, opt, TrainConfig(steps=steps, checkpoint_every=2, checkpoint_dir=str(folder)),
                    mesh=mesh, device=dev)
        chain_matmul.launches = chain_dgrad.launches = chain_wgrad.launches = 0
        out = t.run(resume=resume, model=model)
        torch.cuda.synchronize()
        return [h["loss"] for h in out["history"]], (chain_matmul.launches, chain_dgrad.launches, chain_wgrad.launches)

    plain, _ = run(None, tmp_path / "plain", steps=3)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        losses, launches = run(make_debug_mesh(1, 1, device=dev), tmp_path / "mesh")
    finally:
        dist.destroy_process_group()
    assert launches == (2, 2, 2)
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, plain[:2]))
    resumed, _ = run(None, tmp_path / "mesh", steps=3, resume=True)
    assert len(resumed) == 1 and abs(resumed[0] - plain[2]) <= 1e-5 * abs(plain[2])
