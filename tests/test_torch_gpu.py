"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides in its body whether a card is present
(never at import: every xdist worker must collect the same tests) and
skips without one.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: f32 ≤ 1e-5 of max|y| (FFMA in another summation order); bf16
≤ 3e-2 of max|y| (activations round to bf16 between factors on both
sides, and a one-ulp difference propagates).
"""
import math

import pytest
import torch

from repro_torch.api import FactorizeSpec, factorize
from repro_torch.core.compress import BlockFaust, pack_chain, random_block_factor
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain

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


def test_fused_kernel_refuses_to_train(dev):
    w = torch.randn((128, 128), generator=torch.Generator().manual_seed(1))
    op, _ = factorize(w, FactorizeSpec(n_factors=2, block=64, k_first=1, k_mid=1), device=dev)
    x = torch.randn((4, 128), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        op.apply(x, "fused")
    op.apply(x, "bsr").sum().backward()  # the bsr kernel path trains
    assert x.grad is not None and torch.isfinite(x.grad).all()
