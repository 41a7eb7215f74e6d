"""Packed block-sparse FAµST formats and the block-route helpers.
Counterpart of the format half of :mod:`repro.core.compress`.

:class:`BlockSparseFactor` packs a right-multiplication factor
``F ∈ R^{in × out}`` whose support is a union of aligned ``(bk × bn)``
blocks, exactly k blocks per output block-column::

    values : (n_out_blocks, k, bk, bn)
    in_idx : (n_out_blocks, k) int32      input block ids gathered per
                                          output block

so ``y[:, o·bn:(o+1)·bn] = Σ_j x[:, in_idx[o,j]·bk : +bk] @ values[o,j]``.
:class:`PackedChain` concatenates a whole chain's blocks for the fused
kernel (``kernels/chain.py``); its layout is described by a
:class:`ChainPlan`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import projections as P
from repro_torch.core.faust import Faust
from repro_torch.core.hierarchical import HierarchicalSpec


def _desc_topk_indices(v: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Indices of the k largest entries along ``dim``, ties to the lowest
    index (the ``lax.top_k`` order the reference packs with)."""
    order = torch.sort(v, dim=dim, descending=True, stable=True).indices
    return order.narrow(dim, 0, k)


@dataclasses.dataclass(frozen=True)
class BlockSparseFactor:
    """Packed block-sparse factor for ``y = x @ F`` (module docstring)."""

    values: torch.Tensor  # (O, K, bk, bn)
    in_idx: torch.Tensor  # (O, K) int32
    in_features: int
    out_features: int

    @property
    def bk(self) -> int:
        return self.values.shape[2]

    @property
    def bn(self) -> int:
        return self.values.shape[3]

    @property
    def k(self) -> int:
        return self.values.shape[1]

    @property
    def n_out_blocks(self) -> int:
        return self.values.shape[0]

    @property
    def n_in_blocks(self) -> int:
        return -(-self.in_features // self.bk)

    @property
    def nnz(self) -> int:
        return self.values.numel()

    def to(self, device=None, dtype=None) -> "BlockSparseFactor":
        return dataclasses.replace(
            self,
            values=self.values.to(device=device, dtype=dtype),
            in_idx=self.in_idx.to(device=device),
        )

    def todense(self) -> torch.Tensor:
        """Materialize F (in_features × out_features)."""
        o, k, bk, bn = self.values.shape
        ib = self.n_in_blocks
        dense = torch.zeros((ib, o, bk, bn), dtype=self.values.dtype, device=self.values.device)
        ob = torch.arange(o, device=self.values.device)[:, None].expand(o, k)
        dense.index_put_((self.in_idx.long(), ob), self.values, accumulate=True)
        dense = dense.permute(0, 2, 1, 3).reshape(ib * bk, o * bn)
        return dense[: self.in_features, : self.out_features]


@dataclasses.dataclass(frozen=True)
class BlockFaust:
    """Deployment FAµST ``W ≈ lam · F_1 F_2 ··· F_J`` for right
    multiplication: ``y = lam · (((x @ F_1) @ F_2) ...)``."""

    factors: tuple[BlockSparseFactor, ...]
    lam: torch.Tensor

    @property
    def in_features(self) -> int:
        return self.factors[0].in_features

    @property
    def out_features(self) -> int:
        return self.factors[-1].out_features

    @property
    def s_tot(self) -> int:
        return sum(f.nnz for f in self.factors)

    @property
    def device(self) -> torch.device:
        return self.factors[0].values.device

    def rc(self) -> float:
        return self.s_tot / (self.in_features * self.out_features)

    def rcg(self) -> float:
        return 1.0 / self.rc()

    def to(self, device=None, dtype=None) -> "BlockFaust":
        return BlockFaust(
            tuple(f.to(device, dtype) for f in self.factors), self.lam.to(device=device)
        )

    def todense(self) -> torch.Tensor:
        w = self.factors[0].todense()
        for f in self.factors[1:]:
            w = w @ f.todense()
        return self.lam * w


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Static metadata of a flat-packed chain (pure Python, hashable).

    One *step* per stored block, in ``(factor j, output block o, slot k)``
    order: step ``s = offsets[j] + o·k_blocks[j] + k``.  ``in_idx[s]`` is the
    input block of the current activation that step ``s`` multiplies.
    """

    block: int
    in_blocks: tuple[int, ...]  # IB_j = ceil(in_features_j / block)
    out_blocks: tuple[int, ...]  # O_j
    k_blocks: tuple[int, ...]  # K_j
    offsets: tuple[int, ...]  # len J+1, offsets[J] == n_steps
    in_feats: tuple[int, ...]
    out_feats: tuple[int, ...]

    @property
    def n_factors(self) -> int:
        return len(self.out_blocks)

    @property
    def n_steps(self) -> int:
        return self.offsets[-1]

    @property
    def max_blocks(self) -> int:
        """Widest activation (in blocks) anywhere along the chain."""
        return max(max(self.in_blocks), max(self.out_blocks))

    @property
    def in_features(self) -> int:
        return self.in_feats[0]

    @property
    def out_features(self) -> int:
        return self.out_feats[-1]

    def reverse(self) -> "ChainPlan":
        """Plan of the transposed chain ``Wᵀ = F_Jᵀ ··· F_1ᵀ`` (an involution)."""
        sizes = tuple(self.offsets[j + 1] - self.offsets[j] for j in range(self.n_factors))
        offs = [0]
        for s in reversed(sizes):
            offs.append(offs[-1] + s)
        return ChainPlan(
            block=self.block,
            in_blocks=tuple(reversed(self.out_blocks)),
            out_blocks=tuple(reversed(self.in_blocks)),
            k_blocks=tuple(reversed(self.k_blocks)),
            offsets=tuple(offs),
            in_feats=tuple(reversed(self.out_feats)),
            out_feats=tuple(reversed(self.in_feats)),
        )


@dataclasses.dataclass(frozen=True)
class PackedChain:
    """Flat-packed chain: ``values (S, block, block)`` and ``in_idx (S,)``
    int32 in the :class:`ChainPlan` step order, plus λ.

    A quantized chain (``qscheme`` set, e.g. ``"int8:per_block"``) holds
    int8/fp8 codes in ``values`` and f32 scales in ``scales``: ``(S,)`` for
    scheme ``per_block``, ``(S, block)`` for ``per_row`` (one scale per
    block row, i.e. per input feature of the block)."""

    values: torch.Tensor
    in_idx: torch.Tensor
    lam: torch.Tensor
    plan: ChainPlan
    scales: torch.Tensor | None = None
    qscheme: str | None = None

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def quantized(self) -> bool:
        return self.qscheme is not None

    @property
    def values_dtype(self) -> str:
        return str(self.values.dtype).removeprefix("torch.")

    @property
    def weight_bytes(self) -> int:
        """Bytes of one full weight stream: values plus scales."""
        b = self.values.numel() * self.values.element_size()
        if self.scales is not None:
            b += self.scales.numel() * self.scales.element_size()
        return b

    def to(self, device=None, dtype=None) -> "PackedChain":
        """Move (and, unquantized, cast) the chain.  A quantized chain
        moves only: casting its codes would drop the scales' meaning."""
        if self.quantized and dtype is not None:
            raise TypeError(
                f"a quantized chain ({self.qscheme}) cannot be cast to {dtype}; "
                "dequantize_chain() it first"
            )
        return dataclasses.replace(
            self,
            values=self.values.to(device=device, dtype=dtype),
            in_idx=self.in_idx.to(device=device),
            lam=self.lam.to(device=device),
            scales=None if self.scales is None else self.scales.to(device=device),
        )


# Quantization schemes for PackedChain values: name -> (torch dtype, qmax),
# qmax the largest magnitude each group's absmax maps onto (int8 symmetric:
# 127; fp8: the format's finite max).
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}
QUANT_SCHEMES = ("per_block", "per_row")


def _scale_broadcast(scales: torch.Tensor) -> torch.Tensor:
    """Scales broadcastable against ``(S, blk, blk)`` values."""
    if scales.ndim == 1:  # per_block (S,)
        return scales[:, None, None]
    return scales[:, :, None]  # per_row (S, blk)


def expand_scales(scales: torch.Tensor, blk: int) -> torch.Tensor:
    """Scales in the ``(S, blk)`` per-row layout the kernels stream
    (per_block ``(S,)`` scales broadcast exactly)."""
    sc = scales.to(torch.float32)
    if sc.ndim == 1:
        sc = sc[:, None].expand(sc.shape[0], blk)
    return sc


def quantize_chain(chain: PackedChain, dtype: str = "int8", scheme: str = "per_block") -> PackedChain:
    """Quantize a chain's block values to ``dtype`` with per-block (or
    per-block-row) f32 scales, giving the reference's codes bit for bit.

    Symmetric absmax: ``scale = absmax / qmax`` per group (1.0 for an
    all-zero group), then ``q = round(v / scale)`` (half to even) clipped
    to ±127 for int8, or the round-to-nearest-even cast for fp8.  λ,
    ``in_idx`` and the plan are untouched.  ``quantize_chain(
    dequantize_chain(q)) == q`` bit for bit."""
    if chain.quantized:
        raise ValueError(f"chain is already quantized ({chain.qscheme})")
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"unknown quant dtype {dtype!r}; want one of {list(QUANT_DTYPES)}")
    if scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown quant scheme {scheme!r}; want one of {QUANT_SCHEMES}")
    qdt, qmax = QUANT_DTYPES[dtype]
    v = chain.values.to(torch.float32)
    axes = (1, 2) if scheme == "per_block" else (2,)
    amax = v.abs().amax(dim=axes)
    scales = torch.where(amax > 0, amax / qmax, torch.ones((), dtype=torch.float32, device=v.device))
    scaled = v / _scale_broadcast(scales)
    if dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(qdt)
    else:
        q = scaled.to(qdt)  # round to nearest even into the fp8 grid
    return dataclasses.replace(chain, values=q, scales=scales, qscheme=f"{dtype}:{scheme}")


def dequantize_chain(chain: PackedChain) -> PackedChain:
    """The exact f32 chain ``q · scale`` of a quantized chain; an
    unquantized chain comes back as it is."""
    if not chain.quantized:
        return chain
    v = chain.values.to(torch.float32) * _scale_broadcast(chain.scales)
    return PackedChain(v, chain.in_idx, chain.lam, chain.plan)


def chain_plan(factors: Sequence[BlockSparseFactor]) -> ChainPlan:
    """The :class:`ChainPlan` of a chain of factors in the fused layout.
    Needs uniform square blocks and a contiguous chain; raises
    ``ValueError`` otherwise."""
    blk = factors[0].bk
    for f in factors:
        if f.bk != blk or f.bn != blk:
            raise ValueError(f"pack_chain needs uniform square blocks; got ({f.bk},{f.bn}) vs {blk}")
    for a, b in zip(factors[:-1], factors[1:]):
        if a.out_features != b.in_features or a.n_out_blocks != b.n_in_blocks:
            raise ValueError(
                "pack_chain needs a contiguous chain: factor boundary "
                f"{a.out_features}/{a.n_out_blocks} blocks → "
                f"{b.in_features}/{b.n_in_blocks} blocks"
            )
    offsets = [0]
    for f in factors:
        offsets.append(offsets[-1] + f.n_out_blocks * f.k)
    return ChainPlan(
        block=blk,
        in_blocks=tuple(f.n_in_blocks for f in factors),
        out_blocks=tuple(f.n_out_blocks for f in factors),
        k_blocks=tuple(f.k for f in factors),
        offsets=tuple(offsets),
        in_feats=tuple(f.in_features for f in factors),
        out_feats=tuple(f.out_features for f in factors),
    )


def pack_chain(bfaust: BlockFaust) -> PackedChain:
    """Flatten a :class:`BlockFaust` into the fused-kernel layout.  Needs
    uniform square blocks and a contiguous chain; raises ``ValueError``
    otherwise."""
    factors = bfaust.factors
    plan = chain_plan(factors)
    blk = plan.block
    values = torch.cat([f.values.reshape(-1, blk, blk) for f in factors])
    in_idx = torch.cat([f.in_idx.reshape(-1).to(torch.int32) for f in factors])
    return PackedChain(values, in_idx, bfaust.lam, plan)


def unpack_chain(chain: PackedChain, dequantize: bool = True) -> BlockFaust:
    """Inverse of :func:`pack_chain` (views sliced by the plan's offsets).
    A quantized chain unpacks to its exact f32 values, or with
    ``dequantize=False`` to its codes (the sharded apply takes the scales
    beside them)."""
    if dequantize:
        chain = dequantize_chain(chain)
    plan, blk = chain.plan, chain.plan.block
    factors = []
    for j in range(plan.n_factors):
        o, k = plan.out_blocks[j], plan.k_blocks[j]
        sl = slice(plan.offsets[j], plan.offsets[j + 1])
        factors.append(
            BlockSparseFactor(
                chain.values[sl].reshape(o, k, blk, blk),
                chain.in_idx[sl].reshape(o, k),
                plan.in_feats[j],
                plan.out_feats[j],
            )
        )
    return BlockFaust(tuple(factors), chain.lam)


def _pad_to_multiple(w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    i, o = w.shape
    pi, po = (-i) % bk, (-o) % bn
    if pi or po:
        w = torch.nn.functional.pad(w, (0, po, 0, pi))
    return w


def _outcol_block_energy(w: torch.Tensor, bk: int, bn: int):
    """``(blocks (O, I, bk, bn), energy (O, I))`` of the padded ``w``."""
    wp = _pad_to_multiple(w, bk, bn)
    ib, ob = wp.shape[0] // bk, wp.shape[1] // bn
    blocks = wp.reshape(ib, bk, ob, bn).permute(2, 0, 1, 3)
    return blocks, torch.sum(blocks**2, dim=(-1, -2))


def pack_dense(w: torch.Tensor, bk: int, bn: int, k: int) -> BlockSparseFactor:
    """Pack dense ``F (in, out)`` keeping the top-``k`` energy blocks of
    every output block-column (padded blocks have zero energy)."""
    in_f, out_f = w.shape
    blocks, energy = _outcol_block_energy(w, bk, bn)
    k = min(k, blocks.shape[1])
    idx = torch.sort(_desc_topk_indices(energy, k, 1), dim=1).values
    values = torch.take_along_dim(blocks, idx[:, :, None, None], dim=1)
    return BlockSparseFactor(values.contiguous(), idx.to(torch.int32), in_f, out_f)


def random_block_factor(
    in_features: int,
    out_features: int,
    bk: int,
    bn: int,
    k: int,
    *,
    generator: torch.Generator,
    scale: float = 1.0,
    dtype=torch.float32,
    device,
) -> BlockSparseFactor:
    """Prescribed-support init: k distinct random input blocks per output
    block, values with std ``scale/sqrt(k·bk)`` (the sparse fan-in).
    ``generator`` is a CPU generator; the result moves to ``device``."""
    ib, ob = -(-in_features // bk), -(-out_features // bn)
    k = min(k, ib)
    idx = torch.stack([torch.randperm(ib, generator=generator)[:k] for _ in range(ob)])
    idx = torch.sort(idx, dim=1).values.to(torch.int32)
    std = scale / (k * bk) ** 0.5
    values = torch.randn((ob, k, bk, bn), generator=generator, dtype=torch.float32) * std
    return BlockSparseFactor(
        values.to(device=device, dtype=dtype), idx.to(device), in_features, out_features
    )


def _compress_spec(
    a_shape: tuple[int, int],
    transpose: bool,
    n_factors: int,
    bk: int,
    bn: int,
    k_first: int,
    k_mid: int,
    k_resid: Sequence[int] | None,
    n_iter_two: int,
    n_iter_global: int,
) -> HierarchicalSpec:
    """The §V-A-style block-granular constraint schedule for one padded,
    oriented matrix shape (residuals are (m, m): mb × mb blocks)."""
    m, _ = a_shape
    mb = m // bk
    if k_resid is None:
        rho = 0.7
        k_resid = [
            max(int(round(mb * 0.5 * rho ** (ell - 1))), min(2, mb))
            for ell in range(1, n_factors)
        ]
    # a per-line budget on the A side that maps to per-block-column on the
    # chain side
    kind = "blockrow" if transpose else "blockcol"
    key = "k_per_row" if transpose else "k_per_col"
    factor_projs, resid_projs = [], []
    for ell in range(1, n_factors):
        kf = k_first if ell == 1 else k_mid
        factor_projs.append(P.make_proj(kind, bm=bk, bn=bn, **{key: kf}))
        resid_projs.append(P.make_proj(kind, bm=bk, bn=bn, **{key: int(k_resid[ell - 1])}))
    return HierarchicalSpec(
        tuple(factor_projs),
        tuple(resid_projs),
        (m,) * (n_factors - 1),
        n_iter_two=n_iter_two,
        n_iter_global=n_iter_global,
    )


def _faust_to_blockfaust(
    faust: Faust, transpose: bool, bk: int, bn: int, in_f: int, out_f: int
) -> BlockFaust:
    """Map A = S_J ... S_1 to the right-multiply packed chain on the padded W:
    ``transpose=True``: W = Aᵀ, F_i = S_iᵀ; ``transpose=False``: W = A,
    F_i = S_{J+1-i}.  Each factor packs losslessly (k = its most live
    blocks in any output block-column)."""
    if transpose:
        dense_chain = [s.T for s in faust.factors]
    else:
        dense_chain = list(reversed(faust.factors))
    packed = [pack_dense(f, bk, bn, _max_blocks_per_outcol(f, bk, bn)) for f in dense_chain]
    packed[0] = dataclasses.replace(packed[0], in_features=in_f)
    packed[-1] = dataclasses.replace(packed[-1], out_features=out_f)
    return BlockFaust(tuple(packed), faust.lam)


def _max_blocks_per_outcol(f: torch.Tensor, bk: int, bn: int) -> int:
    _, energy = _outcol_block_energy(f, bk, bn)
    return max(int((energy > 0).sum(dim=1).max()), 1)
