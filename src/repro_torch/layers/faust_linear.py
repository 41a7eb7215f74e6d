"""FaustLinear: the paper's technique as a trainable linear layer.
Counterpart of :mod:`repro.layers.faust_linear`.

The weight ``W (in, out)`` is a FAµST chain of J block-sparse factors with
prescribed random block supports (the paper's fixed-support constraint
set): per factor the block ``values`` are an ``nn.Parameter`` and the
support ``in_idx`` a buffer (indices get no gradient and no optimizer
state), and λ is a parameter.  Every forward builds the operator afresh
from the live parameters and applies it through
:meth:`repro_torch.api.FaustOp.apply`, as the reference builds a
``FaustOp`` from its params on every apply: ``auto`` dispatch prices the
training apply, the fused backend packs the live values (its backward runs
the chain backward kernels), and an optimizer step is seen by the next
forward.  :class:`StackedFaustLinear` holds ``n`` such projections of one
layout stacked on a leading axis (musicgen's per-codebook heads, as the
reference stacks them) and applies one of them at a time, each its own
chain.  A spec may carry a :class:`~repro_torch.api.operator.ShardSpec`
(``FaustSpec.shard``, or ``shard=`` on a forward, which overrides it):
every apply through the layer is then on the mesh (``fused_sharded``
joins the dispatch candidates), each rank applying the layer to the same
input and getting the whole result, and :func:`factorize_spec` places
compressed layers.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.compress import BlockFaust, BlockSparseFactor, random_block_factor
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FaustSpec:
    """Static layout of a FAµST projection: ``n_factors`` J, square
    ``block`` side, ``k`` kept blocks per output block-column per factor;
    ``shard`` an optional mesh placement (a ``ShardSpec``)."""

    n_factors: int = 2
    block: int = 128
    k: int = 4
    shard: object = None

    def chain_dims(self, in_dim: int, out_dim: int) -> list[int]:
        inner = min(in_dim, out_dim)
        inner = -(-inner // self.block) * self.block  # round up to a block
        return [in_dim] + [inner] * (self.n_factors - 1) + [out_dim]

    def s_tot(self, in_dim: int, out_dim: int) -> int:
        dims = self.chain_dims(in_dim, out_dim)
        tot = 0
        for i in range(self.n_factors):
            ob = -(-dims[i + 1] // self.block)
            k = min(self.k, -(-dims[i] // self.block))
            tot += ob * k * self.block * self.block
        return tot

    def rcg(self, in_dim: int, out_dim: int) -> float:
        return in_dim * out_dim / self.s_tot(in_dim, out_dim)


def factorize_spec(spec: FaustSpec, n_iter_two: int = 40, n_iter_global: int = 40):
    """The :class:`repro_torch.api.factorize.FactorizeSpec` that compresses
    a dense weight into this layer's chain layout (the block route with
    ``k_first = k_mid = spec.k``), placed on ``spec.shard``'s mesh when it
    has one."""
    from repro_torch.api.factorize import FactorizeSpec

    sh = spec.shard
    return FactorizeSpec(
        strategy="hierarchical",
        n_factors=spec.n_factors,
        block=spec.block,
        k_first=spec.k,
        k_mid=spec.k,
        n_iter_two=n_iter_two,
        n_iter_global=n_iter_global,
        mesh=sh.mesh if sh is not None else None,
        data_axis=sh.data_axis if sh is not None else "data",
        model_axis=sh.model_axis if sh is not None else "model",
    )


class _Factor(nn.Module):
    def __init__(self, values: torch.Tensor, in_idx: torch.Tensor, in_features: int, out_features: int):
        super().__init__()
        self.values = nn.Parameter(values)
        self.register_buffer("in_idx", in_idx)
        self.in_features, self.out_features = in_features, out_features


def _supports_generator(generator: torch.Generator) -> torch.Generator:
    """A CPU generator seeded from ``generator``: the supports are drawn on the CPU."""
    if generator.device.type == "cpu":
        return generator
    seed = torch.randint(2**62, (1,), generator=generator, device=generator.device)
    return torch.Generator().manual_seed(int(seed))


class FaustLinear(nn.Module):
    """``y = x @ (λ · F_1 ⋯ F_J)`` for ``x (..., in_dim)``.  State dict keys
    mirror the reference's param tree: ``factors.{i}.values``,
    ``factors.{i}.in_idx``, ``lam``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        spec: FaustSpec,
        *,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
        device=None,
        backend: str = "auto",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim, self.out_dim, self.spec, self.backend = in_dim, out_dim, spec, backend
        dims = spec.chain_dims(in_dim, out_dim)
        generator = _supports_generator(generator)
        factors = []
        for i in range(spec.n_factors):
            f = random_block_factor(dims[i], dims[i + 1], spec.block, spec.block, spec.k,
                                    generator=generator, dtype=dtype, device=dev)
            factors.append(_Factor(f.values, f.in_idx, f.in_features, f.out_features))
        self.factors = nn.ModuleList(factors)
        self.lam = nn.Parameter(torch.ones((), dtype=dtype, device=dev))

    def blockfaust(self) -> BlockFaust:
        """The chain on the live parameters (no copy)."""
        return BlockFaust(
            tuple(BlockSparseFactor(f.values, f.in_idx, f.in_features, f.out_features) for f in self.factors),
            self.lam,
        )

    def forward(self, x: torch.Tensor, backend: str | None = None, shard=None) -> torch.Tensor:
        """``x @ W`` on ``backend`` (default: the layer's); ``shard``
        overrides ``spec.shard`` for this call."""
        return self._apply_chain(self.blockfaust(), x, backend, shard)

    def _apply_chain(self, bf: BlockFaust, x: torch.Tensor, backend: str | None, shard=None) -> torch.Tensor:
        from repro_torch.api.operator import FaustOp

        op = FaustOp(bf, shard=shard if shard is not None else self.spec.shard)
        return op.apply(x, backend or self.backend, device=x.device)


class StackedFaustLinear(FaustLinear):
    """``n`` projections ``y = x @ (λ_h · F_h1 ⋯ F_hJ)`` of one layout,
    stacked: ``factors.{i}.values (n, O, K, blk, blk)``,
    ``factors.{i}.in_idx (n, O, K)`` and ``lam (n,)``, the reference's
    stacked parameter tree (``stack_annotated`` of ``n`` inits).  Head
    ``h`` is applied on its own chain, views of the stacked tensors."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        spec: FaustSpec,
        n: int,
        *,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
        device=None,
        backend: str = "auto",
    ):
        nn.Module.__init__(self)
        dev = resolve_device(device)
        self.in_dim, self.out_dim, self.spec, self.backend, self.n = in_dim, out_dim, spec, backend, n
        dims = spec.chain_dims(in_dim, out_dim)
        generator = _supports_generator(generator)
        heads = [[random_block_factor(dims[i], dims[i + 1], spec.block, spec.block, spec.k,
                                      generator=generator, dtype=dtype, device=dev)
                  for i in range(spec.n_factors)] for _ in range(n)]
        self.factors = nn.ModuleList(
            _Factor(torch.stack([h[i].values for h in heads]), torch.stack([h[i].in_idx for h in heads]),
                    dims[i], dims[i + 1])
            for i in range(spec.n_factors)
        )
        self.lam = nn.Parameter(torch.ones((n,), dtype=dtype, device=dev))

    def blockfaust(self, head: int) -> BlockFaust:
        """Head ``head``'s chain on views of the live parameters (no copy)."""
        return BlockFaust(
            tuple(BlockSparseFactor(f.values[head], f.in_idx[head], f.in_features, f.out_features)
                  for f in self.factors),
            self.lam[head],
        )

    def forward(self, x: torch.Tensor, head: int, backend: str | None = None, shard=None) -> torch.Tensor:
        return self._apply_chain(self.blockfaust(head), x, backend, shard)
