"""What a rank holds and computes when the model trains on a mesh, and the
collectives that move it, as autograd Functions.

* **Parameters** are stored as each rank's :class:`~repro_torch.distributed.
  sharding.Block`.  :func:`gather_param` gathers one whole, in its dtype,
  over the axes its spec names (one all-gather of the flat blocks, tiled
  on the device), for the layer about to run.  Every rank
  then uses the whole weight on its own rows or positions, so the
  backward sums the gradient over **every** rank of the mesh and keeps the
  rank's block: one reduce-scatter over the axes the spec names, then an
  all-reduce over the axes it does not name (a replicated
  parameter's gradient is summed over the whole mesh).  An axis of one
  rank moves nothing: on a 1 × 1 mesh no parameter collective runs.
* **Positions**: under a sequence split (:class:`SeqSplit`) a rank holds a
  contiguous chunk of every row's positions.  :meth:`SeqSplit.gather`
  rebuilds the whole sequence (attention's keys and values, a MoE layer's
  input); its backward is a reduce-scatter (sum) over the sequence group.
* :func:`sum_over` is an all-reduce of a value every rank computed a part
  of (the loss, squared norms, counts), outside autograd.
* Serving (``runtime/engine.py`` ``LMExecutor`` on a mesh): :func:`reduce_over`
  merges the blocks of a split KV cache (``"kv_merge"``: a max, then a
  sum) and gathers each step's sampled tokens and finite flags over the
  rows' axes (``"row_gather"``); :func:`embed_lookup` looks tokens up in
  an embedding table split by vocabulary and features without gathering
  it (``"embed_lookup"``).

:data:`COLLECTIVES` counts the calls by purpose and :data:`BYTES` the
bytes of their results on the rank (a gathered parameter whole, a reduced
tensor once); tests and ``chip_smoke.py`` read them.  The transport is :mod:`repro_torch.distributed.
mesh`'s (NCCL on cards, ``gloo`` on the CPU or staged through host memory).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import mesh as _mesh
from repro_torch.distributed.sharding import Block, axes_tuple
from repro_torch.kernels import library

# collective calls by purpose: a parameter's gather, its gradient's
# reduce-scatter and all-reduce; the sequence gathers (attention's K/V, a
# MoE layer's input) and their reduce-scatters; the scalar sums (loss,
# norms, EF's selection, the preemption flag)
COLLECTIVES = dict.fromkeys(
    ("param_gather", "grad_reduce_scatter", "grad_all_reduce", "seq_gather", "seq_reduce_scatter", "sum",
     "kv_merge", "row_gather", "embed_lookup"), 0)
BYTES = dict.fromkeys(COLLECTIVES, 0)
_OPS = {"sum": torch.distributed.ReduceOp.SUM, "max": torch.distributed.ReduceOp.MAX}


def _count(purpose: str, t: torch.Tensor) -> None:
    COLLECTIVES[purpose] += 1
    BYTES[purpose] += t.numel() * t.element_size()


def _ordered(mesh, ax) -> tuple[str, ...]:
    """The axes of one spec entry, which must be in mesh order (the rank
    order of :meth:`Mesh.group`)."""
    ax_t = axes_tuple(ax)
    if ax_t != tuple(a for a in mesh.axis_names if a in ax_t):
        raise ValueError(f"spec entry {ax} is not in the mesh's axis order {mesh.axis_names}")
    return ax_t


def _layout(block: Block, mesh) -> tuple:
    """How the blocks of a parameter tile it: the mesh axes of more than
    one rank it is split over (mesh order: the rank order of their group),
    the whole tensor's dimensions cut into (those axes' sizes in each
    dimension's spec entry, the block's extent), and the permutation that
    takes the gathered ``(axis sizes..., block dims...)`` to that cut."""
    axes = tuple(a for a in mesh.axis_names if a in block.axes and mesh.shape[a] > 1)
    dims, order = [], []
    for i, ax in enumerate(block.spec):
        for a in _ordered(mesh, ax):
            if a in axes:
                dims.append(mesh.shape[a])
                order.append(axes.index(a))
        dims.append(block.shape[i])
        order.append(len(axes) + i)
    return axes, dims, order


class _GatherParam(torch.autograd.Function):
    """A parameter's block → the whole parameter (module docstring): one
    all-gather of the flat block over the group of every axis its spec
    names, the blocks tiled on the device; the backward's reduce-scatter
    takes the whole gradient cut the same way."""

    @staticmethod
    def forward(ctx, t, block: Block, mesh):
        ctx.block, ctx.mesh = block, mesh
        axes, _, order = _layout(block, mesh)
        if not axes:
            return t.view_as(t)
        parts = _mesh.all_gather(t.contiguous().reshape(1, -1), mesh.group(axes), 0)
        _count("param_gather", parts)
        tiles = parts.reshape(*[mesh.shape[a] for a in axes], *block.shape)
        return tiles.permute(order).reshape(block.global_shape)

    @staticmethod
    def backward(ctx, g):
        block, mesh = ctx.block, ctx.mesh
        axes, dims, order = _layout(block, mesh)
        if axes:
            back = [order.index(j) for j in range(len(order))]
            tiles = g.reshape(dims).permute(back).reshape(math.prod(mesh.shape[a] for a in axes), -1)
            g = _mesh.reduce_scatter(tiles.contiguous(), mesh.group(axes), 0).reshape(block.shape)
            _count("grad_reduce_scatter", g)
        rest = tuple(a for a in mesh.axis_names if a not in axes and mesh.shape[a] > 1)
        if rest:
            g = _mesh.all_reduce(g.contiguous(), mesh.group(rest))
            _count("grad_all_reduce", g)
        return g, None, None


def gather_param(t: torch.Tensor, block: Block, mesh) -> torch.Tensor:
    """The whole parameter of which ``t`` is this rank's ``block``; its
    gradient summed over the mesh, this rank's block kept."""
    return _GatherParam.apply(t, block, mesh)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        out = _mesh.all_gather(t.contiguous(), group, dim)
        _count("seq_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = _mesh.reduce_scatter(g.contiguous(), ctx.group, ctx.dim)
        _count("seq_reduce_scatter", g)
        return g, None, None


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A rank's chunk of the positions: ``[start, start + local)`` of
    ``length``, the chunk ``index`` of ``n`` over the mesh axes ``axes``
    (whose process group is ``group``)."""

    axes: tuple
    group: object
    n: int
    index: int
    length: int

    @property
    def local(self) -> int:
        return self.length // self.n

    @property
    def start(self) -> int:
        return self.index * self.local

    def positions(self, device) -> torch.Tensor:
        return torch.arange(self.start, self.start + self.local, device=device)

    def gather(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence along ``dim`` from every rank's chunk; the
        backward sums the cotangent over the group and keeps this chunk."""
        return _SeqGather.apply(t, self.group, dim)

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's chunk of a whole sequence along ``dim``."""
        return t.narrow(dim, self.start, self.local)


def seq_split(mesh, axes, length: int) -> SeqSplit | None:
    """The split of ``length`` positions over ``axes`` of ``mesh`` (None
    where the axes hold one rank: no split)."""
    axes = _ordered(mesh, axes_tuple(axes))
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return None
    if length % n:
        raise ValueError(f"{length} positions do not split over {axes} ({n} ranks)")
    return SeqSplit(axes, mesh.group(axes), n, mesh.index(axes), length)


def sum_over(t: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes`` (default: the whole mesh),
    outside autograd."""
    return reduce_over(t, mesh.group(tuple(mesh.axis_names) if axes is None else axes))


def reduce_over(t: torch.Tensor, group, op: str = "sum", purpose: str = "sum") -> torch.Tensor:
    """``t`` reduced by ``op`` (``"sum"`` or ``"max"``) over the ranks of
    ``group``, outside autograd, counted under ``purpose``."""
    _count(purpose, t)
    return _mesh.all_reduce(t.detach().contiguous(), group, _OPS[op])


def take_block(t: torch.Tensor, block: Block) -> torch.Tensor:
    """``block`` of the whole tensor ``t`` (a view)."""
    for dim, (o, n) in enumerate(zip(block.offset, block.shape)):
        if n != t.shape[dim]:
            t = t.narrow(dim, o, n)
    return t


def embed_lookup(tokens: torch.Tensor, t: torch.Tensor, block: Block, mesh) -> torch.Tensor:
    """``table[tokens]`` (``tokens`` any shape, the result ``(*tokens.shape,
    d)``) from this rank's ``block`` ``t`` of a 2-D ``(vocab, d)`` table
    split by vocabulary (``block.spec[0]``) and features
    (``block.spec[1]``), outside autograd, without gathering the table:

    1. every rank's tokens are gathered over the table's axes (ranks may
       hold other rows or positions, and other counts of them);
    2. each rank looks them up in its vocabulary block, zeros for a token
       outside it, and the rows are summed over the vocabulary axes: one
       value and zeros, so each is the table's entry bit for bit;
    3. the feature blocks are gathered and the rank keeps its tokens' rows.

    Moves every rank's token ids and their rows of ``d`` features, where
    :func:`gather_param` moves the whole table."""
    vocab = tuple(a for a in _ordered(mesh, block.spec[0]) if mesh.shape[a] > 1)
    feats = tuple(a for a in _ordered(mesh, block.spec[1]) if mesh.shape[a] > 1)
    axes = tuple(a for a in mesh.axis_names if a in vocab + feats)
    ids = tokens.reshape(-1).long()
    n = ids.shape[0]
    if axes:
        group = mesh.group(axes)
        sizes = _mesh.all_gather(torch.tensor([n], device=ids.device), group, 0)
        _count("embed_lookup", sizes)
        # a dry run's fake sizes hold no data; its ranks all hold the cell's rows
        widest = sizes.max()
        width = n if library.faking() else int(widest)
        ids = _mesh.all_gather(torch.nn.functional.pad(ids, (0, width - n), value=-1)[None], group, 0).reshape(-1)
        _count("embed_lookup", ids)
    local = ids - block.offset[0]
    inside = (local >= 0) & (local < t.shape[0])
    rows = torch.where(inside[:, None], t[local.clamp(0, t.shape[0] - 1)], torch.zeros((), dtype=t.dtype, device=t.device))
    if vocab:
        rows = reduce_over(rows, mesh.group(vocab), "sum", "embed_lookup")
    if feats:
        rows = _mesh.all_gather(rows.contiguous(), mesh.group(feats), 1)
        _count("embed_lookup", rows)
    if axes:
        start = mesh.index(axes) * width
        rows = rows[start:start + n]
    return rows.reshape(*tokens.shape, rows.shape[-1])
