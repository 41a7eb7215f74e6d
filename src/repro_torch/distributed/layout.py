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
  :meth:`SeqSplit.scatter` is its mirror: a whole sequence of partial sums
  (a MoE layer's output from the rank's experts or columns) summed over
  the group to the rank's chunk, an all-gather backward.
* **Tensor parallelism** (:class:`TPSplit`): where the policy computes a
  module in blocks over axes ``A`` (:func:`~repro_torch.distributed.
  sharding.compute_axes`), the ranks on ``A`` hold the same rows and each
  computes its block of heads, hidden columns or vocabulary with its
  parameter blocks (:func:`gather_param` with ``keep=A``).  The module's
  input enters through :meth:`TPSplit.enter` (identity forward; the
  gradient's blocks summed over ``A`` backward), a row-parallel
  projection's partial output leaves through :meth:`TPSplit.reduce`
  (summed over ``A`` forward, identity backward); a value each rank
  computes a part of from its own columns (a mamba block's gated norm's
  sum of squares) through :meth:`TPSplit.total` (summed over ``A`` both
  ways: each rank's cotangent differs); a MoE layer split over its
  experts or their width enters and leaves the same way, counted under
  purposes of its own; the logits stay split:
  :func:`vocab_cross_entropy`, :func:`vocab_argmax` and
  :func:`vocab_lookup` work on the blocks.
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
# norms, EF's selection, the preemption flag); serving's merges and
# gathers; a tensor-parallel split's (TPSplit): the column-parallel input's
# backward all-reduce, the row-parallel output's all-reduce, the
# vocab-parallel cross entropy's and greedy pick's all-reduces, a split
# mamba block's norm sums (forward and backward), a split FAµST head's
# boundary all-gathers and their backward reduce-scatters, and a split MoE
# layer's: its partial output summed (an all-reduce on whole rows, a
# reduce-scatter to the rank's positions under a sequence split), that
# sum's backward all-gather, and its input's backward all-reduce
COLLECTIVES = dict.fromkeys(
    ("param_gather", "grad_reduce_scatter", "grad_all_reduce", "seq_gather", "seq_reduce_scatter", "sum",
     "kv_merge", "row_gather", "embed_lookup", "tp_input_grad", "tp_output", "vocab_ce", "vocab_pick",
     "tp_norm", "tp_norm_grad", "head_boundary_gather", "head_boundary_reduce_scatter", "moe_combine",
     "moe_combine_grad", "moe_input_grad"), 0)
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


def _layout(block: Block, mesh, keep) -> tuple:
    """How the blocks of a parameter tile what a rank computes with: the
    mesh axes of more than one rank it is gathered over (those its spec
    names less ``keep``, in mesh order: the rank order of their group),
    the gathered tensor's dimensions cut into (those axes' sizes in each
    dimension's spec entry, the block's extent), and the permutation that
    takes the gathered ``(axis sizes..., block dims...)`` to that cut."""
    axes = tuple(a for a in mesh.axis_names if a in block.axes and mesh.shape[a] > 1 and a not in keep)
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
    """A parameter's block → what the rank computes with (module
    docstring): one all-gather of the flat block over the group of the
    axes its spec names less ``keep``, the blocks tiled on the device.
    The backward sums the gradient over the ranks that computed with the
    same tensor on other rows, positions or heads, and keeps the rank's
    block: a reduce-scatter over the gathered axes, an all-reduce over the
    axes the spec does not name.  Over ``whole`` (the axes whose ranks
    cooperate on one computation, each holding this parameter's whole
    gradient already) it sums nothing: a gathered axis there takes the
    rank's tile."""

    @staticmethod
    def forward(ctx, t, block: Block, mesh, keep, whole):
        ctx.block, ctx.mesh, ctx.keep, ctx.whole = block, mesh, keep, whole
        axes, _, order = _layout(block, mesh, keep)
        if not axes:
            return t.view_as(t)
        parts = _mesh.all_gather(t.contiguous().reshape(1, -1), mesh.group(axes), 0)
        _count("param_gather", parts)
        tiles = parts.reshape(*[mesh.shape[a] for a in axes], *block.shape)
        shape = [n * math.prod(mesh.shape[a] for a in axes_tuple(ax) if a in axes)
                 for n, ax in zip(block.shape, block.spec)]
        return tiles.permute(order).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        block, mesh, keep, whole = ctx.block, ctx.mesh, ctx.keep, ctx.whole
        axes, dims, order = _layout(block, mesh, keep)
        if axes:
            back = [order.index(j) for j in range(len(order))]
            tiles = g.reshape(dims).permute(back)  # (gathered axes' sizes..., block dims...)
            for j in reversed(range(len(axes))):
                if axes[j] in whole:  # every rank holds the whole gradient: its tile, no sum
                    tiles = tiles.select(j, mesh.coord[axes[j]])
            summed = tuple(a for a in axes if a not in whole)
            if summed:
                tiles = tiles.reshape(math.prod(mesh.shape[a] for a in summed), -1).contiguous()
                g = _mesh.reduce_scatter(tiles, mesh.group(summed), 0).reshape(block.shape)
                _count("grad_reduce_scatter", g)
            else:
                g = tiles.reshape(block.shape)
        rest = tuple(a for a in mesh.axis_names if a not in block.axes and a not in whole and mesh.shape[a] > 1)
        if rest:
            g = _mesh.all_reduce(g.contiguous(), mesh.group(rest))
            _count("grad_all_reduce", g)
        return g, None, None, None, None


def gather_param(t: torch.Tensor, block: Block, mesh, keep=(), whole=()) -> torch.Tensor:
    """The parameter of which ``t`` is this rank's ``block``, gathered
    over every axis its spec names but ``keep`` (the axes the rank
    computes its block over: :func:`~repro_torch.distributed.sharding.
    compute_axes`); its gradient summed over the mesh but ``whole`` (the
    axes of a tensor-parallel computation over which this parameter's
    gradient is whole on every rank, :class:`TPSplit`), this rank's block
    kept."""
    return _GatherParam.apply(t, block, mesh, tuple(keep), tuple(whole))


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

    def scatter(self, t: torch.Tensor, dim: int = 1, dtype=None) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the group's sum of ``t``, a
        whole sequence of partial sums, rounded to ``dtype`` (default:
        ``t``'s) once summed; the backward gathers the chunks' cotangents
        whole on every rank, in ``dtype`` (:class:`_SeqScatter`)."""
        return _SeqScatter.apply(t, self.group, dim, dtype or t.dtype)


class _SeqScatter(torch.autograd.Function):
    """A MoE layer's output from the rank's experts or columns, whole
    positions: one reduce-scatter (sum, in ``t``'s dtype) to the rank's
    chunk forward, rounded to ``dtype``; the chunks' cotangents
    all-gathered backward in ``dtype`` (each rank's partial output enters
    the sum with weight one, so it takes the whole cotangent)."""

    @staticmethod
    def forward(ctx, t, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, t.dtype
        out = _mesh.reduce_scatter(t.contiguous(), group, dim)
        _count("moe_combine", out)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        g = _mesh.all_gather(g.contiguous(), ctx.group, ctx.dim)
        _count("moe_combine_grad", g)
        return g.to(ctx.dtype), None, None, None


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


class _EnterSplit(torch.autograd.Function):
    """The column-parallel input: identity forward; every rank's block of
    the input's gradient summed over the split's group backward (counted
    under ``purpose``)."""

    @staticmethod
    def forward(ctx, x, group, purpose):
        ctx.group, ctx.purpose = group, purpose
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _mesh.all_reduce(g.contiguous(), ctx.group)
        _count(ctx.purpose, g)
        return g, None, None


class _LeaveSplit(torch.autograd.Function):
    """The row-parallel output: the partial products summed over the
    split's group forward (in f32 for a narrower float; counted under
    ``purpose``); identity backward (every rank holds the whole
    cotangent)."""

    @staticmethod
    def forward(ctx, y, group, purpose):
        y = _mesh.all_reduce(y.contiguous(), group)
        _count(purpose, y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ProjectF32(torch.autograd.Function):
    """A row-parallel projection ``x @ w`` whose partial products are
    summed in f32 under autograd too (:meth:`TPSplit.project` with
    ``f32_sum``), rounded once to ``x``'s dtype; the backward is the
    product's own (``dx = g·wᵀ``, ``dw = xᵀ·g``).  ``x`` and ``w`` are held
    on ``ctx``, not saved for backward: a remat recompute stops after the
    last saved tensor, so it stops before this product as before a plain
    one (saving them would rerun the product there), and ``x`` outlives
    the forward instead."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.x, ctx.w = x, w
        y = _mesh.all_reduce(_partial_f32(x, w).contiguous(), group)
        _count("tp_output", y)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.x, ctx.w
        g = g.to(x.dtype)
        dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return g @ w.t(), dw, None


class _SplitTotal(torch.autograd.Function):
    """A value every rank of the split computes a part of from its own
    columns: the parts summed over the split's group forward; the
    cotangents summed over it backward, since each rank's columns use the
    total in their own way (unlike :class:`_LeaveSplit`'s output, whose
    cotangent every rank holds whole)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = _mesh.all_reduce(t.contiguous(), group)
        _count("tp_norm", t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = _mesh.all_reduce(g.contiguous(), ctx.group)
        _count("tp_norm_grad", g)
        return g, None


def _partial_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of narrow floats, its result in f32: one f32-accumulating
    matmul on the card (``mm`` with ``out_dtype``, which has no
    derivative), the narrow values' products in f32 elsewhere."""
    if x.is_cuda or library.faking():
        y = torch.ops.aten.mm.dtype(x.reshape(-1, x.shape[-1]), w, torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


@dataclasses.dataclass(frozen=True)
class TPSplit:
    """A module computed in blocks over the mesh axes ``axes`` of ``mesh``
    (module docstring): ``n`` ranks (group ``group``), this one's block
    ``index``."""

    mesh: object
    axes: tuple
    group: object
    n: int
    index: int

    def enter(self, x: torch.Tensor, purpose: str = "tp_input_grad") -> torch.Tensor:
        """``x`` as the input of column-parallel projections."""
        return _EnterSplit.apply(x, self.group, purpose)

    def reduce(self, y: torch.Tensor, purpose: str = "tp_output") -> torch.Tensor:
        """A row-parallel projection's partial output, summed."""
        return _LeaveSplit.apply(y, self.group, purpose)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, this rank's part of a sum over the split's columns (a
        norm's sum of squares), summed over the split both ways
        (:class:`_SplitTotal`)."""
        return _SplitTotal.apply(t, self.group)

    def project(self, x: torch.Tensor, w: torch.Tensor, f32_sum: bool = False) -> torch.Tensor:
        """The row-parallel projection ``x @ w`` (this rank's columns of
        ``x``, rows of ``w``) summed over the split.  Outside autograd
        (serving) a narrower float's partial products stay in f32
        (:func:`_partial_f32`) and the caller rounds their sum once, as
        the whole product rounds: a bf16 model split over the hidden width
        serves the whole model's greedy tokens.  Under autograd each
        partial rounds to the activations' dtype before the sum (``mm``
        with ``out_dtype`` has no derivative), unless ``f32_sum``
        (:class:`_ProjectF32`, which keeps ``x`` alive to the backward: a
        mamba block's ``out_proj``, whose bf16 partials moved a split
        zamba2's loss 3.3e-5 from the whole model's, 1.3e-5 summed in
        f32, on the H100)."""
        narrow = x.is_floating_point() and x.element_size() < 4
        if narrow and f32_sum and torch.is_grad_enabled():
            return _ProjectF32.apply(x, w, self.group)
        if narrow and not torch.is_grad_enabled():
            return self.reduce(_partial_f32(x, w))
        return self.reduce(x @ w)


def tp_split(mesh, axes) -> TPSplit:
    """The split over ``axes`` of ``mesh`` (on an
    :class:`~repro_torch.distributed.mesh.AbstractMesh`, rank 0's, with no
    group)."""
    axes = _ordered(mesh, axes_tuple(axes))
    ranks = isinstance(mesh, _mesh.Mesh)
    return TPSplit(mesh, axes, mesh.group(axes) if ranks else None, math.prod(mesh.shape[a] for a in axes),
                   mesh.index(axes) if ranks else 0)


class _ShareValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        return t / n

    @staticmethod
    def backward(ctx, g):
        return g, None


def share_value(t: torch.Tensor, n: int) -> torch.Tensor:
    """A loss share that every rank of a split computes whole: its value
    divided by the split's ``n`` ranks (so the sum over the mesh counts it
    once), its gradient the share's own (each rank backpropagates into its
    own blocks)."""
    return _ShareValue.apply(t, n)


def part_value(t: torch.Tensor, n: int) -> torch.Tensor:
    """A loss share that every rank of a split computes whole and whose
    gradient flows into tensors summed over the split (a MoE layer's aux
    loss: into the router, whose gradient is summed over its experts'
    ranks, and into the layer's input, whose cotangent is too): value and
    gradient divided by the split's ``n`` ranks, so the sums count it
    once."""
    return t / n


class _VocabCE(torch.autograd.Function):
    """Cross entropy over logits split by vocabulary (whole with no
    group): ``lse - gold`` of every position, the same on every rank of
    the split.  Forward: the block's max, all-reduced (max); the block's
    sum of exponentials and the gold logit (where the label falls in the
    block, else 0), one all-reduce (sum).  Backward: ``g · (softmax −
    one-hot)`` on the block, its exponentials recomputed against the saved
    log-sum-exp.  Each way one buffer the size of the logits (autograd of
    ``logsumexp − gather`` holds four in the backward)."""

    @staticmethod
    def forward(ctx, lg, labels, start, group):
        m = lg.amax(dim=-1)
        if group is not None:
            m = reduce_over(m, group, "max", "vocab_ce")
        local = labels - start
        inside = (local >= 0) & (local < lg.shape[-1])
        idx = local.clamp(0, lg.shape[-1] - 1)
        gold = torch.where(inside, torch.gather(lg, -1, idx[..., None])[..., 0], torch.zeros((), dtype=lg.dtype,
                                                                                            device=lg.device))
        se = torch.sub(lg, m[..., None]).exp_().sum(dim=-1)
        both = torch.stack([se, gold])
        if group is not None:
            both = reduce_over(both, group, "sum", "vocab_ce")
        lse = m + torch.log(both[0])
        ctx.save_for_backward(lg, lse, idx, inside)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        lg, lse, idx, inside = ctx.saved_tensors
        d = torch.sub(lg, lse[..., None]).exp_()
        d.scatter_add_(-1, idx[..., None], -inside[..., None].to(d.dtype))
        return d.mul_(g[..., None]), None, None, None


def vocab_cross_entropy(lg: torch.Tensor, labels: torch.Tensor, start: int = 0,
                        split: TPSplit | None = None) -> torch.Tensor:
    """``logsumexp − gold`` of every position of logits ``lg (..., V/n)``,
    this rank's vocabulary block ``[start, start + V/n)`` of ``split``
    (None: the whole vocabulary, no collective), against ``labels
    (...)``: the whole row's cross entropy on every rank of the split, and
    the block's gradient."""
    return _VocabCE.apply(lg, labels, start, None if split is None else split.group)


def vocab_argmax(logits: torch.Tensor, start: int, split: TPSplit) -> torch.Tensor:
    """``argmax`` over the last dimension of logits split by vocabulary
    (this rank's block starts at ``start``), the same on every rank of
    ``split``: the max over the split, then the lowest index holding it,
    so ties resolve as ``torch.argmax`` over the whole row does."""
    local = logits.argmax(dim=-1)
    best = torch.gather(logits, -1, local[..., None])[..., 0]
    top = reduce_over(best, split.group, "max", "vocab_pick")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(best == top, local + start, torch.full_like(local, big))
    return -reduce_over(-cand, split.group, "max", "vocab_pick")


class _VocabLookup(torch.autograd.Function):
    """Rows of a table split by vocabulary: the block's rows of the tokens
    inside it, zeros for the others, summed over the split (each token's
    row comes from one rank, bit for bit); the backward scatters the
    whole cotangent into the block's rows."""

    @staticmethod
    def forward(ctx, table, ids, start, group):
        local = ids - start
        inside = (local >= 0) & (local < table.shape[0])
        idx = local.clamp(0, table.shape[0] - 1)
        ctx.save_for_backward(idx, inside)
        ctx.rows = table.shape[0]
        rows = torch.where(inside[..., None], table[idx], torch.zeros((), dtype=table.dtype, device=table.device))
        out = _mesh.all_reduce(rows.contiguous(), group)
        _count("tp_output", out)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype, device=g.device)
        grad.index_add_(0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
        return grad, None, None, None


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, start: int, split: TPSplit) -> torch.Tensor:
    """``table[tokens]`` (``(*tokens.shape, d)``) from this rank's
    vocabulary block ``table`` (rows ``[start, start + len)``, whole
    features) of ``split``, under autograd: the row-parallel output of a
    one-hot product (module docstring)."""
    return _VocabLookup.apply(table, tokens.long(), start, split.group)


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
