"""Mesh-sharded fused FAµST chain apply.  Counterpart of
:mod:`repro.kernels.chain_sharded`; it has no kernel of its own: each
rank runs the fused chain kernels on its shard.

The block-diagonal-plus-permutation structure of FAµST factors partitions
by *output block* over a ``"model"`` mesh axis, and the batch over
``"data"``:

* every factor's ``(O_j, K_j, blk, blk)`` value blocks are split
  contiguously by out-block over the ``n_model`` model ranks, so each rank
  streams ``s_tot / n_model`` weight bytes an apply;
* the activation between factors is split by the same out-block ranges.  A
  factor whose input blocks (``in_idx``) all lie in its own rank's range
  needs no communication: the chain runs on in one fused launch (K1,
  ``kernels/chain.py``; K4 on a quantized chain's codes).  Where the
  support *crosses* ranks the chain is cut into segments, and an
  all-gather over ``"model"`` rebuilds the whole activation at exactly
  that boundary;
* the batch is split over ``"data"``, with no collective on that axis in
  the forward.

:func:`plan_shard` decides on the host from block counts and ``in_idx``.
When the out-block counts do not divide ``n_model``, or a ragged feature
width would make the ranks' step tables differ, the plan falls back to
**replicated** weights with the batch split over every fitting axis
(``repro_torch.distributed.sharding._fit_axes``): sharding degrades, it
never errors.  A replicated chain that does not pack (non-uniform blocks,
a non-contiguous boundary) runs per factor through the ``bsr`` backend's
apply (K6 on the card, its plain version on the CPU), where the reference
runs its plain ``jnp`` chain even with ``use_kernel=True``.

**Backward.** Each segment runs under the fused chain's autograd Function
(``kernels/ops.py`` ``_ChainFn``, ``_ChainQFn``), so its backward is K2 +
K3 (K5 on codes) on the rank's shard.  The reference's JAX transposes the
collectives implicitly; here each is explicit:

* a boundary all-gather's backward is a reduce-scatter (sum) of the
  boundary cotangent over the model group;
* ``x`` enters the first segment whole on every model rank, and each reads
  all of it for its own out-blocks: its gradient is summed over the model
  group (an identity forward, an all-reduce backward), then the data
  shards' rows are gathered;
* the values and scales are replicated over the data axis: their shard's
  gradient is summed over the data group, then the model ranks' shards
  are gathered, so every rank holds the whole gradient;
* ``lam`` scales every rank's part of the result: its gradient is summed
  over the mesh.

**What the apply returns, and what a rank holds** (``ROADMAP.md`` caveat
R7).  The reference returns one global array sharded ``P(data, model)``.
The port gathers the result whole on every rank (over the model group,
then the data group), the batch unpadded and shaped as ``x`` was; that
gather's backward takes each rank's own block of the (replicated)
cotangent.  Its bytes are :meth:`ShardPlan.gather_bytes`, priced by the
dispatch model beside the boundary bytes.  And :func:`place_blockfaust`
puts the same bits of the whole chain on every rank (rank 0's, broadcast)
where the reference's ``device_put`` keeps each device's out-block range
only: each rank still streams only its range in an apply.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from repro_torch.core.compress import BlockFaust, ChainPlan, chain_plan
from repro_torch.distributed import mesh as _mesh
from repro_torch.distributed.sharding import _fit_axes
from repro_torch.kernels.chain import FORWARD_BT

# collective calls the sharded apply made, by purpose: the forward's
# boundary all-gathers and the result's gather; the backward's boundary
# reduce-scatters, the sums and gathers of x's, the values' and λ's
# gradients.  Tests and chip_smoke.py read it.
COLLECTIVES = dict.fromkeys(
    ("boundary_gather", "output_gather", "boundary_reduce_scatter", "dx_sum", "dx_gather", "dvalues_sum",
     "dvalues_gather", "dlam_sum"), 0)


def ici_bytes(
    batch: int,
    itemsize: int,
    n_batch_shards: int,
    n_model: int,
    crossing_feats: tuple[int, ...],
) -> int:
    """Bytes a rank receives over the card link in the boundary
    all-gathers of one apply: each delivers the other ranks'
    ``(n_model-1)/n_model`` share of a ``(b_loc, w)`` activation.  The
    reference's name (it counted TPU interconnect bytes); read by
    :meth:`ShardPlan.collective_bytes` and the dispatch cost model."""
    if n_model <= 1 or not crossing_feats:
        return 0
    b_loc = -(-batch // max(n_batch_shards, 1))
    frac = (n_model - 1) / n_model
    return int(itemsize * b_loc * sum(w * frac for w in crossing_feats))


def output_gather_bytes(batch: int, out_features: int, itemsize: int, n_data: int, n_model: int,
                        n_batch_shards: int) -> int:
    """Bytes a rank receives when the result is gathered whole on every
    rank (caveat R7): every other rank's block of the ``(b_pad, out)``
    result, the batch padded to ``n_batch_shards``.  Read by
    :meth:`ShardPlan.gather_bytes` and the dispatch cost model."""
    shards = n_data * n_model
    b_pad = -(-batch // max(n_batch_shards, 1)) * max(n_batch_shards, 1)
    return int(itemsize * b_pad * out_features * (shards - 1) / shards)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One fused launch between collectives: a contiguous run of factors
    whose intermediate supports stay on the rank."""

    factors: tuple[int, ...]  # global factor indices in this segment
    gather_in: bool  # all-gather the activation before this segment
    plan: ChainPlan  # the per-rank chain plan (the same on every rank)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static execution plan for one (chain, mesh, axes) combination.

    ``mode`` is ``"model"`` (factors split by out-block over the model
    axis, batch over data) or ``"replicated"`` (weights whole on every
    rank, batch split over every fitting axis).  ``crossing_feats`` lists
    the padded activation widths all-gathered at segment boundaries."""

    mode: str  # "model" | "replicated"
    n_data: int
    n_model: int
    data_spec: tuple[str, ...] | str | None  # batch mesh axes actually used
    model_axis: str | None
    block: int
    segments: tuple[SegmentPlan, ...]
    crossing_feats: tuple[int, ...]
    reason: str  # why this mode was chosen (surfaces in DispatchReport)
    mesh_shape: tuple[tuple[str, int], ...]
    # replicated mode: whether the chain packs into one fused launch per
    # rank (False: the per-factor apply runs, J launches)
    fusable: bool = True
    n_factors: int = 1

    @property
    def n_batch_shards(self) -> int:
        return self.n_data * (self.n_model if self.mode == "replicated" else 1)

    @property
    def n_launches(self) -> int:
        if self.mode == "model":
            return len(self.segments)
        return 1 if self.fusable else self.n_factors

    def collective_bytes(self, batch: int, itemsize: int) -> int:
        """A rank's received bytes of the boundary all-gathers (the
        reference's count)."""
        if self.mode != "model":
            return 0
        return ici_bytes(batch, itemsize, self.n_batch_shards, self.n_model, self.crossing_feats)

    def gather_bytes(self, batch: int, out_features: int, itemsize: int) -> int:
        """A rank's received bytes of the port's gather of the whole result
        (caveat R7)."""
        return output_gather_bytes(batch, out_features, itemsize, self.n_data, self.n_model, self.n_batch_shards)

    def summary(self) -> dict:
        """The shard facts the dispatch cost model reads."""
        return {
            "mode": self.mode,
            "n_data": self.n_data,
            "n_model": self.n_model,
            "n_segments": self.n_launches,
            "crossing_feats": self.crossing_feats,
            "mesh_shape": self.mesh_shape,
            "fusable": self.fusable,
            "reason": self.reason,
        }


def _mesh_shape(mesh) -> tuple[tuple[str, int], ...]:
    return tuple((str(a), int(s)) for a, s in mesh.shape.items())


def _idx(bf: BlockFaust) -> list[np.ndarray]:
    """Each factor's ``in_idx`` on the host."""
    return [f.in_idx.detach().cpu().numpy() for f in bf.factors]


def _model_blockers(bf: BlockFaust, n_model: int) -> str | None:
    """Why out-block partitioning over ``n_model`` ranks is infeasible
    (None when it is)."""
    if n_model <= 1:
        return "model axis absent or size 1"
    blk = bf.factors[0].bk
    for j, f in enumerate(bf.factors):
        if f.bk != blk or f.bn != blk:
            return f"factor {j}: non-uniform blocks ({f.bk},{f.bn}) vs {blk}"
        if f.n_out_blocks % n_model:
            return f"factor {j}: {f.n_out_blocks} out-blocks do not divide {n_model} model shards"
        if f.out_features != f.n_out_blocks * f.bn:
            return f"factor {j}: ragged out width {f.out_features} (per-shard step tables would diverge)"
    for j, (a, b) in enumerate(zip(bf.factors[:-1], bf.factors[1:])):
        if a.out_features != b.in_features or a.n_out_blocks != b.n_in_blocks:
            return f"factor boundary {j}->{j + 1} not contiguous"
    return None


def _crossing_boundaries(bf: BlockFaust, n_model: int) -> list[bool]:
    """``crossing[j]``: factor ``j`` (j ≥ 1) reads an input block owned by
    another model rank than its output block, so the boundary before it
    needs an all-gather."""
    idx = _idx(bf)
    crossing = [False] * len(bf.factors)
    for j in range(1, len(bf.factors)):
        o_loc_prev = bf.factors[j - 1].n_out_blocks // n_model
        o_loc = bf.factors[j].n_out_blocks // n_model
        out_shard = np.repeat(np.arange(n_model), o_loc)[:, None]
        in_shard = idx[j] // o_loc_prev
        crossing[j] = bool(np.any(in_shard != out_shard))
    return crossing


def _segment_plans(bf: BlockFaust, n_model: int, crossing: list[bool]) -> tuple[SegmentPlan, ...]:
    """Cut the chain at crossing boundaries; each segment's per-rank plan.
    A segment's first factor reads the whole activation (the input, or the
    one just gathered); its later factors read their predecessor's
    out-blocks on the rank."""
    blk = bf.factors[0].bk
    bounds = [0] + [j for j in range(1, len(bf.factors)) if crossing[j]] + [len(bf.factors)]
    segments = []
    for s, js in enumerate(bounds[:-1]):
        je = bounds[s + 1]
        in_blocks, out_blocks, k_blocks, in_feats, out_feats = [], [], [], [], []
        offsets = [0]
        for pos, j in enumerate(range(js, je)):
            f = bf.factors[j]
            o_loc = f.n_out_blocks // n_model
            ib = f.n_in_blocks if pos == 0 else out_blocks[-1]
            in_blocks.append(ib)
            out_blocks.append(o_loc)
            k_blocks.append(f.k)
            in_feats.append(ib * blk)
            out_feats.append(o_loc * blk)
            offsets.append(offsets[-1] + o_loc * f.k)
        segments.append(SegmentPlan(
            factors=tuple(range(js, je)),
            gather_in=s > 0,
            plan=ChainPlan(block=blk, in_blocks=tuple(in_blocks), out_blocks=tuple(out_blocks),
                           k_blocks=tuple(k_blocks), offsets=tuple(offsets), in_feats=tuple(in_feats),
                           out_feats=tuple(out_feats)),
        ))
    return tuple(segments)


def _pack_ok(bf: BlockFaust) -> bool:
    """Whether the chain packs (uniform square blocks, contiguous
    boundaries); ragged feature widths are fine in the replicated mode."""
    blk = bf.factors[0].bk
    if any(f.bk != blk or f.bn != blk for f in bf.factors):
        return False
    return all(a.out_features == b.in_features and a.n_out_blocks == b.n_in_blocks
               for a, b in zip(bf.factors[:-1], bf.factors[1:]))


# Planning reads every in_idx on the host (a device sync on the card), so
# plans are cached per chain support, keyed by where each factor's in_idx
# lives: its base tensor's identity (a FaustLinear's buffer, a stacked
# head's, a packed chain's; the BlockFaust around them is built anew each
# forward) and its offset, shape and strides, guarded by a weakref to the
# base, the version counters and the factors' layout; and by the mesh's
# shape.
_PLAN_CACHE: dict[tuple, tuple] = {}
_PLAN_CACHE_MAX = 64


def _base(t: torch.Tensor) -> torch.Tensor:
    return t._base if t._base is not None else t


def _support_stamp(bf: BlockFaust) -> tuple:
    return tuple((f.in_idx._version, tuple(f.values.shape), f.in_features, f.out_features) for f in bf.factors)


def plan_shard(bf: BlockFaust, mesh, data_axis: str = "data", model_axis: str = "model") -> ShardPlan:
    """Plan the mesh execution of one chain (module docstring) on a
    :class:`~repro_torch.distributed.mesh.Mesh` or an ``AbstractMesh``."""
    where = tuple((id(_base(f.in_idx)), f.in_idx.storage_offset(), tuple(f.in_idx.shape), f.in_idx.stride())
                  for f in bf.factors)
    key = (where, data_axis, model_axis, _mesh_shape(mesh))
    ent = _PLAN_CACHE.get(key)
    if ent is not None and all(r() is _base(f.in_idx) for r, f in zip(ent[0], bf.factors)) \
            and ent[1] == _support_stamp(bf):
        return ent[2]
    plan = _plan_shard(bf, mesh, data_axis, model_axis)
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = (tuple(weakref.ref(_base(f.in_idx)) for f in bf.factors), _support_stamp(bf), plan)
    return plan


def _plan_shard(bf: BlockFaust, mesh, data_axis: str, model_axis: str) -> ShardPlan:
    n_model = int(mesh.shape.get(model_axis, 1))
    n_data = int(mesh.shape.get(data_axis, 1))
    blocker = _model_blockers(bf, n_model)
    if blocker is None:
        crossing = _crossing_boundaries(bf, n_model)
        blk = bf.factors[0].bk
        crossing_feats = tuple(bf.factors[j - 1].n_out_blocks * blk for j in range(1, len(bf.factors))
                               if crossing[j])
        return ShardPlan(
            mode="model",
            n_data=n_data,
            n_model=n_model,
            data_spec=data_axis if data_axis in mesh.shape else None,
            model_axis=model_axis,
            block=blk,
            segments=_segment_plans(bf, n_model, crossing),
            crossing_feats=crossing_feats,
            reason=(f"out-blocks partition over {n_model} '{model_axis}' shards; "
                    f"{len(crossing_feats)}/{max(len(bf.factors) - 1, 0)} boundaries cross shards"),
            mesh_shape=_mesh_shape(mesh),
            fusable=True,
            n_factors=len(bf.factors),
        )
    # replicated: weights whole on every rank, batch over every fitting
    # axis (the batch is padded to divisibility by the apply, so _fit_axes
    # here only drops axes the mesh lacks)
    n_shards = n_data * n_model
    return ShardPlan(
        mode="replicated",
        n_data=n_data,
        n_model=n_model,
        data_spec=_fit_axes((data_axis, model_axis), n_shards, mesh),
        model_axis=None,
        block=bf.factors[0].bk,
        segments=(),
        crossing_feats=(),
        reason=f"replicated fallback: {blocker}" + ("" if _pack_ok(bf) else "; non-fusable chain: per-factor fallback"),
        mesh_shape=_mesh_shape(mesh),
        fusable=_pack_ok(bf),
        n_factors=len(bf.factors),
    )


# ---------------------------------------------------------------------------
# The collectives as autograd Functions (each counts into COLLECTIVES)
# ---------------------------------------------------------------------------


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` (an operand
    every rank of the group reads whole for its own part of the work)."""

    @staticmethod
    def forward(ctx, t, group, purpose):
        ctx.group, ctx.purpose = group, purpose
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES[ctx.purpose] += 1
        return _mesh.all_reduce(g.contiguous(), ctx.group), None, None


class _Rows(torch.autograd.Function):
    """Rows ``[index·n, (index+1)·n)`` of an input every rank holds whole;
    the backward gathers the ranks' row cotangents over ``group``."""

    @staticmethod
    def forward(ctx, x, index, n, group):
        ctx.group = group
        return x.narrow(0, index * n, n)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["dx_gather"] += 1
        return _mesh.all_gather(g.contiguous(), ctx.group, 0), None, None, None


class _BoundaryGather(torch.autograd.Function):
    """All-gather of the activation along features over the model group;
    the backward reduce-scatters (sums) the boundary cotangent."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        COLLECTIVES["boundary_gather"] += 1
        return _mesh.all_gather(y.contiguous(), group, 1)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["boundary_reduce_scatter"] += 1
        return _mesh.reduce_scatter(g.contiguous(), ctx.group, 1), None


class _OutputGather(torch.autograd.Function):
    """The result's blocks gathered along ``dim`` over ``group`` (caveat
    R7); what follows runs the same on every rank, so the backward takes
    this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, y, group, dim, index):
        ctx.dim, ctx.index, ctx.n = dim, index, y.shape[dim]
        COLLECTIVES["output_gather"] += 1
        return _mesh.all_gather(y.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


class _Shard(torch.autograd.Function):
    """Rows ``[start, start + n)`` of each factor's tensor (``(O, K,
    ...)``), flattened to ``(n·K, ...)`` and concatenated: a segment's
    values or scales on this rank.  The backward sums each shard's
    gradient over ``sum_group`` (the ranks that read the same rows) and
    gathers the shards over ``gather_group``, so every rank gets each
    factor's whole gradient."""

    @staticmethod
    def forward(ctx, start, n, sum_group, gather_group, *tensors):
        ctx.shapes = [t.shape for t in tensors]
        ctx.n, ctx.groups = n, (sum_group, gather_group)
        return torch.cat([t.narrow(0, start, n).reshape(-1, *t.shape[2:]) for t in tensors])

    @staticmethod
    def backward(ctx, g):
        sum_group, gather_group = ctx.groups
        parts = torch.split(g, [ctx.n * s[1] for s in ctx.shapes])
        out = []
        for part, shape in zip(parts, ctx.shapes):
            part = part.reshape(ctx.n, *shape[1:]).contiguous()
            if sum_group is not None:
                COLLECTIVES["dvalues_sum"] += 1
                part = _mesh.all_reduce(part, sum_group)
            if gather_group is not None:
                COLLECTIVES["dvalues_gather"] += 1
                part = _mesh.all_gather(part, gather_group, 0)
            out.append(part)
        return (None, None, None, None, *out)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def segment_idx(bf: BlockFaust, seg: SegmentPlan, p: int) -> torch.Tensor:
    """Model rank ``p``'s ``in_idx (S_seg,)`` of segment ``seg``: each
    factor's rows of its out-block range, a later factor's input blocks
    numbered from 0 within the predecessor's range on the rank."""
    parts = []
    for pos, j in enumerate(seg.factors):
        o_loc = seg.plan.out_blocks[pos]
        ij = bf.factors[j].in_idx.narrow(0, p * o_loc, o_loc).reshape(-1).to(torch.int32)
        if pos > 0:
            ij = ij - p * seg.plan.in_blocks[pos]
        parts.append(ij)
    return torch.cat(parts)


def segment_values(bf: BlockFaust, seg: SegmentPlan, p: int) -> torch.Tensor:
    """Model rank ``p``'s ``values (S_seg, blk, blk)`` of segment ``seg``,
    as its fused launch reads them (no gradient path: for checks)."""
    o_loc = seg.plan.out_blocks
    return torch.cat([bf.factors[j].values.detach().narrow(0, p * o_loc[pos], o_loc[pos]).reshape(-1, seg.plan.block,
                                                                                              seg.plan.block)
                      for pos, j in enumerate(seg.factors)])


def _segment_apply(y, vals, idx, plan: ChainPlan, bt: int, kernel: bool, scales=None):
    """One fused segment on the rank's shard: K1 (K4 with ``scales``) and,
    in the backward, K2 + K3 (K5)."""
    from repro_torch.kernels.ops import _ChainFn, _ChainQFn

    if scales is not None:
        return _ChainQFn.apply(y.contiguous(), vals.contiguous(), scales.contiguous(), idx, plan, bt, kernel)
    return _ChainFn.apply(y.contiguous(), vals.to(y.dtype).contiguous(), idx, plan, bt, kernel)


def sharded_chain_apply(
    x: torch.Tensor,
    bf: BlockFaust,
    mesh,
    data_axis: str = "data",
    model_axis: str = "model",
    *,
    plan: ShardPlan | None = None,
    use_kernel: bool | None = None,
    bt: int = FORWARD_BT,
    scales: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """``y = lam · x @ F_1 ⋯ F_J`` on ``mesh`` (a
    :class:`~repro_torch.distributed.mesh.Mesh`), every rank calling it
    with the same ``x`` and chain: any leading batch dims, features padded
    and sliced, λ applied, as :func:`repro_torch.kernels.ops.packed_chain_apply`;
    the result whole on every rank (module docstring).  ``plan`` may come
    from :func:`plan_shard` (so the dispatch report prices the plan that
    runs).  ``use_kernel`` follows ``x``'s device, as the other applies.

    A quantized chain: ``bf``'s factor values hold the int8/fp8 codes
    (``unpack_chain(chain, dequantize=False)``) and ``scales`` each
    factor's f32 scale rows ``(O_j, K_j, blk)`` (``expand_scales``, cut by
    factor).  They are split by out-block with the codes they scale."""
    from repro_torch.kernels.ops import _want_kernel

    if plan is None:
        plan = plan_shard(bf, mesh, data_axis, model_axis)
    kernel = _want_kernel(x, use_kernel)
    blk = bf.factors[0].bk
    in_pad = bf.factors[0].n_in_blocks * blk
    batch_shape = x.shape[:-1]
    if x.shape[-1] != in_pad:
        x = torch.nn.functional.pad(x, (0, in_pad - x.shape[-1]))
    b = math.prod(batch_shape)
    x2 = x.reshape(b, in_pad)
    n_shards = plan.n_batch_shards
    b_pad = -(-b // n_shards) * n_shards
    if b_pad != b:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, b_pad - b))
    b_loc = b_pad // n_shards
    if plan.mode == "model":
        y2 = _apply_model_sharded(x2, bf, mesh, plan, b_loc, bt, kernel, scales)
    else:
        y2 = _apply_replicated(x2, bf, mesh, plan, b_loc, bt, kernel, scales)
    y = y2[:b].reshape(*batch_shape, -1)
    if y.shape[-1] != bf.out_features:
        y = y[..., : bf.out_features]
    return y


def _scaled_and_gathered(y, lam, mesh, lam_axes, gathers):
    """``lam · y`` on the rank's block, λ's gradient summed over
    ``lam_axes``, then the result gathered whole: ``gathers`` is a list of
    ``(axis, dim)``, each axis's blocks concatenated along ``dim``."""
    if lam_axes is not None:
        lam = _SumGrad.apply(lam, mesh.group(lam_axes), "dlam_sum")
    y = lam.to(y.dtype) * y
    for axis, dim in gathers:
        y = _OutputGather.apply(y, mesh.group(axis), dim, mesh.index(axis))
    return y


def _apply_model_sharded(x2, bf, mesh, plan, b_loc, bt, kernel, fac_scales):
    model_axis, data_axis = plan.model_axis, plan.data_spec
    model_group, data_group = mesh.group(model_axis), mesh.group(data_axis)
    p = mesh.coord[model_axis]
    y = x2
    if data_axis is not None:
        y = _Rows.apply(y, mesh.index(data_axis), b_loc, data_group)
    y = _SumGrad.apply(y, model_group, "dx_sum")
    for seg in plan.segments:
        if seg.gather_in:
            y = _BoundaryGather.apply(y, model_group)
        o_loc = seg.plan.out_blocks
        # every factor of a segment has its own out-block count: cut each
        vals = torch.cat([_Shard.apply(p * o_loc[pos], o_loc[pos], data_group, model_group, bf.factors[j].values)
                          for pos, j in enumerate(seg.factors)])
        scl = None
        if fac_scales is not None:
            scl = torch.cat([_Shard.apply(p * o_loc[pos], o_loc[pos], data_group, model_group, fac_scales[j])
                             for pos, j in enumerate(seg.factors)])
        y = _segment_apply(y, vals, segment_idx(bf, seg, p), seg.plan, bt, kernel, scl)
    gathers = [(model_axis, 1)] + ([(data_axis, 0)] if data_axis is not None else [])
    lam_axes = (data_axis, model_axis) if data_axis is not None else model_axis
    return _scaled_and_gathered(y, bf.lam, mesh, lam_axes, gathers)


def _apply_replicated(x2, bf, mesh, plan, b_loc, bt, kernel, fac_scales):
    from repro_torch.kernels.ops import bsr_apply

    axes = plan.data_spec
    group = mesh.group(axes)
    y = x2
    if axes is not None:
        y = _Rows.apply(y, mesh.index(axes), b_loc, group)
    whole = lambda t: _Shard.apply(0, t.shape[0], group, None, t)  # noqa: E731
    if plan.fusable:
        cplan = chain_plan(bf.factors)
        vals = torch.cat([whole(f.values) for f in bf.factors])
        idx = torch.cat([f.in_idx.reshape(-1).to(torch.int32) for f in bf.factors])
        scl = None if fac_scales is None else torch.cat([whole(s) for s in fac_scales])
        y = _segment_apply(y, vals, idx, cplan, bt, kernel, scl)
    else:
        # a chain that does not pack: the bsr backend's per-factor apply
        # (K6 on the card), the codes dequantized first where quantized
        for j, f in enumerate(bf.factors):
            v = whole(f.values).reshape(f.values.shape)
            if fac_scales is not None:
                v = v.float() * whole(fac_scales[j]).reshape(fac_scales[j].shape)[..., None]
            y = bsr_apply(y, dataclasses.replace(f, values=v), use_kernel=kernel)
    gathers = [(axes, 0)] if axes is not None else []
    return _scaled_and_gathered(y, bf.lam, mesh, axes, gathers)


# ---------------------------------------------------------------------------
# Placement (factorize with a mesh gives placed operators)
# ---------------------------------------------------------------------------


def place_blockfaust(bf: BlockFaust, mesh, model_axis: str = "model") -> BlockFaust:
    """The chain as every rank of ``mesh`` holds it: on the rank's device,
    rank 0's bits broadcast to every rank (so all ranks apply the same
    chain).  Each factor whose out-block count the model axis divides
    (``_fit_axes``) is read by out-block range in the apply, the others
    whole; every rank keeps the whole chain (module docstring, caveat
    R7).  An ``AbstractMesh`` has no ranks: the chain comes back as it is."""
    if not isinstance(mesh, _mesh.Mesh):
        return bf

    def put(t):
        return _mesh.broadcast(t.detach().to(mesh.device), 0)

    factors = tuple(dataclasses.replace(f, values=put(f.values), in_idx=put(f.in_idx)) for f in bf.factors)
    return BlockFaust(factors, put(bf.lam))


def split_scales(scales: torch.Tensor, bf: BlockFaust) -> list[torch.Tensor]:
    """Flat ``(S, blk)`` scale rows cut back per factor, ``(O_j, K_j,
    blk)``, in the packed stream's (factor, out-block, slot) order."""
    out, off = [], 0
    for f in bf.factors:
        n = f.n_out_blocks * f.k
        out.append(scales[off: off + n].reshape(f.n_out_blocks, f.k, -1))
        off += n
    return out

