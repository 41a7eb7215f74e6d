"""Mesh-axis placement rules.  Counterpart of the part of
:mod:`repro.distributed.sharding` that the sharded chain apply reads:
:data:`MeshAxes` and :func:`_fit_axes`, the divisibility rule by which a
dimension whose size the axes do not divide is replicated instead of
sharded.  The logical-axis policies (``ShardingPolicy``, ``use_rules``,
``shard_act``, parameter specs) come with the model-wide mesh.
"""
from __future__ import annotations

import math

MeshAxes = tuple[str, ...] | str | None


def _fit_axes(ax: MeshAxes, dim_size: int, mesh) -> MeshAxes:
    """Drop axes absent from ``mesh``; replicate (``None``) if their
    product does not divide ``dim_size``."""
    if ax is None:
        return None
    ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
    ax_t = tuple(a for a in ax_t if a in mesh.shape)
    if not ax_t:
        return None
    n = math.prod(mesh.shape[a] for a in ax_t)
    if dim_size % n != 0:
        return None
    return ax_t if len(ax_t) > 1 else ax_t[0]
