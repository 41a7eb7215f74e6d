"""Logical-axis sharding: policies, the rules context, and parameter specs.
Counterpart of :mod:`repro.distributed.sharding`.

Model code names the dimensions of its activations with *logical* axes
(:func:`shard_act`) and every parameter carries logical axes
(:mod:`repro_torch.layers.param`).  A :class:`ShardingPolicy` (one per
architecture and shape kind) maps logical names to mesh axes, and
:func:`resolve_param_pspecs` turns a table of parameter axes into one spec
per parameter: a tuple with one entry per dimension, ``None`` (replicated),
a mesh axis name, or a tuple of names, in the order of the reference's
``PartitionSpec``.  A mesh axis the dimension's size does not divide is
dropped (8 query heads on a 16-wide ``model`` axis stay replicated), and a
mesh axis appears at most once in a spec (the first dimension to ask for it
wins).

:func:`tree_named_sharding` turns specs into what a rank of a
:class:`~repro_torch.distributed.mesh.Mesh` holds: each parameter's
:class:`Block` (its offset and shape in the whole tensor).  The trainer
keeps only these blocks (``repro_torch.runtime.trainer``).

The policy's activation names decide, on a mesh, which rows
(``batch``) and which positions (``seq``) a rank computes; the model
gathers what a layer needs whole (``repro_torch.models.lm``).
Outside a :func:`use_rules` context :func:`shard_act` is the identity, so
the model runs unchanged on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import NamedTuple

MeshAxes = tuple[str, ...] | str | None

_TLS = threading.local()


def default_param_rules() -> dict[str, MeshAxes]:
    return {
        "embed": "data",  # ZeRO-3-style storage sharding
        "vocab": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "mlp": "model",
        "experts": "model",
        "inner_flat": "model",
        "heads": None,
        "blocks": "model",
        "block_k": None,
        "layers": None,
    }


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Logical-axis → mesh-axis mapping for one (arch, shape kind)."""

    # activations
    batch: MeshAxes = ("pod", "data")
    seq: MeshAxes = None  # 'model' for context-parallel archs
    heads_act: MeshAxes = "model"
    kv_seq: MeshAxes = None  # decode cache sequence axis
    mlp_act: MeshAxes = "model"
    vocab_act: MeshAxes = "model"
    experts_act: MeshAxes = "model"
    # gather the sequence at the MoE boundary (the port routes whole rows
    # under any sequence split: repro_torch.models.lm)
    moe_gather_seq: bool = False
    # parameters (logical axes from repro_torch.layers.param)
    params: dict[str, MeshAxes] = dataclasses.field(default_factory=default_param_rules)

    def act_axes(self, name: str) -> MeshAxes:
        return getattr(self, name)


@dataclasses.dataclass
class _Rules:
    mesh: object
    policy: ShardingPolicy


@contextlib.contextmanager
def use_rules(mesh, policy: ShardingPolicy | None):
    """``mesh`` and ``policy`` are the rules of this thread while the
    context is open (``mesh=None``: no rules); nests, and restores the
    outer rules on exit."""
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = _Rules(mesh, policy) if mesh is not None else None
    try:
        yield
    finally:
        _TLS.rules = prev


def _current() -> _Rules | None:
    return getattr(_TLS, "rules", None)


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


def axes_tuple(ax: MeshAxes) -> tuple[str, ...]:
    """``ax`` as a tuple of mesh axis names (``()`` for ``None``)."""
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def shard_act(x, *logical: str | None):
    """One logical name (or None) per dimension of ``x``.  On a mesh the
    model holds each activation as this rank's block already (its rows and
    positions), so this checks the names and returns ``x`` itself, as it
    does outside :func:`use_rules`."""
    if _current() is None:
        return x
    assert len(logical) == x.ndim, (logical, tuple(x.shape))
    return x


def resolve_param_pspecs(axes: dict, shapes: dict, mesh, policy: ShardingPolicy) -> dict:
    """``{name: logical axes}`` and ``{name: shape}`` → ``{name: spec}``,
    a spec being one entry per dimension (``None``, an axis name or a
    tuple of names); a parameter whose axes are ``None`` or ``()`` gets
    ``()`` (replicated)."""

    def one(names, shape) -> tuple:
        if not names:
            return ()
        spec, used = [], set()
        for dim_size, name in zip(shape, names):
            ax = _fit_axes(policy.params.get(name) if name else None, dim_size, mesh)
            ax_t = axes_tuple(ax)
            if any(a in used for a in ax_t):  # a mesh axis at most once per spec: first wins
                ax = None
            else:
                used.update(ax_t)
            spec.append(ax)
        return tuple(spec)

    return {name: one(axes[name], tuple(shapes[name])) for name in axes}


class Block(NamedTuple):
    """What a rank holds of one parameter: its ``spec``, the whole
    tensor's ``global_shape``, and the block's ``offset`` and ``shape``."""

    spec: tuple
    global_shape: tuple
    offset: tuple
    shape: tuple

    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec splits over."""
        return tuple(a for ax in self.spec for a in axes_tuple(ax))

    @property
    def whole(self) -> bool:
        return self.shape == self.global_shape


def block_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """The shape of every rank's block of a ``shape`` tensor under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(mesh.shape[a] for a in axes_tuple(ax)) for n, ax in zip(shape, spec))


def tree_named_sharding(pspecs: dict, shapes: dict, mesh) -> dict:
    """``{name: spec}`` → ``{name: Block}`` of this rank of ``mesh`` (a
    :class:`~repro_torch.distributed.mesh.Mesh`): a dimension split over
    axes ``(a, b)`` is cut in ``|a|·|b|`` parts and the rank holds part
    ``mesh.index((a, b))``, row-major over those axes in the spec's order.
    On an :class:`~repro_torch.distributed.mesh.AbstractMesh` the blocks
    are rank 0's."""
    coord = getattr(mesh, "coord", None) or dict.fromkeys(mesh.shape, 0)
    out = {}
    for name, spec in pspecs.items():
        shape = tuple(shapes[name])
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        bshape = block_shape(spec, shape, mesh)
        offset = []
        for ax, n in zip(spec, bshape):
            idx = 0
            for a in axes_tuple(ax):
                idx = idx * mesh.shape[a] + coord[a]
            offset.append(idx * n)
        out[name] = Block(spec, shape, tuple(offset), bshape)
    return out
