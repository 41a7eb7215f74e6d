"""Device meshes over a ``torch.distributed`` group, and the collectives
the sharded apply runs on them.  Counterpart of :mod:`repro.launch.mesh`
(the production and debug meshes) and of what ``jax.sharding.Mesh`` gives
the reference's planners.

A :class:`Mesh` lays the processes of the default group out on named axes
(``"data"``, ``"model"``, and ``"pod"`` for two pods): a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names.  Every rank runs the same program (SPMD), as the reference's
``shard_map`` body does.  What the planners read is :attr:`Mesh.shape`,
``{axis: size}`` in axis order, as ``mesh.shape`` in the reference; what
the sharded apply reads is this rank's coordinate on each axis
(:attr:`Mesh.coord`) and the process group of each set of axes
(:meth:`Mesh.group`).  :class:`AbstractMesh` has the same ``shape`` and no
group: it plans on the host (and in tests), as the reference's
``AbstractMesh`` does.

One rank per card where there are several cards (NCCL); ``gloo`` on the
CPU.  The collectives below take CUDA tensors on a ``gloo`` group too
(several ranks sharing one card, which NCCL refuses): such a call is
staged through host memory, the tensors copied to the CPU for the
collective and back.  That is a transport: the computation stays on the
card.  :data:`TRANSPORT` counts the calls each transport carried.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

# collective calls by transport: "direct" (the group's own device) and
# "host" (CUDA tensors on a gloo group, staged through host memory)
TRANSPORT = {"direct": 0, "host": 0}


class AbstractMesh:
    """Axis names and sizes, no processes: what host-side planning reads."""

    def __init__(self, shape, names):
        shape, names = tuple(int(s) for s in shape), tuple(str(n) for n in names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one distinct name per axis; got {shape} over {names}")
        self.shape = dict(zip(names, shape))
        self.axis_names = names

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """The processes of the default group on named axes (module docstring).
    Needs an initialized default group whose world size is the product of
    ``shape``; rank ``r`` sits at the row-major coordinate of ``r``, as
    ``init_device_mesh`` lays ranks out.  ``device`` is where this rank's
    tensors live (default: the current CUDA card when the group is NCCL,
    the CPU otherwise); a ``gloo`` group with tensors on a card stages its
    collectives through host memory."""

    def __init__(self, shape, names, *, device=None):
        super().__init__(shape, names)
        if not dist.is_available() or not dist.is_initialized():
            raise ValueError(
                "a Mesh needs torch.distributed's default group: call init_process_group first "
                "(every rank of the mesh, one process each)"
            )
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a {tuple(self.shape.values())} mesh needs {self.size} ranks; the group has {world}")
        from torch.distributed.device_mesh import init_device_mesh

        self.backend = dist.get_backend()
        # the device mesh only holds the groups: its device type follows the
        # backend (NCCL: cuda; gloo: cpu, whatever device the tensors are on)
        self.device_mesh = init_device_mesh(
            "cuda" if self.backend == "nccl" else "cpu", tuple(self.shape.values()), mesh_dim_names=self.axis_names
        )
        self.rank = dist.get_rank()
        self.coord = {n: int(self.device_mesh.get_local_rank(n)) for n in self.axis_names}
        self._groups = {(n,): self.device_mesh.get_group(n) for n in self.axis_names}
        self._groups[self.axis_names] = dist.group.WORLD
        # every other set of two or more axes, created collectively now
        # (a group is made by every rank of the world at once)
        for k in range(2, len(self.axis_names)):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = self._subgroup(axes)
        if device is None:
            device = ("cuda", torch.cuda.current_device()) if self.backend == "nccl" else ("cpu",)
            device = torch.device(*device)
        self.device = torch.device(device)

    def _subgroup(self, axes):
        """The group of the ranks that differ only along ``axes``."""
        sizes = list(self.shape.values())
        ranks = torch.arange(self.size).reshape(sizes)
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(sizes)) if i not in keep]
        lists = ranks.permute(*rest, *keep).reshape(-1, math.prod(sizes[i] for i in keep)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(lists)
        return group

    def group(self, axes):
        """The process group of the axes ``axes`` (a name or a tuple of
        names, in mesh order); ``None`` for no axis."""
        if axes is None:
            return None
        key = (axes,) if isinstance(axes, str) else tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a name or a tuple of
        names, in mesh order): its shard of a dimension split over them."""
        if axes is None:
            return 0
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in self.axis_names if a in axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        return idx


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device=None) -> Mesh:
    """A small ``("data", "model")`` mesh over the default group (tests,
    and the card's one-card runs)."""
    return Mesh((n_data, n_model), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production meshes: ``(16, 16)`` over ``("data",
    "model")``, 256 ranks; with ``multi_pod`` ``(2, 16, 16)`` over
    ``("pod", "data", "model")``, 512 ranks.  Raises ``ValueError`` when the
    default group has another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, names, device=device)


# ---------------------------------------------------------------------------
# Collectives (tensor in, tensor out; the transport per the module docstring)
# ---------------------------------------------------------------------------


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _as_wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's transport carries it: on the CPU for a staged
    call, contiguous either way."""
    staged = _host_staged(t, group)
    TRANSPORT["host" if staged else "direct"] += 1
    return (t.cpu() if staged else t).contiguous()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float narrower than f32 (bf16, fp16, fp8) as its bytes (the last
    dimension ``element_size`` times as long): the bits travel unchanged
    whatever floats the backend knows (gloo knows no bf16 or int16)."""
    if t.is_floating_point() and t.element_size() < 4:
        return t.view(torch.uint8)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group rank
    order.  Moves bits only."""
    wire = _as_wire(t, group)
    bits = _bits(wire)
    n = dist.get_world_size(group)
    flat = torch.empty((n * bits.numel(),), dtype=bits.dtype, device=bits.device)
    dist.all_gather_into_tensor(flat, bits.reshape(-1), group=group)  # one flat buffer (gloo's layout)
    flat = flat.view(n, *bits.shape)
    d = dim % bits.ndim
    out = flat.movedim(0, d).reshape(*bits.shape[:d], n * bits.shape[d], *bits.shape[d + 1:])
    return out.view(t.dtype).to(t.device) if bits is not wire else out.to(t.device)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The group's elementwise sum (or ``op``) of ``t``, summed in f32 for
    a narrower float, in ``t``'s dtype."""
    wire = _as_wire(t, group)
    acc = wire.float() if wire.is_floating_point() and wire.element_size() < 4 else wire.clone()
    dist.all_reduce(acc, op=op, group=group)
    return acc.to(device=t.device, dtype=t.dtype)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's ``1/n`` slice along ``dim`` of the group's sum of ``t``
    (``t.shape[dim]`` a multiple of the group's size), summed in f32 for a
    narrower float."""
    n = dist.get_world_size(group)
    wire = _as_wire(t, group)
    acc = wire.float() if wire.is_floating_point() and wire.element_size() < 4 else wire
    acc = acc.movedim(dim, 0).contiguous()
    out = torch.empty((acc.shape[0] // n, *acc.shape[1:]), dtype=acc.dtype, device=acc.device)
    dist.reduce_scatter_tensor(out, acc, group=group)
    return out.movedim(0, dim).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of ``group`` (default:
    the world), bit for bit."""
    group = group if group is not None else dist.group.WORLD
    wire = _as_wire(t, group)
    if wire is t:
        wire = t.clone()
    bits = _bits(wire)
    dist.broadcast(bits, src=src, group=group)
    return bits.view(t.dtype).to(t.device) if bits is not wire else wire.to(t.device)
