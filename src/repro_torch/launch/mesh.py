"""Production meshes.  Counterpart of :mod:`repro.launch.mesh`.

:func:`make_production_mesh` (``(16, 16)`` over ``("data", "model")``, or
``(2, 16, 16)`` over ``("pod", "data", "model")``) and
:func:`make_debug_mesh` lay out the ranks of an initialized default group
(:mod:`repro_torch.distributed.mesh`).  :func:`abstract_rank` is the dry
run's: one rank of a mesh of any size in this process, over
``torch.distributed``'s ``"fake"`` backend, whose collectives return at
once and move nothing.  With fake tensors (``launch/dryrun.py``) that rank
runs its step as the real one would, collectives included.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh, make_debug_mesh, make_production_mesh

__all__ = ["abstract_rank", "make_debug_mesh", "make_production_mesh", "production_shape", "release"]


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, names)`` of the production mesh :func:`make_production_mesh` builds."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def abstract_rank(shape, names, rank: int = 0) -> Mesh:
    """Rank ``rank`` of a ``shape`` mesh over ``names``, on a fake process
    group of the mesh's size started in this process (a fake group already
    running is replaced; any other default group raises ``RuntimeError``).
    Its device mesh is on ``"cpu"``, whatever device the tensors claim."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    release()
    if dist.is_initialized():
        raise RuntimeError(f"abstract_rank needs this process's default group; a {dist.get_backend()!r} group runs")
    size = math.prod(shape)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in a mesh of {size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    return Mesh(shape, names, device="cpu")


def release() -> None:
    """End the fake process group :func:`abstract_rank` started, if one runs."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
