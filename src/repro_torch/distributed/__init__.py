"""Meshes over ``torch.distributed`` groups and the placement rules the
sharded apply reads (counterparts of :mod:`repro.launch.mesh` and part of
:mod:`repro.distributed.sharding`)."""
from repro_torch.distributed.mesh import AbstractMesh, Mesh, make_debug_mesh, make_production_mesh

__all__ = ["AbstractMesh", "Mesh", "make_debug_mesh", "make_production_mesh"]
