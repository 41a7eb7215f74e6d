"""Meshes over ``torch.distributed`` groups (:mod:`.mesh`, counterpart of
:mod:`repro.launch.mesh`), the sharding policies and parameter specs
(:mod:`.sharding`), what a rank holds and gathers when the model trains on
a mesh (:mod:`.layout`), and the pod pipeline (:mod:`.pipeline`)."""
from repro_torch.distributed.mesh import AbstractMesh, Mesh, make_debug_mesh, make_production_mesh

__all__ = ["AbstractMesh", "Mesh", "make_debug_mesh", "make_production_mesh"]
