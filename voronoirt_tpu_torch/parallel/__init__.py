"""Parallelism of the Lambda iteration: quadrature angles over the
devices of one process (angles.py), wavelength blocks over processes
joined by torch.distributed (lam.py), and the mesh of processes that
also splits the grid (mesh.py)."""

from .angles import distribute_angles
from .lam import (LamGroup, gather_lambda, join_group, leave_group,
                  shard_regular, shard_voronoi, spawn)
from .mesh import Mesh, gather_space, make_hybrid_mesh, make_mesh

__all__ = ["distribute_angles", "LamGroup", "gather_lambda", "join_group",
           "leave_group", "shard_regular", "shard_voronoi", "spawn", "Mesh",
           "gather_space", "make_hybrid_mesh", "make_mesh"]
