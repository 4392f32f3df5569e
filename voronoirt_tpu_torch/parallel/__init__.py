"""Parallelism of the Lambda iteration: quadrature angles over the
devices of one process (angles.py), and wavelength blocks over processes
joined by torch.distributed (lam.py)."""

from .angles import distribute_angles
from .lam import (LamGroup, gather_lambda, join_group, leave_group,
                  shard_regular, shard_voronoi, spawn)

__all__ = ["distribute_angles", "LamGroup", "gather_lambda", "join_group",
           "leave_group", "shard_regular", "shard_voronoi", "spawn"]
