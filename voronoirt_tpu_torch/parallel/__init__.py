"""Angle (quadrature) parallelism across devices of one process."""

from .angles import distribute_angles

__all__ = ["distribute_angles"]
