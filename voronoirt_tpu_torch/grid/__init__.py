"""Voronoi grid layer of the port.

The host half is numpy and ctypes, copied from the JAX package's grid
layer (tests/test_torch_host_copies.py holds each copy equal to its
original): the sites container and the per-direction sweep plans
(voronoi.py), the native tessellation library and BFS layering behind
them (neighbors.py, which builds the repo's native/ sources with make),
trilinear site initialisation (interpolate.py), rejection sampling with
the five numpy densities (sampling.py) and the disk cache (cache.py).
The densities that evaluate the physics run on the port's torch physics
(sampling.py).  `build_native` runs make on native/ and returns the
loaded library, or None; without it build_sites falls back to scipy, a
test-size path.
"""

from . import cache
from .interpolate import initialise_sites
from .neighbors import build_native
from .sampling import (DENSITIES, density_avg_extinction,
                       density_destruction, density_extinction,
                       density_invNH_invT, density_logNH_invT,
                       density_logNH_invT_rootv, density_temp_gradient,
                       density_total_extinction, rejection_sampling,
                       sample_sites)
from .voronoi import (VoronoiPlan, VoronoiSites, build_sites,
                      build_voronoi_plan)

__all__ = ["cache", "initialise_sites", "build_native", "VoronoiPlan",
           "VoronoiSites",
           "build_sites", "build_voronoi_plan", "DENSITIES",
           "density_avg_extinction", "density_destruction",
           "density_extinction", "density_invNH_invT", "density_logNH_invT",
           "density_logNH_invT_rootv", "density_temp_gradient",
           "density_total_extinction", "rejection_sampling", "sample_sites"]
