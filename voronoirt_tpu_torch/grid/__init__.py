"""Voronoi grid layer of the port.

The host half of the JAX package's grid layer is numpy and ctypes and
imports no jax, so it is imported here, not copied: the sites container
and the per-direction sweep plans (voronoirt_tpu.grid.voronoi), the
native tessellation library and BFS layering behind them
(grid.neighbors), trilinear site initialisation (grid.interpolate),
rejection sampling with the four numpy densities (grid.sampling) and
the disk cache (grid.cache).  Only the densities that evaluate the
physics are the port's own (grid/sampling.py).  `build_native` runs
make on native/ and returns the loaded library, or None; without it
build_sites falls back to scipy, a test-size path.
"""

from voronoirt_tpu.grid import cache
from voronoirt_tpu.grid.interpolate import initialise_sites
from voronoirt_tpu.grid.neighbors import build_native
from voronoirt_tpu.grid.voronoi import (VoronoiPlan, VoronoiSites,
                                        build_sites, build_voronoi_plan)

from .sampling import (DENSITIES, density_avg_extinction,
                       density_destruction, density_extinction,
                       density_invNH_invT, density_logNH_invT,
                       density_logNH_invT_rootv, density_temp_gradient,
                       density_total_extinction, rejection_sampling,
                       sample_sites)

__all__ = ["cache", "initialise_sites", "build_native", "VoronoiPlan",
           "VoronoiSites",
           "build_sites", "build_voronoi_plan", "DENSITIES",
           "density_avg_extinction", "density_destruction",
           "density_extinction", "density_invNH_invT", "density_logNH_invT",
           "density_logNH_invT_rootv", "density_temp_gradient",
           "density_total_extinction", "rejection_sampling", "sample_sites"]
