"""Typed run configuration.

The reference hard-codes every tunable in driver scripts and module consts
(SURVEY.md §5 "Config / flag system"); this module promotes the complete
tunable surface to one dataclass.

Reference anchors for defaults:
  eps / maxiter / nlam_bb / nlam_bf   src/compare_line.jl:10-18
  n_sweeps = 3                        src/characteristics.jl:25, lambda_iteration.jl:82
  upwind blend exponent p = 7.0       src/irregular_ray_tracing.jl:1
  collisional BOOST = 2.0e9           src/rates.jl:3
  natural broadening 4.702e8 s^-1     src/broadening.jl:76
  max_neighbours guess = 70           src/voronoi_utils.jl:42
  quadrature ul7n12                   src/compare_line.jl:216
  RNG seeds                           src/compare_line.jl:6-7, compare_continuum.jl:7-8

The port's own copy of voronoirt_tpu/config.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # --- iteration control ---
    eps: float = 1e-3             # Lambda-iteration convergence tolerance
    maxiter: int = 150            # max Lambda iterations
    n_sweeps: int = 3             # in-plane / in-layer Gauss-Seidel passes

    # --- wavelength sampling (line.jl:59-61) ---
    nlam_bb: int = 51             # bound-bound points (forced odd)
    nlam_bf: int = 20             # bound-free points per level

    # --- quadrature ---
    quadrature: str = "ul7n12"    # name of an angular quadrature set

    # --- irregular grid ---
    upwind_exponent: float = 7.0  # blend-weight exponent p
    max_neighbours: int = 70      # neighbour-list cap (reference max_guess)
    voronoi_order: str = "layer"  # sweep ordering: 'layer' = reference's
    # BFS layers + n_sweeps Jacobi passes; 'wavefront' = exact
    # topological levels over the upwind DAG (single pass, conserves
    # grazing-angle beams the fixed pass count truncates) with s-binned
    # relaxation only for seam-wrapping chains
    voronoi_relax_tol: float = 1e-7  # early-exit tolerance for the
    # wavefront relax repeats: stop once TWO consecutive repeats change I
    # by less than this relative sup-norm (the repeat count is calibrated
    # for the zero-opacity searchlight; with real opacity 1-2 repeats
    # converge).  The two-lap streak guards against a single stalled lap
    # truncating an unconverged low-opacity wrap chain.
    # 0 = always run the full fixed repeat count (bitwise schedule)

    # --- physics compat switches (SURVEY.md §7 "fidelity traps") ---
    # 'reference' reproduces the reference's published behaviour exactly,
    # including its documented quirks; 'fixed' corrects them.
    compat: str = "reference"
    boost: float = 2.0e9          # collisional-rate boost (rates.jl:3)
    gamma_natural: float = 4.702e8  # hard-coded natural broadening [s^-1]

    # --- numerics ---
    formal_interpolation: str = "linear"  # 'linear' (reference parity)
    # or 'bezier': quadratic DELO-Bezier source integration in the
    # regular grid's xy sweep segments (dCRP13); marching segments and
    # the Voronoi sweep stay linear
    dtype: str = "float64"        # physics dtype ('float64' on CPU tests)
    transport_dtype: Optional[str] = None  # sweep dtype; None => same as dtype
    lambda_chunk: Optional[int] = None  # stream wavelengths in blocks of
    # this size through profile->alpha->sweep->J (bounds peak memory at
    # production scale, e.g. 91 lambda x 3.5e6 sites); None = all at once
    rates_site_chunk: Optional[int] = None  # stream the rates/SE update
    # over site slabs of this size (with damping recomputed per lambda
    # chunk / rate slab from the per-cell gamma): the production-memory
    # path that never materializes the (nlam, n) damping cube.
    # Pointwise in space -- results are bitwise the full-path values
    stream_rates: bool = False    # regular grid: stream the WHOLE
    # iteration per lambda chunk (J chunk -> rate-integral accumulation
    # -> in-place S update): no resident J cube, second S buffer or
    # Planck cube (3 x 5.13 GB at 215x256x256 x 91).  Rates equal
    # calculate_R up to float addition order (tests/test_rates_stream)
    group_max_angles: Optional[int] = None  # cap on angles per batched
    # mirror-group sweep (regular grid); None = auto from lambda_chunk
    # (a group's extinction stack is P x chunk-field bytes of
    # execution temp -- see RegularEngine.__init__)

    # --- seeds ---
    seed: int = 2022              # site-sampling seed (compare_line.jl:7)

    # --- host preprocessing cache ---
    cache_dir: Optional[str] = None  # disk cache for tessellations and
    # per-direction sweep plans (grid/cache.py): the analog of the
    # reference persisting neighbours.txt (src/functions.jl:13-23).
    # None = off; drivers default it to .cache/vrt (or $VRT_CACHE_DIR)

    # --- checkpointing ---
    checkpoint_every: int = 1     # Lambda iterations between checkpoints

    @property
    def sweep_dtype(self) -> str:
        return self.transport_dtype or self.dtype

    def fixed(self) -> bool:
        return self.compat == "fixed"


DEFAULT = Config()
