#!/usr/bin/env python3
"""Smoke run of voronoirt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card's name and power limit (nvidia-smi); build the kernels;
  2. each hand-written kernel against its plain PyTorch version on the
     card, float64 and float32, at the production plane shape
     (52, 256, 256), at (16, 256, 256), at a ragged (5, 37, 29), at the
     per-angle plane of the Bezier iteration, (13, 256, 256), and at the
     continuum iteration's batch of one, (1, 256, 256), over every
     stencil-shift / march-direction combination with mixed per-element
     geometry: xy_plane (K1 one plane a launch), and K2 as
     march_coeffs, march_chain and their composition march_plane; then
     march_chain at the split march_plane.chain_split chooses (W warps
     a line, a halo exchange every H steps) bit for bit against the
     plain chain, float64 and float32, at B = 1, 13, 52, 124, 200 and
     lines of 32, 100, 256, 512 and 2048 points, every stencil shift,
     march axis and sign, and timed beside its bound at (B, 256, 256)
     for B = 1, 13, 52, 124; then
     xy_segment (K1 a segment a launch) at the same shapes and a
     320x320 plane (its global placement) and a 6x1 one, over every
     shift pair, both directions and segment lengths 1, 2, 7 and 214,
     bit-equal to its plain version and to a loop of xy_plane, a
     segment cut into pieces bit-equal to the whole one; then all
     timed at the production shape beside their bounds, K2 per march
     axis, and at (1, 256, 256), and at the production shape in float32
     too; a 214-plane xy segment at B = 52, 13 and 1 in both types, ms a
     step beside its bound and the per-plane K1's time; then the
     extinction's kernels (physics/extinction.py) on phase 5's fields,
     float64 and float32: alpha_tot_group at the production group (the
     first ul7n12 group's 4 angles and flips, (215, 52, 256, 256)), at
     one angle with its flips and on a ragged (5, 37, 29) tile (damping
     rows and no continuum too); alpha_tot at one production angle (215,
     13, 256, 256) and at B = 1, site-major at (442368, 13) and on the
     ragged tile; voigt_rows over the bound-bound window (51, 215, 256,
     256); all three at damping rows within 3 ulps of each Humlicek
     region boundary, each bit-equal to its plain version or within TOL
     (atol a share of the largest magnitude), then timed beside its
     bound (operations counted by region on the call's data), the group
     beside four per-angle launches, with the share of warps whose
     points span two regions and, from tools/e1_sass.py, E1's
     instructions a point in each region and the time the SMs need to
     issue its double-precision (float32: single) instructions; then
     V1, the Voronoi level steps (solvers/voronoi_level.py, one
     persistent launch a stage call): every stage kind ('gs', 'layer'
     with three Jacobi passes, 'exact', 'relax' as a plain lap, a lap
     with its change, a hoisted lap with and without, the hoisted laps
     forming the lean weights from the fields in the kernel and held
     against the plain level loop fed _precompute_lean) through the
     kernel and the plain level loop, bit for bit, the folded change
     too, one launch a call, float64 and float32, at B = 91, 13 and 1
     on V1_SMALL_SITES-site plans of two directions, and on direction 8
     of the production sites (VOR_SITES, built here for phase 7 too) at
     B = 91 (the line's batch) and, on its gs stage, B = 1 (the
     continuum's); then a level step of that direction's gs stage and
     of its 'layer' stage (every level self-referencing) timed beside
     its bytes bound at B = 91 (both types) and B = 1; then G1-G3, a
     mirror group's J emit (solvers/group_emit.py, csrc/group_emit.cu:
     group_emit the angle reduction of a piece of swept planes,
     group_stack the flipped S and I0 stacks, group_fold the J halves
     into the chunk's J), float64 and float32, with the first ul7n12
     group's flips and down flags, at (nz, B, nx, ny) (215, 13, 256,
     256), a ragged (5, 13, 37, 29) and (215, 1, 256, 256), G1 on pieces
     of 1, 7 and a production piece of planes, each bit-equal to its
     plain version, then timed at the production shape beside its bytes
     bound; then R1 and S1, the streamed iteration's rates and S update
     (physics/rates.py calculate_R_chunk, engine/s_update.py;
     csrc/rates.cu), float64 and float32, on phase 5's fields at the
     production grid and a ragged (5, 37, 29) tile: R1 chunk after chunk
     over the iteration's 7 lambda chunks, the carried row leading each,
     the rates added in place, then the lambda split's edge pair onto
     them; S1 at each chunk, and with a NaN in J; R1 as the standard
     loop launches it, all 91 rows into new rates at 442,368 sites
     (the production grid's first cells); each bit-equal to its plain
     version (or within TOL), then both timed at each production chunk
     beside their bounds, R1 by chunk kind (bound-bound, bound-free)
     and at the 442,368-site launch too; then X1, the Bezier xy plane
     step (solvers/xy_bezier.py, csrc/xy_bezier.cu), float64 and
     float32, at (13, 256, 256), (1, 256, 256), (5, 37, 29) and a
     y-split tile padded with 2-cell halos, over both stencil shifts in
     x and y, first 0 and 1 and fractions at 0, 1 and between, bit-equal
     to its plain version, one launch a call, then timed at (13, 512,
     512), the plane phase 8c steps it on, beside its bytes bound and
     the plain version's time; then X1 as a segment
     (solvers/xy_bezier_segment.py, csrc/xy_bezier_segment.cu), float64
     and float32, at (13, 256, 256), (1, 256, 256) and (5, 37, 29) on 48
     planes, every shift pair, both directions, segments from the
     boundary plane and after a march segment of 1, 2, 7 and 40 steps,
     each plane bit-equal to its plain version, one launch a segment;
     at (2, 16, 1040), a
     plane that does not fit its band, the wrapper refuses and a Bezier
     sweep steps through X1 a plane, bit-equal to the plain step's; then
     a step of a 214-step segment (one launch) timed at (13, 256, 256)
     (both types) beside its bound (alpha[t] and S[t] read, I[t]
     written; X1_OPS a point), X1's plane step and the plain version's
     on the same inputs, with its registers, local memory and the
     clusters the card runs at once;
  3. the 8 regular-sweep goldens (tests/golden/regular_sweep_fixtures.npz)
     through the port's short_characteristics on the card, float64;
  4. the small entry() step on the card against the same step on the CPU,
     its rates one R1 launch and no voigt_rows;
  5. one Lambda iteration of the production configuration
     (215x256x256 grid, 91 wavelengths, ul7n12, float64, lambda-streamed)
     through RegularEngine.run(), with every kernel's launch count
     (xy_segment one a piece of an xy segment, alpha_tot_group one a
     mirror group and lambda chunk, 21, alpha_tot and xy_plane none;
     rates_chunk and s_update one each a lambda chunk, 7, voigt_rows
     none, as on every iteration path: R1 runs once a slab of the rates
     in phase 8, a chunk of a rank's block and once more for its edge
     pair in phase 13, and once an iteration (the standard loop's rates)
     in phases 4, 6, 7 and 15's Voronoi iterations;
     every path below launches the extinction's kernels where it makes
     extinction -- the unsplit grouped path alpha_tot_group, the
     per-direction paths alpha_tot -- and never calls the eager
     Humlicek of the plain versions on the card; the J emit: group_emit
     one a K2 plane, an xy piece and a group sweep's boundary plane,
     group_stack two and group_fold one a group sweep, as in phases 13,
     14 and 15, and on no other path; the sha256 of S and the
     populations, which tools/phase5_checksum.py prints of any
     checkout's iteration; after phases 5, 7, 8,
     12, 15 and 16, every alpha_tot_group / alpha_tot / voigt_rows call
     shape the path made that no earlier phase held is held against the
     plain version at that shape, on this phase's fields cut to its
     cells);
  6. the Voronoi NLTE chain goldens (tests/golden/nlte_fixtures.npz
     vor_*: 500 sites, 'layer' order, 3 iterations) through
     VoronoiEngine.run() on the card, and wavefront sweeps of every
     ul7n12 direction with the adaptive relax exit, card against CPU;
     both launch V1, one launch a stage or relax-lap call (level steps
     counted apart), and never the plain level loop or the lean
     precompute on the card (as every Voronoi path below: phases 7, 9,
     10, 11, 13, 14, 15);
  7. two Voronoi Lambda iterations ('layer' order) at the reference's
     quarter-resolution production count, 442,368 sites sampled from the
     phase-5 atmosphere, 91 wavelengths, ul7n12, float64; set-up and
     iteration seconds, per-direction seconds, level steps, peak memory
     and launch counts, V1's equal to the stage calls (the 'wavefront'
     order runs in phase 6 only); the first J pass's direction 8 sweep
     run again through V1 and through the plain level loop, timed, both
     bit-equal to the iteration's own output;
  8. the Bezier formal solution: Bezier (and linear) sweeps of every
     ul7n12 direction at a small size, card against CPU, the Bezier
     ones one xy_bezier_segment launch a Bezier xy segment and no X1,
     the linear ones neither; then one full Lambda iteration at the phase-5 grid through
     RegularEngine.run() with formal_interpolation='bezier', lambda_chunk
     13 and the rates in slabs of z-planes (the standard loop: S_old,
     S_new, J and B0 resident), with seconds, the J-pass share, the
     kernels' launch counts (xy_bezier_segment's one a Bezier xy
     segment of the iteration, X1's none), peak memory and the
     sha256 of S and the populations (tools/profile_iteration.py
     --interpolation bezier prints them of any checkout); one
     march_plane call against its plain version on its own inputs and
     one xy_bezier_segment call (the second) on its first XBS_HOLD
     planes against its plain version, bit for bit; a Bezier xy step's
     time (a segment's step, X1's plane step and the plain step's)
     beside K1's, K1 held against its plain version there too; then
     (8c) one Bezier J pass on a 48x512x512 grid, whose plane does not
     fit the segment kernel's band, 13 wavelengths: one X1 launch a
     Bezier xy step and no segment launch, an X1 call and a march_plane
     call held against their plain versions, the extinction's new call
     shapes held too, J finite and positive;
  9. angle distribution: compute_J serial against
     distribute_angles(engine, [cuda:0, cuda:0]), regular (linear and
     Bezier: xy_bezier_segment's launches one a segment on both sides,
     no X1, neither in the linear ones) and Voronoi (its launches), at
     a small size;
 10. the continuum scattering iteration (a batch of ONE wavelength
     through every sweep): card against CPU at a small size, then
     lambda_continuum_regular at the phase-5 grid, 3 iterations, with
     the kernels' launch counts, and lambda_continuum_voronoi on phase
     7's sites, 2 iterations, a V1 launch a stage call;
 11. checkpoint and resume on the card: a small run killed after its
     second write_state and resumed equals the uninterrupted run,
     through a store that keeps the arrays in memory and, where h5py
     imports, through the HDF5 file; one small J pass under
     observability.device_trace; then the searchlight driver (flux kept
     for all 12 directions; then --irregular --n 21, through V1) and
     the line_nlte driver with --interpolation bezier (through
     xy_bezier_segment, no X1), as a user calls them;
 12. the last two drivers at full width: synthesize() on phase 5's
     populations through the synthesize driver's _load_regular
     (215x256x256, 91 wavelengths, float64), disk centre (theta 180)
     and slanted (theta 135), with seconds, peak memory, launch counts,
     finite non-negative intensities, a line centre brighter than the
     far wing and its brightness temperature; one xy_segment call of
     the first and one march_plane call of the second held against the
     plain versions on their own inputs; then the continuum_study
     driver on the production atmosphere (skips 1-4, STUDY_SITES
     sites);
 13. the lambda-split regular iteration at the production width: two
     spawned ranks (NCCL on two cards where two are visible, else gloo,
     both on cuda:0) each run one streamed iteration of phase 5's
     configuration on its block of the 91 wavelengths padded to 92,
     with seconds, collective seconds, peak memory and launch counts a
     rank (alpha_tot_group 3 a lambda chunk of the rank's block, no
     alpha_tot); one xy_segment and one march_plane call of a rank's last
     lambda chunk (B = 28) held against the plain versions; the S rows
     at the block edges and the populations against phase 5's, with
     the cell and level of the largest populations difference; then
     dryrun_multichip(2) on the card, and
     with one card also dryrun_multichip(1) over NCCL (each reports its
     split Voronoi iteration's V1 launches on rank 0, required);
 14. the regular iteration split over the y axis of a mesh
     (parallel/mesh.py): two spawned ranks (NCCL on two cards where two
     are visible, else gloo, both on cuda:0) each run one streamed
     iteration of phase 5's configuration on their half of the grid in
     y, K1 on halo-padded tiles and K2 on gathered march planes, with
     seconds, the halo and gather calls, bytes and seconds, peak memory
     and launch counts a rank (the extinction per angle, alpha_tot, on
     the padded tiles); one xy_plane call on a padded tile and
     one march_plane call on a gathered plane of a rank held against
     the plain versions; S at phase 13's rows and the populations
     against phase 5's at phase 13's bars; then dryrun_multichip(4)
     (lam 2 x y 2, and lam 2 x site 2 for the Voronoi engine, whose V1
     launches on rank 0 are required) over gloo on the card;
 15. float32 production (Config(dtype="float32"), the JAX package's
     production mode): one streamed iteration of phase 5's
     configuration in float32, with seconds, the J-pass share, peak
     memory and launch counts (K2's equal to phase 5's, xy_segment's
     one a piece), the second xy_segment and the 100th K2 call on the
     production batch (52 planes) held against the plain versions at
     TOL["float32"], and S and the populations held against
     phase 5's float64 result at the bar of
     tests/test_f32_physics.py::test_nlte_iteration_f32_vs_f64 (rtol
     5e-3 plus 5e-3 of the float64 array's largest magnitude), with the
     worst entry; then two 'layer' iterations in float32 on phase 7's
     sites with phase 7's plans, seconds, peak and launches (V1's equal
     to phase 7's), held against phase 7's float64 result at the same
     bar;
 16. the paper's regular-vs-Voronoi line figures at full width
     (voronoirt_tpu_torch.analysis.line_figures.figures, no drawing):
     phase 5's run and phase 7's 442,368 sites, as in-memory mappings
     in the checkpoint schema, the sites rasterised by inverse distance
     onto phase 5's 215x256x256 grid, each synthesised at mu 1.0, 0.6
     and 0.2 (theta 180: xy_segment only; 126.87 and 101.54: yz
     segments, K2 only), with each synthesis's seconds and launches,
     the resampling's seconds and the peak memory; one xy_segment and
     one march_plane call held against the plain versions; every cube
     finite and >= 0, the line centre brighter than the far wing and its
     T_b between 3,000 and 50,000 K in each run, the centre's relative
     difference finite, and, when phase 12 ran, the regular mu = 1 cube
     equal to phase 12's theta 180 cube bit for bit.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside it, and fails if
jax or any module of the JAX package (voronoirt_tpu) was imported.

    python3 chip_smoke.py --phases 5,14

runs phase 1 and the phases named (a phase that needs phase 5's result
needs 5 named too, and phases 15 and 16 need 5 and 7: `--phases 5,7,15`,
`--phases 5,7,16`) and
prints neither JSON line: a check while the code changes, not the
smoke's result.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager

HERE = os.path.dirname(os.path.abspath(__file__))

PROD = dict(nz=215, nx=256, ny=256, nlam_bb=51, nlam_bf=20,
            quadrature="ul7n12", lambda_chunk=13, group_max_angles=4)
# the reference's quarter-resolution Voronoi production count
# (compare_line.jl:64-68)
VOR_SITES = 442_368
# phase 12: site counts of the continuum study (each pays a tessellation
# and six inverse-distance resamplings onto the 14M-point grid, on the
# host); which march_plane call of a synthesis is held against the plain
# version (and XY_SEG_CALL's xy_segment call)
STUDY_SITES = "1e5"
SYNTH_CALL = 100
# phase 13: ranks, and which march_plane call of a rank's iteration is
# held against the plain version: the 100th on the batch of the block's
# last lambda chunk (7 wavelengths at 2 ranks: 28 planes, which phase 2
# does not check); its xy_segment call there is XY_SEG_CALL's
LAM_RANKS = 2
LAM_CALL = 100
# phase 14: ranks of the y axis, and which K1 call (on a padded tile) and
# K2 call (on a gathered plane) of a rank is held against the plain one
MESH_RANKS = 2
MESH_CALL = 100
TOL = {"float64": dict(rtol=1e-12, atol=0.0),
       "float32": dict(rtol=2e-5, atol=1e-6)}
# which xy_segment call (a piece of an xy segment) of phases 12, 13 and
# 15 is held against the plain version: the second, whose carried plane
# is not the boundary's
XY_SEG_CALL = 2
# the hand-written kernels of the regular sweep: K1 as xy_segment (the
# unsplit sweep) and xy_plane (the split sweep); march_plane is K2 as the
# composition of march_coeffs and march_chain
SWEEP_KERNELS = ("xy_segment", "xy_plane", "march_plane", "march_coeffs",
                 "march_chain")
# the extinction's (physics/extinction.py, csrc/extinction.cu): a lambda
# chunk's extinction for a mirror group into its flipped stack and for
# one direction, and the rates' bound-bound profile
EXT_KERNELS = ("alpha_tot_group", "alpha_tot", "voigt_rows")
# a mirror group's J emit (solvers/group_emit.py, csrc/group_emit.cu): G1
# the angle reduction of the swept planes, G2 the flipped S and I0
# stacks, G3 the fold of the J halves into the chunk's J; every grouped
# regular path (phases 5, 13, 14, 15) launches all three
GROUP_KERNELS = ("group_emit", "group_stack", "group_fold")
# the streamed iteration's per-chunk rates and S update
# (physics/rates.py calculate_R_chunk, engine/s_update.py; csrc/rates.cu):
# R1 a lambda block's rate integrals added into the running rates, S1
# the chunk's S update and the criterion's maximum; every rate path
# launches R1 (the streamed iteration and its lambda split's edge pair,
# the standard loop's rates at once or in slabs, entry(): phases 4-8,
# 13-15), the streamed iteration S1 too
RATE_KERNELS = ("rates_chunk", "s_update")
# X1, the Bezier xy step, as a segment (solvers/xy_bezier_segment.py,
# csrc/xy_bezier_segment.cu): one launch a Bezier xy segment on an
# unsplit grid whose plane fits its band (phases 8, 9, 11); and one
# plane a launch (solvers/xy_bezier.py, csrc/xy_bezier.cu) on a split
# grid and on planes that do not fit (phase 8c's 512 x 512 J pass); no
# linear path launches either
X1 = "xy_bezier"
XBS = "xy_bezier_segment"
KERNELS = (SWEEP_KERNELS + EXT_KERNELS + GROUP_KERNELS + RATE_KERNELS
           + (X1, XBS))
# the extinction of the unsplit grouped regular path (phases 5, 13, 15)
# and of the per-direction paths (Voronoi, Bezier, the split grid); no
# iteration path launches E2 (calculate_R's profile)
GROUPED_EXT = ("alpha_tot_group",)
PER_ANGLE_EXT = ("alpha_tot",)
# the kernels that take one plane a launch
PLANE_KERNELS = SWEEP_KERNELS[1:]
# V1, the Voronoi level steps (solvers/voronoi_level.py,
# csrc/voronoi_level.cu): one launch a stage or relax-lap call; the
# count of those calls (sweep_voronoi.STAGE_CALLS), and of its plain
# version's runs and of the relax hoist's eager precompute on the card,
# which no path makes
V1 = "voronoi_stage"
V1_CALLS = "stage calls"
EAGER_LEVELS = "plain level loop on the card"
EAGER_HOIST = "lean precompute on the card"
# the kernels of the Voronoi NLTE iteration: a direction's extinction,
# the level steps and the rates (the standard loop's: one R1 launch an
# iteration over all the line's rows)
VORONOI = PER_ANGLE_EXT + ("rates_chunk", V1)
# phase 2: V1's small plan (sites), its batches and the stage functions
# a relax stage is held through (a plain lap, a lap with its change, the
# hoisted lap without and with it); the directions of its holds: ul7n12
# direction 2 is steep (|mu| 0.888), 8 grazing (0.205)
V1_SMALL_SITES = 3000
V1_BATCHES = (91, 13, 1)
# the production direction's holds, (B, plan label ending): the line's
# batch at every stage kind, the continuum's at the gs stage ('layer'
# order's)
V1_PRODUCTION_BATCHES = ((91, ""), (1, " gs"))
V1_RELAX_FNS = ("stage", "lap", "hoisted", "hoisted_d")
# V1's grid capped at these blocks for holds on the small plans at B =
# 13: many items a thread, as the widest levels of the largest plans give
# it
V1_CAPPED_BLOCKS = (1, 3)
V1_DIRECTIONS = (2, 8)
# phase 7: which sweep of the two iterations is held kernel against plain
# loop: the 9th, the first J pass's direction 8 (grazing; the first
# iteration, so the host copies stay out of the second, the one timed)
V1_CALL = 9
# phase 2's plane shapes (B, Nx, Ny): the production group plane (4
# angles x lambda_chunk), a smaller full plane, a ragged one, the
# per-angle plane of the Bezier iteration (lambda_chunk) and the
# continuum iteration's (one)
PHASE2_SHAPES = ((4 * PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
                 (16, 256, 256), (5, 37, 29),
                 (PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
                 (1, PROD["nx"], PROD["ny"]))
# phase 2: K2's chain split (march_plane.chain_split) held at these
# batches and lines (a line of SPLIT_COLUMNS columns, 3 passes), and
# timed at (B, 256, 256) for the batches of SPLIT_TIMED
SPLIT_BATCHES = (1, 13, 52, 124, 200)
SPLIT_LINES = (32, 100, 256, 512, 2048)
SPLIT_COLUMNS = 80
SPLIT_TIMED = (1, 13, 52, 124)
# the kernels an unsplit linear regular sweep launches
UNSPLIT = ("xy_segment", "march_plane", "march_coeffs", "march_chain")
# phase 2: xy segment lengths held against the plain version and the
# per-plane kernel (214: a whole production segment), and the length
# and piece of the segment cut into pieces
SEG_LENGTHS = (1, 2, 7, 214)
SEG_CUT = (23, 5)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA's data sheet)
# floating-point operations a second outside the tensor cores, the same
OPS_PER_S = {"float64": 34e12, "float32": 67e12}
ELEMENT_BYTES = {"float64": 8, "float32": 4}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------ phase 2

def _rand(gen, shape, lo, hi, dtype, log=False):
    import torch
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    v = lo + (hi - lo) * u
    if log:
        v = 10.0 ** v
    return v.to(dtype=dtype, device="cuda")


def _planes(gen, B, nx, ny, dtype):
    # extinction over 7 decades so dtau crosses every weight branch
    a_p = _rand(gen, (B, nx, ny), -5.0, 2.0, dtype, log=True)
    a_c = _rand(gen, (B, nx, ny), -5.0, 2.0, dtype, log=True)
    s_p = _rand(gen, (B, nx, ny), 0.1, 1.0, dtype)
    s_c = _rand(gen, (B, nx, ny), 0.1, 1.0, dtype)
    i_p = _rand(gen, (B, nx, ny), 0.0, 1.0, dtype)
    return a_p, a_c, s_p, s_c, i_p


def _fractions(gen, B, dtype):
    """Per-element fractions in [0, 1], with exact 0 and 1 among them."""
    f = _rand(gen, (B,), 0.0, 1.0, dtype)
    f[0] = 0.0
    if B > 1:
        f[1] = 1.0
    return f


def _compare(name, got, want, dtype_name):
    import torch
    err = (got - want).abs()
    tol = TOL[dtype_name]
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    require(bool(torch.isfinite(got).all()), f"{name} output not finite")
    require(not bool(bad.any()),
            f"{name} disagrees with its plain version: max abs err "
            f"{float(err.max()):.3e}, max rel err "
            f"{float((err / want.abs()).max()):.3e} ({dtype_name})")
    return float(err.max()), float((err / want.abs()).max())


def check_kernels():
    """Phase 2a: each per-plane kernel against its plain version on the
    card, at PHASE2_SHAPES; K2 as
    its two kernels, march_coeffs and march_chain (on the kernel's own
    scratch), and as their composition march_plane.  Returns {dtype
    name: {kernel: max abs err}}."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    worst = {d: dict.fromkeys(PLANE_KERNELS, 0.0) for d in TOL}
    gen = torch.Generator().manual_seed(2024)
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        for (B, nx, ny) in PHASE2_SHAPES:
            err = dict.fromkeys(PLANE_KERNELS, (0.0, 0.0))

            def compare(name, got, want):
                torch.cuda.synchronize()
                e = _compare(name, got, want, dtype_name)
                err[name] = tuple(map(max, err[name], e))

            for sxs in (0, -1):
                for sys_ in (0, -1):
                    planes = _planes(gen, B, nx, ny, dtype)
                    r = _rand(gen, (B,), -1.0, 1.0, dtype, log=True)
                    fx, fy = _fractions(gen, B, dtype), _fractions(gen, B,
                                                                   dtype)
                    compare("xy_plane", xp.xy_plane(*planes, r, fx, fy, sxs,
                                                    sys_),
                            xp.xy_plane_plain(*planes, r, fx, fy, sxs, sys_))
            for axis in ("x", "y"):
                line = ny if axis == "x" else nx
                for sign in (1, -1):
                    for s_base in (0, -1):
                        planes = _planes(gen, B, nx, ny, dtype)
                        r = _rand(gen, (B,), -1.0, 1.0, dtype, log=True)
                        f_line = _fractions(gen, B, dtype)
                        w_cur = _rand(gen, (B,), 0.0, 1.0, dtype)
                        c_prev = (torch.arange(B, device="cuda") % 2).to(dtype)
                        args = (*planes, r, f_line, w_cur, c_prev)
                        st = dict(march_axis=axis, sign=sign, s_base=s_base)
                        scratch = mp.march_coeffs(*args, **st)
                        compare("march_coeffs", scratch,
                                mp.march_coeffs_plain(*args, **st))
                        compare("march_chain",
                                mp.march_chain(scratch, f_line, line,
                                               n_sweeps=3, **st),
                                mp.march_chain_plain(scratch, f_line, line,
                                                     n_sweeps=3, **st))
                        compare("march_plane",
                                mp.march_plane(*args, n_sweeps=3, **st),
                                mp.march_plane_plain(*args, n_sweeps=3,
                                                     **st))
            print(f"  {dtype_name} B={B} {nx}x{ny}: max abs err (rel) "
                  + "; ".join(f"{k} {a:.3e} ({b:.3e})"
                              for k, (a, b) in err.items()), flush=True)
            for k in PLANE_KERNELS:
                worst[dtype_name][k] = max(worst[dtype_name][k], err[k][0])
    return worst


def _chain_scratch(gen, B, N, M, dtype):
    """A march_chain scratch (B, N, line_pad(M), 2) made on the card:
    coeff in [0, 1), const in [-0.3, 0.7), zero padding pairs; and f_line
    with an exact 0 and 1 among its values."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda",
                                  dtype=torch.float64)
    scratch = torch.zeros((B, N, mp.line_pad(M), 2), dtype=dtype,
                          device="cuda")
    scratch[:, :, :M, 0] = u(B, N, M).to(dtype)
    scratch[:, :, :M, 1] = (u(B, N, M) - 0.3).to(dtype)
    f_line = u(B).to(dtype)
    f_line[0] = 0.0
    if B > 1:
        f_line[-1] = 1.0
    return scratch, f_line


def check_march_split():
    """Phase 2: march_chain at the split march_plane.chain_split chooses
    (W warps a line, an exchange every H steps), bit for bit (max abs err
    0) against march_chain_plain, float64 and float32, at every B of
    SPLIT_BATCHES and line of SPLIT_LINES, every stencil shift, march axis
    and sign; then a launch at (B, 256, 256), 3 passes, for B in
    SPLIT_TIMED, beside the chain's bound.  Returns {dtype: max abs err}
    and {B: (split, us, bound us)}."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp

    gen = torch.Generator(device="cuda").manual_seed(2022)
    worst = {}
    for dtype_name in TOL:
        dtype = getattr(torch, dtype_name)
        worst[dtype_name] = 0.0
        for B in SPLIT_BATCHES:
            for M in SPLIT_LINES:
                N = SPLIT_COLUMNS
                scratch, f_line = _chain_scratch(gen, B, N, M, dtype)
                split = mp.chain_split(M)
                for axis in ("x", "y"):
                    for sign in (1, -1):
                        for s_base in (0, -1):
                            st = dict(march_axis=axis, sign=sign,
                                      s_base=s_base, n_sweeps=3)
                            got = mp.march_chain(scratch, f_line, M, **st)
                            want = mp.march_chain_plain(scratch, f_line, M,
                                                        **st)
                            err = float((got - want).abs().max())
                            require(bool(torch.isfinite(got).all()) and
                                    err == 0.0,
                                    f"march_chain split {split} at B={B} "
                                    f"M={M} {axis} sign {sign} s_base "
                                    f"{s_base} ({dtype_name}): max abs err "
                                    f"{err:.3e} against the plain chain")
                            worst[dtype_name] = max(worst[dtype_name], err)
            print(f"  march_chain split ({dtype_name}) B={B}: lines "
                  f"{SPLIT_LINES} at "
                  + ", ".join(f"(W, H) = {mp.chain_split(M)}"
                              for M in SPLIT_LINES)
                  + f", max abs err {worst[dtype_name]:.1e} against the "
                  "plain chain", flush=True)
    times = {}
    for B in SPLIT_TIMED:
        n = PROD["nx"]
        scratch, f_line = _chain_scratch(gen, B, n, PROD["ny"], torch.float64)
        st = dict(march_axis="x", sign=-1, s_base=-1, n_sweeps=3)
        split = mp.chain_split(PROD["ny"])
        us = 1e3 * _time_ms(lambda: mp.march_chain(
            scratch, f_line, PROD["ny"], **st), 20)
        bound = 1e3 * _bounds(B, n, PROD["ny"])["march_chain"][0]
        times[B] = (split, us, bound)
        print(f"  march_chain (B={B}, {n}x{PROD['ny']}, float64, 3 passes): "
              f"split {split} {us:.2f} us; bound {bound:.2f} us, "
              f"{100 * bound / us:.1f} % of it", flush=True)
    return worst, times


def _seg_fields(gen, nz, B, nx, ny, dtype):
    """alpha (7 decades), S and I0 for an xy segment, made on the card
    from `gen` (a CUDA generator): the production fields are 5.9 GB each
    in float64."""
    import torch
    u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda",
                                  dtype=torch.float64)
    alpha = (10.0 ** (-5.0 + 7.0 * u(nz, B, nx, ny))).to(dtype)
    S = (0.1 + 0.9 * u(nz, B, nx, ny)).to(dtype)
    return alpha, S, u(B, nx, ny).to(dtype)


def _seg_geometry(gen, n, B, dtype):
    """Per-step, per-element r, fx, fy; exact 0 and 1 fractions among
    them."""
    import torch
    u = lambda: torch.rand(n, B, generator=gen, device="cuda",
                           dtype=torch.float64)
    r = (10.0 ** (-1.0 + 2.0 * u())).to(dtype)
    fx, fy = u().to(dtype), u().to(dtype)
    fx[0, 0], fy[0, -1], fx[-1, -1] = 0.0, 1.0, 1.0
    return r, fx, fy


def _seg_steps(nz, dirn, n):
    return (list(range(1, n + 1)) if dirn == 1
            else list(range(nz - 2, nz - 2 - n, -1)))


def _hold_segment(args, out, against_k1=False):
    """out, the planes an xy_segment call made from `args`, against its
    plain version on the same inputs, step by step (the plain planes are
    made one at a time, so no second stack of planes is held), at TOL of
    the dtype; with against_k1, against a loop of the per-plane kernel
    xy_plane too, bit for bit.  The steps' errors stay on the card until
    the end.  Returns the max abs and rel error against the plain
    version."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys_ = args[:10]
    dtype_name = str(out.dtype).replace("torch.", "")
    tol = TOL[dtype_name]
    errs, bad, k1_off = [], [], []
    I = K = I0
    for j, t in enumerate(steps):
        planes = (alpha[t - dirn], alpha[t], S[t - dirn], S[t])
        geom = (r[j], fx[j], fy[j], sxs, sys_)
        I = xp.xy_plane_plain(*planes, I, *geom)
        e = (out[j] - I).abs()
        errs.append(torch.stack([e.max(), (e / I.abs()).max()]))
        bad.append((e > tol["atol"] + tol["rtol"] * I.abs()).any()
                   | ~torch.isfinite(out[j]).all())
        if against_k1:
            K = xp.xy_plane(*planes, K, *geom)
            k1_off.append((out[j] != K).any())
    e_abs, e_rel = (float(v) for v in torch.stack(errs).max(0).values)
    require(not bool(torch.stack(bad).any()),
            f"xy_segment disagrees with its plain version (or is not "
            f"finite): max abs err {e_abs:.3e}, max rel err {e_rel:.3e} "
            f"({dtype_name})")
    require(not (k1_off and bool(torch.stack(k1_off).any())),
            "xy_segment differs from a loop of the per-plane kernel")
    return e_abs, e_rel


def check_xy_segment(shapes):
    """Phase 2b: xy_segment on the card against its plain version and a
    loop of the per-plane kernel, bit for bit, at `shapes`, a plane
    larger than a cluster's shared memory holds (the kernel's global
    placement) and one a single column wide (the y wrap onto itself),
    float64 and float32, over every shift pair, both directions and
    SEG_LENGTHS; a segment of SEG_CUT[0] planes cut into pieces of
    SEG_CUT[1] against the whole one.  Returns {dtype name: max abs
    err}."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_segment as xs

    nz = max(SEG_LENGTHS) + 1
    worst = dict.fromkeys(TOL, 0.0)
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(2025)
        for (B, nx, ny) in shapes + ((2, 320, 320), (3, 6, 1)):
            alpha, S, I0 = _seg_fields(gen, nz, B, nx, ny, dtype)
            lay = xs.layout(nx, ny, dtype)
            runs = 0
            for sxs in (0, -1):
                for sys_ in (0, -1):
                    for dirn in (1, -1):
                        for n in SEG_LENGTHS:
                            steps = _seg_steps(nz, dirn, n)
                            geom = _seg_geometry(gen, n, B, dtype)
                            args = (alpha, S, I0, steps, dirn, *geom, sxs,
                                    sys_)
                            out = torch.empty((n, B, nx, ny), dtype=dtype,
                                              device="cuda")
                            xs.xy_segment(*args, out)
                            torch.cuda.synchronize()
                            e = _hold_segment(args, out, True)
                            require(e[0] == 0.0, "xy_segment differs from "
                                                 "its plain version")
                            runs += 1
                            del out
            # a segment cut into pieces, each from the last plane of the
            # one before, against the whole segment
            n, k = SEG_CUT
            steps = _seg_steps(nz, -1, n)
            r, fx, fy = _seg_geometry(gen, n, B, dtype)
            whole = xs.xy_segment(alpha, S, I0, steps, -1, r, fx, fy, -1, 0,
                                  torch.empty((n, B, nx, ny), dtype=dtype,
                                              device="cuda"))
            carry, pieces = I0, []
            for j0 in range(0, n, k):
                sl = slice(j0, j0 + k)
                p = xs.xy_segment(alpha, S, carry, steps[sl], -1, r[sl],
                                  fx[sl], fy[sl], -1, 0,
                                  torch.empty((len(steps[sl]), B, nx, ny),
                                              dtype=dtype, device="cuda"))
                pieces.append(p)
                carry = p[-1].clone()
            torch.cuda.synchronize()
            require(torch.equal(torch.cat(pieces), whole),
                    "xy_segment in pieces differs from the whole segment")
            print(f"  xy_segment {dtype_name} B={B} {nx}x{ny} ({lay}): "
                  f"{runs} segments of lengths {SEG_LENGTHS}, 4 shift "
                  f"pairs, both directions: bit-equal to the plain version "
                  f"and to the per-plane kernel; {n} planes in pieces of "
                  f"{k} bit-equal to one call", flush=True)
            del alpha, S, I0, whole, pieces, carry
            torch.cuda.empty_cache()
    return worst


def time_segment(B, dtype_name):
    """A 214-plane xy segment at (B, 256, 256) in `dtype_name` (in pieces
    of at most piece_steps planes, as the sweep cuts it): the kernel's
    ms a step, the plain version's, the per-plane kernel's on the same
    inputs, and the bound of a step (three planes).  Returns (ms, plain
    ms, K1 ms, bound ms, bound_by)."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    from voronoirt_tpu_torch.solvers import xy_segment as xs

    nx, ny = PROD["nx"], PROD["ny"]
    dtype = getattr(torch, dtype_name)
    n = PROD["nz"] - 1
    gen = torch.Generator(device="cuda").manual_seed(11)
    alpha, S, I0 = _seg_fields(gen, PROD["nz"], B, nx, ny, dtype)
    r, fx, fy = _seg_geometry(gen, n, B, dtype)
    steps = list(range(1, n + 1))
    k = min(n, xs.piece_steps(B, nx, ny, dtype))
    buf = torch.empty((k, B, nx, ny), dtype=dtype, device="cuda")

    def segment():
        carry = I0
        for j0 in range(0, n, k):
            j1 = min(j0 + k, n)
            out = xs.xy_segment(alpha, S, carry, steps[j0:j1], 1, r[j0:j1],
                                fx[j0:j1], fy[j0:j1], -1, 0, buf[:j1 - j0])
            carry = out[-1].clone()

    def per_plane(step):
        def run():
            I = I0
            for j, t in enumerate(steps):
                I = step(alpha[t - 1], alpha[t], S[t - 1], S[t], I, r[j],
                         fx[j], fy[j], -1, 0)
        return run

    ms = _time_ms(segment, 5) / n
    k1 = _time_ms(per_plane(xp.xy_plane), 3) / n
    plain = _time_ms(per_plane(xp.xy_plane_plain), 1) / n
    bound, by = _bounds(B, nx, ny, dtype_name=dtype_name)["xy_segment"]
    print(f"  xy_segment, {n} planes at (B={B}, {nx}x{ny}, {dtype_name}) in "
          f"pieces of {k}: {ms:.5f} ms a step; per-plane K1 on the same "
          f"inputs {k1:.5f} ms; plain {plain:.4f} ms; bound {bound:.5f} ms "
          f"({by}, three planes), {100 * bound / ms:.1f} % of it; "
          f"{xs.layout(nx, ny, dtype)}", flush=True)
    del alpha, S, I0, buf
    torch.cuda.empty_cache()
    return ms, plain, k1, bound, by


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, reps, kernel):
    """The device time (ms) a call of fn spends in kernels whose name
    holds `kernel`, from torch.profiler (CUPTI) over reps calls: a
    short kernel's own time, where CUDA events around back-to-back calls
    measure the host's launch rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    us = sum(device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    require(us > 0, f"the profiler saw no device time of {kernel}")
    return us / 1e3 / reps


def _bound_ms(nbytes, ops, dtype_name):
    """(ms, 'bytes' | 'operations'): the larger of nbytes over the card's
    memory rate and ops over its rate for the dtype, and which it is."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / OPS_PER_S[dtype_name]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _bounds(B, nx, ny, n_sweeps=3, dtype_name="float64"):
    """Least time (ms) of each kernel's work at (B, nx, ny) in
    `dtype_name` on an H100 SXM: the larger of its bytes (each input
    plane read once, each output written once, ELEMENT_BYTES a point)
    over 3.35 TB/s and its floating-point operations over the dtype's
    rate outside the tensor cores, 34 TFLOP/s float64 or 67 TFLOP/s
    float32 (NVIDIA's data sheet); operations counted per point from
    the CUDA source, an exp as one.  Returns {kernel: (ms, 'bytes' |
    'operations')}."""
    pts = B * nx * ny
    plane = ELEMENT_BYTES[dtype_name] * pts
    work = {"xy_plane": (6 * plane, 60 * pts),
            # a step of a segment: alpha[t] and S[t] read, I[t] written
            "xy_segment": (3 * plane, 60 * pts),
            "march_coeffs": (7 * plane, 50 * pts),
            "march_chain": (3 * plane, 5 * n_sweeps * pts),
            "march_plane": (6 * plane, (50 + 5 * n_sweeps) * pts)}
    return {k: _bound_ms(nbytes, ops, dtype_name)
            for k, (nbytes, ops) in work.items()}


def time_kernels(B, dtype_name="float64"):
    """Kernel and plain times at (B, 256, 256) in `dtype_name`, beside
    each kernel's bound: B = 4 angles x lambda_chunk wavelengths is the
    production group plane, B = 1 the continuum iteration's.  K2 per
    march axis, and split into its two kernels."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    nx, ny = PROD["nx"], PROD["ny"]
    dtype = getattr(torch, dtype_name)
    bound = _bounds(B, nx, ny, dtype_name=dtype_name)
    gen = torch.Generator().manual_seed(7)
    planes = _planes(gen, B, nx, ny, dtype)
    r = _rand(gen, (B,), -1.0, 1.0, dtype, log=True)
    f1, f2 = (_fractions(gen, B, dtype) for _ in range(2))
    c_prev = (torch.arange(B, device="cuda") % 2).to(dtype)
    times = {}
    xy_args = (*planes, r, f1, f2, -1, 0)
    times["xy_plane"] = (_time_ms(lambda: xp.xy_plane(*xy_args), 50),
                         _time_ms(lambda: xp.xy_plane_plain(*xy_args), 10))
    print(f"  xy_plane (B={B}, {nx}x{ny}, {dtype_name}): kernel "
          f"{times['xy_plane'][0]:.4f} ms, plain {times['xy_plane'][1]:.4f} "
          f"ms, bound {bound['xy_plane'][0]:.4f} ms "
          f"({100 * bound['xy_plane'][0] / times['xy_plane'][0]:.1f} %)",
          flush=True)
    acc = {k: ([], []) for k in ("march_plane", "march_coeffs",
                                 "march_chain")}
    m_args = (*planes, r, f1, f2, c_prev)
    for axis in ("x", "y"):
        st = dict(march_axis=axis, sign=-1, s_base=-1)
        line = ny if axis == "x" else nx
        scratch = mp.march_coeffs(*m_args, **st)
        fns = {"march_plane": (
                   lambda: mp.march_plane(*m_args, n_sweeps=3, **st),
                   lambda: mp.march_plane_plain(*m_args, n_sweeps=3, **st)),
               "march_coeffs": (
                   lambda: mp.march_coeffs(*m_args, **st),
                   lambda: mp.march_coeffs_plain(*m_args, **st)),
               "march_chain": (
                   lambda: mp.march_chain(scratch, f1, line, n_sweeps=3,
                                          **st),
                   lambda: mp.march_chain_plain(scratch, f1, line,
                                                n_sweeps=3, **st))}
        for k, (kern, plain) in fns.items():
            acc[k][0].append(_time_ms(kern, 20))
            acc[k][1].append(_time_ms(plain, 2))
        kp = acc["march_plane"][0][-1]
        print(f"  march_plane axis={axis} (B={B}, {nx}x{ny}, {dtype_name}): "
              f"kernel {kp:.4f} ms = march_coeffs "
              f"{acc['march_coeffs'][0][-1]:.4f} + march_chain "
              f"{acc['march_chain'][0][-1]:.4f} ms (alone); plain "
              f"{acc['march_plane'][1][-1]:.4f} ms; bound "
              f"{bound['march_plane'][0]:.4f} ms ({bound['march_plane'][1]}),"
              f" {100 * bound['march_plane'][0] / kp:.1f} % of it",
              flush=True)
    for k, (km, pm) in acc.items():
        times[k] = (sum(km) / 2, sum(pm) / 2)
    print(f"  march_plane mean of both axes ({dtype_name}) "
          f"{times['march_plane'][0]:.4f} ms, "
          f"{100 * bound['march_plane'][0] / times['march_plane'][0]:.1f}"
          f" % of its bound", flush=True)
    return times, bound


# ------------------------------------------------- phase 2: the Bezier xy step

# X1's holds (B, Nx, Ny): the Bezier iteration's plane (a lambda chunk),
# a batch of one, a ragged plane and a y-split rank's tile of the
# production grid padded with 2-cell halos
X1_SHAPES = ((PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
             (1, PROD["nx"], PROD["ny"]), (5, 37, 29),
             (PROD["lambda_chunk"], PROD["nx"] + 4, PROD["ny"] // 2 + 4))
# (fx, fy, fx_prev, fy_prev): all zero, all one, between, mixed
X1_FRACTIONS = ((0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0),
                (0.3, 0.8, 0.55, 0.1), (0.0, 1.0, 0.45, 1.0))
# floating-point operations of csrc/xy_bezier.cu a point: three stencils
# (9 each), two composed ones (45 each), dtau and dtau_uu (3 each), the
# control point (27) and the weights' middle branch (17: six divisions
# and the exp counted as one each), the update (7)
X1_OPS = 3 * 9 + 2 * 45 + 2 * 3 + 27 + 17 + 7


def _x1_planes(gen, B, nx, ny, dtype):
    """I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp on the card;
    alpha over 10^-2.5 .. 10^2.2, so dtau crosses the Bezier weights'
    0.05 and 50 branches."""
    def alpha():
        return _rand(gen, (B, nx, ny), -2.5, 2.2, dtype, log=True)

    def source():
        return _rand(gen, (B, nx, ny), 0.1, 1.0, dtype)

    I_p = _rand(gen, (B, nx, ny), 0.0, 1.0, dtype)
    a_c, a_p, S_c, S_p = alpha(), alpha(), source(), source()
    return I_p, a_c, a_p, S_c, S_p, alpha(), source()


def check_xy_bezier():
    """Phase 2: X1 against its plain version on the card, float64 and
    float32, at X1_SHAPES over both stencil base shifts in x and y,
    first 0 and 1 and X1_FRACTIONS, bit for bit, one launch a call.
    Returns {dtype name: max abs err}."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier as xb

    gen = torch.Generator().manual_seed(17)
    worst = {}
    for dtype_name in TOL:
        dtype = getattr(torch, dtype_name)
        worst[dtype_name] = 0.0
        for (B, nx, ny) in X1_SHAPES:
            planes = _x1_planes(gen, B, nx, ny, dtype)
            n0, n = xb.LAUNCHES, 0
            for sxs in (0, -1):
                for sys_ in (0, -1):
                    for first in (0.0, 1.0):
                        for fx, fy, fxp, fyp in X1_FRACTIONS:
                            geom = (1.0, fx, fy, 0.7, fxp, fyp, first)
                            got = xb.xy_bezier(*planes, *geom, sxs, sys_)
                            want = xb.xy_bezier_plain(*planes, *geom, sxs,
                                                      sys_)
                            torch.cuda.synchronize()
                            n += 1
                            e, _ = _compare(X1, got, want, dtype_name)
                            worst[dtype_name] = max(worst[dtype_name], e)
                            require(torch.equal(got, want),
                                    f"{X1} differs from its plain version "
                                    f"at ({B}, {nx}, {ny}) {dtype_name}, "
                                    f"shifts ({sxs}, {sys_}), first "
                                    f"{first}: max abs err {e:.3e}")
            require(xb.LAUNCHES - n0 == n,
                    f"{X1}: {xb.LAUNCHES - n0} launches for {n} calls")
            print(f"  {X1} {dtype_name} ({B}, {nx}, {ny}): {n} calls bit-"
                  f"equal to the plain version", flush=True)
    return worst


def time_xy_bezier(B, dtype_name, plane=(PROD["nx"], PROD["ny"])):
    """X1 and its plain version at (B, *plane) in `dtype_name`, ms a
    plane step, beside X1's bound: seven planes read and one written,
    X1_OPS a point.  X1's own time is its device time (torch.profiler):
    CUDA events around back-to-back calls measure the host's launch rate
    (the wrapper's checks and the ctypes call, ~0.05 ms), which they
    give beside it.  Returns (device ms, plain ms, bound ms, bound_by,
    events ms)."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier as xb

    nx, ny = plane
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(9)
    planes = _x1_planes(gen, B, nx, ny, dtype)
    args = (*planes, 1.0, 0.3, 0.6, 0.8, 0.2, 0.5, 0.0, -1, 0)
    events = _time_ms(lambda: xb.xy_bezier(*args), 50)
    ms = _device_ms(lambda: xb.xy_bezier(*args), 50, "xy_bezier_kernel")
    plain = _time_ms(lambda: xb.xy_bezier_plain(*args), 10)
    pts = B * nx * ny
    bound, by = _bound_ms(8 * ELEMENT_BYTES[dtype_name] * pts, X1_OPS * pts,
                          dtype_name)
    print(f"  {X1} (B={B}, {nx}x{ny}, {dtype_name}): kernel {ms:.5f} ms a "
          f"plane step (device time; {events:.5f} ms by CUDA events over "
          f"back-to-back calls), plain {plain:.4f} ms, bound {bound:.5f} ms "
          f"({by}), {100 * bound / ms:.1f} % of it", flush=True)
    del planes
    return ms, plain, bound, by, events


# ------------------------------------------- phase 2: the Bezier xy segment

# the segment kernel's holds (B, Nx, Ny): the Bezier iteration's plane (a
# lambda chunk), a batch of one and a ragged plane, on XBS_NZ planes;
# segment lengths held; a plane that does not fit the kernel's band (more
# runs of a band than its threads: the sweep's per-plane rule) and the z
# planes of its Bezier sweep
XBS_SHAPES = ((PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
              (1, PROD["nx"], PROD["ny"]), (5, 37, 29))
XBS_NZ = 48
XBS_LENGTHS = (1, 2, 7, 40)
XBS_WIDE = (2, 16, 1040)
XBS_WIDE_NZ = 12


def _xbs_fields(gen, nz, B, nx, ny, dtype):
    """alpha (10^-2.5 .. 10^2.2: dtau crosses the Bezier weights' 0.05
    and 50 branches), S and I0 of a Bezier xy segment, made on the card
    from `gen` (a CUDA generator)."""
    import torch
    u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda",
                                  dtype=torch.float64)
    alpha = (10.0 ** (-2.5 + 4.7 * u(nz, B, nx, ny))).to(dtype)
    S = (0.1 + 0.9 * u(nz, B, nx, ny)).to(dtype)
    return alpha, S, u(B, nx, ny).to(dtype)


def _xbs_segment(gen, nz, L, dirn, start):
    """The z indices and per-step Python-float geometry (r, fx, fy) of an
    L-step Bezier xy segment from the boundary plane (t = 1 up, nz - 2
    down: its second-upwind index clamps) or after a march segment (4
    planes in); gen a CPU generator; exact 0 and 1 fractions among
    them."""
    import torch
    off = 1 if start == "boundary" else 4
    t0 = off if dirn == 1 else nz - 1 - off
    u = torch.rand((3, L), generator=gen, dtype=torch.float64).tolist()
    fx, fy = list(u[1]), list(u[2])
    fx[0], fy[-1] = 0.0, 1.0
    return (tuple(t0 + j * dirn for j in range(L)),
            tuple(10.0 ** (v - 0.5) for v in u[0]), tuple(fx), tuple(fy))


class _Against:
    """Stands for the output cube of xy_bezier_segment_plain: each plane
    the plain version makes is held against the kernel's plane `got[t]`
    at its index, bit for bit (and finite), as it is made, so no second
    cube is held."""

    def __init__(self, got):
        self.got, self.off, self.last = got, [], None

    def __setitem__(self, t, plane):
        import torch
        self.off.append((self.got[t] != plane).any()
                        | ~torch.isfinite(plane).all())
        self.last = plane

    def __getitem__(self, t):
        return self.last


def _hold_bezier_segment(args, got):
    """The planes an xy_bezier_segment call with `args` (its arguments
    but the cube; a segment's first steps hold the planes of its first
    steps) wrote into `got`, against its plain version on the same
    inputs, bit for bit.  Returns the planes held."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs
    against = _Against(got)
    xbs.xy_bezier_segment_plain(*args, against)
    n_off = int(torch.stack(against.off).sum())
    require(n_off == 0, f"{XBS} differs from its plain version (or is not "
                        f"finite) on {n_off} of {len(against.off)} planes")
    return len(against.off)


def _bezier_wide_sweep(dtype):
    """A Bezier sweep on the card at XBS_WIDE, a plane that does not fit
    the segment kernel's band: its xy steps go through X1, one launch a
    plane, and no segment launch; bit-equal to the same sweep with the
    plain step.  Returns (X1 launches, Bezier xy steps)."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs
    B, nx, ny = XBS_WIDE
    require(not xbs.fits(nx, ny), f"{nx}x{ny} fits the segment kernel")
    gen = torch.Generator(device="cuda").manual_seed(5)
    alpha, S, I0 = _xbs_fields(gen, XBS_WIDE_NZ, B, nx, ny, dtype)
    try:
        xbs.xy_bezier_segment(alpha, S, I0, (1, 2), 1, (1.0, 1.0),
                              (0.5, 0.5), (0.5, 0.5), 0, 0,
                              torch.empty_like(alpha))
        refused = False
    except ValueError:
        refused = True
    require(refused, f"{XBS} took a plane that does not fit its band")
    t = np.deg2rad(160.0)
    k = np.array([np.cos(t), 0.6 * np.sin(t), 0.8 * np.sin(t)])
    plan = sr.build_plan(k, np.linspace(0.0, 0.3, XBS_WIDE_NZ), 1.0 / 6,
                         1.0 / 5, True)
    n_xy = sum(len(s.steps) for s in plan.segments if s.case == "xy")
    _launch_counts(reset=True)
    got = sr.sweep(plan, S, alpha, I0, interpolation="bezier")
    n = _launch_counts()
    require(n_xy > 0 and n[X1] == n_xy and n[XBS] == 0,
            f"the Bezier sweep at {nx}x{ny}: {n[X1]} {X1} launches for "
            f"{n_xy} xy steps, {n[XBS]} {XBS}")
    step = sr.xy_bezier
    sr.xy_bezier = xb.xy_bezier_plain
    try:
        want = sr.sweep(plan, S, alpha, I0, interpolation="bezier")
    finally:
        sr.xy_bezier = step
    require(torch.equal(got, want), f"the Bezier sweep at {nx}x{ny} through "
                                    f"{X1} differs from the plain step's")
    return n[X1], n_xy


def check_xy_bezier_segment():
    """Phase 2: the Bezier xy segment kernel against its plain version on
    the card, float64 and float32, bit for bit: at XBS_SHAPES (XBS_NZ
    planes) over every shift pair, both directions, a segment from the
    boundary plane and one after a march segment, at XBS_LENGTHS; one
    launch a segment.  Then XBS_WIDE, which does not fit: the wrapper
    refuses it and a Bezier sweep there steps through X1 a plane
    (_bezier_wide_sweep).  Returns {dtype name: max abs err (0:
    bit-equal)}."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs

    worst = {}
    for dtype_name in TOL:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(18)
        ggen = torch.Generator().manual_seed(18)
        for (B, nx, ny) in XBS_SHAPES:
            alpha, S, I0 = _xbs_fields(gen, XBS_NZ, B, nx, ny, dtype)
            cube = torch.empty_like(alpha)
            n0, n, held = xbs.LAUNCHES, 0, 0
            for sxs in (0, -1):
                for sys_ in (0, -1):
                    for dirn in (1, -1):
                        for start in ("boundary", "after-march"):
                            for L in XBS_LENGTHS:
                                geom = _xbs_segment(ggen, XBS_NZ, L, dirn,
                                                    start)
                                args = (alpha, S, I0, geom[0], dirn,
                                        *geom[1:], sxs, sys_)
                                xbs.xy_bezier_segment(*args, cube)
                                n += 1
                                held += _hold_bezier_segment(args, cube)
            require(xbs.LAUNCHES - n0 == n,
                    f"{XBS}: {xbs.LAUNCHES - n0} launches for {n} calls")
            print(f"  {XBS} {dtype_name} ({B}, {nx}, {ny}): {n} segments of "
                  f"lengths {XBS_LENGTHS}, 4 shift pairs, both directions, "
                  f"from the boundary and after a march, one launch each: "
                  f"{held} planes bit-equal to the plain version; "
                  f"{xbs.layout(nx, ny, dtype)}", flush=True)
            del alpha, S, I0, cube
            torch.cuda.empty_cache()
        n_x1, n_xy = _bezier_wide_sweep(dtype)
        print(f"  {XBS} {dtype_name} at {XBS_WIDE} (does not fit): refused; "
              f"its Bezier sweep {n_x1} {X1} launches for {n_xy} xy steps, "
              f"bit-equal to the plain step's", flush=True)
        worst[dtype_name] = 0.0
    return worst


def time_xy_bezier_segment(B, dtype_name):
    """A 214-step Bezier xy segment at (B, 256, 256) in `dtype_name`, one
    launch, each plane into the output cube: the kernel's ms a step by
    CUDA events around the launch (it runs for milliseconds, so the
    events read the kernel, not the host's launch rate), X1's plane step
    on the same inputs (device time, torch.profiler), the plain
    version's (CUDA events), the bound of a step (alpha[t] and S[t]
    read, I[t] written; X1_OPS a point) and the kernel's layout
    (cluster, band, registers, local memory, clusters at once).
    Returns a dict."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs

    nz, nx, ny = PROD["nz"], PROD["nx"], PROD["ny"]
    dtype = getattr(torch, dtype_name)
    n = nz - 1
    gen = torch.Generator(device="cuda").manual_seed(19)
    alpha, S, I0 = _xbs_fields(gen, nz, B, nx, ny, dtype)
    steps, r, fx, fy = _xbs_segment(torch.Generator().manual_seed(19), nz,
                                    n, 1, "boundary")
    cube = torch.empty_like(alpha)

    def segment():
        xbs.xy_bezier_segment(alpha, S, I0, steps, 1, r, fx, fy, -1, 0, cube)

    def per_plane(step):
        def run():
            I = I0
            for j, t in enumerate(steps):
                jp, t2 = max(j - 1, 0), max(t - 2, 0)
                I = step(I, alpha[t], alpha[t - 1], S[t], S[t - 1],
                         alpha[t2], S[t2], r[j], fx[j], fy[j], r[jp],
                         fx[jp], fy[jp], 1.0 if j == 0 else 0.0, -1, 0)
        return run

    ms = _time_ms(segment, 3) / n
    x1 = _device_ms(per_plane(xb.xy_bezier), 1, "xy_bezier_kernel") / n
    plain = _time_ms(per_plane(xb.xy_bezier_plain), 1) / n
    pts = B * nx * ny
    bound, by = _bound_ms(3 * ELEMENT_BYTES[dtype_name] * pts, X1_OPS * pts,
                          dtype_name)
    lay = xbs.layout(nx, ny, dtype)
    print(f"  {XBS}, {n} steps at (B={B}, {nx}x{ny}, {dtype_name}) in one "
          f"launch: {ms:.5f} ms a step (CUDA events); {X1} a plane on the "
          f"same inputs {x1:.5f} ms (device time); plain {plain:.4f} ms; "
          f"bound {bound:.5f} ms ({by}: 3 planes, {X1_OPS} operations a "
          f"point), {100 * bound / ms:.1f} % of it; {lay}", flush=True)
    del alpha, S, I0, cube
    torch.cuda.empty_cache()
    return {"ms": ms, "x1_ms": x1, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, **lay}


# ------------------------------------------------------ phase 2: extinction

# operations of csrc/extinction.cu a point in each Humlicek region (I-IV),
# the region tests included and only what the real part of w needs: E2's
# evaluator (humlicek_H) and E1's (e1_H: regions III's and IV's real part
# with one division, 3 operations fewer); and beside H: E1 a point with
# the per-cell gamma (with damping rows: 3 fewer), a cell, and a cell and
# angle (the shift; with the velocity, v . k too), E2 a point and a cell;
# an fma counted as two, a division, a reciprocal, an exp or a cos as one
REGION_OPS = (17, 31, 63, 107)
E1_REGION_OPS = (17, 31, 60, 104)
ALPHA_OPS = {"point": 8, "rows_point": 5, "cell": 7, "angle": 2,
             "angle_velocity": 7}
VOIGT_OPS = {"point": 3, "cell": 1}
# the fields E1 reads once a cell: g (none with damping rows), n_i, n_j,
# a_cont and dlamD, and v_los (alpha_tot) or the velocity's 3 components
# (alpha_tot_group)
ALPHA_FIELDS = {"alpha_tot": 6, "alpha_tot_group": 8}
# phase 2's extinction shapes: (name, cells, wavelength rows of the line)
# -- one production angle at a lambda chunk (B = 13) and at B = 1, the
# production sites site-major, a ragged tile; E2 over the bound-bound
# window (51 rows) of the production grid
EXT_SHAPES = (("production angle", None, slice(13, 26)),
              ("B = 1", None, slice(25, 26)),
              ("sites", (VOR_SITES,), slice(0, 13)),
              ("ragged", (5, 37, 29), slice(24, 27)))
# alpha_tot_group's: (name, cells, wavelength rows, angles of the first
# production group taken) -- the production group at a lambda chunk, its
# first angle alone, a ragged tile
GROUP_SHAPES = (("production group", None, slice(13, 26), 4),
                ("one angle", None, slice(13, 26), 1),
                ("ragged", (5, 37, 29), slice(24, 27), 4))


def _production_group(atmos):
    """The first mirror group of ul7n12 on the production grid, as
    (ks, flips): what phase 5's first alpha_tot_group call takes."""
    import numpy as np
    from voronoirt_tpu_torch import get_quadrature
    from voronoirt_tpu_torch.solvers.sweep_regular import group_plans
    quad = get_quadrature(PROD["quadrature"])
    g = group_plans(quad.k, quad.is_up, np.asarray(atmos.z), atmos.dx,
                    atmos.dy, max_group=PROD["group_max_angles"])[0]
    return [quad.k[i] for i, _, _ in g], [f for _, _, f in g]


def _ext_fields(atmos, dtype_name):
    """Phase 5's per-cell fields on the card in `dtype_name`: the line,
    the LTE populations, the continuum extinction, the damping rate at
    those populations, the velocity, the line-of-sight velocity of a
    slanted production direction (ul7n12's 6th) and the first
    production group's ks and flips."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch import Config, get_quadrature
    from voronoirt_tpu_torch.engine.lambda_iter import frozen_setup
    from voronoirt_tpu_torch.physics.atom import (line_of_sight_velocity,
                                                  lyman_alpha_line)
    from voronoirt_tpu_torch.physics.broadening import gamma_constant
    dtype = getattr(torch, dtype_name)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    cfg = Config(nlam_bb=PROD["nlam_bb"], nlam_bf=PROD["nlam_bf"],
                 dtype=dtype_name)
    T, ne, nH = (f(atmos.temperature), f(atmos.electron_density),
                 f(atmos.hydrogen_populations))
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the synthetic n_e's warning
        lte, a_cont = frozen_setup(line, T, ne, nH, cfg,
                                   block=slice(0, 0))[:2]
    g = gamma_constant(line, T, lte[..., 0] + lte[..., 1], ne,
                       cfg.gamma_natural)
    k = get_quadrature(PROD["quadrature"]).k[5]
    velocity = f(atmos.velocity_zxy()).contiguous()
    v_los = line_of_sight_velocity(velocity, -np.asarray(k))
    return {"line": line, "populations": lte.contiguous(), "a_cont": a_cont,
            "g_cell": g, "v_los": v_los, "velocity": velocity,
            "group": _production_group(atmos)}


def _cut_fields(F, cells):
    """The fields of the first cells of the production grid: a flat
    block of sites for a 1-d `cells`, a corner tile otherwise."""
    if len(cells) == 1:
        n = cells[0]
        cut = {k: F[k].reshape(-1)[:n] for k in ("a_cont", "g_cell", "v_los")}
        for k in ("populations", "velocity"):
            cut[k] = F[k].reshape(-1, 3)[:n]
        dlamD = F["line"].dlamD.reshape(-1)[:n]
    else:
        idx = tuple(slice(0, c) for c in cells)
        cut = {k: F[k][idx] for k in ("a_cont", "g_cell", "v_los",
                                      "populations", "velocity")}
        dlamD = F["line"].dlamD[idx]
    cut = {k: v.contiguous() for k, v in cut.items()}
    cut["line"] = dataclasses.replace(F["line"], dlamD=dlamD.contiguous())
    cut["group"] = F["group"]
    return cut


def _region_map(a, v):
    """The Humlicek region (1-4) of each point at damping a and shift v,
    by physics/voigt.py's tests."""
    import torch
    av = v.abs()
    s = av + a
    r = torch.where(a >= 0.195 * av - 0.176, 3, 4).to(torch.int8)
    r = torch.where(s >= 5.5, 2, r).to(torch.int8)
    return torch.where(s >= 15.0, 1, r).to(torch.int8)


def _tally(r, acc):
    """Add a plane of regions r, in the kernel's thread order, to acc:
    the points of each region, the points each region's warps issue (a
    warp of 32 consecutive cells runs every region among its points, for
    all 32), the warps, and those whose points span two regions or more."""
    import torch
    flat = r.reshape(-1)
    pad = (-flat.numel()) % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    warps = flat.reshape(-1, 32)
    present = torch.stack([(warps == k).any(1) for k in (1, 2, 3, 4)])
    for k in range(4):
        acc["points"][k] += int((flat == k + 1).sum())
        acc["issued"][k] += 32 * int(present[k].sum())
    acc["warps"] += warps.shape[0]
    acc["mixed"] += int((present.sum(0) > 1).sum())


def _ext_work(kind, F, lam, damp=None, angles=None):
    """(bytes, operations, region tally) of one call of `kind`
    ('alpha_tot' or 'alpha_tot_group' with the per-cell gamma or damping
    rows, 'voigt_rows') on these inputs, for alpha_tot_group on the
    angles' ks: each input read once and each output written once; the
    operations of each point's own Humlicek region, counted on this
    call's data."""
    import numpy as np
    from voronoirt_tpu_torch.constants import c_0
    from voronoirt_tpu_torch.physics.atom import line_of_sight_velocity
    from voronoirt_tpu_torch.physics.broadening import damping
    line = F["line"]
    cells, es = line.dlamD.numel(), line.dlamD.element_size()
    acc = {"points": [0] * 4, "issued": [0] * 4, "warps": 0, "mixed": 0}
    shape = (1,) + (1,) * line.dlamD.dim()
    if kind == "alpha_tot_group":
        v_loses = [line_of_sight_velocity(F["velocity"], -np.asarray(k))
                   for k in angles]
    else:
        v_loses = [F["v_los"] if kind == "alpha_tot" else None]
    for v_los in v_loses:
        for j in range(lam.shape[0]):
            lj = lam[j:j + 1].reshape(shape)
            if damp is not None:
                a = damp[j:j + 1]
            else:
                a = damping(F["g_cell"][None], lj, line.dlamD[None])
            if v_los is not None:
                v = (lj - line.lam0 + line.lam0 * v_los[None] / c_0) \
                    / line.dlamD[None]
            else:
                v = (lj - line.lam0) / line.dlamD[None]
            _tally(_region_map(a, v), acc)
            del a, v
    P = len(v_loses)
    points = P * lam.shape[0] * cells
    if kind == "voigt_rows":
        h_ops = sum(n * o for n, o in zip(acc["points"], REGION_OPS))
        nbytes = es * (cells + 2 * points)
        ops = h_ops + VOIGT_OPS["cell"] * cells + VOIGT_OPS["point"] * points
        return nbytes, ops, acc
    h_ops = sum(n * o for n, o in zip(acc["points"], E1_REGION_OPS))
    fields = ALPHA_FIELDS[kind] - (damp is not None)
    nbytes = es * (fields * cells + (damp is not None) * lam.shape[0] * cells
                   + points)
    per_angle = ALPHA_OPS["angle_velocity" if kind == "alpha_tot_group"
                          else "angle"]
    ops = h_ops + (ALPHA_OPS["cell"] + P * per_angle) * cells + points * (
        ALPHA_OPS["rows_point"] if damp is not None else ALPHA_OPS["point"])
    return nbytes, ops, acc


_SASS = {}


def _e1_issue(acc, dtype_name):
    """E1's instructions a point by region, from the code nvcc compiled
    (tools/e1_sass.py, the group kernel's instance of the dtype; counted
    once a process), and the least time the SMs need to issue them for
    the warps of `acc` at the card's largest SM clock: (ms, 'pipe' |
    'mufu', {region: counts}, the clock in MHz)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import e1_sass
    if not _SASS:
        _SASS.update(e1_sass.count())
    tag = {"float64": "alpha_tot_kernelIdLb1", "float32":
           "alpha_tot_kernelIfLb1"}[dtype_name]
    (rec,) = [r for name, r in _SASS.items() if tag in name]
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    issued = {k + 1: n for k, n in enumerate(acc["issued"])}
    ms, by = e1_sass.issue_ms(rec["regions"], issued, dtype_name, mhz * 1e6)
    return ms, by, rec["regions"], mhz


def _hold_ext(name, got, want, dtype_name, err):
    """got (the kernel's) against want (the plain version's) on the
    card: bit-equal, or within TOL with atol a share of want's largest
    magnitude; the largest differences and bit-equality into err."""
    import torch
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name} output not finite")
    tol = TOL[dtype_name]
    d = (got - want).abs()
    bad = d > tol["atol"] * float(want.abs().max()) + tol["rtol"] * want.abs()
    require(not bool(bad.any()),
            f"{name} disagrees with its plain version: max abs err "
            f"{float(d.max()):.3e} ({dtype_name})")
    nz = want != 0
    rel = float((d[nz] / want[nz].abs()).max()) if bool(nz.any()) else 0.0
    e = err.setdefault(name, {"abs": 0.0, "rel": 0.0, "equal": True})
    e["abs"], e["rel"] = max(e["abs"], float(d.max())), max(e["rel"], rel)
    e["equal"] = e["equal"] and torch.equal(got, want)
    return torch.equal(got, want)


def _boundary_rows(v, ulps=3):
    """Damping rows that put s = |v| + a on each Humlicek region
    boundary (15 and 5.5) and a on the line a = 0.195 |v| - 0.176, each
    nudged by -ulps .. ulps units in the last place (a target below 0
    taken as its absolute value)."""
    import torch
    av = v.abs()
    rows = []
    for a in (15.0 - av, 5.5 - av, 0.195 * av - 0.176):
        a = a.abs()
        for k in range(-ulps, ulps + 1):
            b = a
            to = torch.full_like(a, float("inf") if k > 0 else 0.0)
            for _ in range(abs(k)):
                b = torch.nextafter(b, to)
            rows.append(b)
    return torch.stack(rows)


def check_extinction(atmos):
    """Phase 2c: alpha_tot_group and alpha_tot (E1) and voigt_rows (E2)
    against their plain versions on the card, float64 and float32, on
    phase 5's fields at GROUP_SHAPES and EXT_SHAPES (per-cell gamma; the
    ragged tiles with damping rows and without the continuum too), E2
    over the production bound-bound window, and points within a few ulps
    of each region boundary; then each timed at its production shape
    beside its bound, the group beside four per-angle launches and
    beside the path it replaces (four eager v_los, four launches, their
    flips and the stack's cat), with its warps' region mix and its
    instructions a point from the compiled code.  Returns ({dtype:
    {kernel: err}}, {dtype: {kernel: (ms, plain ms, bound ms, bound
    by)}}, {dtype: the group's other numbers})."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.physics import extinction as ex
    from voronoirt_tpu_torch.physics.atom import line_of_sight_velocity
    from voronoirt_tpu_torch.physics.broadening import damping
    from voronoirt_tpu_torch.solvers.sweep_regular import flip_field

    errs, times, info = {}, {}, {}
    for dtype_name in ("float64", "float32"):
        err = errs.setdefault(dtype_name, {})
        F = _ext_fields(atmos, dtype_name)
        lam_all = F["line"].lam_tensor()

        def rows_of(G, lam):
            return damping(G["g_cell"][None], lam.reshape(
                (-1,) + (1,) * G["g_cell"].dim()),
                G["line"].dlamD[None]).contiguous()

        for name, cells, rows, P in GROUP_SHAPES:
            G = F if cells is None else _cut_fields(F, cells)
            lam = lam_all[rows]
            ks, flips = (x[:P] for x in G["group"])
            args = (G["line"], lam, G["velocity"], ks, flips,
                    G["populations"])
            kws = [dict(g_cell=G["g_cell"])]
            if name == "ragged":
                kws.append(dict(damp=rows_of(G, lam)))
            equal = []
            for kw in kws:
                for a_c in ((G["a_cont"], None) if name == "ragged"
                            else (G["a_cont"],)):
                    got = ex.alpha_tot_group(*args, a_c, **kw)
                    want = ex.alpha_tot_group_plain(*args, a_c, **kw)
                    equal.append(_hold_ext("alpha_tot_group", got, want,
                                           dtype_name, err))
                    del got, want
            shape = ex.out_shape(tuple(G["v_los"].shape), P * lam.shape[0])
            print(f"  alpha_tot_group {dtype_name} {name} (flips {flips}): "
                  f"out {shape}, bit-equal to the plain version: "
                  f"{all(equal)}", flush=True)
            del G
        for name, cells, rows in EXT_SHAPES:
            G = F if cells is None else _cut_fields(F, cells)
            lam = lam_all[rows]
            args = (G["line"], lam, G["v_los"], G["populations"])
            kws = [dict(g_cell=G["g_cell"])]
            if name == "ragged":
                kws.append(dict(damp=rows_of(G, lam)))
            equal = []
            for kw in kws:
                for a_c in ((G["a_cont"], None) if name == "ragged"
                            else (G["a_cont"],)):
                    got = ex.alpha_tot(*args, a_c, **kw)
                    want = ex.alpha_tot_plain(*args, a_c, **kw)
                    equal.append(_hold_ext("alpha_tot", got, want,
                                           dtype_name, err))
                    del got, want
            print(f"  alpha_tot {dtype_name} {name}: out "
                  f"{ex.out_shape(tuple(G['v_los'].shape), lam.shape[0])}, "
                  f"bit-equal to the plain version: {all(equal)}",
                  flush=True)
            del G
        # E2 over the bound-bound window of the production grid
        line = F["line"]
        lam_bb = lam_all[line.lam_idx[0]:line.lam_idx[1]]
        damp = rows_of(F, lam_bb)
        eq = _hold_ext("voigt_rows", ex.voigt_rows(line, lam_bb, damp),
                       ex.voigt_rows_plain(line, lam_bb, damp), dtype_name,
                       err)
        print(f"  voigt_rows {dtype_name}: out {tuple(damp.shape)}, "
              f"bit-equal to the plain version: {eq}", flush=True)
        # the region boundaries: one wavelength, no velocity, 4096 cells
        # (a block of sites for alpha_tot and voigt_rows, a 1 x 16 x 256
        # tile for the group), every kernel
        G = _cut_fields(F, (4096,))
        G["v_los"] = torch.zeros_like(G["v_los"])
        T = _cut_fields(F, (1, 16, 256))
        T["velocity"] = torch.zeros_like(T["velocity"])
        eq = []
        for off in (1.0, 4.0, 9.0, 14.0):
            lam1 = (line.lam0 + off * G["line"].dlamD.median()).reshape(1)
            v = (lam1 - G["line"].lam0) / G["line"].dlamD
            for row in _boundary_rows(v):
                d1 = row[None].contiguous()
                eq.append(_hold_ext("voigt_rows", ex.voigt_rows(
                    G["line"], lam1, d1), ex.voigt_rows_plain(
                    G["line"], lam1, d1), dtype_name, err))
                a_args = (G["line"], lam1, G["v_los"], G["populations"],
                          G["a_cont"])
                eq.append(_hold_ext("alpha_tot", ex.alpha_tot(
                    *a_args, damp=d1), ex.alpha_tot_plain(*a_args, damp=d1),
                    dtype_name, err))
            v = (lam1 - T["line"].lam0) / T["line"].dlamD
            for row in _boundary_rows(v):
                d1 = row[None].contiguous()
                g_args = (T["line"], lam1, T["velocity"], *T["group"],
                          T["populations"], T["a_cont"])
                eq.append(_hold_ext("alpha_tot_group", ex.alpha_tot_group(
                    *g_args, damp=d1), ex.alpha_tot_group_plain(
                    *g_args, damp=d1), dtype_name, err))
        print(f"  {dtype_name} region boundaries ({len(eq) // 3} damping "
              f"rows of 4096 cells, each kernel): bit-equal: {all(eq)}",
              flush=True)
        del G, T
        # times at the production shapes
        lam13 = lam_all[EXT_SHAPES[0][2]]
        t = {}
        ks, flips = F["group"]
        g_args = (line, lam13, F["velocity"], ks, flips, F["populations"],
                  F["a_cont"])
        g_kw = dict(g_cell=F["g_cell"])
        nbytes, ops, acc = _ext_work("alpha_tot_group", F, lam13,
                                     angles=ks)
        t["alpha_tot_group"] = (
            _time_ms(lambda: ex.alpha_tot_group(*g_args, **g_kw), 10),
            _time_ms(lambda: ex.alpha_tot_group_plain(*g_args, **g_kw), 1),
            *_bound_ms(nbytes, ops, dtype_name))
        v_loses = [line_of_sight_velocity(F["velocity"], -np.asarray(k))
                   for k in ks]
        four = _time_ms(lambda: [ex.alpha_tot(
            line, lam13, v, F["populations"], F["a_cont"], **g_kw)
            for v in v_loses], 5)
        # what the group launch replaces: four eager line-of-sight
        # velocities and per-angle launches, flipped and stacked by cat
        old = _time_ms(lambda: torch.cat([flip_field(ex.alpha_tot(
            line, lam13, line_of_sight_velocity(F["velocity"], -np.asarray(k)),
            F["populations"], F["a_cont"], **g_kw), *f)
            for k, f in zip(ks, flips)], dim=1), 5)
        issue, issue_by, sass, mhz = _e1_issue(acc, dtype_name)
        mix = acc["mixed"] / acc["warps"]
        ms = t["alpha_tot_group"][0]
        print(f"  alpha_tot_group {dtype_name} at the production group "
              f"(215, 4 x 13, 256, 256): kernel {ms:.4f} ms, plain "
              f"{t['alpha_tot_group'][1]:.4f} ms, bound "
              f"{t['alpha_tot_group'][2]:.4f} ms "
              f"({t['alpha_tot_group'][3]}: {nbytes / 1e9:.4f} GB, "
              f"{ops / 1e9:.4f} G operations), "
              f"{100 * t['alpha_tot_group'][2] / ms:.1f} % of it; four "
              f"alpha_tot launches {four:.4f} ms; the path it replaces "
              f"(eager v_los, four launches, flips, cat) {old:.4f} ms",
              flush=True)
        print(f"  E1 {dtype_name} at the production group: points by region "
              f"I-IV {acc['points']}, issued by warps {acc['issued']}; "
              f"warps whose points span two regions or more "
              f"{acc['mixed']} of {acc['warps']} ({100 * mix:.2f} %)",
              flush=True)
        for r in sorted(sass):
            print(f"  E1 {dtype_name} SASS a region {r} point: "
                  f"{json.dumps(sass[r])}", flush=True)
        print(f"  E1 {dtype_name} issue bound at {mhz:.0f} MHz (the "
              f"{'FP64' if dtype_name == 'float64' else 'FP32'} pipe and "
              f"MUFU on {132} SMs, the warps' issued points): {issue:.4f} ms "
              f"({issue_by}), {100 * issue / ms:.1f} % of the kernel's time",
              flush=True)
        info[dtype_name] = {"four_alpha_tot_ms": four,
                            "replaced_path_ms": old}
        a_args = (line, lam13, F["v_los"], F["populations"], F["a_cont"])
        nbytes, ops, acc = _ext_work("alpha_tot", F, lam13)
        t["alpha_tot"] = (
            _time_ms(lambda: ex.alpha_tot(*a_args, **g_kw), 20),
            _time_ms(lambda: ex.alpha_tot_plain(*a_args, **g_kw), 2),
            *_bound_ms(nbytes, ops, dtype_name))
        print(f"  alpha_tot {dtype_name} at one production angle (215, 13, "
              f"256, 256): kernel {t['alpha_tot'][0]:.4f} ms, plain "
              f"{t['alpha_tot'][1]:.4f} ms, bound {t['alpha_tot'][2]:.4f} "
              f"ms ({t['alpha_tot'][3]}: {nbytes / 1e9:.4f} GB, "
              f"{ops / 1e9:.4f} G operations; points by region I-IV "
              f"{acc['points']}; warps of two regions or more "
              f"{100 * acc['mixed'] / acc['warps']:.2f} %), "
              f"{100 * t['alpha_tot'][2] / t['alpha_tot'][0]:.1f} % of it",
              flush=True)
        nbytes, ops, acc = _ext_work("voigt_rows", F, lam_bb, damp)
        t["voigt_rows"] = (
            _time_ms(lambda: ex.voigt_rows(line, lam_bb, damp), 10),
            _time_ms(lambda: ex.voigt_rows_plain(line, lam_bb, damp), 1),
            *_bound_ms(nbytes, ops, dtype_name))
        print(f"  voigt_rows {dtype_name} over the bound-bound window (51, "
              f"215, 256, 256): kernel {t['voigt_rows'][0]:.4f} ms, plain "
              f"{t['voigt_rows'][1]:.4f} ms, bound "
              f"{t['voigt_rows'][2]:.4f} ms ({t['voigt_rows'][3]}: "
              f"{nbytes / 1e9:.4f} GB, {ops / 1e9:.4f} G operations; points "
              f"by region I-IV {acc['points']}), "
              f"{100 * t['voigt_rows'][2] / t['voigt_rows'][0]:.1f} % of it",
              flush=True)
        times[dtype_name] = t
        for k, e in err.items():
            print(f"  {k} {dtype_name}: max abs err {e['abs']:.3e}, max rel "
                  f"err {e['rel']:.3e}, bit-equal everywhere: {e['equal']} "
                  f"(TOL rtol {TOL[dtype_name]['rtol']:g}, atol "
                  f"{TOL[dtype_name]['atol']:g} of the largest magnitude)",
                  flush=True)
        del F, damp, v_loses
        gc.collect()
        torch.cuda.empty_cache()
    return errs, times, info


# the modules that call the extinction's wrappers, by the name each
# imported: the engines, synthesize, the rates, and phase 2 itself
_EXT_CALLERS = (("voronoirt_tpu_torch.engine.lambda_iter", "alpha_tot"),
                ("voronoirt_tpu_torch.engine.lambda_iter",
                 "alpha_tot_group"),
                ("voronoirt_tpu_torch.drivers.synthesize", "alpha_tot"),
                ("voronoirt_tpu_torch.physics.rates", "voigt_rows"),
                ("voronoirt_tpu_torch.physics.extinction", "alpha_tot"),
                ("voronoirt_tpu_torch.physics.extinction",
                 "alpha_tot_group"),
                ("voronoirt_tpu_torch.physics.extinction", "voigt_rows"))
# the call signatures already held against the plain versions
_EXT_HELD = set()


def _ext_sig(name, args, kwargs):
    """A wrapper call's signature: (kernel, dtype, cells, B, levels,
    continuum, damping rows) for alpha_tot, the same and (ks, flips) for
    alpha_tot_group, (kernel, dtype, cells, nb) for voigt_rows -- all
    that sets the kernel's layout and strides (its inputs are
    contiguous) and, for a group, its angles."""
    lam = args[1]
    dtype_name = str(lam.dtype).replace("torch.", "")
    if name == "voigt_rows":
        damp = args[2] if len(args) > 2 else kwargs["damp"]
        return (name, dtype_name, tuple(damp.shape[1:]), lam.shape[0])
    group = name == "alpha_tot_group"
    pops, n_cont = (args[5], 6) if group else (args[3], 4)
    a_cont = args[n_cont] if len(args) > n_cont else kwargs.get("a_cont")
    cells = tuple(args[2].shape[:-1] if group else args[2].shape)
    sig = (name, dtype_name, cells, lam.shape[0], pops.shape[-1],
           a_cont is not None, kwargs.get("damp") is not None)
    if group:
        sig += (tuple(tuple(float(c) for c in k) for k in args[3]),
                tuple(tuple(bool(b) for b in f) for f in args[4]))
    return sig


@contextmanager
def _record_ext():
    """Record the signature of every alpha_tot_group / alpha_tot /
    voigt_rows call made on the card: yields {signature: that call's
    wavelengths}.  The calls
    run as they are (the wavelengths are kept as a copy on the card, so
    nothing waits for it)."""
    import importlib
    seen, saved = {}, []

    def recording(name, fn):
        def recorded(*args, **kwargs):
            if args[1].is_cuda:
                sig = _ext_sig(name, args, kwargs)
                if sig not in seen:
                    seen[sig] = args[1].clone()
            return fn(*args, **kwargs)
        return recorded

    for mod_name, name in _EXT_CALLERS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, recording(name, saved[-1][2]))
    try:
        yield seen
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _hold_recorded(atmos, seen, what, errs):
    """Each alpha_tot_group / alpha_tot / voigt_rows call signature that
    `what` made on the card and that no earlier phase held: the kernel
    against its plain version at that signature, on phase 5's fields cut
    to its cells (a flat block of sites, a corner tile of the grid), at
    the path's own wavelengths, damping source and, for a group, angles
    and flips; the errors into errs[dtype]."""
    import torch
    from voronoirt_tpu_torch.physics import extinction as ex
    from voronoirt_tpu_torch.physics.broadening import damping
    new = [sig for sig in seen if sig not in _EXT_HELD]
    print(f"  {what}: {len(seen)} extinction call shapes on the card, "
          f"{len(seen) - len(new)} held by an earlier phase", flush=True)
    for dtype_name in sorted({sig[1] for sig in new}):
        F = _ext_fields(atmos, dtype_name)
        full = tuple(F["v_los"].shape)
        err = errs.setdefault(dtype_name, {})
        for sig in (sig for sig in new if sig[1] == dtype_name):
            name, _, cells, B = sig[:4]
            require(len(cells) in (1, len(full)) and all(
                c <= f for c, f in zip(cells, full if len(cells) > 1 else
                                       (len(F["g_cell"].reshape(-1)),))),
                f"{what}: cells {cells} are not a cut of the grid {full}")
            G = _cut_fields(F, cells)
            lam = seen[sig]
            rows = damping(G["g_cell"][None],
                           lam.reshape((-1,) + (1,) * len(cells)),
                           G["line"].dlamD[None]).contiguous()
            if name in ("alpha_tot", "alpha_tot_group"):
                levels, cont, by_rows = sig[4:7]
                require(levels <= G["populations"].shape[-1],
                        f"{what}: {levels} levels")
                pops = G["populations"][..., :levels].contiguous()
                a_c = G["a_cont"] if cont else None
                kw = dict(damp=rows) if by_rows else dict(g_cell=G["g_cell"])
                how = (f"B = {B}, {'damping rows' if by_rows else 'g_cell'}, "
                       f"{'with' if cont else 'no'} continuum")
                if name == "alpha_tot":
                    args = (G["line"], lam, G["v_los"], pops, a_c)
                    got, want = ex.alpha_tot(*args, **kw), \
                        ex.alpha_tot_plain(*args, **kw)
                else:
                    ks, flips = sig[7:]
                    args = (G["line"], lam, G["velocity"], ks, flips, pops,
                            a_c)
                    got, want = ex.alpha_tot_group(*args, **kw), \
                        ex.alpha_tot_group_plain(*args, **kw)
                    how += f", {len(ks)} angles, flips {flips}"
            else:
                got = ex.voigt_rows(G["line"], lam, rows)
                want = ex.voigt_rows_plain(G["line"], lam, rows)
                how = f"nb = {B}"
            eq = _hold_ext(name, got, want, dtype_name, err)
            print(f"  {name} {dtype_name} as {what} calls it: cells {cells}, "
                  f"{how}; out {tuple(got.shape)}, bit-equal to the plain "
                  f"version: {eq}", flush=True)
            _EXT_HELD.add(sig)
            del got, want, rows, G
        del F
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------- phase 2: R1, S1

# phase 2's rate shapes: the production grid and a ragged corner tile
RATE_SHAPES = (("production", None), ("ragged", (5, 37, 29)))
# the standard loop's R1 launch at the Voronoi production count: all the
# line's rows at once into new rates, on the first VOR_SITES cells of
# the production grid taken as sites
RATE_SITES = VOR_SITES
# the lambda split's edge pair at LAM_RANKS ranks: rank 1's first row
# and the row before it, the pair R1 adds after the rank's chunks
EDGE_ROW = -(-(PROD["nlam_bb"] + 2 * PROD["nlam_bf"]) // LAM_RANKS)
# operations R1 does a point of a bound-bound row besides its Humlicek
# region's (REGION_OPS: E2's evaluator), a point of a bound-free row, a
# cell and window; S1 a point and a cell; an exp, expm1, reciprocal or
# division as one (csrc/rates.cu)
RATE_OPS = {"bb_point": 26, "bf_point": 19, "window_cell": 8}
S_UPDATE_OPS = {"point": 14, "cell": 1}
RATE_LEVELS = {"bf0": (0, 2), "bf1": (1, 2), "bb": (0, 1)}


def _rate_fields(atmos, dtype_name, cells=None):
    """What R1 and S1 read besides J and S, at phase 5's LTE start on
    the card: the line, T, the LTE populations, the damping rate and
    eps; cut to a corner tile of `cells` when given."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine.lambda_iter import frozen_setup
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.physics.broadening import gamma_constant
    dtype = getattr(torch, dtype_name)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    cfg = Config(nlam_bb=PROD["nlam_bb"], nlam_bf=PROD["nlam_bf"],
                 dtype=dtype_name)
    T, ne, nH = (f(atmos.temperature), f(atmos.electron_density),
                 f(atmos.hydrogen_populations))
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the synthetic n_e's warning
        lte, _, eps = frozen_setup(line, T, ne, nH, cfg,
                                   block=slice(0, 0))[:3]
    F = {"T": T, "lte": lte, "eps": eps,
         "g": gamma_constant(line, T, lte[..., 0] + lte[..., 1], ne,
                             cfg.gamma_natural), "dlamD": line.dlamD}
    idx = tuple(slice(0, c) for c in cells) if cells else ()
    F = {k: v[idx].contiguous() for k, v in F.items()}
    F["line"] = dataclasses.replace(line, dlamD=F.pop("dlamD"))
    return F


def _rows_like_B(F, rows, seed):
    """Rows `rows` (a slice of the line's) of a J- or S-like field: the
    Planck function at the cell's T times a seeded factor in [0.5,
    1.5)."""
    import torch
    from voronoirt_tpu_torch.physics.planck import B_lambda
    T = F["T"]
    lam = F["line"].lam_tensor()[rows].reshape((-1,) + (1,) * T.dim())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = B_lambda(lam, T[None])
    return out.mul_(torch.rand(out.shape, generator=gen, device="cuda",
                               dtype=out.dtype).add_(0.5))


def _rates_work(F, r0, n_rows, acc):
    """(bytes, operations) of one R1 launch on these inputs: each J row
    a window reads once, the per-cell fields its windows read (T, the
    LTE levels, and g and dlamD for a bound-bound window) once, each
    rate written once and, where acc holds it, read once; the
    operations of each bound-bound point's own Humlicek region, counted
    on this launch's data."""
    from voronoirt_tpu_torch.physics import rates
    from voronoirt_tpu_torch.physics.broadening import damping
    line, T = F["line"], F["T"]
    cells, es = T.numel(), T.element_size()
    wins = rates._chunk_windows(line, r0, n_rows)
    levels = {lv for kind, _, _, _ in wins for lv in RATE_LEVELS[kind]}
    bb = [(a, b) for kind, a, b, _ in wins if kind == "bb"]
    rows = sum(b - a + 1 for _, a, b, _ in wins)
    rates_io = sum(2 * (1 + (rates._RATE_KEYS[kind][0] in (acc or {})))
                   for kind, _, _, _ in wins)
    nbytes = es * cells * (rows + 1 + len(levels) + 2 * bool(bb) + rates_io)
    tally = {"points": [0] * 4, "issued": [0] * 4, "warps": 0, "mixed": 0}
    lam = line.lam_tensor()
    for a, b in bb:
        for r in range(a, b + 1):
            lb = lam[r:r + 1].reshape((1,) * (T.dim() + 1))
            _tally(_region_map(damping(F["g"][None], lb, line.dlamD[None]),
                               (lb - line.lam0) / line.dlamD[None]), tally)
    n_bb = sum(b - a + 1 for a, b in bb)
    ops = (sum(n * o for n, o in zip(tally["points"], REGION_OPS))
           + cells * (RATE_OPS["bb_point"] * n_bb
                      + RATE_OPS["bf_point"] * (rows - n_bb)
                      + RATE_OPS["window_cell"] * len(wins)))
    return nbytes, ops


def _s_update_work(F, nb):
    """(bytes, operations) of one S1 launch over nb rows: J and S_old
    read and S_new written once a point, eps and T once a cell."""
    cells, es = F["T"].numel(), F["T"].element_size()
    return (es * cells * (3 * nb + 2),
            cells * (S_UPDATE_OPS["point"] * nb + S_UPDATE_OPS["cell"]))


def _hold_bits(name, got, want, dtype_name, err):
    """_hold_ext for values that may be NaN: NaN where want is NaN, the
    rest held by _hold_ext."""
    import torch
    require(torch.equal(got.isnan(), want.isnan()),
            f"{name}: NaN at other points than its plain version's")
    ok = ~want.isnan()
    return _hold_ext(name, got[ok], want[ok], dtype_name, err)


def check_rates(atmos):
    """Phase 2: R1 (physics/rates.py calculate_R_chunk) and S1
    (engine/s_update.py s_update_stream) against their plain versions on
    the card, float64 and float32, at RATE_SHAPES: R1 chunk after chunk
    over the line's lambda chunks of the production iteration, the
    previous chunk's last J row leading each chunk, the rates added in
    place into the running rates, then the lambda split's edge pair onto
    them; S1 at each chunk, its rows one row into S, and with a NaN in J
    at the production grid's first chunk; then R1 as the standard loop
    launches it, all 91 rows into new rates, at RATE_SITES sites.  Then
    R1 and S1 timed at each production chunk (CUDA events; R1's device
    time under torch.profiler too), the plain versions once, beside
    their bounds, R1 also by chunk kind (the
    chunks that hold bound-bound rows and those that hold bound-free
    rows only) and at the RATE_SITES launch.  Returns {"errs": {dtype:
    {kernel: err}}, "times": {dtype: {kernel: (ms a launch, plain ms a
    launch, bound ms a launch, bound_by, ms an iteration, bound ms an
    iteration)}}, "r1": {dtype: {"bound-bound" | "bound-free" | "sites":
    {"launches", "ms", "plain_ms", "bound_ms", "bound_by"} a launch}}}."""
    import torch
    from voronoirt_tpu_torch.engine import s_update as s1
    from voronoirt_tpu_torch.engine.lambda_iter import _lambda_chunks
    from voronoirt_tpu_torch.physics import rates

    info = {"errs": {}, "times": {}, "r1": {}}
    n_lambda = PROD["nlam_bb"] + 2 * PROD["nlam_bf"]
    chunks = _lambda_chunks(n_lambda, PROD["lambda_chunk"])
    for dtype_name in ("float64", "float32"):
        err = info["errs"].setdefault(dtype_name, {})
        kinds = info["r1"].setdefault(dtype_name, {})
        for label, cells in RATE_SHAPES:
            F = _rate_fields(atmos, dtype_name, cells)
            line, T, eps = F["line"], F["T"], F["eps"]
            rest = (F["g"], F["lte"], T, "reference")
            t = {"rates_chunk": [0.0, 0.0, 0.0, 0.0],
                 "s_update": [0.0, 0.0, 0.0, 0.0]}
            acc_k = acc_p = lead = None
            for ci, sl in enumerate(chunks):
                J = _rows_like_B(F, sl, ci)
                r0 = sl.start - (lead is not None)
                acc_k = rates.calculate_R_chunk(line, acc_k, J, r0, *rest,
                                                lead=lead)
                acc_p = rates.calculate_R_chunk_plain(line, acc_p, J, r0,
                                                      *rest, lead=lead)
                require(set(acc_k) == set(acc_p), f"rates_chunk keys "
                        f"{sorted(acc_k)}, plain {sorted(acc_p)}")
                eq = all([_hold_ext("rates_chunk", acc_k[k], acc_p[k],
                                    dtype_name, err) for k in acc_p])
                # S1: the chunk's rows one row into a buffer of S rows
                S = _rows_like_B(F, slice(max(sl.start - 1, 0), sl.stop + 1),
                                 100 + ci)
                lam_c = line.lam_tensor()[sl]
                nans = (False, True) if label == "production" and ci == 0 \
                    else (False,)
                for nan in nans:
                    Jn = J.clone() if nan else J
                    if nan:
                        Jn.view(-1)[Jn.numel() // 3] = float("nan")
                    S_k, S_p = S.clone(), S.clone()
                    _, m_k = s1.s_update_stream(S_k, Jn, eps, T, lam_c, 1)
                    _, m_p = s1.s_update_stream_plain(S_p, Jn, eps, T, lam_c,
                                                      1)
                    eq_s = _hold_bits("s_update", S_k, S_p, dtype_name, err)
                    require(bool(m_k.isnan()) == bool(m_p.isnan()) == nan,
                            f"s_update maximum {float(m_k)}, plain "
                            f"{float(m_p)}, NaN in J: {nan}")
                    if not nan:
                        eq_s = _hold_ext("s_update", m_k, m_p, dtype_name,
                                         err) and eq_s
                    print(f"  rates_chunk / s_update {dtype_name} {label} "
                          f"{tuple(T.shape)}, rows [{r0}, {sl.stop})"
                          f"{' with the lead row' if lead is not None else ''}"
                          f"{', a NaN in J' if nan else ''}: R1 bit-equal "
                          f"{eq}, S1 bit-equal {eq_s}, maximum "
                          f"{float(m_k):.6e} ({float(m_p):.6e} plain)",
                          flush=True)
                    del S_k, S_p, Jn
                if label == "production":
                    _time_rates(F, J, r0, lead, acc_k, S, lam_c, t, kinds)
                lead = J[-1:].clone()
                del J, S
                torch.cuda.empty_cache()
            # the lambda split's edge pair onto the accumulated rates
            J2 = _rows_like_B(F, slice(EDGE_ROW - 1, EDGE_ROW + 1), 99)
            got = rates.calculate_R_chunk(line, acc_k, J2[1:], EDGE_ROW - 1,
                                          *rest, lead=J2[:1].contiguous())
            want = rates.calculate_R_chunk_plain(line, acc_p, J2[1:],
                                                 EDGE_ROW - 1, *rest,
                                                 lead=J2[:1])
            eq = all([_hold_ext("rates_chunk", got[k], want[k], dtype_name,
                                err) for k in want])
            print(f"  rates_chunk {dtype_name} {label}: the lambda split's "
                  f"edge pair (rows {EDGE_ROW - 1}, {EDGE_ROW}) onto the "
                  f"iteration's rates bit-equal {eq}", flush=True)
            if label == "production":
                n = len(chunks)
                info["times"][dtype_name] = {
                    k: (v[0] / n, v[1] / n, v[2] / n, v[3], v[0], v[2])
                    for k, v in t.items()}
                for k, v in info["times"][dtype_name].items():
                    print(f"  {k} {dtype_name} at the production grid: "
                          f"{v[0]:.4f} ms a launch (an iteration's {n}: "
                          f"{v[4]:.4f} ms), plain {v[1]:.4f} ms, bound "
                          f"{v[2]:.4f} ms ({v[3]}; an iteration "
                          f"{v[5]:.4f} ms), {100 * v[2] / v[0]:.1f} % of it",
                          flush=True)
            del F, acc_k, acc_p, lead, J2, got, want
            gc.collect()
            torch.cuda.empty_cache()
        kinds["sites"] = _hold_rates_sites(atmos, dtype_name, err)
        for kind, v in kinds.items():
            print(f"  rates_chunk {dtype_name}, {kind} ({v['launches']} "
                  f"launch{'es' if v['launches'] > 1 else ''}): "
                  f"{v['ms']:.4f} ms a launch ({v['ms_device']:.4f} ms "
                  f"on the device), plain "
                  f"{v['plain_ms']:.4f} ms, "
                  f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), "
                  f"{100 * v['bound_ms'] / v['ms']:.1f} % of it", flush=True)
    return info


def _hold_rates_sites(atmos, dtype_name, err):
    """R1 as the standard loop launches it (engine/lambda_iter.py
    _rates_and_populations): all the line's rows from row 0 into new
    rates, on the first RATE_SITES cells of the production grid as
    sites; held against the plain version, then timed beside its bound.
    Returns its times a launch."""
    import torch
    from voronoirt_tpu_torch.physics import rates
    F = _rate_fields(atmos, dtype_name)
    n = RATE_SITES
    S = {k: v.reshape(-1)[:n].contiguous() for k, v in F.items()
         if k not in ("line", "lte")}
    S["lte"] = F["lte"].reshape(-1, F["lte"].shape[-1])[:n].contiguous()
    S["line"] = dataclasses.replace(
        F["line"], dlamD=F["line"].dlamD.reshape(-1)[:n].contiguous())
    del F
    line = S["line"]
    J = _rows_like_B(S, slice(0, line.n_lambda), 7)
    rest = (S["g"], S["lte"], S["T"], "reference")
    got = rates.calculate_R_chunk(line, None, J, 0, *rest)
    want = rates.calculate_R_chunk_plain(line, None, J, 0, *rest)
    require(set(got) == set(want), f"rates_chunk keys {sorted(got)}, plain "
            f"{sorted(want)}")
    eq = all([_hold_ext("rates_chunk", got[k], want[k], dtype_name, err)
              for k in want])
    print(f"  rates_chunk {dtype_name} at {n} sites, rows [0, "
          f"{line.n_lambda}) into new rates (the standard loop's launch): "
          f"bit-equal {eq}", flush=True)
    b_ms, by = _bound_ms(*_rates_work(S, 0, line.n_lambda, None), dtype_name)

    def launch():
        rates.calculate_R_chunk(line, None, J, 0, *rest)

    out = {"launches": 1, "bound_ms": b_ms, "bound_by": by,
           "ms": _time_ms(launch, 5),
           "ms_device": _device_ms(launch, 5, "rates_chunk_kernel"),
           "plain_ms": _time_ms(lambda: rates.calculate_R_chunk_plain(
               line, None, J, 0, *rest), 1)}
    del S, J, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _time_rates(F, J, r0, lead, acc, S, lam_c, t, kinds):
    """R1 and S1 at one production chunk, timed with CUDA events (R1
    into a copy of the running rates, S1 on a copy of S), the plain
    versions once; their bounds added into t[kernel] = [ms, plain ms,
    bound ms, bound_by] summed over the chunks, R1's into kinds[its
    chunk kind] too, as means a launch."""
    from voronoirt_tpu_torch.engine import s_update as s1
    from voronoirt_tpu_torch.physics import rates
    dtype_name = str(F["T"].dtype).replace("torch.", "")
    rest = (F["g"], F["lte"], F["T"], "reference")
    acc_t = {k: v.clone() for k, v in acc.items()}
    n_rows = J.shape[0] + (lead is not None)
    # the bound of a launch whose windows are all known to acc
    b_ms, by = _bound_ms(*_rates_work(F, r0, n_rows, acc_t), dtype_name)
    def launch():
        rates.calculate_R_chunk(F["line"], acc_t, J, r0, *rest, lead=lead)

    # a call by CUDA events (its row table made once, the call is the
    # launch), and R1's own device time under torch.profiler beside it
    ms = _time_ms(launch, 5)
    device = _device_ms(launch, 5, "rates_chunk_kernel")
    plain = _time_ms(lambda: rates.calculate_R_chunk_plain(
        F["line"], acc_t, J, r0, *rest, lead=lead), 1)
    _add_time(t["rates_chunk"], ms, plain, b_ms, by)
    kind = ("bound-bound" if any(w[0] == "bb" for w in rates._chunk_windows(
        F["line"], r0, n_rows)) else "bound-free")
    k = kinds.setdefault(kind, {"launches": 0, "ms": 0.0, "ms_device": 0.0,
                                "plain_ms": 0.0, "bound_ms": 0.0,
                                "bound_by": by})
    n = k["launches"]
    for key, v in (("ms", ms), ("ms_device", device), ("plain_ms", plain),
                   ("bound_ms", b_ms)):
        k[key] = (k[key] * n + v) / (n + 1)
    k["launches"] = n + 1
    S_t = S.clone()
    b_ms, by = _bound_ms(*_s_update_work(F, J.shape[0]), dtype_name)
    ms = _time_ms(lambda: s1.s_update_stream(S_t, J, F["eps"], F["T"], lam_c,
                                             1), 5)
    plain = _time_ms(lambda: s1.s_update_stream_plain(
        S_t, J, F["eps"], F["T"], lam_c, 1), 1)
    _add_time(t["s_update"], ms, plain, b_ms, by)


def _add_time(acc, ms, plain, bound, by):
    acc[0] += ms
    acc[1] += plain
    acc[2] += bound
    acc[3] = by if acc[3] in (0.0, by) else "bytes and operations"


# -------------------------------------------------- phase 2: G1-G3

# phase 2's J emit shapes (label, nz, B, nx, ny): the production group's
# (four angles of a lambda chunk), a ragged tile, a batch of one; G1 runs
# on pieces of 1 and 7 planes and of a production piece (piece_steps at
# the production batch, as many planes as an xy segment piece holds)
EMIT_SHAPES = (("production", PROD["nz"], PROD["lambda_chunk"], PROD["nx"],
                 PROD["ny"]),
                ("ragged", 5, PROD["lambda_chunk"], 37, 29),
                ("B=1", PROD["nz"], 1, PROD["nx"], PROD["ny"]))
EMIT_PIECES = (1, 7)


def _group_work(kind, L, P, B, nx, ny, nz=None):
    """(bytes, operations) of a G1-G3 call: each value read once and
    each written once; G1 multiplies and adds a value read, G3 adds
    twice a point."""
    pts = B * nx * ny
    if kind == "group_emit":
        return (P + 2) * L * pts, 2 * P * L * pts
    if kind == "group_stack":
        return (1 + P) * nz * pts, 0
    return 4 * nz * pts, 2 * nz * pts


def check_group_emit(atmos):
    """Phase 2: G1-G3 (solvers/group_emit.py) against their plain
    versions on the card, bit for bit, float64 and float32, with the
    first production group's flips and down flags at EMIT_SHAPES: G1 on
    pieces of EMIT_PIECES planes up and down and of a production piece
    (its J halves full of a sentinel, so a stray write shows); G2 the S
    stack from the transposed view of a chunk's S and the I0 stack; G3
    on whole halves and on the interior of padded tiles.  Then each
    timed at the production shape beside its bytes bound, G1 a plane and
    a piece.  Returns {"times": {dtype: {kernel: (device ms, plain ms,
    bound ms, bound_by, what, ms a call)}}, "piece": {dtype: L}}."""
    import torch
    from voronoirt_tpu_torch.solvers import group_emit as ge
    from voronoirt_tpu_torch.solvers.xy_segment import piece_steps

    _, flips = _production_group(atmos)
    P = len(flips)
    down = tuple(f[2] for f in flips)
    unflips = tuple(f[:2] for f in flips)
    info = {"times": {}, "piece": {}}
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(2026)

        def u(*shape):
            return torch.rand(*shape, generator=gen, device="cuda",
                              dtype=torch.float64).to(dtype)

        piece = min(PROD["nz"] - 1, piece_steps(
            P * PROD["lambda_chunk"], PROD["nx"], PROD["ny"], dtype))
        info["piece"][dtype_name] = piece
        for label, nz, B, nx, ny in EMIT_SHAPES:
            w = u(P)
            held = []
            # G1: J halves of the production depth, so every piece fits
            J_nz = PROD["nz"]
            for L in EMIT_PIECES + (piece,):
                for dirn in ((1, -1) if L > 1 else (1,)):
                    steps = (list(range(1, L + 1)) if dirn == 1 else
                             list(range(J_nz - 2, J_nz - 2 - L, -1)))
                    planes = u(L, P * B, nx, ny)
                    got = [torch.full((J_nz, B, nx, ny), -1.0, dtype=dtype,
                                      device="cuda") for _ in range(2)]
                    want = [x.clone() for x in got]
                    ge.group_emit(planes, steps, w, down, unflips, *got)
                    ge.group_emit_plain(planes, steps, w, down, unflips,
                                        *want)
                    torch.cuda.synchronize()
                    require(all(torch.equal(a, b) for a, b in zip(got, want)),
                            f"group_emit differs from its plain version "
                            f"({label}, L {L}, dirn {dirn}, {dtype_name})")
                    held.append(f"G1 L={L}{'' if dirn == 1 else ' down'}")
                    del planes, got, want
            # G2: the S stack from a chunk's transposed view, the I0 stack
            S_t = u(B, nz, nx, ny).transpose(0, 1)
            require(torch.equal(ge.group_stack([S_t] * P, flips),
                                ge.group_stack_plain([S_t] * P, flips)),
                    f"group_stack (S) differs ({label}, {dtype_name})")
            I0 = [u(B, nx, ny) for _ in range(P)]
            require(torch.equal(ge.group_stack(I0, unflips),
                                ge.group_stack_plain(I0, unflips)),
                    f"group_stack (I0) differs ({label}, {dtype_name})")
            del S_t, I0
            held.append("G2 S and I0")
            # G3: whole halves, and the interiors of padded tiles
            J_up, J_dn = (u(nz, B, nx + 4, ny + 4) for _ in range(2))
            for cut in (slice(None), slice(2, -2)):
                up, dn = J_up[..., cut, cut], J_dn[..., cut, cut]
                Jc = u(B, nz, *up.shape[2:])
                want = Jc.clone()
                ge.group_fold(Jc, up, dn)
                ge.group_fold_plain(want, up, dn)
                torch.cuda.synchronize()
                require(torch.equal(Jc, want),
                        f"group_fold differs ({label}, {dtype_name})")
                del Jc, want
            held.append("G3 whole and interior")
            del J_up, J_dn
            torch.cuda.empty_cache()
            print(f"  J emit {dtype_name} {label} (nz {nz}, P {P}, B {B}, "
                  f"{nx}x{ny}): {', '.join(held)} bit-equal to the plain "
                  f"versions", flush=True)
        info["times"][dtype_name] = _time_group_emit(
            dtype_name, u, P, down, unflips, flips, piece)
        torch.cuda.empty_cache()
    return info


def _time_group_emit(dtype_name, u, P, down, unflips, flips, piece):
    """G1 (a plane and a piece), G2 (the S stack) and G3 at the
    production shape beside their bytes bounds."""
    import torch
    from voronoirt_tpu_torch.solvers import group_emit as ge
    nz, B, nx, ny = (PROD["nz"], PROD["lambda_chunk"], PROD["nx"],
                     PROD["ny"])
    esize = ELEMENT_BYTES[dtype_name]
    dtype = getattr(torch, dtype_name)
    J_up, J_dn = (torch.empty((nz, B, nx, ny), dtype=dtype, device="cuda")
                  for _ in range(2))
    w = u(P)
    out = {}

    def record(name, label, fn, plain, reps, work):
        calls = _time_ms(fn, reps)
        ms = _device_ms(fn, reps, name.replace("_piece", "") + "_kernel")
        plain_ms = _time_ms(plain, 2)
        nbytes, ops = work
        bound, by = _bound_ms(nbytes * esize, ops, dtype_name)
        out[name] = (ms, plain_ms, bound, by, label, calls)
        print(f"  {name} {label} ({dtype_name}): kernel {ms:.5f} ms of "
              f"device time ({calls:.5f} ms a call back to back, the "
              f"wrapper's host work included), plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({by}, {nbytes * esize / 1e9:.4f} GB), "
              f"{100 * bound / ms:.1f} % of it", flush=True)

    for L, name in ((1, "group_emit"), (piece, "group_emit_piece")):
        planes = u(L, P * B, nx, ny)
        steps = list(range(1, L + 1))
        args = (planes, steps, w, down, unflips, J_up, J_dn)
        record(name, f"a piece of {L} plane(s) at (P {P}, B {B}, {nx}x{ny})",
               lambda: ge.group_emit(*args),
               lambda: ge.group_emit_plain(*args), 20 if L > 1 else 200,
               _group_work("group_emit", L, P, B, nx, ny))
        del planes, args
    S_t = u(B, nz, nx, ny).transpose(0, 1)
    record("group_stack", f"the S stack (nz {nz}, P {P}, B {B}, {nx}x{ny}) "
           f"from a chunk's transposed view",
           lambda: ge.group_stack([S_t] * P, flips),
           lambda: ge.group_stack_plain([S_t] * P, flips), 10,
           _group_work("group_stack", 1, P, B, nx, ny, nz))
    del S_t
    Jc = u(B, nz, nx, ny)
    record("group_fold", f"(nz {nz}, B {B}, {nx}x{ny})",
           lambda: ge.group_fold(Jc, J_up, J_dn),
           lambda: ge.group_fold_plain(Jc, J_up, J_dn), 10,
           _group_work("group_fold", 1, P, B, nx, ny, nz))
    del Jc, J_up, J_dn
    return out


# ------------------------------------------------------------ phase 2: V1

# phase 2 builds the production sites (VOR_SITES) for its 442k-sized
# direction; phase 7 takes them from here with the seconds they took
_PRODUCTION_SITES = {}


def _production_sites(atmos):
    """(sites, {'sampling': s, 'tessellation': s}): VOR_SITES sites with
    the production density, tessellated by the native library; built
    once a run."""
    from voronoirt_tpu_torch import grid
    if not _PRODUCTION_SITES:
        require(grid.build_native() is not None,
                "native tessellation library not built")
        setup = {}
        t = time.perf_counter()
        pos, bounds = _sample(atmos, VOR_SITES)
        setup["sampling"] = time.perf_counter() - t
        t = time.perf_counter()
        sites = grid.build_sites(pos, bounds,
                                 grid.initialise_sites(pos, atmos))
        setup["tessellation"] = time.perf_counter() - t
        _PRODUCTION_SITES.update(sites=sites, setup=setup)
    return _PRODUCTION_SITES["sites"], dict(_PRODUCTION_SITES["setup"])


def _v1_plans(sites, directions):
    """[(label, plan)]: each direction's 'layer' plan (one gs stage), the
    same plan without its gs schedule (a 'layer' stage, three Jacobi
    passes a level) and its 'wavefront' plan (exact and relax stages)."""
    from voronoirt_tpu_torch import get_quadrature, grid
    quad = get_quadrature("ul7n12")
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        for i in directions:
            k, up = quad.k[i], bool(quad.is_up[i])
            gs = grid.build_voronoi_plan(sites, k, up)
            out += [(f"direction {i} gs", gs),
                    (f"direction {i} layer", dataclasses.replace(
                        gs, gs_levels=None, gs_up_occ=None)),
                    (f"direction {i} wavefront", grid.build_voronoi_plan(
                        sites, k, up, order="wavefront"))]
    return out


def _v1_inputs(plan, n_rows, B, dtype, seed):
    """Random I (its dummy row 0), S and an extinction whose dtau = r a
    spans 1e-4 to 1e2 at the plan's median path length (every branch of
    the linear weights), on the card."""
    import numpy as np
    import torch
    gen = torch.Generator().manual_seed(seed)
    r = np.asarray(plan.r)
    scale = float(np.median(r[r > 0]))
    S = _rand(gen, (plan.n, B), 0.1, 1.0, dtype)
    a = _rand(gen, (plan.n, B), -4.0, 2.0, dtype, log=True) / scale
    I = _rand(gen, (n_rows + 1, B), 0.0, 1.0, dtype)
    I[-1] = 0.0
    return I, S, a


def _v1_hold(plan, B, dtype, seed):
    """Every stage of `plan` through V1 and through its plain version on
    the card, from the same inputs; a relax stage through each of
    V1_RELAX_FNS, the hoisted laps through V1 from the fields and
    through the plain version fed _precompute_lean.  Raises unless the
    intensities (and the folded change) are bit-equal and each kernel
    call launched once.  Returns (stage kinds, holds, max abs err)."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    stages, _, n_rows = sv.device_plan(plan, 3, "cuda", dtype)
    I, S, a = _v1_inputs(plan, n_rows, B, dtype, seed)
    kinds, holds, worst = set(), 0, 0.0
    for sd in stages:
        kinds.add(sd.kind)
        for fn in (V1_RELAX_FNS if sd.kind == "relax" else ("stage",)):
            hoisted = fn.startswith("hoisted")
            fold = fn in ("lap", "hoisted_d")
            out = []
            for run in (vl.voronoi_stage, vl.voronoi_stage_plain):
                Ic = I.clone()
                change = (torch.zeros(2, dtype=dtype, device="cuda") if fold
                          else None)
                if run is vl.voronoi_stage:
                    n0 = vl.LAUNCHES
                    run(Ic, sd, S, a, change=change, hoisted=hoisted)
                    require(vl.LAUNCHES == n0 + 1,
                            f"V1 {sd.kind} {fn}: {vl.LAUNCHES - n0} launches")
                elif hoisted:
                    run(Ic, sd, lean=sv._precompute_lean(sd, S, a),
                        change=change)
                else:
                    run(Ic, sd, S, a, change=change)
                out.append((Ic, change))
            torch.cuda.synchronize()
            (Ik, ck), (Ip, cp) = out
            err = float((Ik - Ip).abs().max())
            worst = max(worst, err)
            require(bool(torch.isfinite(Ik).all()),
                    f"V1 {sd.kind} {fn}: output not finite")
            require(torch.equal(Ik, Ip) and (not fold or torch.equal(ck, cp)),
                    f"V1 {sd.kind} {fn} at B = {B}, {dtype}: differs from "
                    f"the plain version (max abs err {err:.3e}"
                    + (f"; change {ck.tolist()} against {cp.tolist()}"
                       if fold else "") + ")")
            holds += 1
            del out
    return kinds, holds, worst


def _v1_hold_capped(cases, dtype):
    """_v1_hold on each (label, plan) at B = 13 with V1's grid capped at
    each of V1_CAPPED_BLOCKS blocks; returns the holds."""
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    grid_blocks, holds = vl.grid_blocks, 0
    try:
        for cap in V1_CAPPED_BLOCKS:
            vl.grid_blocks = lambda *args, cap=cap: min(cap,
                                                        grid_blocks(*args))
            for j, (label, plan) in enumerate(cases):
                holds += _v1_hold(plan, 13, dtype, j)[1]
    finally:
        vl.grid_blocks = grid_blocks
    return holds


def _v1_stage_work(sd, B, esize):
    """(bytes, operations) that a pass over stage sd's levels in the
    formal form must move and do: per level, each distinct upwind I row
    and each distinct site's S and extinction read once, the rows' ids
    (int64) and geometry read once, the new rows written once, the I
    rows read and written again on each further pass; 32 operations a
    row and wavelength (an exp counted as one)."""
    import numpy as np
    off = sd.off
    level = np.repeat(np.arange(len(off) - 1), np.diff(off))

    def distinct(ids):
        return len(np.unique(level[:, None] * (int(ids.max()) + 1) + ids))

    R = int(off[-1])
    up_slot = sd.up_slot.cpu().numpy()
    sites = np.concatenate([sd.up_site.cpu().numpy(),
                            sd.row_site.cpu().numpy()[:, None]], 1)
    n_I, n_site = distinct(up_slot), distinct(sites)
    fields = (2 * n_site * B) * esize + R * (5 * 8 + 4 * esize)
    rows = (n_I + R) * B * esize
    return fields + sd.passes * rows, sd.passes * 32 * R * B


def _v1_time(plan, B, dtype_name, reps=5):
    """V1 at plan's one stage (a gs stage, or a 'layer' stage of three
    passes a level; one launch a stage): ms a level step, the plain
    version's ms a step, the bound a step and what sets it, and the
    stage's level steps."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    dtype = getattr(torch, dtype_name)
    stages, _, n_rows = sv.device_plan(plan, 3, "cuda", dtype)
    (sd,) = stages
    I, S, a = _v1_inputs(plan, n_rows, B, dtype, 7)
    steps = (len(sd.off) - 1) * sd.passes
    ms = _time_ms(lambda: vl.voronoi_stage(I, sd, S, a), reps) / steps
    plain = _time_ms(lambda: vl.voronoi_stage_plain(I, sd, S, a), 1) / steps
    nbytes, ops = _v1_stage_work(sd, B, ELEMENT_BYTES[dtype_name])
    bound, by = _bound_ms(nbytes / steps, ops / steps, dtype_name)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "steps": steps, "rows": int(sd.off[-1]),
            "bytes_a_step": nbytes / steps}


def check_voronoi_level(atmos):
    """Phase 2, V1: every stage kind through the kernel and its plain
    version, bit for bit, f64 and f32: at B in V1_BATCHES on the small
    plans of V1_DIRECTIONS, and on the production sites' direction 8 at
    the batches the Voronoi paths give it (V1_PRODUCTION_BATCHES: the
    line's 91 wavelengths at every stage kind, the continuum's one on
    the gs stage); then a level step of that direction's gs and 'layer'
    stages timed beside its bound at B = 91 (f64, f32) and B = 1 (f64).
    Returns {'errs': {dtype name: max abs err}, 'times': {(stage, dtype
    name, B): ...}}."""
    import torch
    from voronoirt_tpu_torch import grid
    pos, bounds = _sample(atmos, V1_SMALL_SITES)
    small = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    big, _ = _production_sites(atmos)
    t = time.perf_counter()
    cases = ([("small", c) for c in _v1_plans(small, V1_DIRECTIONS)]
             + [("production", c) for c in _v1_plans(big, V1_DIRECTIONS[1:])])
    print(f"  V1: {small.n} and {big.n} sites, {len(cases)} plans built in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    out = {"errs": {}, "times": {}}
    for dtype_name in ("float64", "float32"):
        worst, holds, kinds = 0.0, 0, set()
        for B in V1_BATCHES:
            for j, (size, (label, plan)) in enumerate(cases):
                if size == "production" and not any(
                        B == b and label.endswith(end)
                        for b, end in V1_PRODUCTION_BATCHES):
                    continue
                k, h, e = _v1_hold(plan, B, getattr(torch, dtype_name), j)
                kinds |= k
                holds += h
                worst = max(worst, e)
            gc.collect()
        out["errs"][dtype_name] = worst
        print(f"  V1 {dtype_name}: {holds} stage runs (stage kinds "
              f"{sorted(kinds)}, B {V1_BATCHES} on the small plans, "
              f"{V1_PRODUCTION_BATCHES} on the production direction) "
              f"bit-equal to the plain version, the folded change too, "
              f"one launch each; the hoisted laps from the fields against "
              f"the plain version fed _precompute_lean", flush=True)
        require(kinds == {"gs", "layer", "exact", "relax"},
                f"V1 stage kinds held: {kinds}")
        holds = _v1_hold_capped([c for size, c in cases if size == "small"],
                                getattr(torch, dtype_name))
        print(f"  V1 {dtype_name}: {holds} stage runs on the small plans at "
              f"B = 13 with the grid capped at {V1_CAPPED_BLOCKS} blocks, "
              f"bit-equal to the plain version",
              flush=True)
    timed = {stage: next(p for size, (label, p) in cases
                         if size == "production"
                         and label.endswith(f" {stage}"))
             for stage in ("gs", "layer")}
    for stage, plan in timed.items():
        for dtype_name, B in (("float64", 91), ("float32", 91),
                              ("float64", 1)):
            r = _v1_time(plan, B, dtype_name)
            out["times"][stage, dtype_name, B] = r
            print(f"  V1 {dtype_name}, B = {B}, production direction 8 "
                  f"{stage} stage ({r['steps']} level steps, {r['rows']} "
                  f"rows): {1e3 * r['ms']:.3f} us a level step (plain "
                  f"{1e3 * r['plain_ms']:.1f} us); bound "
                  f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']}: "
                  f"{r['bytes_a_step'] / 1e6:.3f} MB a step), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f} % of it",
                  flush=True)
    del cases, timed
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 3-4

def check_goldens():
    import numpy as np
    import torch
    from voronoirt_tpu_torch.solvers.sweep_regular import \
        short_characteristics
    fx = np.load(os.path.join(HERE, "tests", "golden",
                              "regular_sweep_fixtures.npz"))
    for case in ("up_xy", "dn_xy", "up_yz", "dn_yz", "up_xz", "dn_xz",
                 "up_mix", "dn_mix"):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
        S = fx[f"{case}_S"]
        dx = 1.0 / S.shape[1]
        I = short_characteristics(
            fx[f"{case}_k"], t(S), t(fx[f"{case}_alpha"]),
            t(fx[f"{case}_I0"]), fx[f"{case}_z"], dx, dx,
            up=bool(fx[f"{case}_up"]), n_sweeps=3).cpu().numpy()
        want = fx[f"{case}_I"]
        err = float(np.max(np.abs(I - want) / (np.abs(want) + 1e-12)))
        print(f"  golden {case}: max rel err {err:.3e}", flush=True)
        require(err < 1e-12, f"golden {case}: max rel err {err}")


def _max_rel(a, b):
    import torch
    return float(torch.max(torch.abs(a / b - 1.0)))


def check_entry():
    """Phase 4: entry()'s step on the card against the CPU; its rates
    one R1 launch and no E2.  Returns the card step's launches."""
    import torch
    from voronoirt_tpu_torch.entry import entry
    step_g, args_g = entry()            # the card, by default
    _launch_counts(reset=True)
    S_g, P_g = step_g(*args_g)
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"  entry step launches: {launches}", flush=True)
    require(launches["rates_chunk"] == 1,
            f"rates_chunk: {launches['rates_chunk']} launches in the entry "
            f"step, not 1")
    require(launches["voigt_rows"] == 0 and launches[EAGER_VOIGT] == 0,
            f"the entry step's rates reached E2 or the eager Voigt: "
            f"{launches}")
    step_c, args_c = entry(device="cpu")
    S_c, P_c = step_c(*args_c)
    eS, eP = _max_rel(S_g.cpu(), S_c), _max_rel(P_g.cpu(), P_c)
    print(f"  entry step card vs CPU: S max rel diff {eS:.3e} (< 1e-10), "
          f"populations {eP:.3e} (< 1e-8)", flush=True)
    require(eS < 1e-10 and eP < 1e-8, "entry step: card disagrees with CPU")
    return launches


# ------------------------------------------------------------ phase 5

# calls of the eager Humlicek (physics/voigt.py humlicek_w, the plain
# versions' Voigt) on CUDA tensors, which no path on the card makes
EAGER_VOIGT = "eager humlicek_w on the card"
_eager_voigt = [0]


def _count_eager_voigt():
    """Count humlicek_w's calls on CUDA tensors from here on (once a
    process: spawned ranks count their own)."""
    from voronoirt_tpu_torch.physics import voigt
    if hasattr(voigt.humlicek_w, "plain"):
        return
    plain = voigt.humlicek_w

    def counted(a, v):
        if any(getattr(x, "is_cuda", False) for x in (a, v)):
            _eager_voigt[0] += 1
        return plain(a, v)

    counted.plain = plain
    voigt.humlicek_w = counted


def _launch_counts(reset=False):
    """The kernel wrappers' launch counters and the eager Voigt's calls
    on the card; reset=True sets them to 0."""
    from voronoirt_tpu_torch.engine import s_update as s1
    from voronoirt_tpu_torch.physics import extinction as ex
    from voronoirt_tpu_torch.physics import rates
    from voronoirt_tpu_torch.solvers import group_emit as ge
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    from voronoirt_tpu_torch.solvers import xy_segment as xs
    _count_eager_voigt()
    if reset:
        xp.LAUNCHES = xs.LAUNCHES = xb.LAUNCHES = xbs.LAUNCHES = 0
        mp.LAUNCHES = mp.COEFFS_LAUNCHES = mp.CHAIN_LAUNCHES = 0
        ex.LAUNCHES = ex.GROUP_LAUNCHES = ex.VOIGT_LAUNCHES = 0
        ge.EMIT_LAUNCHES = ge.STACK_LAUNCHES = ge.FOLD_LAUNCHES = 0
        rates.LAUNCHES = s1.LAUNCHES = 0
        vl.LAUNCHES = vl.PLAIN_ON_CARD = 0
        sv.STAGE_CALLS = sv.LEAN_ON_CARD = 0
        _eager_voigt[0] = 0
    return {"xy_segment": xs.LAUNCHES, "xy_plane": xp.LAUNCHES,
            "march_plane": mp.LAUNCHES, "march_coeffs": mp.COEFFS_LAUNCHES,
            "march_chain": mp.CHAIN_LAUNCHES,
            "alpha_tot_group": ex.GROUP_LAUNCHES, "alpha_tot": ex.LAUNCHES,
            "voigt_rows": ex.VOIGT_LAUNCHES, "group_emit": ge.EMIT_LAUNCHES,
            "group_stack": ge.STACK_LAUNCHES, "group_fold": ge.FOLD_LAUNCHES,
            "rates_chunk": rates.LAUNCHES, "s_update": s1.LAUNCHES,
            X1: xb.LAUNCHES, XBS: xbs.LAUNCHES, V1: vl.LAUNCHES,
            V1_CALLS: sv.STAGE_CALLS, EAGER_VOIGT: _eager_voigt[0],
            EAGER_LEVELS: vl.PLAIN_ON_CARD, EAGER_HOIST: sv.LEAN_ON_CARD}


def _require_path(launches, used, what):
    """Every kernel in `used` launched on the path, and no other (nor
    the eager Voigt, the plain level loop or the lean precompute on the
    card); V1, where used, once a stage or relax-lap call."""
    if V1 in used:
        require(launches[V1] == launches[V1_CALLS],
                f"{V1}: {launches[V1]} launches in {what}, "
                f"{launches[V1_CALLS]} stage calls")
    for name, n in launches.items():
        if name == V1_CALLS:
            continue
        if name in used:
            require(n > 0, f"{name}: no launch in {what}")
        else:
            require(n == 0, f"{name}: {n} launches in {what}, which should "
                            f"not reach it")


def _xy_pieces(eng, dtype):
    """xy_segment launches one streamed iteration of `eng` makes: a piece
    of at most piece_steps planes of every xy segment of every group, in
    every lambda chunk."""
    from voronoirt_tpu_torch.solvers.xy_segment import piece_steps
    chunk = eng.cfg.lambda_chunk
    n = 0
    for lo in range(0, eng.line.n_lambda, chunk):
        b = min(chunk, eng.line.n_lambda - lo)
        for g in eng.plan_groups:
            B = b * len(g)
            n += sum(-(-len(s.steps) // piece_steps(B, *eng.atmos.shape[1:],
                                                    dtype))
                     for s in g[0][1].segments if s.case == "xy")
    return n


def _bezier_xy(eng):
    """(segments, steps): the Bezier xy segments one J pass of `eng`
    sweeps, and their z-steps: every xy segment of every direction, in
    every lambda chunk (one sweep an angle at B = the chunk's
    wavelengths).  An unsplit grid whose plane fits makes one
    xy_bezier_segment launch a segment; one that does not fit one X1
    launch a step."""
    n_chunks = -(-eng.line.n_lambda // eng.cfg.lambda_chunk)
    segs = [s for plan in eng.plans for s in plan.segments if s.case == "xy"]
    return n_chunks * len(segs), n_chunks * sum(len(s.steps) for s in segs)


def _group_launches(eng):
    """alpha_tot_group launches one streamed iteration of `eng` makes:
    one a mirror group and lambda chunk of the engine's block (every
    production group holds four angles, so no per-angle alpha_tot)."""
    require(all(len(g) > 1 for g in eng.plan_groups),
            f"a singleton group: {[len(g) for g in eng.plan_groups]}")
    n_lambda = eng.lam_block.stop - eng.lam_block.start
    return len(eng.plan_groups) * -(-n_lambda // eng.cfg.lambda_chunk)


def _emit_expected(eng, launches):
    """G1-G3's launches on a grouped regular path, from the sweep
    kernels' launches of the same run: one group_emit a K2 plane, a K1
    launch (a piece of an xy segment, or a plane on a split grid) and a
    group sweep's boundary plane; two group_stack (S and I0) and one
    group_fold a group sweep, one sweep a mirror group and lambda
    chunk."""
    n = _group_launches(eng)
    return {"group_emit": launches["march_plane"] + launches["xy_segment"]
            + launches["xy_plane"] + n, "group_stack": 2 * n,
            "group_fold": n}


def _require_emit(launches, want, what):
    got = {k: launches[k] for k in want}
    require(got == want, f"{what}: launches {got}, not {want}")


def _edge_rows(n_lambda, n_ranks):
    """The first and last row of each rank's block of n_lambda
    wavelengths padded to a multiple of n_ranks, as rows of the
    unpadded grid (a padded row repeats the last wavelength)."""
    n = -(-n_lambda // n_ranks)
    rows = {r * n + d for r in range(n_ranks) for d in (0, n - 1)}
    return {row: min(row, n_lambda - 1) for row in sorted(rows)}


def _production_iteration(atmos, dtype_name):
    """One lambda-streamed iteration at the production configuration in
    `dtype_name`, the J pass timed chunk by chunk; prints its set-up,
    seconds, J-pass share, rate, peak memory and launch counts, and
    requires the shapes, finite values and a launch of every kernel.
    Returns (result, engine, launches, max |sum(populations)/n_H - 1|)."""
    from collections import Counter

    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import march_plane as mp

    p = PROD
    t0 = time.perf_counter()
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=1, eps=0.0,
                 dtype=dtype_name)
    T = torch.as_tensor(atmos.temperature, dtype=getattr(torch, dtype_name),
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = RegularEngine(atmos, line, cfg, device="cuda")
    torch.cuda.synchronize()
    groups = [(len(g), sorted({s.case for s in g[0][1].segments}))
              for g in eng.plan_groups]
    print(f"  {dtype_name}: set-up {time.perf_counter() - t0:.2f} s; grid "
          f"{p['nz']}x{p['nx']}x{p['ny']}, {line.n_lambda} wavelengths, "
          f"{eng.quad.n_angles} directions, lambda_chunk "
          f"{cfg.lambda_chunk}; groups (angles, cases) {groups}", flush=True)

    # J-pass time: synchronise around every chunk's grouped J
    j_times = []
    j_chunk = eng._J_chunk_grouped

    def timed_J(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = j_chunk(*args, **kwargs)
        torch.cuda.synchronize()
        j_times.append(time.perf_counter() - t)
        return out

    eng._J_chunk_grouped = timed_J
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    splits = Counter(mp.CHAIN_SPLIT)
    res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    splits = dict(Counter(mp.CHAIN_SPLIT) - splits)
    want_split = mp.chain_split(p["ny"])
    print(f"  march_chain launches by split (W, H): {splits}", flush=True)
    require(set(splits) == {want_split} and
            splits[want_split] == launches["march_chain"],
            f"the iteration's chain launches took splits {splits}, not "
            f"only {want_split}")

    require(res.iterations == 1 and len(res.timings) == 1,
            f"expected 1 iteration, ran {res.iterations}")
    it, j = res.timings[0], sum(j_times)
    shape = (line.n_lambda, p["nz"], p["nx"], p["ny"])
    require(tuple(res.S.shape) == shape, f"S shape {tuple(res.S.shape)}")
    require(tuple(res.populations.shape) == shape[1:] + (3,),
            f"populations shape {tuple(res.populations.shape)}")
    require(res.S.dtype == res.populations.dtype == T.dtype,
            f"S {res.S.dtype}, populations {res.populations.dtype}")
    finite = bool(torch.isfinite(res.S).all()) and bool(
        torch.isfinite(res.populations).all())
    require(finite, "S or populations not finite")
    mass = _max_rel(res.populations.double().sum(-1), eng.nH.double())
    rate = (p["nz"] * p["nx"] * p["ny"] * line.n_lambda
            * eng.quad.n_angles) / j
    print(f"  the iteration {it:.4f} s, J pass {j:.4f} s "
          f"({100 * j / it:.1f}%), {rate:.4e} grid-points*rays/s",
          flush=True)
    print(f"  peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated); criterion {res.convergence}; "
          f"S, populations finite: {finite}; sum(populations)/n_H - 1 "
          f"max {mass:.3e}", flush=True)
    pieces = _xy_pieces(eng, T.dtype)
    n_ext = _group_launches(eng)
    emit = _emit_expected(eng, launches)
    print(f"  launches during the iteration: {launches} (xy_segment: one a "
          f"piece of an xy segment, {pieces} expected; alpha_tot_group: one "
          f"a mirror group and lambda chunk, {n_ext} expected; alpha_tot: "
          f"none; the J emit {emit} expected: group_emit one a K2 plane, "
          f"an xy piece and a group sweep's boundary)", flush=True)
    n_chunks = -(-line.n_lambda // cfg.lambda_chunk)
    print(f"  rates_chunk, s_update: {launches['rates_chunk']}, "
          f"{launches['s_update']} launches, one each a lambda chunk "
          f"({n_chunks}); voigt_rows {launches['voigt_rows']}", flush=True)
    _require_path(launches, UNSPLIT + GROUPED_EXT + GROUP_KERNELS
                  + RATE_KERNELS, "the streamed iteration")
    _require_emit(launches, emit, "the streamed iteration")
    require(launches["rates_chunk"] == launches["s_update"] == n_chunks,
            f"rates_chunk / s_update: {launches['rates_chunk']} / "
            f"{launches['s_update']} launches, not {n_chunks} each")
    require(launches["xy_segment"] == pieces,
            f"xy_segment: {launches['xy_segment']} launches, not {pieces}")
    require(launches["alpha_tot_group"] == n_ext,
            f"alpha_tot_group: {launches['alpha_tot_group']} launches, not "
            f"{n_ext}")
    return res, eng, launches, mass


def state_digest(S, populations):
    """The sha256 of S's and of the populations' bytes, a row at a time
    from the card: equal digests, equal results bit for bit."""
    import hashlib
    out = []
    for A in (S, populations):
        h = hashlib.sha256()
        for row in A:
            h.update(row.contiguous().cpu().numpy())
        out.append(h.hexdigest())
    return out


def run_production(atmos, n_ranks=LAM_RANKS, keep_S=False):
    """Phase 5: one lambda-streamed iteration at the production
    configuration, float64.  Returns the launch counts and, on the host,
    what phases 12-13 hold against: the populations, the wavelengths and
    the S rows at the edges of n_ranks' lambda blocks; with keep_S, for
    phase 15, the whole S (10.26 GB) and its largest magnitude too; for
    phase 16's checkpoint mapping, the line's wavelength windows, the
    convergence history and the iteration's seconds."""
    res, eng, launches, mass = _production_iteration(atmos, "float64")
    require(mass < 1e-10, f"populations do not sum to n_H ({mass:.3e})")
    d_S, d_P = state_digest(res.S, res.populations)
    print(f"  sha256 of S {d_S}, of the populations {d_P} (equal digests "
          f"from tools/phase5_checksum.py on another checkout: bit-equal)",
          flush=True)
    n_lambda = res.S.shape[0]
    ref = {"populations": res.populations.cpu().numpy(),
           "lam": eng.line.lam, "temperature": atmos.temperature,
           "S_rows": {row: res.S[row].cpu().numpy() for row in set(
               _edge_rows(n_lambda, n_ranks).values())},
           "lam_idx": eng.line.lam_idx, "convergence": res.convergence,
           "time": sum(res.timings)}
    if keep_S:
        ref["S"] = res.S.cpu().numpy()
        ref["S_scale"] = float(res.S.abs().max())
    return launches, ref


# ------------------------------------------------------------ phase 6-7

_VOR_FIELDS = ("positions", "neighbours", "delaunay_lines", "layers_up",
               "layers_down", "temperature", "electron_density",
               "hydrogen_populations", "velocity_z", "velocity_x",
               "velocity_y")


def _rel_err(got, want):
    """Max relative difference, absolute where want == 0 (as
    tests/test_nlte_parity.py measures it)."""
    import torch
    denom = torch.where(want == 0.0, 1.0, want)
    return float(torch.where(want == 0.0, got.abs(),
                             (got / denom - 1.0).abs()).max())


def _sample(atmos, n_sites):
    """n_sites positions sampled with the production density, and the
    atmosphere's bounds."""
    from voronoirt_tpu_torch import grid
    pos = grid.sample_sites(atmos, n_sites, density="invNH_invT", seed=2022)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return pos, bounds


def check_voronoi_goldens():
    """Phase 6: the vor_* chain through VoronoiEngine.run() on the card,
    then wavefront sweeps card against CPU."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch import Config, get_quadrature, synthetic_atmosphere
    from voronoirt_tpu_torch import grid
    from voronoirt_tpu_torch.engine import VoronoiEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv

    fx = np.load(os.path.join(HERE, "tests", "golden", "nlte_fixtures.npz"))
    sites = grid.VoronoiSites(
        **{f: fx[f"vor_sites_{f}"] for f in _VOR_FIELDS},
        bounds=tuple(fx["vor_bounds"]))
    cfg = Config(maxiter=3, eps=1e-30, quadrature="ul7n12", nlam_bb=9,
                 nlam_bf=4, compat="reference", voronoi_order="layer")
    T = torch.as_tensor(sites.temperature, dtype=torch.float64,
                        device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        eng = VoronoiEngine(sites, lyman_alpha_line(9, 4, T), cfg,
                            device="cuda")
    eng.load_state({"a_cont": fx["vor_alpha_cont"], "eps": fx["vor_eps"],
                    **{f"C_{k}": fx[f"vor_C_{k}"]
                       for k in ("01", "10", "02", "20", "12", "21")}})
    _launch_counts(reset=True)
    res = eng.run()
    launches = _launch_counts()
    print(f"  vor_* chain launches: {launches}", flush=True)
    _require_path(launches, VORONOI, "the vor_* chain")
    require(res.iterations == 3, f"vor chain ran {res.iterations} iterations")
    for what, got, key, tol in (("J", res.J, "vor_J_2", 1e-8),
                                ("S", res.S, "vor_S_2", 1e-8),
                                ("populations", res.populations,
                                 "vor_pops_2", 1e-7)):
        require(got.is_cuda, f"vor chain {what} left the card")
        err = _rel_err(got, torch.as_tensor(fx[key], device="cuda"))
        print(f"  vor_* golden {what}: max rel err {err:.3e} (< {tol:g})",
              flush=True)
        require(err < tol, f"vor_* golden {what}: max rel err {err:.3e}")

    # wavefront sweeps, card against CPU: the 4 steep directions are
    # exact-only, the 8 others relax with repeats; the extinction keeps
    # every dtau above 0.03, clear of the linear weights' cancellation
    # near their 5e-4 guard, where one-ulp exp differences between the
    # devices' libraries grow (ROADMAP C3)
    atmos = synthetic_atmosphere(nz=40, nx=32, ny=32)
    pos, bounds = _sample(atmos, 5000)
    wsites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    quad = get_quadrature("ul7n12")
    gen = np.random.default_rng(6)
    B, worst, kinds = 8, 0.0, set()
    _launch_counts(reset=True)
    for i in range(quad.n_angles):
        plan = grid.build_voronoi_plan(wsites, quad.k[i],
                                       bool(quad.is_up[i]),
                                       order="wavefront")
        r = np.asarray(plan.r)
        S = gen.uniform(0.1, 1.0, (B, wsites.n))
        alpha = 10.0 ** gen.uniform(0.0, 2.0, (B, wsites.n)) * 0.03 / r[
            r > 0].min()
        I0 = gen.uniform(0.0, 1.0, (B, len(plan.bc_sites)))
        out, steps = {}, {}
        for dev in ("cuda", "cpu"):
            t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
            sv.LEVEL_STEPS = 0
            calls = sv.STAGE_CALLS
            out[dev] = sv.sweep_voronoi(plan, t(S), t(alpha), t(I0),
                                        relax_tol=1e-7)
            steps[dev] = sv.LEVEL_STEPS
            if dev == "cpu":
                # the CPU reference's stage calls are not the card's
                sv.STAGE_CALLS = calls
        require(steps["cuda"] == steps["cpu"],
                f"direction {i}: {steps['cuda']} level steps on the card, "
                f"{steps['cpu']} on the CPU")
        worst = max(worst, _rel_err(out["cuda"].cpu(), out["cpu"]))
        kinds |= {st.kind for st in sv.build_slot_plan(plan).stages}
    launches = _launch_counts()
    print(f"  wavefront sweeps ({wsites.n} sites, B={B}, 12 directions, "
          f"stages {sorted(kinds)}, relax_tol 1e-7): card vs CPU max rel "
          f"diff {worst:.3e} (<= 1e-10), equal level steps; {V1} launches "
          f"on the card {launches[V1]}", flush=True)
    _require_path(launches, (V1,), "the wavefront sweeps")
    require(kinds == {"exact", "relax"}, f"stage kinds {kinds}")
    require(worst <= 1e-10, f"wavefront sweep card vs CPU: {worst:.3e}")


@contextmanager
def _timed_J(eng, lambda_iter, sv):
    """Synchronised host timers around each compute_J (seconds, level
    steps) and, inside the last one, each direction's extinction and
    sweep.  Without lambda chunking a J pass makes one extinction and
    one sweep per direction, in quadrature order."""
    import torch
    n_dir = eng.quad.n_angles
    rec = {"J": [], "steps": [], "ext": [], "sweep": []}
    compute_J, alpha_tot, sweep_t = (eng.compute_J, eng._alpha_tot_T,
                                     lambda_iter.sweep_voronoi_t)

    def timed(fn, times):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return out
        return wrapped

    def J(*args, **kwargs):
        rec["ext"].clear()
        rec["sweep"].clear()
        s0 = sv.LEVEL_STEPS
        out = timed(compute_J, rec["J"])(*args, **kwargs)
        rec["steps"].append(sv.LEVEL_STEPS - s0)
        require(len(rec["sweep"]) == len(rec["ext"]) == n_dir,
                f"{len(rec['sweep'])} sweeps in a J pass of {n_dir} "
                f"directions")
        return out

    eng.compute_J = J
    eng._alpha_tot_T = timed(alpha_tot, rec["ext"])
    lambda_iter.sweep_voronoi_t = timed(sweep_t, rec["sweep"])
    try:
        yield rec
    finally:
        del eng.compute_J, eng._alpha_tot_T
        lambda_iter.sweep_voronoi_t = sweep_t


@contextmanager
def _keep_sweep(lambda_iter, n):
    """The n-th sweep_voronoi_t call's plan and keywords, and its inputs
    and output copied to the host as it returns (before compute_J
    weights the output in place)."""
    kept = {}
    sweep = lambda_iter.sweep_voronoi_t
    calls = [0]

    def keeping(plan, S_T, a_T, I0, **kwargs):
        out = sweep(plan, S_T, a_T, I0, **kwargs)
        calls[0] += 1
        if calls[0] == n:
            kept.update(plan=plan, kwargs=kwargs, S_T=S_T.cpu(),
                        a_T=a_T.cpu(), I0=I0.cpu(), out=out.cpu())
        return out

    lambda_iter.sweep_voronoi_t = keeping
    try:
        yield kept
    finally:
        lambda_iter.sweep_voronoi_t = sweep


def _hold_production_sweep(kept, sv):
    """Phase 7: the kept production sweep again on the card through V1
    and through the plain level loop, timed; both bit-equal to the
    iteration's own output."""
    import torch
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    require(bool(kept), f"sweep {V1_CALL} of the iterations not kept")
    args = (kept["plan"],) + tuple(kept[k].to("cuda")
                                   for k in ("S_T", "a_T", "I0"))
    out, secs, steps = {}, {}, {}
    for name, stage in ((V1, sv.voronoi_stage),
                        ("plain", vl.voronoi_stage_plain)):
        real = sv.voronoi_stage
        sv.voronoi_stage = stage
        try:
            s0 = sv.LEVEL_STEPS
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = sv.sweep_voronoi_t(*args, **kept["kwargs"])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            steps[name] = sv.LEVEL_STEPS - s0
        finally:
            sv.voronoi_stage = real
    same = (torch.equal(out[V1], out["plain"])
            and torch.equal(out[V1].cpu(), kept["out"]))
    print(f"  sweep {V1_CALL} of the iterations (direction "
          f"{(V1_CALL - 1) % 12}, (n, B) = {tuple(out[V1].shape)}, "
          f"{steps[V1]} level steps) again: {V1} {secs[V1]:.4f} s, the plain "
          f"level loop {secs['plain']:.4f} s; both bit-equal to the "
          f"iteration's output: {same}", flush=True)
    require(same, f"sweep {V1_CALL}: {V1} and the plain loop differ")


def run_voronoi_production(atmos):
    """Phase 7: two 'layer' iterations at VOR_SITES sites, 91
    wavelengths, ul7n12, float64.  Returns the sites and, for phase 15,
    the plans and the result's S and populations on the host (the
    populations, convergence history and seconds for phase 16 too)."""
    import torch
    from voronoirt_tpu_torch import Config, get_quadrature
    from voronoirt_tpu_torch.engine import VoronoiEngine, lambda_iter
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv

    p = PROD
    sites, setup = _production_sites(atmos)
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], voronoi_order="layer",
                 maxiter=2, eps=0.0)
    quad = get_quadrature(cfg.quadrature)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        plans = VoronoiEngine.build_plans(sites, quad, cfg)
    setup["plans (layer, 12 directions)"] = time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    T = torch.as_tensor(sites.temperature, dtype=torch.float64,
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = VoronoiEngine(sites, line, cfg, plans=plans, device="cuda")
    torch.cuda.synchronize()
    setup["engine set-up"] = time.perf_counter() - t
    print(f"  {sites.n} sites, {line.n_lambda} wavelengths, "
          f"{quad.n_angles} directions; set-up seconds "
          f"{ {k: round(v, 4) for k, v in setup.items()} }", flush=True)

    _launch_counts(reset=True)
    with _timed_J(eng, lambda_iter, sv) as rec, \
            _keep_sweep(lambda_iter, V1_CALL) as kept:
        res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(res.iterations == 2 and len(res.timings) == 2,
            f"expected 2 iterations, ran {res.iterations}")
    n_ext = 2 * quad.n_angles * len(lambda_iter._lambda_chunks(
        line.n_lambda, cfg.lambda_chunk))
    print(f"  launches during the two iterations: {launches} (alpha_tot: "
          f"one a direction and lambda chunk, {n_ext} expected; "
          f"{V1}: one a stage call, {launches[V1_CALLS]} calls; "
          f"{sum(rec['steps'])} level steps)", flush=True)
    _require_path(launches, VORONOI, "the Voronoi iterations")
    require(launches["alpha_tot"] == n_ext,
            f"alpha_tot: {launches['alpha_tot']} launches, not {n_ext}")
    n, nlam = sites.n, line.n_lambda
    require(tuple(res.S.shape) == (nlam, n) and res.S.is_cuda,
            f"S shape {tuple(res.S.shape)} on {res.S.device}")
    require(tuple(res.populations.shape) == (n, 3),
            f"populations shape {tuple(res.populations.shape)}")
    finite = bool(torch.isfinite(res.S).all()) and bool(
        torch.isfinite(res.populations).all())
    require(finite, "S or populations not finite")
    mass = _max_rel(res.populations.sum(-1), eng.nH)
    require(mass < 1e-10, f"populations do not sum to n_H ({mass:.3e})")
    it2, j2 = res.timings[1], rec["J"][1]
    rays = n * nlam * quad.n_angles
    sweep_s = sum(rec["sweep"])
    print(f"  layer: iteration seconds {[round(x, 4) for x in res.timings]};"
          f" J pass {[round(x, 4) for x in rec['J']]} s "
          f"({100 * j2 / it2:.1f}% of the second iteration), "
          f"{rays / j2:.4e} sites*wavelengths*rays/s", flush=True)
    print(f"  layer, second J pass by direction: extinction s "
          f"{[round(x, 4) for x in rec['ext']]}; sweep s "
          f"{[round(x, 4) for x in rec['sweep']]}",
          flush=True)
    print(f"  layer: level steps per J pass {rec['steps']}; "
          f"{1e6 * sweep_s / rec['steps'][1]:.2f} us of sweep per level step",
          flush=True)
    print(f"  criterion {res.convergence}; sum(populations)/n_H - 1 max "
          f"{mass:.3e}", flush=True)
    print(f"  peak device memory {peak / 2**30:.3f}"
          f" GiB (max_memory_allocated, phase 7)", flush=True)
    _hold_production_sweep(kept, sv)
    # host copies of the plans for phase 15: the float64 device arrays
    # the engine cached on the originals would stay on the card through
    # phases 8-14, whose spawned ranks need the room
    return sites, {"plans": [dataclasses.replace(p) for p in plans],
                   "launches": launches, "S": res.S.cpu().numpy(),
                   "populations": res.populations.cpu().numpy(),
                   "convergence": res.convergence,
                   "time": sum(res.timings)}


# ------------------------------------------------------------ phase 8-11

def _card_timer():
    """A PhaseTimer whose phases end with the card synchronised; the
    card is synchronised here too, so the first phase starts idle."""
    import torch
    from voronoirt_tpu_torch.observability import PhaseTimer
    torch.cuda.synchronize()
    return PhaseTimer(device="cuda")


def _small_line_engine(atmos, device, nlam=(5, 3), **cfg_kw):
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    cfg = Config(nlam_bb=nlam[0], nlam_bf=nlam[1], **cfg_kw)
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64,
                        device=device)
    return RegularEngine(atmos, lyman_alpha_line(*nlam, T), cfg,
                         device=device)


def check_bezier_sweeps():
    """Phase 8a: interpolation='bezier' (and 'linear') sweeps of every
    ul7n12 direction on a stretched z axis, card against CPU.  The linear
    bar is 1e-12; the Bezier one 1e-10, because the Bezier weights
    cancel digits near their dtau = 0.05 branch, where one-ulp exp
    differences between the devices' libraries grow (ROADMAP C3).  The
    Bezier sweeps' xy segments go through the segment kernel, one launch
    a segment, and none through X1."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch import get_quadrature
    from voronoirt_tpu_torch.solvers import sweep_regular as sr

    quad = get_quadrature("ul7n12")
    gen = np.random.default_rng(8)
    nz, nx, ny, B = 24, 32, 32, 5
    # steps from 0.2 to 3 cells: the oblique directions change plane-cut
    # case from plane to plane
    z = np.concatenate([[0.0], np.cumsum(gen.uniform(0.2, 3.0, nz - 1))]) / nx
    S = gen.uniform(0.1, 1.0, (nz, B, nx, ny))
    # every dtau stays above 0.03, clear of the linear weights'
    # cancellation near their 5e-4 guard (as in phase 6), and crosses
    # the Bezier weights' 0.05 branch and the large-dtau one
    alpha = 10.0 ** gen.uniform(0.7, 2.5, (nz, B, nx, ny))
    I0 = gen.uniform(0.5, 1.0, (B, nx, ny))
    worst = {"linear": 0.0, "bezier": 0.0}
    launches = {interp: dict.fromkeys(_launch_counts(), 0)
                for interp in worst}
    cases, differs, n_xy, n_segs = set(), 0.0, 0, 0
    for i in range(quad.n_angles):
        plan = sr.build_plan(quad.k[i], z, 1.0 / nx, 1.0 / ny,
                             bool(quad.is_up[i]))
        cases |= {s.case for s in plan.segments}
        n_xy += sum(len(s.steps) for s in plan.segments if s.case == "xy")
        n_segs += sum(s.case == "xy" for s in plan.segments)
        out = {}
        for interp in worst:
            for dev in ("cuda", "cpu"):
                t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                              device=dev)
                _launch_counts(reset=True)
                out[interp, dev] = sr.sweep(
                    plan, t(S), t(alpha), t(I0 if plan.up else 0.0 * I0),
                    n_sweeps=3, interpolation=interp).cpu()
                for k, n in _launch_counts().items():
                    launches[interp][k] += n
            worst[interp] = max(worst[interp],
                                _rel_err(out[interp, "cuda"],
                                         out[interp, "cpu"]))
        differs = max(differs, _rel_err(out["bezier", "cuda"],
                                        out["linear", "cuda"]))
    print(f"  sweeps of 12 directions ({nz}x{nx}x{ny}, B={B}, cases "
          f"{sorted(cases)}): card vs CPU max rel diff linear "
          f"{worst['linear']:.3e} (<= 1e-12), bezier {worst['bezier']:.3e} "
          f"(<= 1e-10); bezier vs linear on the card {differs:.3e}; "
          f"launches of the linear sweeps {launches['linear']}, of the "
          f"Bezier sweeps {launches['bezier']} ({n_xy} Bezier xy plane "
          f"steps in {n_segs} segments)", flush=True)
    require(cases == {"xy", "yz", "xz"}, f"plane-cut cases {cases}")
    require(worst["linear"] <= 1e-12 and worst["bezier"] <= 1e-10,
            f"sweeps card vs CPU: {worst}")
    require(differs > 1e-3, "the Bezier sweep equals the linear one")
    # the linear sweeps run their xy segments through K1 (xy_segment),
    # the Bezier sweeps through the segment kernel, one launch a segment,
    # and no X1; the marching segments of both go through K2
    _require_path(launches["linear"], UNSPLIT, "the linear sweeps")
    _require_path(launches["bezier"], (XBS,) + UNSPLIT[1:],
                  "the Bezier sweeps")
    require(launches["bezier"][XBS] == n_segs,
            f"{XBS}: {launches['bezier'][XBS]} launches, not one a Bezier "
            f"xy segment ({n_segs})")


def _time_bezier_step(B):
    """ms of one Bezier xy step at (B, 256, 256), float64: a step of a
    214-step segment through the segment kernel, X1's plane step and
    the plain version's on the same inputs, and the bound
    (time_xy_bezier_segment); and K1's (the linear step, one plane a
    launch), held against its plain version on the same planes first.
    Returns (time_xy_bezier_segment's dict, K1 ms)."""
    import torch
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    seg = time_xy_bezier_segment(B, "float64")
    nx, ny = PROD["nx"], PROD["ny"]
    gen = torch.Generator().manual_seed(9)
    a_p, a_c, s_p, s_c, i_p = _planes(gen, B, nx, ny, torch.float64)
    r = torch.full((B,), 0.7, dtype=torch.float64, device="cuda")
    fx, fy = 0.3 * torch.ones_like(r), 0.6 * torch.ones_like(r)
    k1_args = (a_p, a_c, s_p, s_c, i_p, r, fx, fy, -1, 0)
    _compare("xy_plane", xp.xy_plane(*k1_args), xp.xy_plane_plain(*k1_args),
             "float64")
    k1 = _device_ms(lambda: xp.xy_plane(*k1_args), 50, "xy_plane_kernel")
    return seg, k1


# z-planes per slab of the rates in the Bezier production iteration
BEZIER_RATES_PLANES = 8
# which march_plane call and which segment kernel call of that iteration
# are held against the plain versions: mid-sweep, the carried intensity
# no longer the boundary's; the segment's second call, held on its first
# XBS_HOLD planes (in the sweep, so inside the timed iteration: a plain
# step is ~3 ms; phase 2 holds whole segments)
K2_CALL = 1000
XBS_CALL = 2
XBS_HOLD = 3


@contextmanager
def _keep_call(name, n, batch=None, shape=None):
    """Keep the arguments and result of the n-th call that the regular
    sweep makes of the kernel wrapper `name` ('xy_segment', 'xy_plane',
    'march_plane', 'xy_bezier' or 'xy_bezier_segment'), to hold against
    the plain version afterwards; with `batch`, the n-th call on a batch
    of that many planes; with `shape`, the n-th call on planes of that
    shape.  An xy_segment or xy_bezier_segment call is held at once,
    inside the sweep, before the next piece reuses its planes or the
    sweep goes on: its inputs are the whole fields, too large to
    copy (an xy_bezier_segment call on its first XBS_HOLD steps)."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    fn, kept = getattr(sr, name), {"seen": 0}
    # the batch plane: I0 of a segment, the first plane of a plane call
    plane_of = (lambda args: args[2]) if name in ("xy_segment", XBS) \
        else (lambda args: args[0])

    def keeping(*args, **kwargs):
        plane = plane_of(args)
        if ((batch is not None and plane.shape[0] != batch)
                or (shape is not None and tuple(plane.shape) != shape)):
            return fn(*args, **kwargs)
        kept["seen"] += 1
        if kept["seen"] != n:
            return fn(*args, **kwargs)
        if name == XBS:
            out = fn(*args, **kwargs)
            # alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out
            steps, h = args[3], min(len(args[3]), XBS_HOLD)
            kept["planes"] = _hold_bezier_segment(
                args[:3] + (steps[:h], args[4]) +
                tuple(v[:h] for v in args[5:8]) + args[8:10], args[10])
            kept["err"] = (0.0, 0.0)
            kept["shape"], kept["dtype"] = tuple(out.shape), out.dtype
            kept["statics"] = {"steps": f"{steps[0]}..{steps[-1]}",
                               "held": f"{steps[0]}..{steps[h - 1]}",
                               "dirn": args[4], "sxs": args[8],
                               "sys": args[9]}
            return out
        if name == "xy_segment":
            out = fn(*args, **kwargs)
            kept["err"] = _hold_segment(args, out)
            kept["shape"], kept["dtype"] = tuple(out.shape), out.dtype
            kept["statics"] = {"steps": f"{args[3][0]}..{args[3][-1]}",
                               "dirn": args[4], "sxs": args[8],
                               "sys": args[9]}
            return out
        kept["args"] = tuple(a.clone() if torch.is_tensor(a) else a
                             for a in args)
        kept["statics"] = kwargs
        out = fn(*args, **kwargs)
        # a copy: on a split grid the sweep refills the output's halo in
        # place
        kept["out"] = out.clone()
        kept["shape"], kept["dtype"] = tuple(out.shape), out.dtype
        return out

    setattr(sr, name, keeping)
    try:
        yield kept
    finally:
        setattr(sr, name, fn)


def _hold_kept(name, kept, n, what):
    """The kept n-th call of `name` against its plain version on the
    same inputs, at TOL of the call's dtype; returns the max abs
    error."""
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    require("shape" in kept, f"{what} made {kept['seen']} {name} calls, "
                             f"fewer than {n}")
    dtype_name = str(kept["dtype"]).replace("torch.", "")
    if name in ("xy_segment", XBS):
        e_abs, e_rel = kept["err"]
    else:
        plain = {"xy_plane": xp.xy_plane_plain,
                 "march_plane": mp.march_plane_plain,
                 X1: xb.xy_bezier_plain}[name]
        e_abs, e_rel = _compare(name, kept["out"],
                                plain(*kept["args"], **kept["statics"]),
                                dtype_name)
    print(f"  {name} call {n} of {what}, {kept['shape']} {dtype_name}, "
          f"{kept['statics']}: against the plain version on the same "
          f"inputs max abs err {e_abs:.3e} (rel {e_rel:.3e}, "
          f"{TOL[dtype_name]})", flush=True)
    return e_abs


def run_bezier_production(atmos):
    """Phase 8b: one Lambda iteration of the production configuration
    with formal_interpolation='bezier' through RegularEngine.run(), the
    standard (not lambda-streamed) loop: S_old, S_new, J and B0 are
    resident, the rates run in slabs of z-planes."""
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.observability import nan_guard, throughput
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    p = PROD
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], formal_interpolation="bezier",
                 lambda_chunk=p["lambda_chunk"],
                 rates_site_chunk=BEZIER_RATES_PLANES, maxiter=1, eps=0.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64,
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    timer = _card_timer()
    with timer.phase("set-up"):
        eng = RegularEngine(atmos, line, cfg, device="cuda")
    cases = [sorted({s.case for s in pl.segments}) for pl in eng.plans]
    n_xy = sum(len(s.steps) for pl in eng.plans for s in pl.segments
               if s.case == "xy")
    n_segs = _bezier_xy(eng)[0]
    compute_J = eng.compute_J

    def timed_J(*args, **kwargs):
        torch.cuda.synchronize()
        with timer.phase("J pass"):
            return compute_J(*args, **kwargs)

    eng.compute_J = timed_J
    _launch_counts(reset=True)
    # keep one march_plane call (the K2_CALL-th) and one segment kernel
    # call (the XBS_CALL-th) of the iteration
    with _keep_call("march_plane", K2_CALL) as kept, \
            _keep_call(XBS, XBS_CALL) as kept_xbs, timer.phase("run"):
        res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    t_setup, wall = timer.totals["set-up"], timer.totals["run"]

    require(res.iterations == 1 and len(res.timings) == 1
            and timer.counts["J pass"] == 1,
            f"ran {res.iterations} iterations")
    shape = (line.n_lambda, p["nz"], p["nx"], p["ny"])
    require(tuple(res.S.shape) == shape and tuple(res.J.shape) == shape,
            f"S shape {tuple(res.S.shape)}")
    require(tuple(res.populations.shape) == shape[1:] + (3,),
            f"populations shape {tuple(res.populations.shape)}")
    nan_guard("Bezier iteration: S, J, populations", res.S, res.J,
              res.populations)
    mass = _max_rel(res.populations.sum(-1), eng.nH)
    require(mass < 1e-10, f"populations do not sum to n_H ({mass:.3e})")
    it, j = res.timings[0], timer.totals["J pass"]
    n_chunks = -(-line.n_lambda // cfg.lambda_chunk)
    rate = throughput(p["nz"] * p["nx"] * p["ny"], eng.quad.n_angles,
                      line.n_lambda, 1, j)
    print(f"  Bezier iteration at {p['nz']}x{p['nx']}x{p['ny']}, "
          f"{line.n_lambda} wavelengths, {eng.quad.n_angles} directions "
          f"(cases {cases}), lambda_chunk {cfg.lambda_chunk}, rates in slabs "
          f"of {BEZIER_RATES_PLANES} z-planes, float64: set-up "
          f"{t_setup:.2f} s, run() {wall:.4f} s, the iteration {it:.4f} s, "
          f"J pass {j:.4f} s ({100 * j / it:.1f}%), {rate:.4e} "
          f"grid-points*rays/s", flush=True)
    print(f"  Bezier xy plane steps in the iteration: {n_xy * n_chunks} "
          f"({n_xy} a chunk x {n_chunks} chunks) in {n_segs} segments, "
          f"one {XBS} launch each, no {X1} or K1 launch); launches "
          f"{launches}; criterion {res.convergence}; "
          f"peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated); sum(populations)/n_H - 1 max "
          f"{mass:.3e}", flush=True)
    # the rates in slabs: one R1 launch a slab of z-planes
    n_slabs = -(-p["nz"] // BEZIER_RATES_PLANES)
    _require_path(launches, (XBS, "march_plane", "march_coeffs",
                             "march_chain") + PER_ANGLE_EXT
                  + ("rates_chunk",), "the Bezier iteration")
    require(launches["rates_chunk"] == n_slabs,
            f"rates_chunk: {launches['rates_chunk']} launches, not one a "
            f"slab ({n_slabs})")
    require(launches[XBS] == n_segs,
            f"{XBS}: {launches[XBS]} launches, not one a Bezier xy segment "
            f"({n_segs})")
    d_S, d_P = state_digest(res.S, res.populations)
    print(f"  sha256 of S {d_S}, of the populations {d_P} (equal digests "
          f"from tools/profile_iteration.py --interpolation bezier on "
          f"another checkout: bit-equal)", flush=True)
    del res, eng
    torch.cuda.empty_cache()
    B = cfg.lambda_chunk
    _hold_kept("march_plane", kept, K2_CALL, "the Bezier iteration")
    require(tuple(kept["out"].shape) == (B, p["nx"], p["ny"]),
            f"march_plane plane {tuple(kept['out'].shape)} in the iteration")
    _hold_kept(XBS, kept_xbs, XBS_CALL, "the Bezier iteration")
    require(kept_xbs["shape"] == (B, p["nx"], p["ny"])
            and kept_xbs["planes"] > 0,
            f"{XBS} call {XBS_CALL}: plane {kept_xbs['shape']}")
    print(f"  {XBS} call {XBS_CALL}: {kept_xbs['planes']} planes bit-equal "
          f"to its plain version", flush=True)
    del kept, kept_xbs
    seg, k1 = _time_bezier_step(B)
    print(f"  one xy step at (B={B}, {p['nx']}x{p['ny']}, float64): Bezier "
          f"{XBS} {seg['ms']:.5f} ms a step of a segment (CUDA events), "
          f"{X1} {seg['x1_ms']:.5f} ms a plane and K1 (linear, xy_plane) "
          f"{k1:.5f} ms a plane (device times); the plain step "
          f"{seg['plain_ms']:.4f} ms (CUDA events); {XBS} / K1 "
          f"{seg['ms'] / k1:.2f}", flush=True)
    return launches


# phase 8c: a Bezier J pass on a regular grid whose plane does not fit
# the segment kernel's band: 512 x 512 columns at the production grid's
# cell size (twice its width), depth cut to WIDE_GRID[0] planes at its z
# spacing, one lambda chunk of the production's 13 wavelengths, ul7n12,
# float64; which X1 call is held against its plain version (mid-sweep:
# the carried intensity no longer the boundary's)
WIDE_GRID = (48, 512, 512)
WIDE_NLAM = (6, 3)
X1_CALL = 30
WIDE_K2_CALL = 100


def _wide_atmosphere():
    """The synthetic atmosphere of WIDE_GRID: synthetic_atmosphere's
    default z range (-0.1e6 .. 2.0e6 m) and horizontal extent (2.0e6 m)
    at the production grid's spacing, from the bottom up to WIDE_GRID[0]
    planes and out to WIDE_GRID[1:] columns."""
    from voronoirt_tpu_torch import synthetic_atmosphere
    nz, nx, ny = WIDE_GRID
    require(nx == ny, "a square wide grid")
    dz = 2.1e6 / (PROD["nz"] - 1)
    dx = 2.0e6 / (PROD["nx"] - 1)
    return synthetic_atmosphere(nz=nz, nx=nx, ny=ny,
                                z_top=-0.1e6 + (nz - 1) * dz,
                                horiz_extent=(nx - 1) * dx)


def run_bezier_wide(atmos):
    """Phase 8c: one Bezier J pass (compute_J, as RegularEngine.run()
    makes it) on the card on `atmos`, a WIDE_GRID atmosphere, whose
    plane does not fit the segment kernel's band: the sweep steps its
    Bezier xy segments through X1, one launch a step, and none through
    the segment kernel.  The counts are set to 0 just before the pass and
    read just after; the X1_CALL-th X1 call and a march_plane call are
    held against their plain versions on their inputs; J finite,
    positive and of its shape.  Returns the launches."""
    import torch
    from voronoirt_tpu_torch.observability import nan_guard
    nz, nx, ny = WIDE_GRID
    eng = _small_line_engine(atmos, "cuda", nlam=WIDE_NLAM,
                             quadrature=PROD["quadrature"],
                             lambda_chunk=PROD["lambda_chunk"],
                             formal_interpolation="bezier")
    B = eng.cfg.lambda_chunk
    n_segs, n_steps = _bezier_xy(eng)
    require(eng.line.n_lambda == B and n_steps > 0,
            f"{eng.line.n_lambda} wavelengths, {n_steps} Bezier xy steps")
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with _keep_call(X1, X1_CALL) as kept, \
            _keep_call("march_plane", WIDE_K2_CALL) as kept_k2:
        J = eng.compute_J(eng.B0, eng.lte)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    require(tuple(J.shape) == (B, nz, nx, ny), f"J shape {tuple(J.shape)}")
    nan_guard("the Bezier J pass at 512 x 512: J", J)
    require(bool((J > 0).all()), "the Bezier J pass at 512 x 512: J <= 0")
    print(f"  Bezier J pass at {nz}x{nx}x{ny} (a plane that does not fit "
          f"{XBS}'s band), {B} wavelengths, {eng.quad.n_angles} directions, "
          f"float64: {wall:.4f} s with the holds; {n_steps} Bezier xy steps "
          f"in {n_segs} segments, one {X1} launch a step; launches "
          f"{launches}", flush=True)
    _require_path(launches, (X1, "march_plane", "march_coeffs",
                             "march_chain") + PER_ANGLE_EXT,
                  "the Bezier J pass at 512 x 512")
    require(launches[X1] == n_steps,
            f"{X1}: {launches[X1]} launches, not one a Bezier xy step "
            f"({n_steps})")
    _hold_kept(X1, kept, X1_CALL, "the Bezier J pass at 512 x 512")
    _hold_kept("march_plane", kept_k2, WIDE_K2_CALL,
               "the Bezier J pass at 512 x 512")
    require(kept["shape"] == (B, nx, ny),
            f"{X1} call {X1_CALL}: plane {kept['shape']}")
    del J, eng, kept, kept_k2
    torch.cuda.empty_cache()
    return launches


def check_angle_distribution():
    """Phase 9: compute_J serial against the same engine with its angles
    dealt over two slots of the card, [cuda:0, cuda:0].  Bezier and
    Voronoi sweep angle by angle on both sides: 1e-12.  The serial
    linear J is the grouped one, which z-flips the down sweeps onto an
    axis whose steps round differently (ROADMAP C3): 1e-11.  Returns the
    segment kernel's launches in the distributed Bezier J pass."""
    import torch
    from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
    from voronoirt_tpu_torch.engine import VoronoiEngine
    from voronoirt_tpu_torch.parallel import distribute_angles
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    two = [torch.device("cuda", 0)] * 2
    atmos = synthetic_atmosphere(nz=24, nx=32, ny=32)
    xbs, x1, want = {}, {}, {}
    for interp, bar in (("linear", 1e-11), ("bezier", 1e-12)):
        kw = dict(quadrature="ul7n12", lambda_chunk=4,
                  formal_interpolation=interp)
        serial = _small_line_engine(atmos, "cuda", **kw)
        want[interp] = _bezier_xy(serial)[0] if interp == "bezier" else 0
        _launch_counts(reset=True)
        J0 = serial.compute_J(serial.B0, serial.lte)
        n_serial = _launch_counts()
        eng = distribute_angles(_small_line_engine(atmos, "cuda", **kw), two)
        _launch_counts(reset=True)
        J1 = eng.compute_J(eng.B0, eng.lte)
        n_dist = _launch_counts()
        xbs[interp] = (n_serial[XBS], n_dist[XBS])
        x1[interp] = (n_serial[X1], n_dist[X1])
        err = _rel_err(J1, J0)
        print(f"  regular {interp}: distributed vs serial J max rel diff "
              f"{err:.3e} (<= {bar:g}); {XBS} launches serial, distributed "
              f"{xbs[interp]}, {X1} {x1[interp]}", flush=True)
        require(J1.is_cuda and err <= bar,
                f"regular {interp} distributed J: {err:.3e}")
    # every Bezier J pass runs its xy segments through the segment
    # kernel, one launch a segment whichever slot sweeps an angle, and no
    # X1 (an unsplit grid); no linear one launches either
    require(all(xbs[i] == (want[i], want[i]) for i in xbs)
            and want["bezier"] > 0 and x1 == {i: (0, 0) for i in x1},
            f"{XBS} launches (serial, distributed) {xbs}, not {want}; "
            f"{X1} {x1}")

    pos, bounds = _sample(atmos, 5000)
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul7n12", lambda_chunk=4)
    T = torch.as_tensor(sites.temperature, dtype=torch.float64,
                        device="cuda")
    line = lyman_alpha_line(5, 3, T)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        serial = VoronoiEngine(sites, line, cfg, device="cuda")
    J0 = serial.compute_J(serial.B0, serial.lte)
    eng = distribute_angles(
        VoronoiEngine(sites, line, cfg, plans=serial.plans, device="cuda"),
        two)
    _launch_counts(reset=True)
    J1 = eng.compute_J(eng.B0, eng.lte)
    launches = _launch_counts()
    err = _rel_err(J1, J0)
    print(f"  Voronoi ({sites.n} sites): distributed vs serial J max rel "
          f"diff {err:.3e} (<= 1e-12); the distributed J pass's launches "
          f"{launches}", flush=True)
    _require_path(launches, ("alpha_tot", V1), "the distributed J pass")
    require(J1.is_cuda and err <= 1e-12, f"Voronoi distributed J: {err:.3e}")
    return xbs["bezier"][1]


def run_continuum(atmos, sites):
    """Phase 10: the 500 nm scattering iteration, a batch of ONE
    wavelength through K1 and K2: card against CPU at a small size, then
    3 iterations at the production grid, then 2 on phase 7's sites (its
    12 plans and slot plans are built inside, most of its time)."""
    import torch
    from voronoirt_tpu_torch import Config, synthetic_atmosphere
    from voronoirt_tpu_torch.engine.continuum import (
        lambda_continuum_regular, lambda_continuum_voronoi)
    from voronoirt_tpu_torch.observability import nan_guard
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv

    def line_for(temperature, device):
        return lyman_alpha_line(1, 1, torch.as_tensor(
            temperature, dtype=torch.float64, device=device))

    small = synthetic_atmosphere(nz=24, nx=32, ny=32)
    cfg_s = Config(quadrature="ul7n12", maxiter=4, eps=0.0)
    out = {dev: lambda_continuum_regular(small, line_for(small.temperature,
                                                         dev), cfg_s,
                                         device=dev)
           for dev in ("cuda", "cpu")}
    eS = _rel_err(out["cuda"][0].cpu(), out["cpu"][0])
    eJ = _rel_err(out["cuda"][1].cpu(), out["cpu"][1])
    # 5e-10: the physical extinction puts some dtau just above the
    # linear weights' 5e-4 guard, where one-ulp exp differences between
    # the devices' libraries grow (ROADMAP C3)
    print(f"  continuum, {small.shape}, 4 iterations, card vs CPU: S max rel "
          f"diff {eS:.3e}, J {eJ:.3e} (<= 5e-10); history "
          f"{out['cuda'][2]}", flush=True)
    require(eS <= 5e-10 and eJ <= 5e-10, "continuum: card disagrees with CPU")

    p = PROD
    cfg = Config(quadrature=p["quadrature"], maxiter=3, eps=0.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line = line_for(atmos.temperature, "cuda")
    timer = _card_timer()
    _launch_counts(reset=True)
    with timer.phase("regular"):
        S, J, hist = lambda_continuum_regular(atmos, line, cfg)
    launches = _launch_counts()
    wall = timer.totals["regular"]
    require(S.is_cuda and tuple(S.shape) == atmos.shape == tuple(J.shape),
            f"continuum S {tuple(S.shape)} on {S.device}")
    nan_guard("continuum S, J", S, J)
    require(bool((S > 0).all()), "continuum S not positive")
    require(len(hist) == 3, f"continuum ran {len(hist)} iterations")
    print(f"  lambda_continuum_regular at {p['nz']}x{p['nx']}x{p['ny']}, "
          f"500 nm, {p['quadrature']}, B=1, float64: {wall:.4f} s for 3 "
          f"iterations and the set-up, {wall / 3:.4f} s an iteration; "
          f"history {hist}; launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    _require_path(launches, UNSPLIT, "the continuum iteration")
    del S, J

    line_v = line_for(sites.temperature, "cuda")
    cfg_v = Config(quadrature=p["quadrature"], maxiter=2, eps=0.0)
    sv.LEVEL_STEPS = 0
    _launch_counts(reset=True)
    with warnings.catch_warnings(), timer.phase("voronoi"):
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        S, J, hist = lambda_continuum_voronoi(sites, line_v, cfg_v)
    wall = timer.totals["voronoi"]
    launches_v = _launch_counts()
    _require_path(launches_v, (V1,), "the Voronoi continuum iteration")
    require(S.is_cuda and tuple(S.shape) == (sites.n,),
            f"continuum Voronoi S {tuple(S.shape)} on {S.device}")
    nan_guard("continuum Voronoi S, J", S, J)
    require(bool((S > 0).all()) and len(hist) == 2,
            f"continuum Voronoi S not positive, or {len(hist)} iterations")
    print(f"  lambda_continuum_voronoi at {sites.n} sites, 'layer' plans "
          f"built inside, B=1: {wall:.4f} s for the 12 plans, their slot "
          f"plans and 2 iterations; {sv.LEVEL_STEPS} level steps, "
          f"{launches_v[V1]} {V1} launches in {launches_v[V1_CALLS]} "
          f"stage calls; history {hist}",
          flush=True)
    return dict(launches, **{V1: launches_v[V1]})


def _memory_store():
    """A checkpoint store that keeps the arrays in memory behind
    CheckpointFile's four write/read methods."""
    import numpy as np
    from voronoirt_tpu_torch.engine.checkpoint import CheckpointFile

    class MemoryStore(CheckpointFile):
        def __init__(self, maxiter):
            super().__init__(path=None)
            self.conv = np.zeros(maxiter + 1)
            self.pops = self.S = None
            self.seconds = 0.0

        def write_state(self, populations, S):
            self.pops = populations.detach().cpu().numpy().copy()
            self.S = S.detach().cpu().numpy().copy()

        def write_convergence(self, iteration, diff):
            if iteration < len(self.conv):
                self.conv[iteration] = diff

        def write_time(self, seconds):
            self.seconds = seconds

        def read_state(self):
            return self.pops, self.S, self.conv

    return MemoryStore


class _StopAfter:
    """Passes writes on to a store and raises after the n-th
    write_state: a killed run."""

    def __init__(self, inner, n):
        self.inner, self.n, self.count = inner, n, 0

    def write_convergence(self, i, d):
        self.inner.write_convergence(i, d)

    def write_state(self, p, s):
        self.inner.write_state(p, s)
        self.count += 1
        if self.count >= self.n:
            raise KeyboardInterrupt


def check_checkpoint_resume():
    """Phase 11a: on the card, a small run killed after its second
    write_state and resumed equals the uninterrupted run (rtol 1e-8, the
    bar of tests/test_checkpoint.py)."""
    import importlib.util
    import tempfile
    import torch
    from voronoirt_tpu_torch import synthetic_atmosphere
    from voronoirt_tpu_torch.engine.checkpoint import CheckpointFile, recover
    from voronoirt_tpu_torch.engine.lambda_iter import _run_iteration

    atmos = synthetic_atmosphere(nz=16, nx=12, ny=12, seed=2)
    kw = dict(quadrature="n2", maxiter=4, eps=1e-3)
    make = lambda: _small_line_engine(atmos, "cuda", **kw)
    full = make().run()
    have_h5py = importlib.util.find_spec("h5py") is not None
    print(f"  import h5py works here: {have_h5py}", flush=True)

    def crash_and_resume(store, what):
        try:
            _run_iteration(make(), checkpoint=_StopAfter(store, 2))
            require(False, "the killed run ran to its end")
        except KeyboardInterrupt:
            pass
        it = store.resume_iteration()
        res = recover(make(), store)
        eS, eP = _max_rel(res.S, full.S), _max_rel(res.populations,
                                                   full.populations)
        print(f"  {what}: killed after 2 write_state, resumed at iteration "
              f"{it}, ran to {res.iterations} (uninterrupted "
              f"{full.iterations}); S max rel diff {eS:.3e}, populations "
              f"{eP:.3e} (< 1e-8)", flush=True)
        require(it >= 1 and res.S.is_cuda, f"{what}: resume at {it}")
        require(eS < 1e-8 and eP < 1e-8,
                f"{what}: the resumed run differs from the uninterrupted")

    crash_and_resume(_memory_store()(kw["maxiter"]), "memory store")
    if have_h5py:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = CheckpointFile(os.path.join(tmp, "crash.h5"))
            ckpt.create_regular(make().line, atmos, kw["maxiter"])
            crash_and_resume(ckpt, "HDF5 file")


def check_device_trace():
    """Phase 11b: observability.device_trace around one small J pass on
    the card writes a Chrome trace; the hand-written kernels it names
    are printed (none, where the profiler cannot trace the card)."""
    import tempfile
    from voronoirt_tpu_torch import synthetic_atmosphere
    from voronoirt_tpu_torch.observability import device_trace, nan_guard

    eng = _small_line_engine(synthetic_atmosphere(nz=16, nx=12, ny=12, seed=2),
                             "cuda", quadrature="n2")
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as prof:
            J = eng.compute_J(eng.B0, eng.lte)
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    nan_guard("traced J", J)
    events = prof.key_averages()
    ours = sorted(e.key for e in events
                  if "xy_" in e.key or "march_" in e.key)
    print(f"  device_trace over one J pass at {tuple(J.shape)}: trace.json "
          f"{trace_bytes} bytes, {len(events)} kinds of event; hand-written "
          f"kernels among them: {ours}", flush=True)
    require(trace_bytes > 0 and len(events) > 0,
            "device_trace recorded nothing")


def run_drivers():
    """Phase 11c: the drivers as a user calls them, on the card.  Returns
    the segment kernel's launches in the Bezier line_nlte run (one a
    segment the sweep asks for, none through X1)."""
    import math
    from voronoirt_tpu_torch.drivers import line_nlte, searchlight
    from voronoirt_tpu_torch.solvers import sweep_regular as sr

    res = searchlight.main(["--n", "51"])
    worst = max(abs(r["flux_out"] / r["flux_in"] - 1.0) for r in res)
    print(f"  searchlight --n 51: {len(res)} directions, flux out / flux in "
          f"- 1 max {worst:.3e} (<= 1e-4)", flush=True)
    require(len(res) == 12 and worst <= 1e-4, "searchlight: flux not kept")
    _launch_counts(reset=True)
    res = searchlight.main(["--irregular", "--n", "21"])
    launches = _launch_counts()
    print(f"  searchlight --irregular --n 21: {len(res)} directions, mean I "
          f"out {[round(r['mean_out'], 4) for r in res]}; launches "
          f"{launches}", flush=True)
    require(len(res) == 12 and all(math.isfinite(r["mean_out"])
                                   for r in res),
            "searchlight --irregular: not 12 finite directions")
    _require_path(launches, (V1,), "searchlight --irregular")
    _launch_counts(reset=True)
    # the segments the sweeps ask for: the wrapper's calls
    fn, segments = sr.xy_bezier_segment, [0]

    def counting(*args, **kwargs):
        segments[0] += 1
        return fn(*args, **kwargs)

    sr.xy_bezier_segment = counting
    try:
        summary = line_nlte.main(["--interpolation", "bezier", "--maxiter",
                                  "3"])
    finally:
        sr.xy_bezier_segment = fn
    n = _launch_counts()
    print(f"  line_nlte --interpolation bezier --maxiter 3: {summary}; "
          f"{XBS} launches {n[XBS]} for {segments[0]} segments, {X1} "
          f"{n[X1]}",
          flush=True)
    require(summary["grid"] == "regular" and 1 <= summary["iterations"] <= 3
            and math.isfinite(summary["final_diff"]),
            f"line_nlte summary {summary}")
    require(n[XBS] == segments[0] > 0 and n[X1] == 0,
            f"line_nlte --interpolation bezier: {n[XBS]} {XBS} launches for "
            f"{segments[0]} segments, {n[X1]} {X1}")
    return n[XBS]


# ------------------------------------------------------------ phase 12-13

def _regular_store(atmos, ref):
    """Phase 5's run as the datasets of a regular checkpoint that the
    synthesis reads."""
    import numpy as np
    return {"z": atmos.z, "x": atmos.x, "y": atmos.y, **atmos.fields(),
            "populations": ref["populations"],
            "wavelength": np.asarray(ref["lam"]) * 1e9}


def run_synthesis(atmos, ref):
    """Phase 12a: the synthesize driver's synthesize() on phase 5's
    populations at the production grid, read through its _load_regular
    from an in-memory store of the checkpoint's datasets: disk centre
    (theta 180, xy segments: K1) and slanted (theta 135: K2 too).
    Returns {theta: launches} and the disk-centre cube."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.drivers import synthesize as syn

    atmos_s, pops, lam = syn._load_regular(_regular_store(atmos, ref))
    out = {}
    for theta, name, call in ((180.0, "xy_segment", XY_SEG_CALL),
                              (135.0, "march_plane", SYNTH_CALL)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = _card_timer()
        _launch_counts(reset=True)
        with _keep_call(name, call) as kept, timer.phase("synth"):
            I, line = syn.synthesize(atmos_s, pops, lam, theta=theta,
                                     n_bb=PROD["nlam_bb"],
                                     n_bf=PROD["nlam_bf"])
        out[theta] = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(I.shape == (len(lam), PROD["nx"], PROD["ny"]),
                f"synthesis image {I.shape}")
        i_centre = int(np.argmin(np.abs(lam - line.lam0)))
        require(bool(np.isfinite(I).all()) and I.min() >= 0.0,
                f"theta {theta}: intensities not finite and >= 0")
        centre, wing = float(I[i_centre].mean()), float(I[0].mean())
        Tb = float(np.nanmean(syn.brightness_temperature(
            I[i_centre], float(lam[i_centre]))))
        print(f"  synthesize theta={theta:g} at {PROD['nz']}x{PROD['nx']}x"
              f"{PROD['ny']}, {len(lam)} wavelengths in blocks of "
              f"{syn.LAMBDA_BLOCK}, float64: {timer.totals['synth']:.4f} s, "
              f"peak device memory {peak / 2**30:.3f} GiB; launches "
              f"{out[theta]}; I min {I.min():.4e}; mean I centre "
              f"{centre:.6e}, far wing {wing:.6e}; T_b centre mean "
              f"{Tb:.2f} K", flush=True)
        require(centre > wing, f"theta {theta}: line centre not brighter "
                               f"than the far wing")
        if theta == 180.0:
            require(3000.0 < Tb < 50000.0, f"T_b centre {Tb:.1f} K")
        # disk centre looks straight down (xy segments only); slanted,
        # at this grid, marches in yz only
        n_blocks = -(-len(lam) // syn.LAMBDA_BLOCK)
        _require_path(out[theta], ("alpha_tot",) + (
                      ("xy_segment",) if theta == 180.0 else
                      ("march_plane", "march_coeffs", "march_chain")),
                      f"the synthesis at theta {theta:g}")
        require(out[theta]["alpha_tot"] == n_blocks,
                f"alpha_tot: {out[theta]['alpha_tot']} launches in the "
                f"synthesis, not one a block ({n_blocks})")
        _hold_kept(name, kept, call, f"the synthesis at theta {theta:g}")
        if theta == 180.0:
            disk_centre = I
    return out, disk_centre


def run_study():
    """Phase 12b: the continuum_study driver on the production
    atmosphere (phase 5's seed), regular skips 1-4 and STUDY_SITES
    sites, as a user calls it; the bars of
    tests/test_drivers.py::test_continuum_study_harness."""
    import math
    import tempfile
    from voronoirt_tpu_torch.drivers import continuum_study

    with tempfile.TemporaryDirectory() as tmp:
        _launch_counts(reset=True)
        t = time.perf_counter()
        res = continuum_study.main(
            ["--atmos", str(PROD["nz"]), str(PROD["nx"]), str(PROD["ny"]),
             "--skips", "1,2,3,4", "--n-sites", STUDY_SITES, "--no-plots",
             "--out", tmp])
        wall = time.perf_counter() - t
        launches = _launch_counts()
    rows = [(f"regular {k}", r) for k, r in res["regular"].items()] + [
        (f"{k} sites", r) for k, r in res["voronoi"].items()]
    print(f"  continuum_study --atmos {PROD['nz']} {PROD['nx']} {PROD['ny']}"
          f" --skips 1,2,3,4 --n-sites {STUDY_SITES}: {wall:.2f} s; "
          + "; ".join(f"{k}: {r['seconds']:.2f} s, rel_l1 "
                      f"{r['rel_l1_vs_full']:.6e}" for k, r in rows)
          + f"; launches {launches}", flush=True)
    require(all(math.isfinite(r["rel_l1_vs_full"]) for _, r in rows),
            "continuum study: rel_l1 not finite")
    require(res["regular"]["half"]["rel_l1_vs_full"] < 0.5
            and all(r["rel_l1_vs_full"] < 0.5
                    for r in res["voronoi"].values()),
            "continuum study: an image is 50 % off the full regular one")
    # the study's regular images look straight down: xy segments only
    _require_path(launches, ("xy_segment",), "the study")
    return launches


def _phase13_rank(group, call_n):
    """One rank of phase 13: one streamed iteration of phase 5's
    configuration on the rank's lambda block.  Module level: the
    spawned ranks unpickle it by name, and import this file as their
    main module."""
    import torch
    from voronoirt_tpu_torch import Config, synthetic_atmosphere
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.kernels import build
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line, pad_line

    require(build.library_path().exists(),
            "the kernels' library that phase 1 built is not there")
    p = PROD
    atmos = synthetic_atmosphere(nz=p["nz"], nx=p["nx"], ny=p["ny"])
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=1, eps=0.0)
    dev = group.device
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64, device=dev)
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    line = pad_line(line, -(-line.n_lambda // group.size) * group.size)
    eng = RegularEngine(atmos, line, cfg, device=dev, lam_group=group)
    torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t
    b0_rows = eng.B0.shape[0]
    lo, hi = eng.lam_block.start, eng.lam_block.stop
    # the batch of the block's last lambda chunk in a 4-angle group
    B = ((hi - lo) % cfg.lambda_chunk or cfg.lambda_chunk) \
        * cfg.group_max_angles
    _launch_counts(reset=True)
    with _keep_call("xy_segment", XY_SEG_CALL, B) as k1, \
            _keep_call("march_plane", call_n, B) as k2:
        res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_ext = _group_launches(eng)
    emit = _emit_expected(eng, launches)
    # R1 and S1 one each a chunk of the block, R1 once more for the pair
    # across the block's lower edge (not on rank 0)
    n_chunks = -(-(hi - lo) // cfg.lambda_chunk)
    rate_launches = {"rates_chunk": n_chunks + (lo > 0),
                     "s_update": n_chunks}
    held = {name: {"err": _hold_kept(name, kept, n, f"rank "
                                     f"{group.rank}'s iteration at B = {B}"),
                   "shape": kept["shape"], "call": n}
            for name, kept, n in (("xy_segment", k1, XY_SEG_CALL),
                                  ("march_plane", k2, call_n))}
    return {"rank": group.rank, "device": str(dev),
            "name": torch.cuda.get_device_name(dev), "block": (lo, hi),
            "n_lambda": line.n_lambda, "b0_rows": b0_rows, "setup_s": setup,
            "iteration_s": res.timings[0], "collective_s": group.seconds,
            "collectives": group.calls, "peak_gib": peak / 2**30,
            "launches": launches, "held": held, "group_launches": n_ext,
            "emit": emit, "rate_launches": rate_launches,
            "convergence": res.convergence,
            "S_edges": {lo: res.S[0].cpu().numpy(),
                        hi - 1: res.S[-1].cpu().numpy()},
            "populations": res.populations.cpu().numpy()}


def _rel_np(got, want):
    import numpy as np
    return float(np.max(np.abs(got / want - 1.0)))


def _dryrun_v1(lines):
    """The V1 launches that a dry run's Voronoi line reports for rank 0's
    share of the split iteration; requires some, one a stage call."""
    (line,) = [x for x in lines
               if x.startswith("dryrun_multichip voronoi OK")]

    def count(what):
        return int(line.split(f" {what}")[0].rsplit(" ", 1)[1])

    n = count("level-kernel launches")
    require(n > 0, f"no {V1} launch in the dry run's split Voronoi "
                   f"iteration: {line}")
    require(n == count("stage calls"),
            f"{V1}: not one launch a stage call in the dry run: {line}")
    return n


def run_lam_production(ref, n_ranks=LAM_RANKS):
    """Phase 13: the lambda-split streamed iteration at the production
    width on n_ranks spawned ranks, held against phase 5's (whose S
    rows `ref` holds for n_ranks' block edges); then dryrun_multichip
    on the card.  Returns each rank's record, without its arrays."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.entry import dryrun_multichip
    from voronoirt_tpu_torch.parallel import spawn

    backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    # the parent's cached blocks would compete with the ranks
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {n_ranks} ranks over {backend} "
          f"({'one card a rank' if backend == 'nccl' else 'all on cuda:0'});"
          f" the parent holds {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
          f"reserved", flush=True)
    t = time.perf_counter()
    outs = spawn(_phase13_rank, n_ranks, args=(LAM_CALL,), device="cuda",
                 backend=backend, timeout=900.0)
    wall = time.perf_counter() - t
    rows = _edge_rows(PROD["nlam_bb"] + 2 * PROD["nlam_bf"], n_ranks)
    P_ref, temperature = ref["populations"], ref["temperature"]
    n_H = P_ref.sum(-1, keepdims=True)
    for o in outs:
        errS = max(_rel_np(o["S_edges"][r], ref["S_rows"][rows[r]])
                   for r in o["S_edges"])
        # the split sums the rate integrals' pairs in another order, a
        # last-digit change of each rate: populations are held per n_H
        # (1e-10), and per entry to the packages' bar (1e-8)
        errP = float(np.max(np.abs(o["populations"] - P_ref) / n_H))
        rel = np.abs(o["populations"] / P_ref - 1.0)
        relP = float(rel.max())
        # where the per-entry maximum lies: its cell (z, x, y), level,
        # and that level's share of n_H there
        at = tuple(int(i) for i in np.unravel_index(np.argmax(rel),
                                                     rel.shape))
        share = float(P_ref[at] / n_H[at[:-1]][0])
        print(f"  rank {o['rank']} on {o['device']} ({o['name']}), rows "
              f"{o['block'][0]}-{o['block'][1] - 1} of {o['n_lambda']} (B0 "
              f"{o['b0_rows']} rows): set-up {o['setup_s']:.2f} s, the "
              f"iteration {o['iteration_s']:.4f} s, {o['collectives']} "
              f"collectives {o['collective_s']:.4f} s, peak "
              f"{o['peak_gib']:.3f} GiB; launches {o['launches']}; S at the "
              f"block edges vs phase 5 max rel diff {errS:.3e} (<= 1e-12), "
              f"populations max |diff| / n_H {errP:.3e} (<= 1e-10), max rel "
              f"diff {relP:.3e} (<= 1e-8) at cell {at[:-1]}, level n"
              f"{at[-1] + 1} ({share:.3e} of n_H there, T "
              f"{float(temperature[at[:-1]]):.1f} K); "
              + "; ".join(f"{k} call {h['call']} at {h['shape']}: max abs "
                          f"err {h['err']:.3e}" for k, h in o["held"].items()),
              flush=True)
        require(errS <= 1e-12 and errP <= 1e-10 and relP <= 1e-8,
                f"rank {o['rank']} differs from the unsplit iteration")
        require(np.array_equal(o["populations"], outs[0]["populations"])
                and o["convergence"] == outs[0]["convergence"],
                "the ranks' populations or criteria differ")
        # the grid is whole: the grouped path, a group's stack a launch
        _require_path(o["launches"], UNSPLIT + GROUPED_EXT + GROUP_KERNELS
                      + RATE_KERNELS, f"rank {o['rank']}")
        _require_emit(o["launches"], o["emit"], f"rank {o['rank']}")
        _require_emit(o["launches"], o["rate_launches"], f"rank {o['rank']}")
        require(o["launches"]["alpha_tot_group"] == o["group_launches"],
                f"rank {o['rank']}: alpha_tot_group "
                f"{o['launches']['alpha_tot_group']} launches, not "
                f"{o['group_launches']}")
    print(f"  the spawn, start to the last result: {wall:.2f} s; criterion "
          f"{outs[0]['convergence']}", flush=True)
    t = time.perf_counter()
    v1 = _dryrun_v1(dryrun_multichip(n_ranks, backend=backend))
    print(f"  dryrun_multichip({n_ranks}, backend={backend!r}) on the "
          f"card: {time.perf_counter() - t:.2f} s; {V1} launches on rank 0 "
          f"{v1}", flush=True)
    if backend == "gloo":
        # one card: NCCL, the default on cards, still joins and runs its
        # collectives with a single rank
        t = time.perf_counter()
        v1 = _dryrun_v1(dryrun_multichip(1, backend="nccl"))
        print(f"  dryrun_multichip(1, backend='nccl') on the card: "
              f"{time.perf_counter() - t:.2f} s; {V1} launches {v1}",
              flush=True)
    return [{k: v for k, v in o.items()
             if k not in ("S_edges", "populations")} for o in outs]


# ------------------------------------------------------------ phase 14

def _phase14_rank(group, call_n):
    """One rank of phase 14: one streamed iteration of phase 5's
    configuration on the rank's half of the grid in y, on a ("y",) mesh
    of the spawn's ranks.  Module level: the spawned ranks unpickle it
    by name."""
    import torch
    from voronoirt_tpu_torch import Config, synthetic_atmosphere
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.kernels import build
    from voronoirt_tpu_torch.parallel.mesh import make_mesh
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    require(build.library_path().exists(),
            "the kernels' library that phase 1 built is not there")
    p = PROD
    atmos = synthetic_atmosphere(nz=p["nz"], nx=p["nx"], ny=p["ny"])
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=1, eps=0.0)
    dev = group.device
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    mesh = make_mesh((group.size,), ("y",), world=group)
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64, device=dev)
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = RegularEngine(atmos, line, cfg, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t
    ys = eng.tile[1]
    B = cfg.lambda_chunk * cfg.group_max_angles
    k1_shape = (B, p["nx"], ys.stop - ys.start + 2 * eng.halo.hy)
    k2_shape = (B, p["nx"], p["ny"])
    _launch_counts(reset=True)
    with _keep_call("xy_plane", call_n, shape=k1_shape) as k1, \
            _keep_call("march_plane", call_n, shape=k2_shape) as k2:
        res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    emit = _emit_expected(eng, launches)
    held = {name: {"err": _hold_kept(name, kept, call_n, f"rank "
                                     f"{group.rank}'s y-split iteration"),
                   "shape": kept["shape"], "call": call_n}
            for name, kept in (("xy_plane", k1), ("march_plane", k2))}
    rows = sorted(set(_edge_rows(line.n_lambda, LAM_RANKS).values()))
    return {"rank": group.rank, "device": str(dev),
            "name": torch.cuda.get_device_name(dev), "y": (ys.start, ys.stop),
            "setup_s": setup, "iteration_s": res.timings[0],
            "tally": mesh.tally, "world_calls": group.calls,
            "world_s": group.seconds, "peak_gib": peak / 2**30,
            "launches": launches, "held": held, "emit": emit,
            "convergence": res.convergence,
            "S_rows": {r: res.S[r].cpu().numpy() for r in rows},
            "populations": res.populations.cpu().numpy()}


def run_mesh_production(ref, n_ranks=MESH_RANKS):
    """Phase 14: the streamed iteration at the production width split
    over the y axis of n_ranks spawned ranks, held against phase 5's (S
    at phase 13's rows, the populations) at phase 13's bars; then
    dryrun_multichip(4) over gloo on the card.  Returns each rank's
    record, without its arrays."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.entry import dryrun_multichip
    from voronoirt_tpu_torch.parallel import spawn

    backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {n_ranks} ranks on a ('y',) mesh over {backend} "
          f"({'one card a rank' if backend == 'nccl' else 'all on cuda:0'})",
          flush=True)
    t = time.perf_counter()
    outs = spawn(_phase14_rank, n_ranks, args=(MESH_CALL,), device="cuda",
                 backend=backend, timeout=1200.0)
    wall = time.perf_counter() - t
    P_ref = ref["populations"]
    for o in outs:
        ys = slice(*o["y"])
        errS = max(_rel_np(o["S_rows"][r], ref["S_rows"][r][:, :, ys])
                   for r in o["S_rows"])
        want = P_ref[:, :, ys]
        n_H = want.sum(-1, keepdims=True)
        errP = float(np.max(np.abs(o["populations"] - want) / n_H))
        relP = _rel_np(o["populations"], want)
        tally = o["tally"]
        print(f"  rank {o['rank']} on {o['device']} ({o['name']}), y "
              f"{o['y'][0]}-{o['y'][1] - 1}: set-up {o['setup_s']:.2f} s, "
              f"the iteration {o['iteration_s']:.4f} s; halo exchange "
              f"{tally['halo']['calls']} all_reduce, "
              f"{tally['halo']['bytes'] / 1e9:.4f} GB, "
              f"{tally['halo']['seconds']:.4f} s; plane gather "
              f"{tally['gather']['calls']} broadcast, "
              f"{tally['gather']['bytes'] / 1e9:.4f} GB, "
              f"{tally['gather']['seconds']:.4f} s; criterion "
              f"{o['world_calls']} call(s) {o['world_s']:.4f} s; peak "
              f"{o['peak_gib']:.3f} GiB; launches {o['launches']}; S at "
              f"rows {sorted(o['S_rows'])} vs phase 5 max rel diff "
              f"{errS:.3e} (<= 1e-12), populations max |diff| / n_H "
              f"{errP:.3e} (<= 1e-10), max rel diff {relP:.3e} (<= 1e-8); "
              + "; ".join(f"{k} call {MESH_CALL} at {h['shape']}: max abs "
                          f"err {h['err']:.3e}" for k, h in o["held"].items()),
              flush=True)
        require(errS <= 1e-12 and errP <= 1e-10 and relP <= 1e-8,
                f"rank {o['rank']} differs from the unsplit iteration")
        require(o["convergence"] == outs[0]["convergence"],
                "the ranks' criteria differ")
        # the split sweep: K1 one plane a launch on padded tiles, the
        # extinction per angle on padded tiles, the J emit on the padded
        # planes and the fold of the tiles' interiors
        _require_path(o["launches"], PLANE_KERNELS + PER_ANGLE_EXT
                      + GROUP_KERNELS + RATE_KERNELS, f"rank {o['rank']}")
        _require_emit(o["launches"], o["emit"], f"rank {o['rank']}")
        n_chunks = -(-(PROD["nlam_bb"] + 2 * PROD["nlam_bf"])
                     // PROD["lambda_chunk"])
        _require_emit(o["launches"], dict.fromkeys(RATE_KERNELS, n_chunks),
                      f"rank {o['rank']}")
    print(f"  the spawn, start to the last result: {wall:.2f} s; criterion "
          f"{outs[0]['convergence']} (phase 5 and 13 ran the same "
          f"iteration)", flush=True)
    t = time.perf_counter()
    v1 = _dryrun_v1(dryrun_multichip(4, backend="gloo"))
    print(f"  dryrun_multichip(4, backend='gloo') on the card: "
          f"{time.perf_counter() - t:.2f} s; {V1} launches on rank 0 of the "
          f"site split {v1}", flush=True)
    return [{k: v for k, v in o.items()
             if k not in ("S_rows", "populations")} for o in outs]


# ------------------------------------------------------------ phase 15

# tests/test_f32_physics.py::test_nlte_iteration_f32_vs_f64's bar: a
# float32 value within GATE of the float64 one plus GATE of the float64
# array's largest magnitude
GATE = 5e-3
# which K2 call of the float32 iteration, on a batch of 52 planes (4
# angles x lambda_chunk), is held against the plain version (and
# XY_SEG_CALL's xy_segment call)
F32_CALL = 100


def _against_gate(what, got, want, scale, names):
    """got (float32, on the card) against want (float64 numpy, the same
    shape) at the gate's bar, in blocks of the first axis of about 2^24
    entries.  Prints the largest |got - want| as a share of scale, the
    largest relative difference among the entries above 1e-6 of scale,
    and the worst entry's index (named by `names`) and its share of the
    bar; raises if an entry is not finite or misses the bar."""
    import numpy as np
    import torch
    worst, share, rel, at = -1.0, 0.0, 0.0, None
    rows = max(1, (1 << 24) // max(1, int(np.prod(got.shape[1:]))))
    for i in range(0, got.shape[0], rows):
        g = got[i:i + rows].to(torch.float64)
        require(bool(torch.isfinite(g).all()), f"{what}: not finite")
        w = torch.as_tensor(want[i:i + rows], device=g.device)
        d = (g - w).abs()
        share = max(share, float(d.max()) / scale)
        big = w.abs() > 1e-6 * scale
        if bool(big.any()):
            rel = max(rel, float((d[big] / w[big].abs()).max()))
        ratio = d / (GATE * w.abs() + GATE * scale)
        k = int(ratio.argmax())
        if float(ratio.reshape(-1)[k]) > worst:
            worst = float(ratio.reshape(-1)[k])
            at = np.unravel_index(k, g.shape)
            at = (i + int(at[0]),) + tuple(int(j) for j in at[1:])
    label = ", ".join(f"{n} {j}" for n, j in zip(names, at))
    print(f"  {what} float32 vs float64: max |diff| {share:.3e} of scale "
          f"({scale:.4e}), max rel diff {rel:.3e} above 1e-6 of scale; "
          f"worst entry ({label}) at {worst:.3e} of the gate's bar (rtol "
          f"{GATE:g} + {GATE:g} x scale)", flush=True)
    require(worst <= 1.0, f"{what}: float32 misses the gate at ({label})")


def run_f32_production(atmos, ref, launches64):
    """Phase 15a: one streamed iteration of phase 5's configuration in
    float32, held against phase 5's float64 result; the XY_SEG_CALL-th
    xy_segment call and the F32_CALL-th K2 call on the production batch
    against the plain versions.
    Returns the launch counts and the kept calls' max abs errors."""
    import torch

    B = 4 * PROD["lambda_chunk"]
    with _keep_call("xy_segment", XY_SEG_CALL, batch=B) as kept_xy, \
            _keep_call("march_plane", F32_CALL, batch=B) as kept_m:
        res, _, launches, mass = _production_iteration(atmos, "float32")
    # float32 rounding of the three ratios (physics/stateq.py)
    require(mass < 1e-6, f"populations do not sum to n_H ({mass:.3e})")
    # K2 one launch a plane as in float64; K1's pieces hold twice the
    # float32 planes, so half the launches
    require(all(launches[k] == launches64[k]
                for k in PLANE_KERNELS + EXT_KERNELS + RATE_KERNELS),
            f"float32 launches {launches}, float64 (phase 5) {launches64}")
    errs = {}
    for name, kept, n in (("xy_segment", kept_xy, XY_SEG_CALL),
                          ("march_plane", kept_m, F32_CALL)):
        require(kept.get("dtype") == torch.float32,
                f"{name}: no float32 call {n} kept")
        errs[name] = _hold_kept(name, kept, n, "the float32 iteration")
    P64 = ref["populations"]
    _against_gate("S", res.S, ref["S"], ref["S_scale"],
                  ("lambda", "z", "x", "y"))
    _against_gate("populations", res.populations, P64,
                  float(abs(P64).max()), ("z", "x", "y", "level"))
    return launches, errs


def run_f32_voronoi(sites, vor_ref):
    """Phase 15b: two 'layer' iterations at phase 7's sites and with its
    plans in float32, held against phase 7's float64 result."""
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import VoronoiEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    p = PROD
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], voronoi_order="layer",
                 maxiter=2, eps=0.0, dtype="float32")
    t = time.perf_counter()
    T = torch.as_tensor(sites.temperature, dtype=torch.float32,
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = VoronoiEngine(sites, line, cfg, plans=vor_ref["plans"],
                        device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t
    _launch_counts(reset=True)
    res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _require_path(launches, VORONOI, "the float32 Voronoi iterations")
    require(launches[V1] == vor_ref["launches"][V1],
            f"{V1}: {launches[V1]} launches in float32, "
            f"{vor_ref['launches'][V1]} in float64 (phase 7)")
    require(res.iterations == 2, f"ran {res.iterations} iterations")
    require(res.S.dtype == res.populations.dtype == torch.float32,
            f"S {res.S.dtype}, populations {res.populations.dtype}")
    print(f"  float32, {sites.n} sites: engine set-up {setup:.2f} s "
          f"(phase 7's plans), iteration seconds "
          f"{[round(x, 4) for x in res.timings]}, peak device memory "
          f"{peak / 2**30:.3f} GiB; criterion {res.convergence}; launches "
          f"{launches}", flush=True)
    P64 = vor_ref["populations"]
    _against_gate("Voronoi S", res.S, vor_ref["S"],
                  float(abs(vor_ref["S"]).max()), ("lambda", "site"))
    _against_gate("Voronoi populations", res.populations, P64,
                  float(abs(P64).max()), ("site", "level"))
    return launches


# ------------------------------------------------------------ phase 16

# the mus of the paper's figures: disk centre (theta 180, xy segments:
# K1) and two slanted ones (theta 126.87 and 101.54, yz segments at this
# grid: K2)
FIGURE_MUS = (1.0, 0.6, 0.2)
# the Voronoi run's raster: phase 5's grid, so that the line-centre
# images of the two runs share a shape and the relative difference exists
FIGURE_RASTER = (PROD["nz"], PROD["nx"], PROD["ny"])


def run_line_figures(atmos, ref, sites, vor_ref, disk_centre=None):
    """Phase 16: the paper's regular-vs-Voronoi line figures
    (analysis/line_figures.py's figures(), no drawing) on the card from
    in-memory mappings in the checkpoint schema: phase 5's regular run
    and phase 7's Voronoi run rasterised onto phase 5's grid, each
    synthesised at FIGURE_MUS.  Each synthesis timed with its launches;
    the XY_SEG_CALL-th xy_segment and SYNTH_CALL-th march_plane call held
    against the plain versions; disk_centre, phase 12's theta 180 cube
    when phase 12 ran, against the regular mu = 1 cube bit for bit.
    Returns {mu: launches summed over the two runs}."""
    import math
    import numpy as np
    import torch
    from voronoirt_tpu_torch.analysis import line_figures as lf
    from voronoirt_tpu_torch.analysis.plots import brightness_temperature

    lam_idx = ref["lam_idx"]
    tail = {"wavelength": np.asarray(ref["lam"]) * 1e9,
            "n_bb": np.array([lam_idx[1]]),
            "n_bf": np.array([lam_idx[2] - lam_idx[1]])}

    def history(run):
        return {"convergence": np.array([0.0] + list(run["convergence"])),
                "time": np.array([run["time"]])}

    regular = {**_regular_store(atmos, ref), **tail, **history(ref)}
    voronoi = {"positions": sites.positions.T,
               "boundaries": np.asarray(sites.bounds),
               **{n: getattr(sites, n) for n in atmos.fields()},
               "populations": vor_ref["populations"], **tail,
               **history(vor_ref)}
    runs = [lf.load_run(regular)]
    t = time.perf_counter()
    runs.append(lf.load_run(voronoi, raster=FIGURE_RASTER))
    resample = time.perf_counter() - t
    print(f"  Voronoi run rasterised: {sites.n} sites, "
          f"{len(atmos.fields()) + 3} fields onto "
          f"{math.prod(FIGURE_RASTER)} points {FIGURE_RASTER} by inverse "
          f"distance (host) in {resample:.2f} s", flush=True)

    seconds, launches = {}, {}
    synthesize_mu = lf.synthesize_mu

    def timed(run, mu, **kwargs):
        torch.cuda.synchronize()
        _launch_counts(reset=True)
        t = time.perf_counter()
        out = synthesize_mu(run, mu, **kwargs)
        torch.cuda.synchronize()
        seconds[run["kind"], mu] = time.perf_counter() - t
        launches[run["kind"], mu] = _launch_counts()
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated: part of the peak, not of the
    # figures
    resident = torch.cuda.memory_allocated()
    lf.synthesize_mu = timed
    try:
        with _keep_call("xy_segment", XY_SEG_CALL) as kept_xy, \
                _keep_call("march_plane", SYNTH_CALL) as kept_m:
            summary, cubes = lf.figures(runs, FIGURE_MUS, plots=False)
    finally:
        lf.synthesize_mu = synthesize_mu
    peak = torch.cuda.max_memory_allocated()
    for (kind, mu), sec in seconds.items():
        print(f"  synthesis {kind} mu={mu:g} (theta "
              f"{lf.theta_for_mu(mu):.2f}): {sec:.4f} s; launches "
              f"{launches[kind, mu]}", flush=True)
    print(f"  six syntheses {sum(seconds.values()):.4f} s; peak device "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated, phase 16; "
          f"{resident / 2**30:.3f} GiB of it allocated before the phase)",
          flush=True)
    print(f"  summary: centre_rel_diff_rms "
          f"{summary.get('centre_rel_diff_rms')}; iterations "
          f"{summary['iterations']}; final_diff {summary['final_diff']}",
          flush=True)

    for (kind, mu), n in launches.items():
        _require_path(n, ("alpha_tot",) + (
                      ("xy_segment",) if mu == 1.0 else
                      ("march_plane", "march_coeffs", "march_chain")),
                      f"the {kind} synthesis at mu {mu:g}")
    _hold_kept("xy_segment", kept_xy, XY_SEG_CALL, "the line figures")
    _hold_kept("march_plane", kept_m, SYNTH_CALL, "the line figures")
    for run in runs:
        kind, lam = run["kind"], np.asarray(run["lam"])
        for mu in FIGURE_MUS:
            I, line = cubes[kind, mu]
            require(I.shape == (len(lam), PROD["nx"], PROD["ny"]),
                    f"{kind} mu {mu:g}: cube {I.shape}")
            require(bool(np.isfinite(I).all()) and I.min() >= 0.0,
                    f"{kind} mu {mu:g}: intensities not finite and >= 0")
        I, line = cubes[kind, 1.0]
        i_centre = int(np.argmin(np.abs(lam - line.lam0)))
        centre, wing = float(I[i_centre].mean()), float(I[0].mean())
        Tb = float(np.nanmean(brightness_temperature(
            I[i_centre], float(lam[i_centre]))))
        print(f"  {kind} mu=1: mean I centre {centre:.6e}, far wing "
              f"{wing:.6e}; T_b centre mean {Tb:.2f} K", flush=True)
        require(centre > wing, f"{kind}: line centre not brighter than the "
                               f"far wing")
        require(3000.0 < Tb < 50000.0, f"{kind}: T_b centre {Tb:.1f} K")
    require("centre_rel_diff_rms" in summary
            and math.isfinite(summary["centre_rel_diff_rms"]),
            f"centre_rel_diff_rms {summary.get('centre_rel_diff_rms')}")
    if disk_centre is not None:
        same = np.array_equal(cubes["regular", 1.0][0], disk_centre)
        print(f"  regular mu=1 cube equals phase 12's theta 180 cube bit "
              f"for bit: {same}", flush=True)
        require(same, "the regular mu = 1 cube differs from phase 12's")
    return {mu: {name: sum(launches[kind, mu][name] for kind in
                           ("regular", "voronoi")) for name in KERNELS}
            for mu in FIGURE_MUS}


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="smoke run of the port on "
                                 "one CUDA card")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after phase 1 "
                         "(a check while the code changes: no JSON lines)")
    args = ap.parse_args(argv)
    only = (None if args.phases is None
            else {int(p) for p in args.phases.split(",")})

    def want(n):
        return only is None or n in only

    sys.path.insert(0, HERE)
    from voronoirt_tpu_torch import require_cuda
    from voronoirt_tpu_torch.kernels import build

    require_cuda()
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built/loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    from voronoirt_tpu_torch import synthetic_atmosphere

    def phase(title):
        # the timing hooks tie each engine into a reference cycle: free
        # the last phase's cubes before the next one reads its peak
        gc.collect()
        print(f"{title} (at {time.perf_counter() - t0:.1f} s)", flush=True)

    atmos = synthetic_atmosphere(nz=PROD["nz"], nx=PROD["nx"], ny=PROD["ny"])
    ext_errs = {}

    def held(run, what):
        # run a driven path, then hold each extinction call shape it made
        # against the plain version (after the path: its times and peak
        # memory are its own)
        with _record_ext() as seen:
            out = run()
        _hold_recorded(atmos, seen, what, ext_errs)
        return out

    if want(2):
        phase("phase 2: kernels vs plain versions on the card")
        errs = check_kernels()
        split_errs, split_times = check_march_split()
        for d, e in check_xy_segment(PHASE2_SHAPES).items():
            errs[d]["xy_segment"] = e
        B52, B13 = 4 * PROD["lambda_chunk"], PROD["lambda_chunk"]
        times, bounds = time_kernels(B52)
        times_b1, bounds_b1 = time_kernels(1)
        times32, bounds32 = time_kernels(B52, "float32")
        seg = {(B, d): time_segment(B, d) for d in ("float64", "float32")
               for B in (B52, B13, 1)}
        for t, B, d in ((times, B52, "float64"), (times_b1, 1, "float64"),
                        (times32, B52, "float32")):
            t["xy_segment"] = seg[B, d][:2]
        with _record_ext() as seen:
            ext_errs, ext_times, ext_info = check_extinction(atmos)
        _EXT_HELD.update(seen)
        group_info = check_group_emit(atmos)
        rate_info = check_rates(atmos)
        v1_info = check_voronoi_level(atmos)
        x1_errs = check_xy_bezier()
        # X1 at the plane it steps on an unsplit grid: one that does not
        # fit the segment kernel's band (phase 8c's)
        x1_times = {d: time_xy_bezier(B13, d, WIDE_GRID[1:]) for d in TOL}
        xbs_errs = check_xy_bezier_segment()
        xbs_times = {d: time_xy_bezier_segment(B13, d) for d in TOL}
    if want(3):
        phase("phase 3: regular-sweep goldens on the card")
        check_goldens()
    if want(4):
        phase("phase 4: small entry step, card vs CPU")
        launches_entry = check_entry()
    if want(5):
        phase("phase 5: production iteration")
        launches, ref = held(lambda: run_production(atmos, keep_S=want(15)),
                             "phase 5")
    if want(6):
        phase("phase 6: Voronoi goldens on the card, wavefront sweeps card "
              "vs CPU")
        check_voronoi_goldens()
    if want(7):
        phase(f"phase 7: Voronoi production, {VOR_SITES} sites")
        sites, vor_ref = held(lambda: run_voronoi_production(atmos),
                              "phase 7")
    if want(8):
        phase("phase 8: Bezier sweeps card vs CPU, one Bezier production "
              "iteration")
        check_bezier_sweeps()
        launches_bezier = held(lambda: run_bezier_production(atmos),
                               "phase 8")
        atmos_wide = _wide_atmosphere()
        with _record_ext() as seen:
            launches_wide = run_bezier_wide(atmos_wide)
        _hold_recorded(atmos_wide, seen, "phase 8c", ext_errs)
        del atmos_wide
    if want(9):
        phase("phase 9: angle distribution, serial vs two slots on the card")
        launches_xbs_slots = check_angle_distribution()
    if want(10):
        phase("phase 10: continuum scattering iteration")
        launches_continuum = run_continuum(atmos, sites)
    if want(11):
        phase("phase 11: checkpoint/resume on the card, the drivers")
        check_checkpoint_resume()
        check_device_trace()
        launches_xbs_driver = run_drivers()
    if want(12):
        phase("phase 12: the synthesize and continuum_study drivers at full "
              "width")
        launches_synth, synth_disk_centre = held(
            lambda: run_synthesis(atmos, ref), "phase 12")
        launches_study = run_study()
    if want(13):
        phase(f"phase 13: the lambda-split production iteration, "
              f"{LAM_RANKS} ranks")
        launches_lam = [o["launches"] for o in run_lam_production(ref)]
    if want(14):
        phase(f"phase 14: the production iteration split over y, "
              f"{MESH_RANKS} ranks")
        mesh_ranks = run_mesh_production(ref)
    if want(15):
        phase("phase 15: float32 production, the streamed iteration and "
              f"the Voronoi iterations at {VOR_SITES} sites")
        launches32, errs32 = held(
            lambda: run_f32_production(atmos, ref, launches), "phase 15")
        launches32_vor = held(lambda: run_f32_voronoi(sites, vor_ref),
                              "phase 15 (Voronoi)")
    if want(16):
        phase("phase 16: the paper's line figures at full width, regular "
              f"and {VOR_SITES} Voronoi sites, mu {FIGURE_MUS}")
        launches_figures = held(lambda: run_line_figures(
            atmos, ref, sites, vor_ref,
            synth_disk_centre if want(12) else None), "phase 16")
    phase("done")

    require("jax" not in sys.modules, "jax was imported")
    jax_pkg = sorted(m for m in sys.modules if m == "voronoirt_tpu"
                     or m.startswith("voronoirt_tpu."))
    require(not jax_pkg, f"modules of the JAX package imported: {jax_pkg}")
    if only is not None:
        print(f"phases {sorted(only)} passed (a partial run: no result)",
              flush=True)
        return 0
    # the split path's K1 and K2 calls: shapes and launches a rank
    mesh_shapes = {"xy_plane": mesh_ranks[0]["held"]["xy_plane"]["shape"],
                   "march_plane": mesh_ranks[0]["held"]["march_plane"][
                       "shape"]}
    mesh_shapes["march_coeffs"] = mesh_shapes["march_chain"] = \
        mesh_shapes["march_plane"]
    mesh_errs = {name: max(o["held"][name]["err"] for o in mesh_ranks)
                 for name in ("xy_plane", "march_plane")}
    # each kernel's launches on its path: phase 5's streamed iteration;
    # for xy_plane, which only the split sweep launches, a rank of phase
    # 14's; for the per-direction alpha_tot, which the unsplit grouped
    # path no longer launches, phase 8's Bezier iteration, which calls it
    # at the shape phase 2 times; for voigt_rows, which R1 replaced on
    # every rate path, phase 7's Voronoi iterations, which launch it no
    # more (0: phase 2 holds it)
    path = dict.fromkeys(KERNELS, "phase 5: the streamed iteration")
    path["xy_plane"] = "phase 14: the y-split iteration, rank 0"
    path["alpha_tot"] = "phase 8: the Bezier iteration"
    path["voigt_rows"] = ("phase 7: the two Voronoi iterations (none: no "
                          "iteration path launches E2)")
    path_launches = dict(launches,
                         xy_plane=mesh_ranks[0]["launches"]["xy_plane"],
                         alpha_tot=launches_bezier["alpha_tot"],
                         voigt_rows=vor_ref["launches"]["voigt_rows"])
    k1 = "voronoirt_tpu/solvers/pallas_xy.py:65"
    k2 = ("voronoirt_tpu_torch/csrc/march_plane.cu",
          "voronoirt_tpu/solvers/pallas_march.py:89")
    src = {"xy_segment": ("voronoirt_tpu_torch/csrc/xy_segment.cu", k1),
           "xy_plane": ("voronoirt_tpu_torch/csrc/xy_plane.cu", k1),
           "march_plane": k2, "march_coeffs": k2, "march_chain": k2}
    seg_steps = {f"{d}_B{B}": {"ms": v[0], "plain_ms": v[1],
                               "per_plane_k1_ms": v[2], "bound_ms": v[3],
                               "bound_by": v[4]}
                 for (B, d), v in seg.items()}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": path_launches[name],
                "launches_path": path[name],
                "max_abs_err": errs["float64"][name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "pct_of_bound": 100 * bounds[name][0] / times[name][0],
                "library_ms": None,
                "launches_bezier_iteration": launches_bezier[name],
                "launches_continuum": launches_continuum[name],
                "ms_b1": times_b1[name][0], "plain_ms_b1": times_b1[name][1],
                "bound_ms_b1": bounds_b1[name][0],
                "launches_synthesize": {f"theta_{t:g}": n[name] for t, n in
                                        launches_synth.items()},
                "launches_continuum_study": launches_study[name],
                "launches_line_figures": {f"mu_{mu:g}": n[name] for mu, n in
                                          launches_figures.items()},
                "launches_lam_ranks": [n[name] for n in launches_lam],
                "launches_mesh_y_ranks": [o["launches"][name]
                                          for o in mesh_ranks],
                "shape_mesh_y": mesh_shapes.get(name),
                "max_abs_err_mesh_y": mesh_errs.get(name),
                "max_abs_err_f32": errs["float32"][name],
                "ms_f32": times32[name][0], "plain_ms_f32": times32[name][1],
                "bound_ms_f32": bounds32[name][0],
                "bound_by_f32": bounds32[name][1],
                "pct_of_bound_f32": 100 * bounds32[name][0]
                / times32[name][0],
                "launches_f32_iteration": launches32[name],
                "max_abs_err_f32_iteration": errs32.get(name),
                **({"ms_a_step_214_planes": seg_steps}
                   if name == "xy_segment" else {}),
                **({"split": {"max_abs_err": split_errs, "us_by_B": {
                    str(B): {"W_H": list(t[0]), "us": t[1],
                             "bound_us": t[2]}
                    for B, t in split_times.items()}}}
                   if name == "march_chain" else {})}
               for name in SWEEP_KERNELS]
    # the extinction's kernels: what they replace is the JAX package's
    # jitted XLA program, not a Pallas kernel
    ext_src = {"alpha_tot_group": "voronoirt_tpu/engine/lambda_iter.py:130",
               "alpha_tot": "voronoirt_tpu/engine/lambda_iter.py:130",
               "voigt_rows": "voronoirt_tpu/physics/rates.py:37"}
    for name in EXT_KERNELS:
        (e64, e32), (t64, t32) = ((d["float64"][name], d["float32"][name])
                                  for d in (ext_errs, ext_times))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "voronoirt_tpu_torch/csrc/extinction.cu",
            "replaces": ext_src[name], "replaces_a_tpu_kernel": False,
            "launches": path_launches[name], "launches_path": path[name],
            "launches_streamed_iteration": launches[name],
            "max_abs_err": e64["abs"], "max_rel_err": e64["rel"],
            "bit_equal": e64["equal"], "ms": t64[0], "plain_ms": t64[1],
            "bound_ms": t64[2], "bound_by": t64[3],
            "pct_of_bound": 100 * t64[2] / t64[0], "library_ms": None,
            "launches_voronoi_iterations": vor_ref["launches"][name],
            "launches_f32_voronoi_iterations": launches32_vor[name],
            "launches_entry_step": launches_entry[name],
            "launches_bezier_iteration": launches_bezier[name],
            "launches_continuum": launches_continuum[name],
            "launches_synthesize": {f"theta_{t:g}": n[name] for t, n in
                                    launches_synth.items()},
            "launches_line_figures": {f"mu_{mu:g}": n[name] for mu, n in
                                      launches_figures.items()},
            "launches_lam_ranks": [n[name] for n in launches_lam],
            "launches_mesh_y_ranks": [o["launches"][name]
                                      for o in mesh_ranks],
            "max_abs_err_f32": e32["abs"], "max_rel_err_f32": e32["rel"],
            "bit_equal_f32": e32["equal"], "ms_f32": t32[0],
            "plain_ms_f32": t32[1], "bound_ms_f32": t32[2],
            "bound_by_f32": t32[3], "pct_of_bound_f32": 100 * t32[2] / t32[0],
            "launches_f32_iteration": launches32[name],
            **({"f64": ext_info["float64"], "f32": ext_info["float32"]}
               if name == "alpha_tot_group" else {})})
    # G1-G3: what they replace is the XLA the JAX package fuses into its
    # jitted sweep_group_J, not a Pallas kernel; G1's time is a plane's
    # emit (a K2 plane's or a boundary's: most of its launches), with a
    # production piece's beside it
    group_src = {"group_emit": "voronoirt_tpu/solvers/sweep_regular.py:833",
                 "group_stack": "voronoirt_tpu/solvers/sweep_regular.py:877",
                 "group_fold": "voronoirt_tpu/solvers/sweep_regular.py:887"}
    for name in GROUP_KERNELS:
        t64, t32 = (group_info["times"][d][name]
                    for d in ("float64", "float32"))
        row = {
            "name": name, "route": "cuda",
            "source": "voronoirt_tpu_torch/csrc/group_emit.cu",
            "replaces": group_src[name], "replaces_a_tpu_kernel": False,
            "launches": launches[name],
            "launches_path": "phase 5: the streamed iteration",
            "max_abs_err": 0.0, "bit_equal": True, "ms": t64[0],
            "plain_ms": t64[1], "bound_ms": t64[2], "bound_by": t64[3],
            "pct_of_bound": 100 * t64[2] / t64[0], "library_ms": None,
            "ms_is": f"{t64[4]}: the kernel's device time (torch.profiler)",
            "ms_events": t64[5], "ms_events_f32": t32[5],
            "max_abs_err_f32": 0.0, "ms_f32": t32[0],
            "plain_ms_f32": t32[1], "bound_ms_f32": t32[2],
            "bound_by_f32": t32[3], "pct_of_bound_f32": 100 * t32[2] / t32[0],
            "launches_f32_iteration": launches32[name],
            "launches_lam_ranks": [n[name] for n in launches_lam],
            "launches_mesh_y_ranks": [o["launches"][name]
                                      for o in mesh_ranks]}
        if name == "group_emit":
            p64, p32 = (group_info["times"][d]["group_emit_piece"]
                        for d in ("float64", "float32"))
            row.update({f"{k}_piece{suffix}": v for suffix, p in
                        (("", p64), ("_f32", p32)) for k, v in
                        zip(("ms", "plain_ms", "bound_ms"), p)},
                       piece_planes=group_info["piece"])
        kernels.append(row)
    # R1 and S1: what they replace is the JAX package's two jitted
    # programs a lambda chunk, not a Pallas kernel; their times are a
    # launch's mean over the production iteration's chunks
    rate_src = {"rates_chunk": "voronoirt_tpu/engine/lambda_iter.py:254",
                "s_update": "voronoirt_tpu/engine/lambda_iter.py:236"}
    for name in RATE_KERNELS:
        (e64, e32), (t64, t32) = ((d["float64"][name], d["float32"][name])
                                  for d in (rate_info["errs"],
                                            rate_info["times"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "voronoirt_tpu_torch/csrc/rates.cu",
            "replaces": rate_src[name], "replaces_a_tpu_kernel": False,
            "launches": launches[name],
            "launches_path": "phase 5: the streamed iteration",
            "max_abs_err": e64["abs"], "max_rel_err": e64["rel"],
            "bit_equal": e64["equal"], "ms": t64[0], "plain_ms": t64[1],
            "bound_ms": t64[2], "bound_by": t64[3],
            "pct_of_bound": 100 * t64[2] / t64[0], "library_ms": None,
            "ms_is": "a launch's mean over the production iteration's "
                     "lambda chunks (CUDA events)",
            "ms_iteration": t64[4], "bound_ms_iteration": t64[5],
            "launches_bezier_iteration": launches_bezier[name],
            "launches_lam_ranks": [n[name] for n in launches_lam],
            "launches_mesh_y_ranks": [o["launches"][name]
                                      for o in mesh_ranks],
            "launches_voronoi_iterations": vor_ref["launches"][name],
            "launches_f32_voronoi_iterations": launches32_vor[name],
            "launches_entry_step": launches_entry[name],
            "max_abs_err_f32": e32["abs"], "max_rel_err_f32": e32["rel"],
            "bit_equal_f32": e32["equal"], "ms_f32": t32[0],
            "plain_ms_f32": t32[1], "bound_ms_f32": t32[2],
            "bound_by_f32": t32[3], "pct_of_bound_f32": 100 * t32[2] / t32[0],
            "ms_iteration_f32": t32[4], "bound_ms_iteration_f32": t32[5],
            "launches_f32_iteration": launches32[name],
            **({"by_kind": rate_info["r1"]} if name == "rates_chunk"
               else {})})
    # V1: what it replaces is the JAX package's compiled level scan, not
    # a Pallas kernel; its times are a level step of phase 2's
    # production gs stage (one launch a stage), and of its 'layer' stage
    t64, t32, t1 = (v1_info["times"]["gs", d, B] for d, B in (
        ("float64", 91), ("float32", 91), ("float64", 1)))
    layer = {f"layer_{k}_{d}_b{B}": v1_info["times"]["layer", d, B][k]
             for k in ("ms", "plain_ms", "bound_ms") for d, B in (
                 ("float64", 91), ("float32", 91), ("float64", 1))}
    kernels.append({
        "name": V1, "route": "cuda",
        "source": "voronoirt_tpu_torch/csrc/voronoi_level.cu",
        "replaces": "voronoirt_tpu/solvers/sweep_voronoi.py:469",
        "replaces_a_tpu_kernel": False,
        "launches": vor_ref["launches"][V1],
        "launches_path": "phase 7: the two Voronoi iterations, one a stage "
                         "call",
        "max_abs_err": v1_info["errs"]["float64"], "bit_equal": True,
        "ms": t64["ms"], "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"], "bound_by": t64["bound_by"],
        "pct_of_bound": 100 * t64["bound_ms"] / t64["ms"],
        "library_ms": None,
        "ms_is": f"a level step of the production direction 8 gs stage "
                 f"({t64['steps']} steps in one launch), B = 91",
        "launches_continuum": launches_continuum[V1],
        "launches_f32_voronoi_iterations": launches32_vor[V1],
        "max_abs_err_f32": v1_info["errs"]["float32"],
        "ms_f32": t32["ms"], "plain_ms_f32": t32["plain_ms"],
        "bound_ms_f32": t32["bound_ms"], "bound_by_f32": t32["bound_by"],
        "pct_of_bound_f32": 100 * t32["bound_ms"] / t32["ms"],
        "ms_b1": t1["ms"], "plain_ms_b1": t1["plain_ms"],
        "bound_ms_b1": t1["bound_ms"], **layer})
    # X1: what it replaces is the JAX package's lax.scan body of a Bezier
    # xy segment, plain XLA, not a Pallas kernel; as the segment kernel
    # (one launch a segment: every unsplit Bezier path whose plane fits)
    # its time is a step of a 214-step segment at the Bezier iteration's
    # plane (phase 2), and as the per-plane kernel (split grids, planes
    # that do not fit) a plane step at phase 8c's 512 x 512 plane
    t64, t32 = xbs_times["float64"], xbs_times["float32"]
    kernels.append({
        "name": XBS, "route": "cuda",
        "source": "voronoirt_tpu_torch/csrc/xy_bezier_segment.cu",
        "replaces": "voronoirt_tpu/solvers/sweep_regular.py:245",
        "replaces_a_tpu_kernel": False,
        "launches": launches_bezier[XBS],
        "launches_path": "phase 8: the Bezier iteration, one a Bezier xy "
                         "segment",
        "max_abs_err": xbs_errs["float64"], "bit_equal": True,
        "ms": t64["ms"], "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"], "bound_by": t64["bound_by"],
        "pct_of_bound": 100 * t64["bound_ms"] / t64["ms"],
        "library_ms": None,
        "ms_is": f"a step of a {PROD['nz'] - 1}-step segment at "
                 f"({B13}, {PROD['nx']}, {PROD['ny']}) in one launch: CUDA "
                 f"events around the launch",
        "x1_ms_same_inputs": t64["x1_ms"],
        "registers": t64["registers"], "local_bytes": t64["local_bytes"],
        "max_active_clusters": t64["max_active_clusters"],
        "launches_angle_slots": launches_xbs_slots,
        "launches_line_nlte_bezier": launches_xbs_driver,
        "launches_streamed_iteration": launches[XBS],
        "max_abs_err_f32": xbs_errs["float32"], "ms_f32": t32["ms"],
        "plain_ms_f32": t32["plain_ms"], "bound_ms_f32": t32["bound_ms"],
        "bound_by_f32": t32["bound_by"],
        "pct_of_bound_f32": 100 * t32["bound_ms"] / t32["ms"],
        "x1_ms_same_inputs_f32": t32["x1_ms"],
        "registers_f32": t32["registers"],
        "local_bytes_f32": t32["local_bytes"],
        "max_active_clusters_f32": t32["max_active_clusters"]})
    t64, t32 = x1_times["float64"], x1_times["float32"]
    kernels.append({
        "name": X1, "route": "cuda",
        "source": "voronoirt_tpu_torch/csrc/xy_bezier.cu",
        "replaces": "voronoirt_tpu/solvers/sweep_regular.py:245",
        "replaces_a_tpu_kernel": False,
        "launches": launches_wide[X1],
        "launches_path": f"phase 8c: a Bezier J pass at {WIDE_GRID}, whose "
                         f"plane does not fit {XBS}'s band, one a plane step",
        "max_abs_err": x1_errs["float64"], "bit_equal": True,
        "ms": t64[0], "plain_ms": t64[1], "bound_ms": t64[2],
        "bound_by": t64[3], "pct_of_bound": 100 * t64[2] / t64[0],
        "library_ms": None,
        "ms_is": f"a plane step at ({B13}, {WIDE_GRID[1]}, {WIDE_GRID[2]}): "
                 f"the kernel's device time (torch.profiler)",
        "ms_events": t64[4], "ms_events_f32": t32[4],
        "launches_bezier_iteration": launches_bezier[X1],
        "launches_streamed_iteration": launches[X1],
        "max_abs_err_f32": x1_errs["float32"], "ms_f32": t32[0],
        "plain_ms_f32": t32[1], "bound_ms_f32": t32[2],
        "bound_by_f32": t32[3], "pct_of_bound_f32": 100 * t32[2] / t32[0]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
