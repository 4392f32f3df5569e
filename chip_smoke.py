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
     xy_segment (K1 a segment a launch) at the same shapes and a
     320x320 plane (its global placement) and a 6x1 one, over every
     shift pair, both directions and segment lengths 1, 2, 7 and 214,
     bit-equal to its plain version and to a loop of xy_plane, a
     segment cut into pieces bit-equal to the whole one; then all
     timed at the production shape beside their bounds, K2 per march
     axis, and at (1, 256, 256), and at the production shape in float32
     too; a 214-plane xy segment at B = 52, 13 and 1 in both types, ms a
     step beside its bound and the per-plane K1's time;
  3. the 8 regular-sweep goldens (tests/golden/regular_sweep_fixtures.npz)
     through the port's short_characteristics on the card, float64;
  4. the small entry() step on the card against the same step on the CPU;
  5. one Lambda iteration of the production configuration
     (215x256x256 grid, 91 wavelengths, ul7n12, float64, lambda-streamed)
     through RegularEngine.run(), with every kernel's launch count
     (xy_segment one a piece of an xy segment, xy_plane none);
  6. the Voronoi NLTE chain goldens (tests/golden/nlte_fixtures.npz
     vor_*: 500 sites, 'layer' order, 3 iterations) through
     VoronoiEngine.run() on the card, and wavefront sweeps of every
     ul7n12 direction with the adaptive relax exit, card against CPU;
  7. two Voronoi Lambda iterations ('layer' order) at the reference's
     quarter-resolution production count, 442,368 sites sampled from the
     phase-5 atmosphere, 91 wavelengths, ul7n12, float64; set-up and
     iteration seconds, per-direction seconds, level steps and peak
     memory (the 'wavefront' order runs in phase 6 only);
  8. the Bezier formal solution: Bezier (and linear) sweeps of every
     ul7n12 direction at a small size, card against CPU; then one full
     Lambda iteration at the phase-5 grid through RegularEngine.run()
     with formal_interpolation='bezier', lambda_chunk 13 and the rates
     in slabs of z-planes (the standard loop: S_old, S_new, J and B0
     resident), with seconds, the J-pass share, the kernels' launch
     counts and peak memory; one march_plane call of that iteration, on
     its own inputs, against the plain version; a Bezier xy plane step's
     time beside K1's, K1 held against its plain version there too;
  9. angle distribution: compute_J serial against
     distribute_angles(engine, [cuda:0, cuda:0]), regular (linear and
     Bezier) and Voronoi, at a small size;
 10. the continuum scattering iteration (a batch of ONE wavelength
     through every sweep): card against CPU at a small size, then
     lambda_continuum_regular at the phase-5 grid, 3 iterations, with
     the kernels' launch counts, and lambda_continuum_voronoi on phase
     7's sites, 2 iterations;
 11. checkpoint and resume on the card: a small run killed after its
     second write_state and resumed equals the uninterrupted run,
     through a store that keeps the arrays in memory and, where h5py
     imports, through the HDF5 file; one small J pass under
     observability.device_trace; then the searchlight driver (flux kept
     for all 12 directions) and the line_nlte driver with
     --interpolation bezier, as a user calls them;
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
     rank; one xy_segment and one march_plane call of a rank's last
     lambda chunk (B = 28) held against the plain versions; the S rows
     at the block edges and the populations against phase 5's, with
     the cell and level of the largest populations difference; then
     dryrun_multichip(2) on the card, and
     with one card also dryrun_multichip(1) over NCCL;
 14. the regular iteration split over the y axis of a mesh
     (parallel/mesh.py): two spawned ranks (NCCL on two cards where two
     are visible, else gloo, both on cuda:0) each run one streamed
     iteration of phase 5's configuration on their half of the grid in
     y, K1 on halo-padded tiles and K2 on gathered march planes, with
     seconds, the halo and gather calls, bytes and seconds, peak memory
     and launch counts a rank; one xy_plane call on a padded tile and
     one march_plane call on a gathered plane of a rank held against
     the plain versions; S at phase 13's rows and the populations
     against phase 5's at phase 13's bars; then dryrun_multichip(4)
     (lam 2 x y 2) over gloo on the card;
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
     sites with phase 7's plans, seconds and peak, held against phase
     7's float64 result at the same bar;
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
# the hand-written kernels of the regular path: K1 as xy_segment (the
# unsplit sweep) and xy_plane (the split sweep); march_plane is K2 as the
# composition of march_coeffs and march_chain
KERNELS = ("xy_segment", "xy_plane", "march_plane", "march_coeffs",
           "march_chain")
# the kernels that take one plane a launch
PLANE_KERNELS = KERNELS[1:]
# phase 2's plane shapes (B, Nx, Ny): the production group plane (4
# angles x lambda_chunk), a smaller full plane, a ragged one, the
# per-angle plane of the Bezier iteration (lambda_chunk) and the
# continuum iteration's (one)
PHASE2_SHAPES = ((4 * PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
                 (16, 256, 256), (5, 37, 29),
                 (PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
                 (1, PROD["nx"], PROD["ny"]))
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
    out = {}
    for k, (nbytes, ops) in work.items():
        t_b = nbytes / HBM_BYTES_PER_S
        t_o = ops / OPS_PER_S[dtype_name]
        out[k] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


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
    import torch
    from voronoirt_tpu_torch.entry import entry
    step_g, args_g = entry()            # the card, by default
    S_g, P_g = step_g(*args_g)
    torch.cuda.synchronize()
    step_c, args_c = entry(device="cpu")
    S_c, P_c = step_c(*args_c)
    eS, eP = _max_rel(S_g.cpu(), S_c), _max_rel(P_g.cpu(), P_c)
    print(f"  entry step card vs CPU: S max rel diff {eS:.3e} (< 1e-10), "
          f"populations {eP:.3e} (< 1e-8)", flush=True)
    require(eS < 1e-10 and eP < 1e-8, "entry step: card disagrees with CPU")


# ------------------------------------------------------------ phase 5

def _launch_counts(reset=False):
    """The kernel wrappers' launch counters; reset=True sets them to 0."""
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    from voronoirt_tpu_torch.solvers import xy_segment as xs
    if reset:
        xp.LAUNCHES = xs.LAUNCHES = 0
        mp.LAUNCHES = mp.COEFFS_LAUNCHES = mp.CHAIN_LAUNCHES = 0
    return {"xy_segment": xs.LAUNCHES, "xy_plane": xp.LAUNCHES,
            "march_plane": mp.LAUNCHES, "march_coeffs": mp.COEFFS_LAUNCHES,
            "march_chain": mp.CHAIN_LAUNCHES}


def _require_path(launches, used, what):
    """Every kernel in `used` launched on the path, and no other."""
    for name, n in launches.items():
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
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

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
    res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

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
    print(f"  launches during the iteration: {launches} (xy_segment: one a "
          f"piece of an xy segment, {pieces} expected)", flush=True)
    _require_path(launches, UNSPLIT, "the streamed iteration")
    require(launches["xy_segment"] == pieces,
            f"xy_segment: {launches['xy_segment']} launches, not {pieces}")
    return res, eng, launches, mass


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
    res = eng.run()
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
            out[dev] = sv.sweep_voronoi(plan, t(S), t(alpha), t(I0),
                                        relax_tol=1e-7)
            steps[dev] = sv.LEVEL_STEPS
        require(steps["cuda"] == steps["cpu"],
                f"direction {i}: {steps['cuda']} level steps on the card, "
                f"{steps['cpu']} on the CPU")
        worst = max(worst, _rel_err(out["cuda"].cpu(), out["cpu"]))
        kinds |= {st.kind for st in sv.build_slot_plan(plan).stages}
    print(f"  wavefront sweeps ({wsites.n} sites, B={B}, 12 directions, "
          f"stages {sorted(kinds)}, relax_tol 1e-7): card vs CPU max rel "
          f"diff {worst:.3e} (<= 1e-10), equal level steps", flush=True)
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


def run_voronoi_production(atmos):
    """Phase 7: two 'layer' iterations at VOR_SITES sites, 91
    wavelengths, ul7n12, float64.  Returns the sites and, for phase 15,
    the plans and the result's S and populations on the host (the
    populations, convergence history and seconds for phase 16 too)."""
    import torch
    from voronoirt_tpu_torch import Config, get_quadrature, grid
    from voronoirt_tpu_torch.engine import VoronoiEngine, lambda_iter
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv

    p = PROD
    setup = {}
    t = time.perf_counter()
    pos, bounds = _sample(atmos, VOR_SITES)
    setup["sampling"] = time.perf_counter() - t
    require(grid.build_native() is not None,
            "native tessellation library not built")
    t = time.perf_counter()
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    setup["tessellation"] = time.perf_counter() - t
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

    with _timed_J(eng, lambda_iter, sv) as rec:
        res = eng.run()
    require(res.iterations == 2 and len(res.timings) == 2,
            f"expected 2 iterations, ran {res.iterations}")
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
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB (max_memory_allocated, phase 7)", flush=True)
    # host copies of the plans for phase 15: the float64 device arrays
    # the engine cached on the originals would stay on the card through
    # phases 8-14, whose spawned ranks need the room
    return sites, {"plans": [dataclasses.replace(p) for p in plans],
                   "S": res.S.cpu().numpy(),
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
    differences between the devices' libraries grow (ROADMAP C3)."""
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
    cases, differs = set(), 0.0
    _launch_counts(reset=True)
    for i in range(quad.n_angles):
        plan = sr.build_plan(quad.k[i], z, 1.0 / nx, 1.0 / ny,
                             bool(quad.is_up[i]))
        cases |= {s.case for s in plan.segments}
        out = {}
        for interp in worst:
            for dev in ("cuda", "cpu"):
                t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                              device=dev)
                out[interp, dev] = sr.sweep(
                    plan, t(S), t(alpha), t(I0 if plan.up else 0.0 * I0),
                    n_sweeps=3, interpolation=interp).cpu()
            worst[interp] = max(worst[interp],
                                _rel_err(out[interp, "cuda"],
                                         out[interp, "cpu"]))
        differs = max(differs, _rel_err(out["bezier", "cuda"],
                                        out["linear", "cuda"]))
    launches = _launch_counts()
    print(f"  sweeps of 12 directions ({nz}x{nx}x{ny}, B={B}, cases "
          f"{sorted(cases)}): card vs CPU max rel diff linear "
          f"{worst['linear']:.3e} (<= 1e-12), bezier {worst['bezier']:.3e} "
          f"(<= 1e-10); bezier vs linear on the card {differs:.3e}; "
          f"launches {launches}", flush=True)
    require(cases == {"xy", "yz", "xz"}, f"plane-cut cases {cases}")
    require(worst["linear"] <= 1e-12 and worst["bezier"] <= 1e-10,
            f"sweeps card vs CPU: {worst}")
    require(differs > 1e-3, "the Bezier sweep equals the linear one")
    # the Bezier xy step bypasses K1 (only the linear sweeps launch it,
    # as xy_segment); the marching segments of both go through K2
    _require_path(launches, UNSPLIT, "the sweeps")


def _time_bezier_step(B):
    """ms of one Bezier xy plane step (plain torch) and of K1 at
    (B, 256, 256), float64, CUDA events; K1 is held against its plain
    version on the same planes first."""
    import torch
    from voronoirt_tpu_torch import get_quadrature
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    nx, ny = PROD["nx"], PROD["ny"]
    gen = torch.Generator().manual_seed(9)
    a_p, a_c, s_p, s_c, i_p = _planes(gen, B, nx, ny, torch.float64)
    a_pp, _, s_pp, _, _ = _planes(gen, B, nx, ny, torch.float64)
    quad = get_quadrature(PROD["quadrature"])
    plan = sr.build_plan(quad.k[0], [0.0, 1.0], 1.0, 1.0, True)
    bez = _time_ms(lambda: sr._xy_step_bezier(
        plan, i_p, a_c, a_p, s_c, s_p, a_pp, s_pp, 0.7, 0.3, 0.6, 0.8, 0.2,
        0.5, 0.0), 20)
    r = torch.full((B,), 0.7, dtype=torch.float64, device="cuda")
    fx, fy = 0.3 * torch.ones_like(r), 0.6 * torch.ones_like(r)
    k1_args = (a_p, a_c, s_p, s_c, i_p, r, fx, fy, plan.sxs, plan.sys)
    _compare("xy_plane", xp.xy_plane(*k1_args), xp.xy_plane_plain(*k1_args),
             "float64")
    k1 = _time_ms(lambda: xp.xy_plane(*k1_args), 50)
    return bez, k1


# z-planes per slab of the rates in the Bezier production iteration
BEZIER_RATES_PLANES = 8
# which march_plane call of that iteration is held against the plain one
K2_CALL = 1000


@contextmanager
def _keep_call(name, n, batch=None, shape=None):
    """Keep the arguments and result of the n-th call that the regular
    sweep makes of the kernel wrapper `name` ('xy_segment', 'xy_plane' or
    'march_plane'), to hold against the plain version afterwards; with
    `batch`, the n-th call on a batch of that many planes; with `shape`,
    the n-th call on planes of that shape.  An xy_segment call is held
    at once, inside the sweep, before the next piece reuses its planes:
    its inputs are the whole fields, too large to copy."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    fn, kept = getattr(sr, name), {"seen": 0}
    # the batch plane: I0 of a segment, the first plane of a plane call
    plane_of = (lambda args: args[2]) if name == "xy_segment" else \
        (lambda args: args[0])

    def keeping(*args, **kwargs):
        plane = plane_of(args)
        if ((batch is not None and plane.shape[0] != batch)
                or (shape is not None and tuple(plane.shape) != shape)):
            return fn(*args, **kwargs)
        kept["seen"] += 1
        if kept["seen"] != n:
            return fn(*args, **kwargs)
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
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    require("shape" in kept, f"{what} made {kept['seen']} {name} calls, "
                             f"fewer than {n}")
    dtype_name = str(kept["dtype"]).replace("torch.", "")
    if name == "xy_segment":
        e_abs, e_rel = kept["err"]
    else:
        plain = {"xy_plane": xp.xy_plane_plain,
                 "march_plane": mp.march_plane_plain}[name]
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
    compute_J = eng.compute_J

    def timed_J(*args, **kwargs):
        torch.cuda.synchronize()
        with timer.phase("J pass"):
            return compute_J(*args, **kwargs)

    eng.compute_J = timed_J
    _launch_counts(reset=True)
    # keep one march_plane call of the iteration (the K2_CALL-th:
    # mid-sweep, the carried intensity no longer the boundary's)
    with _keep_call("march_plane", K2_CALL) as kept, timer.phase("run"):
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
          f"({n_xy} a chunk, plain torch, no K1 launch); launches "
          f"{launches}; criterion {res.convergence}; peak device memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated); "
          f"sum(populations)/n_H - 1 max {mass:.3e}", flush=True)
    _require_path(launches, ("march_plane", "march_coeffs", "march_chain"),
                  "the Bezier iteration")
    del res, eng
    torch.cuda.empty_cache()
    B = cfg.lambda_chunk
    _hold_kept("march_plane", kept, K2_CALL, "the Bezier iteration")
    require(tuple(kept["out"].shape) == (B, p["nx"], p["ny"]),
            f"march_plane plane {tuple(kept['out'].shape)} in the iteration")
    bez, k1 = _time_bezier_step(B)
    print(f"  one xy plane step at (B={B}, {p['nx']}x{p['ny']}, float64): "
          f"Bezier (plain torch) {bez:.4f} ms, K1 (linear) {k1:.4f} ms, "
          f"ratio {bez / k1:.1f}", flush=True)
    return launches


def check_angle_distribution():
    """Phase 9: compute_J serial against the same engine with its angles
    dealt over two slots of the card, [cuda:0, cuda:0].  Bezier and
    Voronoi sweep angle by angle on both sides: 1e-12.  The serial
    linear J is the grouped one, which z-flips the down sweeps onto an
    axis whose steps round differently (ROADMAP C3): 1e-11."""
    import torch
    from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
    from voronoirt_tpu_torch.engine import VoronoiEngine
    from voronoirt_tpu_torch.parallel import distribute_angles
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    two = [torch.device("cuda", 0)] * 2
    atmos = synthetic_atmosphere(nz=24, nx=32, ny=32)
    for interp, bar in (("linear", 1e-11), ("bezier", 1e-12)):
        kw = dict(quadrature="ul7n12", lambda_chunk=4,
                  formal_interpolation=interp)
        serial = _small_line_engine(atmos, "cuda", **kw)
        J0 = serial.compute_J(serial.B0, serial.lte)
        eng = distribute_angles(_small_line_engine(atmos, "cuda", **kw), two)
        J1 = eng.compute_J(eng.B0, eng.lte)
        err = _rel_err(J1, J0)
        print(f"  regular {interp}: distributed vs serial J max rel diff "
              f"{err:.3e} (<= {bar:g})", flush=True)
        require(J1.is_cuda and err <= bar,
                f"regular {interp} distributed J: {err:.3e}")

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
    J1 = eng.compute_J(eng.B0, eng.lte)
    err = _rel_err(J1, J0)
    print(f"  Voronoi ({sites.n} sites): distributed vs serial J max rel "
          f"diff {err:.3e} (<= 1e-12)", flush=True)
    require(J1.is_cuda and err <= 1e-12, f"Voronoi distributed J: {err:.3e}")


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
    with warnings.catch_warnings(), timer.phase("voronoi"):
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        S, J, hist = lambda_continuum_voronoi(sites, line_v, cfg_v)
    wall = timer.totals["voronoi"]
    require(S.is_cuda and tuple(S.shape) == (sites.n,),
            f"continuum Voronoi S {tuple(S.shape)} on {S.device}")
    nan_guard("continuum Voronoi S, J", S, J)
    require(bool((S > 0).all()) and len(hist) == 2,
            f"continuum Voronoi S not positive, or {len(hist)} iterations")
    print(f"  lambda_continuum_voronoi at {sites.n} sites, 'layer' plans "
          f"built inside, B=1: {wall:.4f} s for the 12 plans, their slot "
          f"plans and 2 iterations; {sv.LEVEL_STEPS} level steps; history "
          f"{hist}",
          flush=True)
    return launches


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
    """Phase 11c: the drivers as a user calls them, on the card."""
    import math
    from voronoirt_tpu_torch.drivers import line_nlte, searchlight

    res = searchlight.main(["--n", "51"])
    worst = max(abs(r["flux_out"] / r["flux_in"] - 1.0) for r in res)
    print(f"  searchlight --n 51: {len(res)} directions, flux out / flux in "
          f"- 1 max {worst:.3e} (<= 1e-4)", flush=True)
    require(len(res) == 12 and worst <= 1e-4, "searchlight: flux not kept")
    summary = line_nlte.main(["--interpolation", "bezier", "--maxiter", "3"])
    print(f"  line_nlte --interpolation bezier --maxiter 3: {summary}",
          flush=True)
    require(summary["grid"] == "regular" and 1 <= summary["iterations"] <= 3
            and math.isfinite(summary["final_diff"]),
            f"line_nlte summary {summary}")


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
        _require_path(out[theta], ("xy_segment",) if theta == 180.0 else
                      ("march_plane", "march_coeffs", "march_chain"),
                      f"the synthesis at theta {theta:g}")
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
            "launches": launches, "held": held,
            "convergence": res.convergence,
            "S_edges": {lo: res.S[0].cpu().numpy(),
                        hi - 1: res.S[-1].cpu().numpy()},
            "populations": res.populations.cpu().numpy()}


def _rel_np(got, want):
    import numpy as np
    return float(np.max(np.abs(got / want - 1.0)))


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
        _require_path(o["launches"], UNSPLIT, f"rank {o['rank']}")
    print(f"  the spawn, start to the last result: {wall:.2f} s; criterion "
          f"{outs[0]['convergence']}", flush=True)
    t = time.perf_counter()
    dryrun_multichip(n_ranks, backend=backend)
    print(f"  dryrun_multichip({n_ranks}, backend={backend!r}) on the "
          f"card: {time.perf_counter() - t:.2f} s", flush=True)
    if backend == "gloo":
        # one card: NCCL, the default on cards, still joins and runs its
        # collectives with a single rank
        t = time.perf_counter()
        dryrun_multichip(1, backend="nccl")
        print(f"  dryrun_multichip(1, backend='nccl') on the card: "
              f"{time.perf_counter() - t:.2f} s", flush=True)
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
            "launches": launches, "held": held,
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
        # the split sweep: K1 one plane a launch on padded tiles
        _require_path(o["launches"], PLANE_KERNELS, f"rank {o['rank']}")
    print(f"  the spawn, start to the last result: {wall:.2f} s; criterion "
          f"{outs[0]['convergence']} (phase 5 and 13 ran the same "
          f"iteration)", flush=True)
    t = time.perf_counter()
    dryrun_multichip(4, backend="gloo")
    print(f"  dryrun_multichip(4, backend='gloo') on the card: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
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
    require(all(launches[k] == launches64[k] for k in PLANE_KERNELS),
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
    res = eng.run()
    peak = torch.cuda.max_memory_allocated()
    require(res.iterations == 2, f"ran {res.iterations} iterations")
    require(res.S.dtype == res.populations.dtype == torch.float32,
            f"S {res.S.dtype}, populations {res.populations.dtype}")
    print(f"  float32, {sites.n} sites: engine set-up {setup:.2f} s "
          f"(phase 7's plans), iteration seconds "
          f"{[round(x, 4) for x in res.timings]}, peak device memory "
          f"{peak / 2**30:.3f} GiB; criterion {res.convergence}",
          flush=True)
    P64 = vor_ref["populations"]
    _against_gate("Voronoi S", res.S, vor_ref["S"],
                  float(abs(vor_ref["S"]).max()), ("lambda", "site"))
    _against_gate("Voronoi populations", res.populations, P64,
                  float(abs(P64).max()), ("site", "level"))


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
        _require_path(n, ("xy_segment",) if mu == 1.0 else
                      ("march_plane", "march_coeffs", "march_chain"),
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

    if want(2):
        phase("phase 2: kernels vs plain versions on the card")
        errs = check_kernels()
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
    if want(3):
        phase("phase 3: regular-sweep goldens on the card")
        check_goldens()
    if want(4):
        phase("phase 4: small entry step, card vs CPU")
        check_entry()
    atmos = synthetic_atmosphere(nz=PROD["nz"], nx=PROD["nx"], ny=PROD["ny"])
    if want(5):
        phase("phase 5: production iteration")
        launches, ref = run_production(atmos, keep_S=want(15))
    if want(6):
        phase("phase 6: Voronoi goldens on the card, wavefront sweeps card "
              "vs CPU")
        check_voronoi_goldens()
    if want(7):
        phase(f"phase 7: Voronoi production, {VOR_SITES} sites")
        sites, vor_ref = run_voronoi_production(atmos)
    if want(8):
        phase("phase 8: Bezier sweeps card vs CPU, one Bezier production "
              "iteration")
        check_bezier_sweeps()
        launches_bezier = run_bezier_production(atmos)
    if want(9):
        phase("phase 9: angle distribution, serial vs two slots on the card")
        check_angle_distribution()
    if want(10):
        phase("phase 10: continuum scattering iteration")
        launches_continuum = run_continuum(atmos, sites)
    if want(11):
        phase("phase 11: checkpoint/resume on the card, the drivers")
        check_checkpoint_resume()
        check_device_trace()
        run_drivers()
    if want(12):
        phase("phase 12: the synthesize and continuum_study drivers at full "
              "width")
        launches_synth, synth_disk_centre = run_synthesis(atmos, ref)
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
        launches32, errs32 = run_f32_production(atmos, ref, launches)
        run_f32_voronoi(sites, vor_ref)
    if want(16):
        phase("phase 16: the paper's line figures at full width, regular "
              f"and {VOR_SITES} Voronoi sites, mu {FIGURE_MUS}")
        launches_figures = run_line_figures(
            atmos, ref, sites, vor_ref,
            synth_disk_centre if want(12) else None)
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
    # each kernel's launches on its path: phase 5's streamed iteration,
    # and for xy_plane, which only the split sweep launches, a rank of
    # phase 14's
    path = dict.fromkeys(KERNELS, "phase 5: the streamed iteration")
    path["xy_plane"] = "phase 14: the y-split iteration, rank 0"
    path_launches = dict(launches,
                         xy_plane=mesh_ranks[0]["launches"]["xy_plane"])
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
                   if name == "xy_segment" else {})}
               for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
