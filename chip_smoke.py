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
     geometry: xy_plane (K1), and K2 as march_coeffs, march_chain and
     their composition march_plane; then all timed at the production
     shape beside their bounds, K2 per march axis, and at (1, 256, 256);
  3. the 8 regular-sweep goldens (tests/golden/regular_sweep_fixtures.npz)
     through the port's short_characteristics on the card, float64;
  4. the small entry() step on the card against the same step on the CPU;
  5. one Lambda iteration of the production configuration
     (215x256x256 grid, 91 wavelengths, ul7n12, float64, lambda-streamed)
     through RegularEngine.run(), with every kernel's launch count;
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
     far wing and its brightness temperature; one xy_plane call of the
     first and one march_plane call of the second held against the
     plain versions on their own inputs; then the continuum_study
     driver on the production atmosphere (skips 1-4, STUDY_SITES
     sites);
 13. the lambda-split regular iteration at the production width: two
     spawned ranks (NCCL on two cards where two are visible, else gloo,
     both on cuda:0) each run one streamed iteration of phase 5's
     configuration on its block of the 91 wavelengths padded to 92,
     with seconds, collective seconds, peak memory and launch counts a
     rank; one xy_plane and one march_plane call of a rank's last
     lambda chunk (B = 28) held against the plain versions; the S rows
     at the block edges and the populations against phase 5's, with
     the cell and level of the largest populations difference; then
     dryrun_multichip(2) on the card, and
     with one card also dryrun_multichip(1) over NCCL.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside it, and fails if
jax or any module of the JAX package (voronoirt_tpu) was imported.
"""

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
# host); which xy_plane / march_plane call of a synthesis is held
# against the plain version
STUDY_SITES = "1e5"
SYNTH_CALL = 100
# phase 13: ranks, and which xy_plane and march_plane call of a rank's
# iteration is held against the plain version: the 100th on the batch of
# the block's last lambda chunk (7 wavelengths at 2 ranks: 28 planes,
# which phase 2 does not check)
LAM_RANKS = 2
LAM_CALL = 100
TOL = {"float64": dict(rtol=1e-12, atol=0.0),
       "float32": dict(rtol=2e-5, atol=1e-6)}
# the hand-written kernels of the regular path; march_plane is K2 as the
# composition of march_coeffs and march_chain
KERNELS = ("xy_plane", "march_plane", "march_coeffs", "march_chain")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12         # float64 outside the tensor cores, the same


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
    """Phase 2: each kernel against its plain version on the card; K2 as
    its two kernels, march_coeffs and march_chain (on the kernel's own
    scratch), and as their composition march_plane.  Returns {kernel:
    max abs err in float64}."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    worst = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator().manual_seed(2024)
    # the production group-plane shape (4 angles x lambda_chunk), a
    # smaller full plane, a ragged one, the per-angle plane of the Bezier
    # iteration (lambda_chunk) and the continuum iteration's (one)
    shapes = ((4 * PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
              (16, 256, 256), (5, 37, 29),
              (PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
              (1, PROD["nx"], PROD["ny"]))
    for dtype_name, dtype in (("float64", torch.float64),
                              ("float32", torch.float32)):
        for (B, nx, ny) in shapes:
            err = dict.fromkeys(KERNELS, (0.0, 0.0))

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
            if dtype_name == "float64":
                for k in KERNELS:
                    worst[k] = max(worst[k], err[k][0])
    return worst


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


def _bounds(B, nx, ny, n_sweeps=3):
    """Least time (ms) of each kernel's work at (B, nx, ny), float64, on
    an H100 SXM: the larger of its bytes (each input plane read once,
    each output written once) over 3.35 TB/s and its floating-point
    operations over the 34 TFLOP/s of float64 outside the tensor cores
    (NVIDIA's data sheet); operations counted per point from the CUDA
    source, an exp as one.  Returns {kernel: (ms, 'bytes' | 'operations')}."""
    pts = B * nx * ny
    plane = 8 * pts
    work = {"xy_plane": (6 * plane, 60 * pts),
            "march_coeffs": (7 * plane, 50 * pts),
            "march_chain": (3 * plane, 5 * n_sweeps * pts),
            "march_plane": (6 * plane, (50 + 5 * n_sweeps) * pts)}
    out = {}
    for k, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
        out[k] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def time_kernels(B):
    """Kernel and plain times at (B, 256, 256), float64, beside each
    kernel's bound: B = 4 angles x lambda_chunk wavelengths is the
    production group plane, B = 1 the continuum iteration's.  K2 per
    march axis, and split into its two kernels."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    nx, ny = PROD["nx"], PROD["ny"]
    bound = _bounds(B, nx, ny)
    gen = torch.Generator().manual_seed(7)
    planes = _planes(gen, B, nx, ny, torch.float64)
    r = _rand(gen, (B,), -1.0, 1.0, torch.float64, log=True)
    f1, f2 = (_fractions(gen, B, torch.float64) for _ in range(2))
    c_prev = (torch.arange(B, device="cuda") % 2).to(torch.float64)
    times = {}
    xy_args = (*planes, r, f1, f2, -1, 0)
    times["xy_plane"] = (_time_ms(lambda: xp.xy_plane(*xy_args), 50),
                         _time_ms(lambda: xp.xy_plane_plain(*xy_args), 10))
    print(f"  xy_plane (B={B}, {nx}x{ny}, float64): kernel "
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
        print(f"  march_plane axis={axis} (B={B}, {nx}x{ny}, float64): "
              f"kernel {kp:.4f} ms = march_coeffs "
              f"{acc['march_coeffs'][0][-1]:.4f} + march_chain "
              f"{acc['march_chain'][0][-1]:.4f} ms (alone); plain "
              f"{acc['march_plane'][1][-1]:.4f} ms; bound "
              f"{bound['march_plane'][0]:.4f} ms ({bound['march_plane'][1]}),"
              f" {100 * bound['march_plane'][0] / kp:.1f} % of it",
              flush=True)
    for k, (km, pm) in acc.items():
        times[k] = (sum(km) / 2, sum(pm) / 2)
    print(f"  march_plane mean of both axes {times['march_plane'][0]:.4f} "
          f"ms, {100 * bound['march_plane'][0] / times['march_plane'][0]:.1f}"
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
    if reset:
        xp.LAUNCHES = 0
        mp.LAUNCHES = mp.COEFFS_LAUNCHES = mp.CHAIN_LAUNCHES = 0
    return {"xy_plane": xp.LAUNCHES, "march_plane": mp.LAUNCHES,
            "march_coeffs": mp.COEFFS_LAUNCHES,
            "march_chain": mp.CHAIN_LAUNCHES}


def _edge_rows(n_lambda, n_ranks):
    """The first and last row of each rank's block of n_lambda
    wavelengths padded to a multiple of n_ranks, as rows of the
    unpadded grid (a padded row repeats the last wavelength)."""
    n = -(-n_lambda // n_ranks)
    rows = {r * n + d for r in range(n_ranks) for d in (0, n - 1)}
    return {row: min(row, n_lambda - 1) for row in sorted(rows)}


def run_production(atmos, n_ranks=LAM_RANKS):
    """One lambda-streamed iteration at the production configuration.
    Returns the launch counts and, on the host, what phases 12-13 hold
    against: the populations, the wavelengths and the S rows at the
    edges of n_ranks' lambda blocks."""
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

    p = PROD
    t0 = time.perf_counter()
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=1, eps=0.0)
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64,
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = RegularEngine(atmos, line, cfg, device="cuda")
    torch.cuda.synchronize()
    groups = [(len(g), sorted({s.case for s in g[0][1].segments}))
              for g in eng.plan_groups]
    print(f"  set-up {time.perf_counter() - t0:.2f} s; grid "
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
    finite = bool(torch.isfinite(res.S).all()) and bool(
        torch.isfinite(res.populations).all())
    require(finite, "S or populations not finite")
    mass = _max_rel(res.populations.sum(-1), eng.nH)
    require(mass < 1e-10, f"populations do not sum to n_H ({mass:.3e})")
    rate = (p["nz"] * p["nx"] * p["ny"] * line.n_lambda
            * eng.quad.n_angles) / j
    print(f"  the iteration {it:.4f} s, J pass {j:.4f} s "
          f"({100 * j / it:.1f}%), {rate:.4e} grid-points*rays/s",
          flush=True)
    print(f"  peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated); criterion {res.convergence}; "
          f"S, populations finite: {finite}; sum(populations)/n_H - 1 "
          f"max {mass:.3e}", flush=True)
    print(f"  launches during the iteration: {launches}", flush=True)
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the main path")
    ref = {"populations": res.populations.cpu().numpy(), "lam": line.lam,
           "temperature": atmos.temperature,
           "S_rows": {row: res.S[row].cpu().numpy() for row in set(
               _edge_rows(line.n_lambda, n_ranks).values())}}
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
    wavelengths, ul7n12, float64."""
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
    return sites


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
    # the Bezier xy step bypasses K1 (only the linear sweeps launch it);
    # the marching segments of both go through K2
    require(launches["march_plane"] > 0 and launches["xy_plane"] > 0,
            f"launches {launches}")


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
def _keep_call(name, n, batch=None):
    """Keep the arguments and result of the n-th call that the regular
    sweep makes of the kernel wrapper `name` ('xy_plane' or
    'march_plane'), to hold against the plain version afterwards; with
    `batch`, the n-th call on a batch of that many planes."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    fn, kept = getattr(sr, name), {"seen": 0}

    def keeping(*args, **kwargs):
        if batch is not None and args[0].shape[0] != batch:
            return fn(*args, **kwargs)
        kept["seen"] += 1
        if kept["seen"] != n:
            return fn(*args, **kwargs)
        kept["args"] = tuple(a.clone() if torch.is_tensor(a) else a
                             for a in args)
        kept["statics"] = kwargs
        kept["out"] = fn(*args, **kwargs)
        return kept["out"]

    setattr(sr, name, keeping)
    try:
        yield kept
    finally:
        setattr(sr, name, fn)


def _hold_kept(name, kept, n, what):
    """The kept n-th call of `name` against its plain version on the
    same inputs, float64 (rtol 1e-12); returns the max abs error."""
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp
    plain = {"xy_plane": xp.xy_plane_plain,
             "march_plane": mp.march_plane_plain}[name]
    require("out" in kept, f"{what} made {kept['seen']} {name} calls, "
                           f"fewer than {n}")
    e_abs, e_rel = _compare(name, kept["out"],
                            plain(*kept["args"], **kept["statics"]),
                            "float64")
    print(f"  {name} call {n} of {what}, {tuple(kept['out'].shape)}, "
          f"{kept['statics']}: against the plain version on the same inputs"
          f" max abs err {e_abs:.3e} (rel {e_rel:.3e}, rtol 1e-12)",
          flush=True)
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
    require(launches["xy_plane"] == 0,
            "the Bezier iteration launched the linear xy kernel")
    for name in ("march_plane", "march_coeffs", "march_chain"):
        require(launches[name] > 0, f"{name}: no launch in the Bezier "
                                    f"iteration")
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
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch in the continuum iteration")
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
                  if "xy_plane" in e.key or "march_" in e.key)
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

def run_synthesis(atmos, ref):
    """Phase 12a: the synthesize driver's synthesize() on phase 5's
    populations at the production grid, read through its _load_regular
    from an in-memory store of the checkpoint's datasets: disk centre
    (theta 180, xy segments: K1) and slanted (theta 135: K2 too).
    Returns {theta: launches}."""
    import numpy as np
    import torch
    from voronoirt_tpu_torch.drivers import synthesize as syn

    store = {"z": atmos.z, "x": atmos.x, "y": atmos.y, **atmos.fields(),
             "populations": ref["populations"],
             "wavelength": np.asarray(ref["lam"]) * 1e9}
    atmos_s, pops, lam = syn._load_regular(store)
    out = {}
    for theta, name in ((180.0, "xy_plane"), (135.0, "march_plane")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = _card_timer()
        _launch_counts(reset=True)
        with _keep_call(name, SYNTH_CALL) as kept, timer.phase("synth"):
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
        require(out[theta][name] > 0, f"{name}: no launch in the synthesis")
        _hold_kept(name, kept, SYNTH_CALL, f"the synthesis at theta {theta:g}")
    return out


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
    require(launches["xy_plane"] > 0, "xy_plane: no launch in the study")
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
    with _keep_call("xy_plane", call_n, B) as k1, \
            _keep_call("march_plane", call_n, B) as k2:
        res = eng.run()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    held = {name: {"err": _hold_kept(name, kept, call_n, f"rank "
                                     f"{group.rank}'s iteration at B = {B}"),
                   "shape": tuple(kept["out"].shape)}
            for name, kept in (("xy_plane", k1), ("march_plane", k2))}
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
        # the split sums the rate integrals' pairs in another order; the
        # ground level, n_H - n2 - n3, is a sliver of n_H in the hottest
        # cells (6e-7 of it at 12,000 K), so a last-digit change of n3
        # moves it ~1e-10 relative: populations are held per n_H (1e-10),
        # and per entry to the packages' bar (1e-8)
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
              + "; ".join(f"{k} call {LAM_CALL} at {h['shape']}: max abs "
                          f"err {h['err']:.3e}" for k, h in o["held"].items()),
              flush=True)
        require(errS <= 1e-12 and errP <= 1e-10 and relP <= 1e-8,
                f"rank {o['rank']} differs from the unsplit iteration")
        require(np.array_equal(o["populations"], outs[0]["populations"])
                and o["convergence"] == outs[0]["convergence"],
                "the ranks' populations or criteria differ")
        for name, n in o["launches"].items():
            require(n > 0, f"{name}: no launch on rank {o['rank']}")
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


def main():
    import torch
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

    phase("phase 2: kernels vs plain versions on the card")
    errs = check_kernels()
    times, bounds = time_kernels(4 * PROD["lambda_chunk"])
    times_b1, bounds_b1 = time_kernels(1)
    phase("phase 3: regular-sweep goldens on the card")
    check_goldens()
    phase("phase 4: small entry step, card vs CPU")
    check_entry()
    phase("phase 5: production iteration")
    atmos = synthetic_atmosphere(nz=PROD["nz"], nx=PROD["nx"], ny=PROD["ny"])
    launches, ref = run_production(atmos)
    phase("phase 6: Voronoi goldens on the card, wavefront sweeps card vs CPU")
    check_voronoi_goldens()
    phase(f"phase 7: Voronoi production, {VOR_SITES} sites")
    sites = run_voronoi_production(atmos)
    phase("phase 8: Bezier sweeps card vs CPU, one Bezier production "
          "iteration")
    check_bezier_sweeps()
    launches_bezier = run_bezier_production(atmos)
    phase("phase 9: angle distribution, serial vs two slots on the card")
    check_angle_distribution()
    phase("phase 10: continuum scattering iteration")
    launches_continuum = run_continuum(atmos, sites)
    del sites
    phase("phase 11: checkpoint/resume on the card, the drivers")
    check_checkpoint_resume()
    check_device_trace()
    run_drivers()
    phase("phase 12: the synthesize and continuum_study drivers at full "
          "width")
    launches_synth = run_synthesis(atmos, ref)
    launches_study = run_study()
    phase(f"phase 13: the lambda-split production iteration, {LAM_RANKS} "
          f"ranks")
    launches_lam = [o["launches"] for o in run_lam_production(ref)]
    phase("done")

    require("jax" not in sys.modules, "jax was imported")
    jax_pkg = sorted(m for m in sys.modules if m == "voronoirt_tpu"
                     or m.startswith("voronoirt_tpu."))
    require(not jax_pkg, f"modules of the JAX package imported: {jax_pkg}")
    k2 = ("voronoirt_tpu_torch/csrc/march_plane.cu",
          "voronoirt_tpu/solvers/pallas_march.py:89")
    src = {"xy_plane": ("voronoirt_tpu_torch/csrc/xy_plane.cu",
                        "voronoirt_tpu/solvers/pallas_xy.py:65"),
           "march_plane": k2, "march_coeffs": k2, "march_chain": k2}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
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
                "launches_lam_ranks": [n[name] for n in launches_lam]}
               for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
