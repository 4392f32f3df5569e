#!/usr/bin/env python3
"""Smoke run of voronoirt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card's name and power limit (nvidia-smi); build the kernels;
  2. each hand-written kernel against its plain PyTorch version on the
     card, float64 and float32, at the production plane shape
     (52, 256, 256), at (16, 256, 256) and at a ragged (5, 37, 29),
     over every stencil-shift / march-direction combination with mixed
     per-element geometry: xy_plane (K1), and K2 as march_coeffs,
     march_chain and their composition march_plane; then all timed at
     the production shape beside their bounds, K2 per march axis;
  3. the 8 regular-sweep goldens (tests/golden/regular_sweep_fixtures.npz)
     through the port's short_characteristics on the card, float64;
  4. the small entry() step on the card against the same step on the CPU;
  5. two Lambda iterations of the production configuration
     (215x256x256 grid, 91 wavelengths, ul7n12, float64, lambda-streamed)
     through RegularEngine.run(), with every kernel's launch count;
  6. the Voronoi NLTE chain goldens (tests/golden/nlte_fixtures.npz
     vor_*: 500 sites, 'layer' order, 3 iterations) through
     VoronoiEngine.run() on the card, and wavefront sweeps of every
     ul7n12 direction with the adaptive relax exit, card against CPU;
  7. two Voronoi Lambda iterations ('layer' order) at the reference's
     quarter-resolution production count, 442,368 sites sampled from the
     phase-5 atmosphere, 91 wavelengths, ul7n12, float64, then one
     'wavefront' J pass on the same sites; set-up and iteration seconds,
     per-direction seconds, level steps and peak memory.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside it, and fails if
jax or any module of the JAX package (voronoirt_tpu) was imported.
"""

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
    # smaller full plane and a ragged one
    shapes = ((4 * PROD["lambda_chunk"], PROD["nx"], PROD["ny"]),
              (16, 256, 256), (5, 37, 29))
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


def time_kernels():
    """Kernel and plain times at the production group-plane shape
    (B = 4 angles x lambda_chunk wavelengths, 256x256, float64), beside
    each kernel's bound.  K2 per march axis, and split into its two
    kernels."""
    import torch
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    B = 4 * PROD["lambda_chunk"]
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

def run_production(atmos):
    """Two lambda-streamed iterations at the production configuration."""
    import torch
    from voronoirt_tpu_torch import Config
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    from voronoirt_tpu_torch.solvers import march_plane as mp
    from voronoirt_tpu_torch.solvers import xy_plane as xp

    p = PROD
    t0 = time.perf_counter()
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=2, eps=0.0)
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
    xp.LAUNCHES = 0
    mp.LAUNCHES = mp.COEFFS_LAUNCHES = mp.CHAIN_LAUNCHES = 0
    res = eng.run()
    launches = {"xy_plane": xp.LAUNCHES, "march_plane": mp.LAUNCHES,
                "march_coeffs": mp.COEFFS_LAUNCHES,
                "march_chain": mp.CHAIN_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    require(res.iterations == 2 and len(res.timings) == 2,
            f"expected 2 iterations, ran {res.iterations}")
    n_chunks = -(-line.n_lambda // cfg.lambda_chunk)
    it2, j2 = res.timings[1], sum(j_times[-n_chunks:])
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
            * eng.quad.n_angles) / j2
    print(f"  iteration seconds {[round(t, 4) for t in res.timings]}; "
          f"second iteration {it2:.4f} s, J pass {j2:.4f} s "
          f"({100 * j2 / it2:.1f}%), {rate:.4e} grid-points*rays/s",
          flush=True)
    print(f"  peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated); criterion {res.convergence}; "
          f"S, populations finite: {finite}; sum(populations)/n_H - 1 "
          f"max {mass:.3e}", flush=True)
    print(f"  launches during the two iterations: {launches}", flush=True)
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the main path")
    return launches


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
    """Phase 7: two 'layer' iterations and one 'wavefront' J pass at
    VOR_SITES sites, 91 wavelengths, ul7n12, float64."""
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
    cfg_w = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                   quadrature=p["quadrature"], voronoi_order="wavefront")
    quad = get_quadrature(cfg.quadrature)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        plans = VoronoiEngine.build_plans(sites, quad, cfg)
    setup["plans (layer, 12 directions)"] = time.perf_counter() - t
    t = time.perf_counter()
    plans_w = VoronoiEngine.build_plans(sites, quad, cfg_w)
    setup["plans (wavefront, 12 directions)"] = time.perf_counter() - t

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
    pops, S = res.populations, res.S
    del res, eng

    eng_w = VoronoiEngine(sites, line, cfg_w, plans=plans_w, device="cuda")
    with _timed_J(eng_w, lambda_iter, sv) as rec_w:
        J_w = eng_w.compute_J(S, pops)
    require(J_w.is_cuda and bool(torch.isfinite(J_w).all()),
            "wavefront J not finite or not on the card")
    jw = rec_w["J"][0]
    sweep_w = sum(rec_w["sweep"])
    print(f"  wavefront (relax_tol {cfg_w.voronoi_relax_tol:g}): J pass "
          f"{jw:.4f} s, {rays / jw:.4e} sites*wavelengths*rays/s; level "
          f"steps {rec_w['steps'][0]}, {1e6 * sweep_w / rec_w['steps'][0]:.2f}"
          f" us of sweep per level step; by direction: extinction s "
          f"{[round(x, 4) for x in rec_w['ext']]}, sweep s "
          f"{[round(x, 4) for x in rec_w['sweep']]}",
          flush=True)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB (max_memory_allocated, phase 7)", flush=True)


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
        print(f"{title} (at {time.perf_counter() - t0:.1f} s)", flush=True)

    phase("phase 2: kernels vs plain versions on the card")
    errs = check_kernels()
    times, bounds = time_kernels()
    phase("phase 3: regular-sweep goldens on the card")
    check_goldens()
    phase("phase 4: small entry step, card vs CPU")
    check_entry()
    phase("phase 5: production iterations")
    atmos = synthetic_atmosphere(nz=PROD["nz"], nx=PROD["nx"], ny=PROD["ny"])
    launches = run_production(atmos)
    phase("phase 6: Voronoi goldens on the card, wavefront sweeps card vs CPU")
    check_voronoi_goldens()
    phase(f"phase 7: Voronoi production, {VOR_SITES} sites")
    run_voronoi_production(atmos)
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
                "library_ms": None} for name in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
