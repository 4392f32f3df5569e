#!/usr/bin/env python3
"""Where the time of the port's Voronoi Lambda iteration goes, on one
CUDA card.

    python3 tools/profile_voronoi.py [--n-sites 3522560] [--layer-only]
                                     [--repeat N] [--repo DIR]
                                     [--out profile.json]

Drives the path of chip_smoke.py phase 7 at --n-sites sites (default
3,522,560, the reference's half-resolution production count,
compare_line.jl:64-68): sites sampled with the production density
(invNH_invT, seed 2022) from synthetic_atmosphere(215, 256, 256),
tessellated by the native library, ul7n12 plans in 'layer' and in
'wavefront' order, Ly-alpha with 91 wavelengths, float64, no lambda
chunking.

  1. set-up seconds: sampling, tessellation, each order's 12 plans,
     engine set-up;
  2. 'layer': a first iteration of VoronoiEngine.run() (cold: the
     allocator's first pass over every level shape), one with
     synchronised host timers around each part (per direction:
     extinction, sweep; then the S update and the rates with
     statistical equilibrium), then --repeat plain ones (their median
     is the plain iteration's seconds);
  3. 'wavefront': a first compute_J (cold), one with the parts timed
     (per direction: extinction, the rest of the sweep; the relax
     stages' eager weight hoist, _precompute_lean, is counted and timed
     where it runs: on the card V1 forms the lean weights in its laps,
     so it runs nowhere, and the bytes of the lean pair (A (R, 2, B), b
     (R, B)) that are no longer allocated are printed), then one plain;
  4. under torch.profiler, for each order, the J work of a steep and a
     grazing direction (extinction + sweep): the kernels' summed device
     time against the same window's plain wall gives the device's busy
     share; the kernels are listed by device time, and V1's (the level
     steps, csrc/voronoi_level.cu, one launch a stage call) device time,
     launches, level steps and device us a launch and a step are summed
     apart; for the 'layer' window, V1's bytes bound a step on its
     stages (chip_smoke._v1_stage_work).

--layer-only runs 1, 2 and the 'layer' window of 4 (no 'wavefront'
plans or passes); --repo runs the voronoirt_tpu_torch package of
another checkout (its kernels built there), e.g. the parent commit
unpacked with git archive, with this checkout's helpers: run with and
without it in one call to compare two checkouts on one card.

Level steps (sweep_voronoi.LEVEL_STEPS), stage calls
(sweep_voronoi.STAGE_CALLS) and V1's launches (voronoi_level.LAUNCHES,
one a stage call) are counted per parts-timed iteration or J pass.
Prints a summary; --out also writes it as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _repo():
    """--repo's checkout, read before its package is imported."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--repo", default=ROOT)
    return os.path.abspath(ap.parse_known_args()[0].repo)


def _this_chip_smoke():
    """This checkout's chip_smoke.py as a module, whatever --repo
    names."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


sys.path.insert(0, _repo())

import torch  # noqa: E402

chip_smoke = _this_chip_smoke()
from voronoirt_tpu_torch import (Config, get_quadrature, grid,  # noqa: E402
                                 require_cuda, synthetic_atmosphere)
from voronoirt_tpu_torch.engine import VoronoiEngine, lambda_iter  # noqa: E402
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line  # noqa: E402
from voronoirt_tpu_torch.solvers import sweep_voronoi as sv  # noqa: E402
from voronoirt_tpu_torch.solvers import voronoi_level as vl  # noqa: E402

# the profiled directions: ul7n12 direction 2 is steep (|mu| 0.888),
# direction 8 grazing (|mu| 0.205)
WINDOW = (2, 8)
# V1's kernel, by the name the profiler gives its instances
V1_KERNEL = "voronoi_stage_kernel"


def _timed(fn, acc, key):
    """fn behind synchronised host timers; the seconds of each call are
    appended to acc[key]."""
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[key].append(time.perf_counter() - t)
        return out
    return wrapped


def _patches(eng, acc):
    """Timers around the parts; the eager hoist's calls are timed where
    they happen (on the card, none)."""
    return [
        mock.patch.object(eng, "_alpha_tot_T",
                          _timed(eng._alpha_tot_T, acc, "extinction")),
        mock.patch.object(lambda_iter, "sweep_voronoi_t",
                          _timed(lambda_iter.sweep_voronoi_t, acc, "sweep")),
        mock.patch.object(sv, "_precompute_lean",
                          _timed(sv._precompute_lean, acc, "hoist")),
        mock.patch.object(lambda_iter, "_update_S",
                          _timed(lambda_iter._update_S, acc, "S update")),
        mock.patch.object(lambda_iter, "_rates_and_populations",
                          _timed(lambda_iter._rates_and_populations, acc,
                                 "rates + statistical equilibrium")),
    ]


def _synced(fn):
    """Wall seconds of fn() between two synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def parts_timed(eng, fn):
    """fn() with every part behind synchronised timers.  Returns (wall
    seconds, {part: [seconds per call]}, level steps, stage calls, V1
    launches)."""
    acc = defaultdict(list)
    patches = _patches(eng, acc)
    for p in patches:
        p.start()
    try:
        sv.LEVEL_STEPS = sv.STAGE_CALLS = vl.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        for p in patches:
            p.stop()
    return wall, dict(acc), sv.LEVEL_STEPS, sv.STAGE_CALLS, vl.LAUNCHES


def summarise(wall, acc, steps, calls, launches, n_dir):
    """Per-direction and per-part seconds of one parts-timed J pass or
    iteration (the hoist, where it runs, is inside the sweep's time)."""
    ext, sweep = acc.get("extinction", []), acc.get("sweep", [])
    hoist = sum(acc.get("hoist", []))
    assert len(ext) == len(sweep) == n_dir, (len(ext), len(sweep))
    parts = {"extinction": sum(ext), "hoist": hoist,
             "level loop": sum(sweep) - hoist}
    for k in ("S update", "rates + statistical equilibrium"):
        if k in acc:
            parts[k] = sum(acc[k])
    parts["other (unwrapped)"] = wall - sum(parts.values())
    return {"wall_s": wall, "parts_s": parts, "level_steps": steps,
            "stage_calls": calls, "v1_launches": launches,
            "hoist_calls": len(acc.get("hoist", [])),
            "us_per_level_step": 1e6 * parts["level loop"] / max(steps, 1),
            "direction_s": [e + s for e, s in zip(ext, sweep)],
            "direction_extinction_s": ext, "direction_sweep_s": sweep}


def window(eng, S_T, pops, damp, lam):
    """The J work of the WINDOW directions, as compute_J does it."""
    for i in WINDOW:
        a_T = eng._alpha_tot_T(eng.quad.k[i], lam, pops, damp)
        lambda_iter.sweep_voronoi_t(eng.plans[i], S_T, a_T,
                                    eng._I0(i, lam), n_sweeps=eng.cfg.n_sweeps,
                                    relax_tol=eng.cfg.voronoi_relax_tol)
    torch.cuda.synchronize()


def lean_bytes(eng):
    """Bytes of the lean pair (A (R, 2, B), b (R, B)) of each direction's
    repeated relax stages, which the eager hoist allocated for the
    direction's sweep: (the largest direction's, the sum over them)."""
    B = eng.line.n_lambda
    esize = torch.empty((), dtype=eng.dtype).element_size()
    per_dir = []
    for plan in eng.plans:
        stages, _, _ = sv.device_plan(plan, eng.cfg.n_sweeps, eng.device,
                                      eng.dtype)
        per_dir.append(sum(3 * int(sd.off[-1]) * B * esize for sd in stages
                           if sd.kind == "relax" and sd.repeats > 1))
    return max(per_dir), sum(per_dir)


def window_bound_ms(eng):
    """V1's bytes bound (ms) and level steps of one pass over the WINDOW
    directions' stages in the formal form (chip_smoke._v1_stage_work)."""
    B = eng.line.n_lambda
    name = str(eng.dtype).split(".")[-1]
    nbytes = ops = steps = 0
    for i in WINDOW:
        stages, _, _ = sv.device_plan(eng.plans[i], eng.cfg.n_sweeps,
                                      eng.device, eng.dtype)
        for sd in stages:
            b, o = chip_smoke._v1_stage_work(sd, B,
                                             chip_smoke.ELEMENT_BYTES[name])
            nbytes, ops = nbytes + b, ops + o
            steps += (len(sd.off) - 1) * sd.passes
    ms, by = chip_smoke._bound_ms(nbytes, ops, name)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes,
            "level_steps": steps}


def profiled_window(eng, S, pops):
    """Plain wall of the window, then its kernels under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lam = eng.line.lam_tensor()
    S_T = S.T.contiguous()
    damp = eng.damping_lam(pops)
    window(eng, S_T, pops, damp, lam)           # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    window(eng, S_T, pops, damp, lam)
    wall = time.perf_counter() - t
    sv.LEVEL_STEPS = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window(eng, S_T, pops, damp, lam)
    steps = sv.LEVEL_STEPS
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((e.key, e.count, us * 1e-6))
    kernels.sort(key=lambda k: -k[2])
    busy = sum(k[2] for k in kernels)
    v1 = [k for k in kernels if V1_KERNEL in k[0]]
    v1_s, v1_n = sum(k[2] for k in v1), sum(k[1] for k in v1)
    return {"directions": list(WINDOW), "plain_wall_s": wall,
            "kernels_device_s": busy, "busy_share": busy / wall,
            "v1_device_s": v1_s, "v1_launches": v1_n, "level_steps": steps,
            "v1_device_us_a_launch": 1e6 * v1_s / max(v1_n, 1),
            "v1_device_us_a_step": 1e6 * v1_s / max(steps, 1),
            "kernels": kernels[:25]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-sites", type=int, default=3_522_560)
    ap.add_argument("--layer-only", action="store_true",
                    help="no 'wavefront' plans or passes")
    ap.add_argument("--repeat", type=int, default=1,
                    help="plain 'layer' iterations after the parts-timed one")
    ap.add_argument("--repo", default=ROOT,
                    help="the checkout whose package runs")
    ap.add_argument("--out", default=None, help="write the summary as JSON")
    args = ap.parse_args()
    require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    if grid.build_native() is None:
        raise SystemExit("native tessellation library not built")

    setup = {}
    atmos = synthetic_atmosphere(nz=215, nx=256, ny=256)
    t = time.perf_counter()
    pos = grid.sample_sites(atmos, args.n_sites, density="invNH_invT",
                            seed=2022)
    setup["sampling"] = time.perf_counter() - t
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    t = time.perf_counter()
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    setup["tessellation"] = time.perf_counter() - t
    del atmos, pos
    orders = ("layer",) if args.layer_only else ("layer", "wavefront")
    cfgs = {order: Config(nlam_bb=51, nlam_bf=20, quadrature="ul7n12",
                          voronoi_order=order, maxiter=1, eps=0.0)
            for order in orders}
    quad = get_quadrature("ul7n12")
    plans = {}
    for order, cfg in cfgs.items():
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # 'layer' at grazing angles
            plans[order] = VoronoiEngine.build_plans(sites, quad, cfg)
        setup[f"plans ({order})"] = time.perf_counter() - t
    t = time.perf_counter()
    T = torch.as_tensor(sites.temperature, dtype=torch.float64,
                        device="cuda")
    line = lyman_alpha_line(51, 20, T)
    eng = VoronoiEngine(sites, line, cfgs["layer"], plans=plans["layer"],
                        device="cuda")
    torch.cuda.synchronize()
    setup["engine set-up"] = time.perf_counter() - t
    n_dir = quad.n_angles
    print(f"{args.repo}: {sites.n} sites, {line.n_lambda} wavelengths, "
          f"{n_dir} directions; set-up s {json.dumps(setup)}", flush=True)

    out = {"device": smi, "repo": os.path.abspath(args.repo),
           "n_sites": sites.n, "setup_s": setup}
    torch.cuda.reset_peak_memory_stats()
    out["layer_iteration_cold_s"] = eng.run().timings[0]
    res = None

    def iterate():
        nonlocal res
        res = eng.run()

    out["layer_iteration_parts_timed"] = summarise(
        *parts_timed(eng, iterate), n_dir)
    runs = []
    for _ in range(args.repeat):
        res = eng.run()
        runs.append(res.timings[0])
    out["layer_iteration_plain_runs_s"] = runs
    out["layer_iteration_plain_s"] = statistics.median(runs)
    S, pops = res.S, res.populations
    if not (bool(torch.isfinite(S).all())
            and bool(torch.isfinite(pops).all())):
        raise SystemExit("S or populations not finite")
    del res
    out["layer_window"] = profiled_window(eng, S, pops)
    out["layer_window"]["bound"] = window_bound_ms(eng)
    if args.layer_only:
        out["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        report(out, line, n_dir, ("layer_iteration_parts_timed",),
               ("layer_window",))
        _write(out, args.out)
        return

    eng_w = VoronoiEngine(sites, line, cfgs["wavefront"],
                          plans=plans["wavefront"], device="cuda")
    out["lean_pair_bytes_max_direction"], out["lean_pair_bytes_sum"] = \
        lean_bytes(eng_w)
    damp = eng_w.damping_lam(pops)
    out["wavefront_J_cold_s"] = _synced(
        lambda: eng_w.compute_J(S, pops, damp))
    out["wavefront_J_parts_timed"] = summarise(
        *parts_timed(eng_w, lambda: eng_w.compute_J(S, pops, damp)), n_dir)
    J = []
    out["wavefront_J_plain_s"] = _synced(
        lambda: J.append(eng_w.compute_J(S, pops, damp)))
    if not bool(torch.isfinite(J[0]).all()):
        raise SystemExit("wavefront J not finite")
    del J
    out["wavefront_window"] = profiled_window(eng_w, S, pops)
    out["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30

    report(out, line, n_dir, ("layer_iteration_parts_timed",
                              "wavefront_J_parts_timed"),
           ("layer_window", "wavefront_window"))
    _write(out, args.out)


def _write(out, path):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


def report(out, line, n_dir, timed, windows):
    """Print the summary of the parts-timed runs `timed` and the
    profiled `windows`."""
    rays = out["n_sites"] * line.n_lambda * n_dir
    for key in timed:
        r = out[key]
        print(f"{key}: {r['wall_s']:.4f} s, {r['level_steps']} level "
              f"steps, {r['stage_calls']} stage calls, {r['v1_launches']} "
              f"V1 launches, {r['us_per_level_step']:.2f} us per level "
              f"step; the eager relax hoist ran {r['hoist_calls']} times",
              flush=True)
        for k, v in sorted(r["parts_s"].items(), key=lambda kv: -kv[1]):
            print(f"  {k:32s} {v:9.4f} s  {100 * v / r['wall_s']:5.1f} %",
                  flush=True)
        print(f"  seconds per direction "
              f"{[round(x, 4) for x in r['direction_s']]}", flush=True)
    print(f"layer iteration: first {out['layer_iteration_cold_s']:.4f} s,"
          f" plain {out['layer_iteration_plain_s']:.4f} s (median of "
          f"{[round(x, 4) for x in out['layer_iteration_plain_runs_s']]})",
          flush=True)
    if "wavefront_J_plain_s" in out:
        print(f"wavefront J pass: first {out['wavefront_J_cold_s']:.4f} s, "
              f"plain {out['wavefront_J_plain_s']:.4f} s, "
              f"{rays / out['wavefront_J_plain_s']:.4e} "
              f"sites*wavelengths*rays/s", flush=True)
    for key in windows:
        w = out[key]
        print(f"{key} (directions {w['directions']}): plain "
              f"{w['plain_wall_s']:.4f} s, kernels' device time "
              f"{w['kernels_device_s']:.4f} s = {100 * w['busy_share']:.1f} %"
              f" busy; V1 {w['v1_device_s']:.4f} s of device time in "
              f"{w['v1_launches']} launches, {w['level_steps']} level steps: "
              f"{w['v1_device_us_a_launch']:.2f} us a launch, "
              f"{w['v1_device_us_a_step']:.3f} us a step", flush=True)
        if "bound" in w:
            b = w["bound"]
            print(f"  V1's {b['bound_by']} bound on the window's stages: "
                  f"{b['bound_ms']:.4f} ms ({b['bytes'] / 1e9:.4f} GB), "
                  f"{1e3 * b['bound_ms'] / b['level_steps']:.3f} us a level "
                  f"step", flush=True)
        for name, count, s in w["kernels"][:10]:
            print(f"  {s:9.4f} s  {count:7d} x  {name[:90]}", flush=True)
    if "lean_pair_bytes_sum" in out:
        print(f"the lean pair, no longer allocated on the card: "
              f"{out['lean_pair_bytes_max_direction'] / 2**30:.3f} GiB for "
              f"the largest direction, "
              f"{out['lean_pair_bytes_sum'] / 2**30:.3f} GiB over the "
              f"{n_dir} directions", flush=True)
    print(f"peak device memory {out['peak_GiB']:.3f} GiB", flush=True)


if __name__ == "__main__":
    main()
