#!/usr/bin/env python3
"""Where the time of the port's production Lambda iteration goes, on one
CUDA card.

    python3 tools/profile_iteration.py [--nz 215] [--dtype float32]
                                       [--iteration-only]
                                       [--interpolation bezier]
                                       [--repo DIR] [--out profile.json]

Builds the configuration of chip_smoke.py phase 5 (215x256x256 grid, 91
wavelengths, ul7n12, float64, lambda-streamed, lambda_chunk 13, 4-angle
groups; --dtype float32 makes it phase 15's, the JAX package's --f32)
and runs three iterations of RegularEngine.iterate_streamed, the step
RegularEngine.run() repeats:

  1. parts timed: host timers around synchronised calls of each part
     (the extinction's alpha_tot_group wrapper -- a mirror group's stack
     a launch -- and its per-direction alpha_tot, each group sweep by
     plane-cut case, rate accumulation (R1 a chunk), S update (S1 a
     chunk), statistical equilibrium);
  2. plain: the iteration's wall seconds, as run() times it;
  3. profiled under torch.profiler: the kernels' summed device time
     against the plain iteration's wall gives the device's busy share;
     the kernels are listed by device time, and the extinction's kernels,
     the J emit's (G1 group_emit, G2 group_stack, G3 group_fold), the
     rates' and S update's (R1 rates_chunk, S1 s_update: their device
     time beside the least time an iteration's launches could take,
     chip_smoke.py's bound of each launch on this run's inputs) and what
     is left of the eager flips, adds, multiplies and stack copies
     (torch.cat) are summed apart.

Then (unless --iteration-only) K1 both ways at the production shape in
the iteration's dtype: a
214-plane xy segment (B = 52, 256x256) through xy_segment, in the
sweep's pieces, against a loop of the per-plane kernel xy_plane on the
same inputs (tools/profile_xy_segment.py's measure), timed in the order
A B B A, ms a step, bit-equal.  Then
the per-plane kernels at the production plane shape (B = 52, 256x256),
float64, built as the package builds them (-fmad=false) and with
multiply-add contraction (-fmad=true), timed in the order A B B A, with
each variant's largest relative difference from the plain version in
float64 and float32.

With --interpolation bezier it profiles chip_smoke.py phase 8's
iteration instead: the standard (not streamed) loop of
RegularEngine.run() with formal_interpolation='bezier', one sweep an
angle at B = lambda_chunk, the rates in slabs of
chip_smoke.BEZIER_RATES_PLANES z-planes.  Three runs of one iteration
each: parts timed (host timers around synchronised calls: the
extinction a direction, the sweeps with their Bezier xy segments --
X1 a segment, X1 a plane in revisions before it, or the
eager step before that -- apart from the
rest of each sweep (K2's marching segments, the emit), the per-angle J
accumulation, the rates and statistical equilibrium in slabs (R1 a
slab), the S update and the criterion), plain, and profiled (the
kernels by device time, X1, K2, E1 and R1 summed apart, and the
device's busy share against the plain run's iteration seconds), and
the sha256 of the profiled run's S and populations: equal digests from
two checkouts, bit-equal iterations.

--repo DIR profiles the voronoirt_tpu_torch package of another checkout
(its kernels built there), e.g. the parent commit unpacked with git
archive; the helpers (chip_smoke.py, this directory's modules) are
always this checkout's, so two revisions are measured by the same code
in one call.

Prints a summary; --out also writes it as JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (this checkout's; imports no package)

# --repo: the checkout whose package is profiled goes first on the path
# before the package is imported
_pre = argparse.ArgumentParser(add_help=False)
_pre.add_argument("--repo", default=HERE)
REPO = os.path.abspath(_pre.parse_known_args()[0].repo)
sys.path.insert(0, REPO)

from voronoirt_tpu_torch import Config, require_cuda, synthetic_atmosphere  # noqa: E402
from voronoirt_tpu_torch.engine import RegularEngine  # noqa: E402
from voronoirt_tpu_torch.engine import lambda_iter  # noqa: E402
from voronoirt_tpu_torch.kernels import build  # noqa: E402
from voronoirt_tpu_torch.physics import rates  # noqa: E402
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line  # noqa: E402
from voronoirt_tpu_torch.solvers import sweep_regular  # noqa: E402
from voronoirt_tpu_torch.solvers import march_plane as mp  # noqa: E402
from voronoirt_tpu_torch.solvers import xy_plane as xp  # noqa: E402
from profile_xy_segment import measure as k1_segment_vs_plane  # noqa: E402


def _timed(fn, key, acc):
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[key(*args) if callable(key) else key] += time.perf_counter() - t
        return out
    return wrapped


def _case(plans, *_):
    return "sweep " + "+".join(sorted({s.case for s in plans[0].segments}))


def parts_timed(eng, S, pops):
    """One iteration with every part behind synchronised host timers."""
    acc = defaultdict(float)
    patches = [
        mock.patch.object(lambda_iter, "alpha_tot_group",
                          _timed(lambda_iter.alpha_tot_group,
                                 "extinction (alpha_tot_group)", acc)),
        mock.patch.object(lambda_iter, "alpha_tot",
                          _timed(lambda_iter.alpha_tot,
                                 "extinction (alpha_tot)", acc)),
        mock.patch.object(lambda_iter, "sweep_group_J",
                          _timed(lambda_iter.sweep_group_J, _case, acc)),
        mock.patch.object(lambda_iter, "sweep_group_J_stack",
                          _timed(lambda_iter.sweep_group_J_stack, _case,
                                 acc)),
        mock.patch.object(lambda_iter, "sweep",
                          _timed(lambda_iter.sweep, "sweep single", acc)),
        mock.patch.object(lambda_iter, "_rates_accum",
                          _timed(lambda_iter._rates_accum, "rates", acc)),
        mock.patch.object(lambda_iter, "_s_update_stream",
                          _timed(lambda_iter._s_update_stream, "S update",
                                 acc)),
        mock.patch.object(lambda_iter, "get_revised_populations",
                          _timed(lambda_iter.get_revised_populations,
                                 "statistical equilibrium", acc)),
    ]
    for p in patches:
        p.start()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        S, pops, _ = eng.iterate_streamed(S, pops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        for p in patches:
            p.stop()
    acc["other (unwrapped)"] = wall - sum(acc.values())
    return S, pops, wall, dict(acc)


def plain(eng, S, pops):
    torch.cuda.synchronize()
    t = time.perf_counter()
    S, pops, _ = eng.iterate_streamed(S, pops)
    torch.cuda.synchronize()
    return S, pops, time.perf_counter() - t


def profiled(eng, S, pops):
    """One iteration under torch.profiler; the device kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        S, pops, _ = eng.iterate_streamed(S, pops)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((e.key, e.count, us * 1e-6))
    kernels.sort(key=lambda k: -k[2])
    return S, pops, kernels


# the kernels summed apart, by a pattern of their name (mangled or
# demangled): E1 (the alpha_tot_kernel instance for a group and the one
# for a direction), E2, the J emit's G1-G3, and PyTorch's flip, add,
# multiply and cat, which made the J emit and the group stacks before
# G1-G3 (the split grid's extinction stack is still a cat)
NAMED = {"alpha_tot_group (E1, a group)":
         r"alpha_tot_kernel(I.Lb1|<\w+, true>)",
         "alpha_tot (E1, a direction)":
         r"alpha_tot_kernel(I.Lb0|<\w+, false>)",
         "voigt_rows (E2)": r"voigt_rows_kernel",
         "group_emit (G1)": r"group_emit_kernel",
         "group_stack (G2)": r"group_stack_kernel",
         "group_fold (G3)": r"group_fold_kernel",
         "rates_chunk (R1)": r"rates_chunk_kernel",
         "s_update (S1)": r"s_update_kernel",
         "flip (left)": r"flip",
         "add (left)": r"CUDAFunctor_add|AddFunctor",
         "mul (left)": r"MulFunctor",
         "cat (stack copies)": r"CatArrayBatchedCopy"}


def named_kernels(kernels):
    """{label: (launches, device seconds)} of NAMED's kernels in a
    profiled iteration's list."""
    import re
    out = {}
    for label, pat in NAMED.items():
        hits = [(c, s) for name, c, s in kernels if re.search(pat, name)]
        out[label] = (sum(c for c, _ in hits), sum(s for _, s in hits))
    return out


def rates_bound(eng, pops):
    """The least time (s) an iteration's R1 and S1 launches could take
    on these inputs: chip_smoke.py's bound of each launch (bytes, and the
    operations of each bound-bound point's Humlicek region), summed over
    the lambda chunks."""
    dtype_name = str(eng.dtype).replace("torch.", "")
    F = {"line": eng.line, "T": eng.T, "g": eng._gamma_cell(pops)}
    n, chunk = eng.line.n_lambda, eng.cfg.lambda_chunk
    acc, r1, s1 = {}, 0.0, 0.0
    for ci, sl in enumerate(lambda_iter._lambda_chunks(n, chunk)):
        r0, n_rows = sl.start - (ci > 0), sl.stop - sl.start + (ci > 0)
        r1 += chip_smoke._bound_ms(*chip_smoke._rates_work(F, r0, n_rows,
                                                           acc),
                                   dtype_name)[0]
        for kind, _, _, _ in rates._chunk_windows(eng.line, r0, n_rows):
            acc.update(dict.fromkeys(rates._RATE_KEYS[kind]))
        s1 += chip_smoke._bound_ms(*chip_smoke._s_update_work(
            F, sl.stop - sl.start), dtype_name)[0]
    return r1 / 1e3, s1 / 1e3


# phase 8's Bezier iteration: its kernels summed apart, by a pattern of
# their name, and what is left of the eager tensor operations (the
# plain Bezier xy step in revisions before X1; the J accumulation, the S
# update and the criterion in every revision)
NAMED_BEZIER = {"xy_bezier_segment (X1 a segment)":
                r"xy_bezier_segment_kernel",
                "xy_bezier (X1 a plane)": r"xy_bezier_kernel",
                "march_coeffs (K2a)": r"march_coeffs_kernel",
                "march_chain (K2b)": r"march_chain_kernel",
                "alpha_tot (E1, a direction)":
                r"alpha_tot_kernel(I.Lb0|<\w+, false>)",
                "rates_chunk (R1)": r"rates_chunk_kernel",
                "roll (left)": r"roll",
                "add (left)": r"CUDAFunctor_add|AddFunctor",
                "mul (left)": r"MulFunctor",
                "div (left)": r"DivFunctor|div_true",
                "where (left)": r"where"}


def bezier_parts_timed(eng):
    """One Bezier iteration (eng.run(), maxiter 1) with every part behind
    synchronised host timers; the Bezier xy segments are timed inside
    the sweeps and taken out of them."""
    from voronoirt_tpu_torch.parallel import angles
    acc = defaultdict(float)
    wraps = [(lambda_iter, "alpha_tot", "extinction (alpha_tot)"),
             (lambda_iter, "sweep", "sweeps"),
             (sweep_regular, "_xy_segment_bezier",
              "sweeps: Bezier xy segments"),
             (angles, "partial_accumulate", "J accumulation (per angle)"),
             (lambda_iter, "_rates_and_populations_slabbed",
              "rates and statistical equilibrium (slabs)"),
             (lambda_iter, "_update_S", "S update"),
             (lambda_iter, "_criterion", "criterion")]
    patches = [mock.patch.object(mod, name,
                                 _timed(getattr(mod, name), label, acc))
               for mod, name, label in wraps]
    for p in patches:
        p.start()
    try:
        res = eng.run()
    finally:
        for p in patches:
            p.stop()
    acc["sweeps"] -= acc["sweeps: Bezier xy segments"]
    acc = {("sweeps: the rest (K2, emit)" if k == "sweeps" else k): v
           for k, v in acc.items()}
    # the criterion runs at the loop heads, outside the timed iteration
    wall = res.timings[0]
    acc["other (unwrapped)"] = wall - sum(v for k, v in acc.items()
                                          if k != "criterion")
    return res, wall, acc


def bezier_profile(args, smi):
    """chip_smoke.py phase 8's Bezier iteration: parts timed, plain and
    profiled, one run of one iteration each."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p = chip_smoke.PROD
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], formal_interpolation="bezier",
                 lambda_chunk=args.lambda_chunk,
                 rates_site_chunk=chip_smoke.BEZIER_RATES_PLANES, maxiter=1,
                 eps=0.0, dtype=args.dtype)
    dtype = getattr(torch, args.dtype)
    atmos = synthetic_atmosphere(nz=args.nz, nx=p["nx"], ny=p["ny"])
    T = torch.as_tensor(atmos.temperature, dtype=dtype, device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    build.library()
    eng = RegularEngine(atmos, line, cfg, device="cuda")
    n_xy = sum(len(s.steps) for pl in eng.plans for s in pl.segments
               if s.case == "xy")
    n_chunks = -(-line.n_lambda // cfg.lambda_chunk)

    res, wall1, parts = bezier_parts_timed(eng)
    print(f"iteration 1 (Bezier, parts timed, {args.dtype}, {REPO}): "
          f"{wall1:.4f} s; {n_xy * n_chunks} Bezier xy plane steps", flush=True)
    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {k:42s} {v:9.4f} s  {100 * v / wall1:5.1f} %", flush=True)
    del res
    torch.cuda.synchronize()
    res = eng.run()
    wall2 = res.timings[0]
    print(f"iteration 2 (plain): {wall2:.4f} s", flush=True)
    del res
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = eng.run()
        torch.cuda.synchronize()
    finite = bool(torch.isfinite(res.S).all()) and bool(
        torch.isfinite(res.populations).all())
    d_S, d_P = chip_smoke.state_digest(res.S, res.populations)
    del res
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
    n_ops = sum(k[1] for k in kernels)
    print(f"iteration 3 (profiled): kernels' device time {busy:.4f} s = "
          f"{100 * busy / wall2:.1f} % of the plain iteration's "
          f"{wall2:.4f} s; {n_ops} device operations", flush=True)
    for name, count, sec in kernels[:15]:
        print(f"  {sec:9.4f} s  {count:7d} x  {name[:90]}", flush=True)
    named = {}
    for label, pat in NAMED_BEZIER.items():
        hits = [(c, sec) for name, c, sec in kernels if re.search(pat, name)]
        named[label] = (sum(c for c, _ in hits), sum(sec for _, sec in hits))
        print(f"  {label}: {named[label][0]} launches, "
              f"{named[label][1]:.4f} s of device time", flush=True)
    print(f"S, populations finite: {finite}; sha256 of S {d_S}, of the "
          f"populations {d_P}", flush=True)
    summary = {"device": smi, "repo": REPO, "interpolation": "bezier",
               "nz": args.nz, "dtype": args.dtype,
               "lambda_chunk": cfg.lambda_chunk, "n_chunks": n_chunks,
               "bezier_xy_steps": n_xy * n_chunks,
               "iteration_parts_timed_s": wall1, "parts_s": parts,
               "iteration_plain_s": wall2, "kernels_device_s": busy,
               "busy_share": busy / wall2, "device_operations": n_ops,
               "kernels": kernels[:40], "named_kernels": named,
               "finite": finite, "sha256_S": d_S, "sha256_populations": d_P}
    _write(args.out, summary)
    if not finite:
        raise SystemExit("S or populations not finite")


def _rand_planes(B, nx, ny, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def u(shape, lo, hi, log=False):
        v = lo + (hi - lo) * torch.rand(shape, generator=g,
                                        dtype=torch.float64)
        return (10.0 ** v if log else v).to(dtype=dtype, device="cuda")
    planes = (u((B, nx, ny), -5, 2, True), u((B, nx, ny), -5, 2, True),
              u((B, nx, ny), 0.1, 1), u((B, nx, ny), 0.1, 1),
              u((B, nx, ny), 0, 1))
    r = u((B,), -1, 1, True)
    f1, f2 = u((B,), 0, 1), u((B,), 0, 1)
    c_prev = (torch.arange(B, device="cuda") % 2).to(dtype)
    return planes, r, f1, f2, c_prev


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def fmad_variants(B, nx, ny):
    """Kernel times and largest relative difference from the plain
    version, built with and without multiply-add contraction."""
    flags = {"fmad=false": build.NVCC_FLAGS,
             "fmad=true": tuple("-fmad=true" if f == "-fmad=false" else f
                                for f in build.NVCC_FLAGS)}
    suffix = {torch.float64: "_f64", torch.float32: "_f32"}
    libs = {name: build.library(f) for name, f in flags.items()}

    def use(name):
        lib = libs[name]
        return mock.patch.object(
            build, "launch_fn",
            lambda fn_name, dtype: getattr(lib, fn_name + suffix[dtype]))

    calls = {
        "xy_plane": lambda p, r, f1, f2, cp: xp.xy_plane(*p, r, f1, f2, -1, 0),
        "march_plane x": lambda p, r, f1, f2, cp: mp.march_plane(
            *p, r, f1, f2, cp, march_axis="x", sign=-1, s_base=-1,
            n_sweeps=3),
        "march_plane y": lambda p, r, f1, f2, cp: mp.march_plane(
            *p, r, f1, f2, cp, march_axis="y", sign=-1, s_base=-1,
            n_sweeps=3),
    }
    plain_calls = {
        "xy_plane": lambda p, r, f1, f2, cp: xp.xy_plane_plain(
            *p, r, f1, f2, -1, 0),
        "march_plane x": lambda p, r, f1, f2, cp: mp.march_plane_plain(
            *p, r, f1, f2, cp, march_axis="x", sign=-1, s_base=-1,
            n_sweeps=3),
        "march_plane y": lambda p, r, f1, f2, cp: mp.march_plane_plain(
            *p, r, f1, f2, cp, march_axis="y", sign=-1, s_base=-1,
            n_sweeps=3),
    }
    out = {}
    args64 = _rand_planes(B, nx, ny, torch.float64, 11)
    for kname, call in calls.items():
        reps = 50 if kname == "xy_plane" else 10
        times = defaultdict(list)
        for vname in ("fmad=false", "fmad=true", "fmad=true", "fmad=false"):
            with use(vname):
                times[vname].append(_ms(lambda: call(*args64), reps))
        rel = {}
        for dtype in (torch.float64, torch.float32):
            args = _rand_planes(B, nx, ny, dtype, 12)
            want = plain_calls[kname](*args)
            for vname in flags:
                with use(vname):
                    got = call(*args)
                rel[f"{vname} {str(dtype)[6:]}"] = float(
                    ((got - want).abs() / want.abs()).max())
        out[kname] = {"ms": dict(times), "max_rel_vs_plain": rel}
    return out


def _write(path, summary):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=215)
    ap.add_argument("--lambda-chunk", type=int, default=13)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--iteration-only", action="store_true",
                    help="profile the iteration only, not K1 and the "
                         "-fmad variants")
    ap.add_argument("--interpolation", default="linear",
                    choices=("linear", "bezier"),
                    help="bezier: profile chip_smoke.py phase 8's standard-"
                         "loop Bezier iteration instead")
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package is profiled")
    ap.add_argument("--out", default=None, help="write the summary as JSON")
    args = ap.parse_args()
    require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    if args.interpolation == "bezier":
        bezier_profile(args, smi)
        return

    cfg = Config(nlam_bb=51, nlam_bf=20, quadrature="ul7n12",
                 stream_rates=True, lambda_chunk=args.lambda_chunk,
                 group_max_angles=4, eps=0.0, dtype=args.dtype)
    dtype = getattr(torch, args.dtype)
    atmos = synthetic_atmosphere(nz=args.nz, nx=256, ny=256)
    T = torch.as_tensor(atmos.temperature, dtype=dtype, device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    eng = RegularEngine(atmos, line, cfg, device="cuda")
    build.library()
    S, pops = eng.B0, eng.lte
    eng.B0 = None       # S is the iteration state, updated in place
    n_chunks = -(-line.n_lambda // cfg.lambda_chunk)

    S, pops, wall1, parts = parts_timed(eng, S, pops)
    print(f"iteration 1 (parts timed, {args.dtype}): {wall1:.4f} s over "
          f"{n_chunks} chunks", flush=True)
    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {k:26s} {v:9.4f} s/iteration  {v / n_chunks:8.4f} "
              f"s/chunk  {100 * v / wall1:5.1f} %", flush=True)
    S, pops, wall2 = plain(eng, S, pops)
    print(f"iteration 2 (plain): {wall2:.4f} s", flush=True)
    S, pops, kernels = profiled(eng, S, pops)
    busy = sum(k[2] for k in kernels)
    n_launches = sum(k[1] for k in kernels)
    print(f"iteration 3 (profiled): kernels' device time {busy:.4f} s = "
          f"{100 * busy / wall2:.1f} % of the plain iteration's wall; "
          f"{n_launches} device operations (kernels, copies, fills)",
          flush=True)
    for name, count, s in kernels[:15]:
        print(f"  {s:9.4f} s  {count:7d} x  {name[:90]}", flush=True)
    named = named_kernels(kernels)
    for what, (count, s) in named.items():
        print(f"  {what}: {count} launches, {s:.4f} s of device time",
              flush=True)
    b_r1, b_s1 = rates_bound(eng, pops)
    d_rs = named["rates_chunk (R1)"][1] + named["s_update (S1)"][1]
    print(f"  the rates and S update (R1 + S1): {d_rs:.4f} s of device "
          f"time; bound {b_r1 + b_s1:.4f} s (R1 {b_r1:.4f}, S1 {b_s1:.4f}):"
          f" {100 * (b_r1 + b_s1) / d_rs:.1f} % of it", flush=True)
    require_finite = bool(torch.isfinite(S).all()) and bool(
        torch.isfinite(pops).all())
    print(f"S, populations finite: {require_finite}", flush=True)
    del S, pops, eng
    torch.cuda.empty_cache()
    summary = {"device": smi, "nz": args.nz, "dtype": args.dtype,
               "lambda_chunk": cfg.lambda_chunk, "n_chunks": n_chunks,
               "iteration_parts_timed_s": wall1, "parts_s": parts,
               "iteration_plain_s": wall2, "kernels_device_s": busy,
               "device_operations": n_launches, "kernels": kernels[:40],
               "named_kernels": named, "rates_s_update_device_s": d_rs,
               "rates_bound_s": b_r1, "s_update_bound_s": b_s1,
               "finite": require_finite}
    if args.iteration_only:
        _write(args.out, summary)
        if not require_finite:
            raise SystemExit("S or populations not finite")
        return

    B = 4 * cfg.lambda_chunk
    k1 = k1_segment_vs_plane(B, dtype, {})
    print(f"K1 over a 214-plane xy segment at (B={B}, 256x256), "
          f"{args.dtype}, ms a step (xy_segment in the sweep's pieces, a "
          f"loop of xy_plane; in the order A B B A): {json.dumps(k1)}",
          flush=True)
    variants = fmad_variants(B, 256, 256)
    print(f"kernels at (B={B}, 256x256), float64 ms in the order "
          f"fmad=false, fmad=true, fmad=true, fmad=false:", flush=True)
    for kname, v in variants.items():
        print(f"  {kname}: {json.dumps(v)}", flush=True)

    summary.update(k1_segment_vs_plane=k1, fmad_variants=variants)
    _write(args.out, summary)
    if not require_finite:
        raise SystemExit("S or populations not finite")
    if not k1["kernel_equals_per_plane"]:
        raise SystemExit("xy_segment differs from the per-plane kernel")


if __name__ == "__main__":
    main()
