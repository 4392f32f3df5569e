#!/usr/bin/env python3
"""The Bezier paths end to end on one CUDA card, host clock, with the
package of a given checkout: what a user of each path waits for,
whichever kernel route the checkout's sweep takes for its Bezier xy
segments.

    python3 tools/time_bezier_route.py [--repo DIR] [--batches 1,4,8,13]
                                       [--reps 5] [--out route.json]

  1. sweep: one Bezier `sweep` of an xy-only ul7n12 direction (one
     214-step xy segment) on the 215x256x256 grid of chip_smoke.py's
     phase 5, float64, at each B of --batches (fields made on the card
     from a seed);
  2. J pass: chip_smoke.py phase 9's Bezier J pass (24x32x32, 11
     wavelengths, lambda_chunk 4, ul7n12), serial and with its angles
     dealt over two slots of the card;
  3. line_nlte: `line_nlte --interpolation bezier --maxiter 3` at its
     defaults (32x16x16, 71 wavelengths in one batch), chip_smoke.py
     phase 11's run, the whole driver as a user calls it, and one J pass
     of its engine.

Each is run once to warm up, then --reps times between
torch.cuda.synchronize() calls; it prints every run's seconds, their
median, the launches of the Bezier xy kernels (xy_bezier a plane,
xy_bezier_segment where the checkout has it) in one run and the sha256
of one run's result (equal digests from two checkouts: the same
result bit for bit).  With --repo the voronoirt_tpu_torch package (and
its kernels, built there) is that checkout's, e.g. the parent commit
unpacked under build/; the helpers (chip_smoke.py) are always this
checkout's.  Run checkouts in turns in one call (A B B A) to compare
them on one card.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where the paths run (a CPU dry run of the script sets it to "cpu")
DEVICE = "cuda"


def _digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _launches():
    """Launches of the Bezier xy kernels so far in the package."""
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    n = {"xy_bezier": xb.LAUNCHES}
    try:
        from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs
        n["xy_bezier_segment"] = xbs.LAUNCHES
    except ImportError:
        pass
    return n


def _timed(fn, reps):
    """(seconds of each of reps runs, launches of one run, the result of
    the last) after one warm-up run."""
    import torch
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    fn()
    sync()
    secs = []
    for i in range(reps):
        n0 = _launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            n = {k: v - n0[k] for k, v in _launches().items()}
    return secs, n, out


def _report(name, secs, n, digest, results):
    med = statistics.median(secs)
    print(f"  {name}: median {med:.6f} s of {[round(s, 6) for s in secs]}; "
          f"launches {n}; sha256 {digest[:16]}", flush=True)
    results[name] = {"seconds": secs, "median_s": med, "launches": n,
                     "sha256": digest}


def time_sweeps(batches, reps, results):
    import numpy as np
    import torch
    from voronoirt_tpu_torch import get_quadrature, synthetic_atmosphere
    from voronoirt_tpu_torch.solvers import sweep_regular as sr
    cs = sys.modules["chip_smoke"]
    p = cs.PROD
    atmos = synthetic_atmosphere(nz=p["nz"], nx=p["nx"], ny=p["ny"])
    quad = get_quadrature(p["quadrature"])
    z = np.asarray(atmos.z)
    for i in range(quad.n_angles):
        plan = sr.build_plan(quad.k[i], z, atmos.dx, atmos.dy,
                             bool(quad.is_up[i]))
        if [s.case for s in plan.segments] == ["xy"]:
            break
    else:
        raise SystemExit("no xy-only direction on the grid")
    print(f"  direction {i} (k {np.round(quad.k[i], 4).tolist()}): one xy "
          f"segment of {len(plan.segments[0].steps)} steps", flush=True)
    for B in batches:
        gen = torch.Generator(device=DEVICE).manual_seed(B)
        u = lambda *s: torch.rand(*s, generator=gen, device=DEVICE,
                                  dtype=torch.float64)
        shape = (p["nz"], B, p["nx"], p["ny"])
        alpha, S = 10.0 ** (-1.0 + 3.0 * u(*shape)), 0.1 + 0.9 * u(*shape)
        I0 = u(*shape[1:])
        secs, n, out = _timed(lambda: sr.sweep(plan, S, alpha, I0,
                                               interpolation="bezier"), reps)
        _report(f"sweep B={B}", secs, n, _digest(out), results)
        del alpha, S, I0, out


def time_j_pass(reps, results):
    import torch
    from voronoirt_tpu_torch import synthetic_atmosphere
    from voronoirt_tpu_torch.parallel import distribute_angles
    cs = sys.modules["chip_smoke"]
    atmos = synthetic_atmosphere(nz=24, nx=32, ny=32)
    kw = dict(quadrature="ul7n12", lambda_chunk=4,
              formal_interpolation="bezier")
    serial = cs._small_line_engine(atmos, DEVICE, **kw)
    secs, n, J = _timed(lambda: serial.compute_J(serial.B0, serial.lte),
                        reps)
    _report("J pass serial", secs, n, _digest(J), results)
    two = [torch.device(DEVICE, 0) if DEVICE == "cuda" else
           torch.device(DEVICE)] * 2
    eng = distribute_angles(cs._small_line_engine(atmos, DEVICE, **kw), two)
    secs, n, J = _timed(lambda: eng.compute_J(eng.B0, eng.lte), reps)
    _report("J pass two slots", secs, n, _digest(J), results)


def time_line_nlte(reps, results):
    from voronoirt_tpu_torch.drivers import line_nlte
    from voronoirt_tpu_torch.engine import RegularEngine
    argv = ["--interpolation", "bezier", "--maxiter", "3"] + (
        [] if DEVICE == "cuda" else ["--device", DEVICE])
    engines = []
    init = RegularEngine.__init__

    def keeping(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return line_nlte.main(argv)

    RegularEngine.__init__ = keeping
    try:
        secs, n, summary = _timed(run, reps)
    finally:
        RegularEngine.__init__ = init
    _report("line_nlte", secs, n,
            hashlib.sha256(json.dumps(summary, sort_keys=True,
                                      default=str).encode()).hexdigest(),
            results)
    eng = engines[-1]
    secs, n, J = _timed(lambda: eng.compute_J(eng.B0, eng.lte), reps)
    _report("line_nlte J pass", secs, n, _digest(J), results)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package is timed")
    ap.add_argument("--batches", default="1,4,8,13")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    sys.path.insert(0, repo)
    from voronoirt_tpu_torch import require_cuda
    from voronoirt_tpu_torch.kernels import build
    require_cuda()
    smi = cs.smi_line()
    print(smi, flush=True)
    build.library()
    print(f"{repo}:", flush=True)
    results = {}
    time_sweeps([int(b) for b in args.batches.split(",")], args.reps,
                results)
    time_j_pass(args.reps, results)
    time_line_nlte(args.reps, results)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"repo": repo, "card": smi, "results": results}, f,
                      indent=1)


if __name__ == "__main__":
    main()
