#!/usr/bin/env python3
"""V1's level step at the production sites, timed with the package of a
given checkout, on one CUDA card.

    python3 tools/time_v1.py [--repo DIR] [--out FILE]

Builds chip_smoke.py phase 7's 442,368 sites (VOR_SITES, sampled from
the production atmosphere), ul7n12 direction 8's 'layer'-order plan (one
gs stage) and the same plan without its gs schedule (a 'layer' stage,
three Jacobi passes a level, every level reading its own rows), and
times a level step of each through `voronoi_level.voronoi_stage` with
CUDA events (chip_smoke._v1_time: the stage's launches over its level
steps) at B = 91 in float64 and float32 and at B = 1 in float64, beside
the bytes bound (chip_smoke._v1_stage_work); then a hoisted relax lap
with its change on the relax stage of direction 8's 'wavefront' plan at
each (B, dtype) of RELAX_CASES: the lap's ms a level step and its mean
items (row, wavelength) a step, and, where the package precomputes the
lean weights on the card (_precompute_lean, in revisions with one V1
launch a level), that precompute's ms apart, once a relax stage and
direction.  At B = 364 a relax step holds as many items as one of the
3,522,560-site plans' relax bins at B = 91 (~700,000), so the B sweep
shows how a step's time grows with its width on data built in a minute.
With --repo, the voronoirt_tpu_torch package of another checkout is
timed (its kernels built there), e.g. the parent commit unpacked with
git archive; the helpers (chip_smoke.py) are always this checkout's, so
that two revisions are timed by the same code in one call.
"""

import argparse
import importlib.util
import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the hoisted relax lap's (B, dtype) cases
RELAX_CASES = ((91, "float64"), (182, "float64"), (364, "float64"),
               (91, "float32"), (364, "float32"))


def _this_chip_smoke():
    """This checkout's chip_smoke.py as a module, whatever --repo
    names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package is timed")
    ap.add_argument("--out", default=None, help="write the times as JSON")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    cs = _this_chip_smoke()
    sys.path.insert(0, repo)
    from voronoirt_tpu_torch import require_cuda, synthetic_atmosphere
    from voronoirt_tpu_torch.kernels import build
    require_cuda()
    smi = cs.smi_line()
    print(smi, flush=True)
    build.library()
    p = cs.PROD
    sites, _ = cs._production_sites(
        synthetic_atmosphere(nz=p["nz"], nx=p["nx"], ny=p["ny"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        plans = dict((label.split()[-1], plan)
                     for label, plan in cs._v1_plans(sites, (8,)))
    out = {"device": smi, "repo": repo, "n_sites": sites.n, "times": []}
    for stage in ("gs", "layer"):
        for dtype_name, B in (("float64", 91), ("float32", 91),
                              ("float64", 1)):
            r = cs._v1_time(plans[stage], B, dtype_name)
            r.update(stage=stage, dtype=dtype_name, B=B)
            out["times"].append(r)
            print(f"{stage} stage, {dtype_name}, B = {B}: {r['steps']} level "
                  f"steps, {1e3 * r['ms']:.3f} us a step (plain "
                  f"{1e3 * r['plain_ms']:.1f} us); bound "
                  f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']}), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f} % of it", flush=True)
    out["relax_hoisted_lap"] = []
    for B, dtype_name in RELAX_CASES:
        r = hoisted_lap(cs, plans["wavefront"], B, dtype_name)
        r.update(B=B, dtype=dtype_name)
        out["relax_hoisted_lap"].append(r)
        print(f"relax stage, hoisted lap with its change, {dtype_name}, "
              f"B = {B}: {r['steps']} level steps, {r['rows']} rows, "
              f"{r['items_a_step']:.0f} items a step, {1e3 * r['ms']:.3f} "
              f"us a step; the lean weights' precompute on the card: "
              + (f"{r['lean_ms']:.3f} ms" if r["lean_ms"] is not None
                 else "none (formed in the kernel)"), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


def hoisted_lap(cs, plan, B, dtype_name, reps=5):
    """A hoisted relax lap with its change on plan's relax stage, as the
    package's sweep runs it on the card: its ms a level step, its mean
    items a step, and the lean precompute's ms where the package makes
    one there."""
    import torch
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
    from voronoirt_tpu_torch.solvers import voronoi_level as vl
    dtype = getattr(torch, dtype_name)
    stages, _, n_rows = sv.device_plan(plan, 3, "cuda", dtype)
    (sd,) = [sd for sd in stages if sd.kind == "relax"]
    I, S, a = cs._v1_inputs(plan, n_rows, B, dtype, 7)
    change = torch.zeros(2, dtype=dtype, device="cuda")
    lean_ms = None
    if hasattr(sv, "_hoist"):
        kw = sv._hoist(sd, S, a)
    else:
        lean_ms = cs._time_ms(lambda: sv._precompute_lean(sd, S, a), 1)
        kw = {"lean": sv._precompute_lean(sd, S, a)}
    steps = (len(sd.off) - 1) * sd.passes
    ms = cs._time_ms(lambda: vl.voronoi_stage(I, sd, change=change, **kw),
                     reps) / steps
    rows = int(sd.off[-1])
    del I, S, a, kw
    torch.cuda.empty_cache()
    return {"ms": ms, "steps": steps, "rows": rows,
            "items_a_step": rows * sd.passes * B / steps,
            "lean_ms": lean_ms}


if __name__ == "__main__":
    main()
