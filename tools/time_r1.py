#!/usr/bin/env python3
"""The rates kernel R1 (physics/rates.py calculate_R_chunk, csrc/rates.cu
vrt_rates_chunk) timed on one CUDA card by chunk kind, with the package
of a given checkout.

    python3 tools/time_r1.py [--repo DIR] [--dtypes float64,float32]
                             [--sass] [--reps N] [--sites 442368,...]
                             [--out r1.json]

Shapes, on chip_smoke.py phase 2's fields (phase 5's LTE start on the
production grid, J rows the Planck function times a seeded factor):

  * the production iteration's 7 lambda chunks (13 rows, the previous
    chunk's last row leading each after the first, the rates added into
    the running rates): 4 that hold bound-bound rows, 3 bound-free only;
  * the standard loop's launch, all 91 rows from row 0 into new rates,
    on the first 442,368 and 3,522,560 cells of the grid taken as sites
    (the Voronoi cells' counts; R1 reads a site as it reads a cell);
    there also the checkout's own _rates_and_populations
    (engine/lambda_iter.py, the standard loop's rates and statistical
    equilibrium, whatever it launches), the damping cube made outside
    the timing where it takes one.

Each launch is timed with CUDA events (the mean of --reps after a
warm-up: the wrapper's call, its small row-table ops included) and under
torch.profiler (the kernel's own device time, which the bound's share
is of), held against the plain version (calculate_R_chunk_plain) bit
for bit, and set beside its bound: the larger of its bytes (each J row,
field and rate read or written once) over 3.35 TB/s and its operations
over the dtype's rate (chip_smoke._rates_work); with --sass also the
least time the SMs need to issue its instructions (the FP64 or FP32
pipe's, the MUFU's, or all of them at one a clock a scheduler,
whichever is longest), from tools/r1_sass.py's counts of the
checkout's source and the Humlicek regions of this launch's
bound-bound points, at the card's largest SM clock.  Run with --repo pointing at another checkout (e.g. the parent
commit unpacked with git archive) and without, in turns in one call, to
compare the two on one card.
"""

import argparse
import gc
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITE_COUNTS = (442_368, 3_522_560)


def _this_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _issued(cs, F, r0, n_rows):
    """(bound-free points, {region: bound-bound points its warps run})
    of a launch of n_rows rows from r0."""
    from voronoirt_tpu_torch.physics import rates
    from voronoirt_tpu_torch.physics.broadening import damping
    line, T = F["line"], F["T"]
    tally = {"points": [0] * 4, "issued": [0] * 4, "warps": 0, "mixed": 0}
    lam = line.lam_tensor()
    bf = 0
    for kind, a, b, _ in rates._chunk_windows(line, r0, n_rows):
        if kind != "bb":
            bf += (b - a + 1) * T.numel()
            continue
        for r in range(a, b + 1):
            lb = lam[r:r + 1].reshape((1,) * (T.dim() + 1))
            cs._tally(cs._region_map(damping(F["g"][None], lb,
                                             line.dlamD[None]),
                                     (lb - line.lam0) / line.dlamD[None]),
                      tally)
    return bf, {k + 1: n for k, n in enumerate(tally["issued"])}, tally


def _record(cs, F, r0, J, lead, acc, reps, sass, mhz):
    """Time one R1 launch (into a copy of acc) and hold it against the
    plain version; returns its record."""
    import torch
    from voronoirt_tpu_torch.physics import rates
    dtype_name = str(F["T"].dtype).replace("torch.", "")
    rest = (F["g"], F["lte"], F["T"], "reference")
    n_rows = J.shape[0] + (lead is not None)
    acc_t = None if acc is None else {k: v.clone() for k, v in acc.items()}
    nbytes, ops = cs._rates_work(F, r0, n_rows, acc_t)
    bound, by = cs._bound_ms(nbytes, ops, dtype_name)
    got = rates.calculate_R_chunk(F["line"], acc_t, J, r0, *rest, lead=lead)
    want = rates.calculate_R_chunk_plain(F["line"], acc, J, r0, *rest,
                                         lead=lead)
    torch.cuda.synchronize()
    equal = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                          for k in want)
    del got, want
    def launch():
        rates.calculate_R_chunk(F["line"], acc_t, J, r0, *rest, lead=lead)

    ms = cs._time_ms(launch, reps)
    device_ms = cs._device_ms(launch, reps, "rates_chunk_kernel")
    wins = rates._chunk_windows(F["line"], r0, n_rows)
    rec = {"rows": [r0, r0 + n_rows], "lead": lead is not None,
           "windows": [w[0] for w in wins], "cells": F["T"].numel(),
           "kind": "bound-bound" if any(w[0] == "bb" for w in wins)
           else "bound-free", "ms": ms, "device_ms": device_ms,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "pct_of_bound": 100 * bound / device_ms, "bit_equal": equal}
    if sass is not None:
        bf, issued, tally = _issued(cs, F, r0, n_rows)
        import r1_sass
        # the instance this launch runs, where the source has a
        # bound-free-only one
        key = dtype_name
        if rec["kind"] == "bound-free" and key + "_bf_only" in sass:
            key += "_bf_only"
        rec["instance"] = key
        rec["issue_ms"], rec["issue_by"] = r1_sass.issue_ms(
            sass[key], bf, issued, dtype_name, mhz * 1e6)
        rec["bb_points_by_region"] = tally["points"]
        rec["bb_warps_mixed"] = [tally["mixed"], tally["warps"]]
    return rec


def _sites(F, n):
    """The first n cells of the grid's fields, as sites."""
    import dataclasses
    out = {k: v.reshape(-1)[:n].contiguous() for k, v in F.items()
           if k not in ("line", "lte")}
    out["lte"] = F["lte"].reshape(-1, F["lte"].shape[-1])[:n].contiguous()
    out["line"] = dataclasses.replace(
        F["line"], dlamD=F["line"].dlamD.reshape(-1)[:n].contiguous())
    return out


def _standard_loop_ms(cs, F, J, reps):
    """The checkout's _rates_and_populations on these sites: ms a call
    (the damping cube, where it takes one, made before the timing)."""
    import torch
    from voronoirt_tpu_torch.engine import lambda_iter
    from voronoirt_tpu_torch.physics.broadening import damping
    from voronoirt_tpu_torch.physics.rates import calculate_C
    fn = lambda_iter._rates_and_populations
    third = list(inspect.signature(fn).parameters)[2]
    line, T = F["line"], F["T"]
    if third == "damping_lam":
        lam = line.lam_tensor().reshape(-1, 1)
        third_arg = damping(F["g"][None], lam, line.dlamD[None])
    else:
        third_arg = F["g"]
    # any positive stand-ins for C and n_H: the timing does not depend on
    # their values
    nH = torch.full_like(T, 1e19)
    C = calculate_C(torch.full_like(T, 1e17), T, F["lte"])
    ms = cs._time_ms(lambda: fn(line, J, third_arg, F["lte"], C, T, nH,
                                "reference"), reps)
    return {"takes": third, "ms": ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package is timed")
    ap.add_argument("--dtypes", default="float64,float32")
    ap.add_argument("--sass", action="store_true",
                    help="add the FP64 (FP32) issue bound from "
                         "tools/r1_sass.py's counts of the checkout's source")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sites", default=",".join(map(str, SITE_COUNTS)),
                    help="site counts of the 91-row launch ('' for none)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    cs = _this_chip_smoke()
    sys.path.insert(0, repo)
    sys.path.insert(1, os.path.join(HERE, "tools"))
    import torch
    from voronoirt_tpu_torch import require_cuda, synthetic_atmosphere
    from voronoirt_tpu_torch.kernels import build
    require_cuda()
    smi = cs.smi_line()
    print(smi, flush=True)
    t = time.perf_counter()
    build.library()
    print(f"{repo}: kernels built/loaded in {time.perf_counter() - t:.2f} s",
          flush=True)
    sass = mhz = None
    if args.sass:
        import r1_sass
        sass = r1_sass.count(os.path.join(repo, "voronoirt_tpu_torch", "csrc",
                                          "rates.cu"))
        mhz = float(subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        for d, rec in sorted(sass.items()):
            regions = {r: (c["fp64"], c["fp32"], c["mufu"], c["all"])
                       for r, c in sorted(rec["regions"].items())}
            print(f"{d}: ptxas {json.dumps(rec['ptxas'])}; a bound-free "
                  f"point fp64 {rec['bf']['fp64']} fp32 {rec['bf']['fp32']} "
                  f"mufu {rec['bf']['mufu']} all {rec['bf']['all']}; a "
                  f"bound-bound point by region {regions} (fp64, fp32, "
                  f"mufu, all); SM clock {mhz:g} MHz", flush=True)
    atmos = synthetic_atmosphere(nz=cs.PROD["nz"], nx=cs.PROD["nx"],
                                 ny=cs.PROD["ny"])
    sites = [int(x) for x in args.sites.split(",") if x]
    out = {"device": smi, "repo": repo, "sass": sass, "sm_mhz": mhz,
           **_time_all(cs, atmos, args.dtypes.split(","), sites, args.reps,
                       sass, mhz)}
    ok = all(r["bit_equal"] for rs in out["chunks"].values()
             for r in rs) and all(r["bit_equal"]
                                  for r in out["standard_loop"].values())
    print(f"every launch bit-equal to the plain version: {ok}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if ok else 1


def _time_all(cs, atmos, dtypes, sites, reps, sass, mhz):
    """{"chunks": {dtype: [records]}, "standard_loop": {dtype_sites:
    record}} of R1 as the package's wrapper launches it now."""
    import torch
    from voronoirt_tpu_torch.engine.lambda_iter import _lambda_chunks
    from voronoirt_tpu_torch.physics import rates
    p = cs.PROD
    n_lambda = p["nlam_bb"] + 2 * p["nlam_bf"]
    out = {"chunks": {}, "standard_loop": {}}
    for dtype_name in dtypes:
        F = cs._rate_fields(atmos, dtype_name)
        recs, acc, lead = [], None, None
        for ci, sl in enumerate(_lambda_chunks(n_lambda, p["lambda_chunk"])):
            J = cs._rows_like_B(F, sl, ci)
            r0 = sl.start - (lead is not None)
            rec = _record(cs, F, r0, J, lead, acc, reps, sass, mhz)
            recs.append(rec)
            print(f"{dtype_name} chunk {ci} rows [{rec['rows'][0]}, "
                  f"{rec['rows'][1]}) {rec['kind']} {rec['windows']}: "
                  f"{rec['device_ms']:.4f} ms on the device "
                  f"({rec['ms']:.4f} ms a call), bound "
                  f"{rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}), {rec['pct_of_bound']:.1f} %"
                  + (f"; issue {rec['issue_ms']:.4f} ms ({rec['issue_by']})"
                     if sass else "") + f"; bit-equal {rec['bit_equal']}",
                  flush=True)
            acc = rates.calculate_R_chunk(F["line"], acc, J, r0, F["g"],
                                          F["lte"], F["T"], "reference",
                                          lead=lead)
            lead = J[-1:].clone()
            del J
        for kind in ("bound-bound", "bound-free"):
            rs = [r for r in recs if r["kind"] == kind]
            ms, dev, bound = (sum(r[k] for r in rs)
                              for k in ("ms", "device_ms", "bound_ms"))
            print(f"{dtype_name} {kind} chunks ({len(rs)}): {dev:.4f} ms on "
                  f"the device, {dev / len(rs):.4f} ms a launch "
                  f"({ms / len(rs):.4f} ms a call), bound {bound:.4f} ms, "
                  f"{100 * bound / dev:.1f} %", flush=True)
        out["chunks"][dtype_name] = recs
        del acc, lead
        for n in sites:
            S = _sites(F, n)
            J = cs._rows_like_B(S, slice(0, n_lambda), 7)
            rec = _record(cs, S, 0, J, None, None, reps, sass, mhz)
            rec["standard_loop_rates"] = _standard_loop_ms(cs, S, J, reps)
            print(f"{dtype_name} {n} sites, 91 rows into new rates: "
                  f"{rec['device_ms']:.4f} ms on the device "
                  f"({rec['ms']:.4f} ms a call), bound "
                  f"{rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}), {rec['pct_of_bound']:.1f} %"
                  + (f"; issue {rec['issue_ms']:.4f} ms ({rec['issue_by']})"
                     if sass else "") + f"; bit-equal {rec['bit_equal']}; "
                  f"_rates_and_populations (takes "
                  f"{rec['standard_loop_rates']['takes']}) "
                  f"{rec['standard_loop_rates']['ms']:.4f} ms", flush=True)
            out["standard_loop"][f"{dtype_name}_{n}"] = rec
            del S, J
            gc.collect()
            torch.cuda.empty_cache()
        del F
        gc.collect()
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
