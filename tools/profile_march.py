#!/usr/bin/env python3
"""K2, the yz/xz march (voronoirt_tpu_torch/solvers/march_plane.py), timed
on one CUDA card at the production group-plane shape.

    python3 tools/profile_march.py [--B 52] [--n 256] [--reps 20]
                                   [--ptxas] [--lines] [--splits]
                                   [--out march.json]

For each march axis ('x': yz case, 'y': xz case) and n_sweeps 1, 2 and 3,
times march_plane with CUDA events (float64, sign -1, s_base -1, mixed
per-element geometry).  The slope over n_sweeps is the cost of one pass
of N column steps; the intercept is what does not repeat per pass (the
pass-invariant precompute, launch and allocation).  Where the module
splits the kernel into march_coeffs and march_chain, each is also timed
alone.  Each time stands beside the bound of the same work: the planes
the function reads once and writes once over the card's 3.35 TB/s.
--ptxas compiles each kernel source once more with -Xptxas -v and prints
the registers, shared memory and spills of every kernel.  --lines times
march_chain alone at (B, n, M) for lines of M = 32 ... 512 points (1 to
16 points a lane), float64 and float32, x march, 3 passes: the time of
one column step against the work in it.  --splits times march_chain
alone at the split march_plane.chain_split chooses (W warps a line, a
halo exchange every H steps) at (B, M) = (1, 256), (13, 256), (52,
256), (124, 256), (52, 512) and (52, 100), n = 256 columns, 3 passes,
both march axes and both stencil shifts, each plane held bit for bit
against the plain version.

Prints the card line (nvidia-smi name, power limit) and a summary;
--out also writes it as JSON.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from voronoirt_tpu_torch import require_cuda  # noqa: E402
from voronoirt_tpu_torch.kernels import build  # noqa: E402
from voronoirt_tpu_torch.solvers import march_plane as mp  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps):
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


def inputs(B, n, dtype, seed=7, m=None):
    """Planes (B, n, m) and per-element geometry; m defaults to n."""
    gen = torch.Generator().manual_seed(seed)
    m = n if m is None else m

    def rand(shape, lo, hi, log=False):
        v = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                        dtype=torch.float64)
        return (10.0 ** v if log else v).to(dtype=dtype, device="cuda")

    planes = [rand((B, n, m), -5.0, 2.0, log=True) for _ in range(2)]
    planes += [rand((B, n, m), 0.1, 1.0) for _ in range(2)]
    planes.append(rand((B, n, m), 0.0, 1.0))
    geom = [rand((B,), -1.0, 1.0, log=True), rand((B,), 0.0, 1.0),
            rand((B,), 0.0, 1.0),
            (torch.arange(B, device="cuda") % 2).to(dtype)]
    return planes, geom


def ptxas_report():
    """nvcc -Xptxas -v of every kernel source, as the package builds it."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
    out = []
    for src in sorted(build.SRC_DIR.glob("*.cu")):
        proc = subprocess.run(
            [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull,
             str(src)], capture_output=True, text=True)
        out.append(f"--- {src.name} (rc {proc.returncode})\n"
                   + proc.stdout + proc.stderr)
    return "\n".join(out)


def step_times(B, n, reps):
    """march_chain alone against the points of a line: ns a column step."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for m in (32, 64, 128, 256, 512):
            planes, geom = inputs(B, n, dtype, m=m)
            st = dict(march_axis="x", sign=-1, s_base=-1)
            scratch = mp.march_coeffs(*planes, *geom, **st)
            ms = time_ms(lambda: mp.march_chain(scratch, geom[1], m,
                                                n_sweeps=3, **st), reps)
            out[f"{name} M={m}"] = ms
            print(f"  march_chain {name} (B={B}, {n}x{m}, {m // 32} points "
                  f"a lane): {ms:.4f} ms, {1e6 * ms / (3 * n):.1f} ns a "
                  f"column step", flush=True)
    return out


SPLIT_SHAPES = ((1, 256), (13, 256), (52, 256), (124, 256), (52, 512),
                (52, 100))


def split_times(n, reps):
    """march_chain alone at its split: us a launch (mean of both axes and
    both stencil shifts) at SPLIT_SHAPES, each plane bit-equal to the
    plain version's."""
    out = []
    for B, m in SPLIT_SHAPES:
        planes, geom = inputs(B, n, torch.float64, m=m)
        cases = []
        for axis in ("x", "y"):
            for s_base in (0, -1):
                st = dict(march_axis=axis, sign=-1, s_base=s_base)
                ps = planes if axis == "x" else [p.transpose(1, 2)
                                                 .contiguous() for p in planes]
                scratch = mp.march_coeffs(*ps, *geom, **st)
                want = mp.march_chain_plain(scratch, geom[1], m, n_sweeps=3,
                                            **st)
                cases.append((scratch, st, want))
        split = mp.chain_split(m)
        us, err = [], 0.0
        for scratch, st, want in cases:
            run = lambda: mp.march_chain(scratch, geom[1], m, n_sweeps=3,
                                         **st)
            err = max(err, float((run() - want).abs().max()))
            us.append(1e3 * time_ms(run, reps))
        mean = sum(us) / len(us)
        row = {"B": B, "M": m, "W_H": list(split), "us": mean,
               "us_by_case": us}
        print(f"  march_chain B={B} M={m} W={split[0]} H={split[1]}: "
              f"{mean:.2f} us a launch ({1e3 * mean / (3 * n):.1f} ns a "
              f"step; x/s0 x/s-1 y/s0 y/s-1 "
              + " ".join(f"{u:.2f}" for u in us)
              + f"), max abs err vs plain {err:.1e}", flush=True)
        if err != 0.0:
            raise SystemExit(f"march_chain at B={B} M={m} is not "
                             f"bit-equal to the plain chain: {err}")
        out.append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=52)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    require_cuda()
    smi = smi_line()
    print(smi, flush=True)
    build.library()
    if args.ptxas:
        print(ptxas_report(), flush=True)

    B, n = args.B, args.n
    dtype = torch.float64
    planes, geom = inputs(B, n, dtype)
    plane_bytes = B * n * n * 8
    bound = {"march_plane": 6 * plane_bytes / HBM_BYTES_PER_S * 1e3,
             "march_coeffs": 7 * plane_bytes / HBM_BYTES_PER_S * 1e3,
             "march_chain": 3 * plane_bytes / HBM_BYTES_PER_S * 1e3}
    res = {"card": smi, "shape": [B, n, n], "dtype": "float64",
           "bound_ms": bound, "march_plane": {}, "split": {}}
    split = hasattr(mp, "march_coeffs") and hasattr(mp, "march_chain")
    # warm-up: the first timed runs of a process came out slower
    for axis in ("x", "y"):
        time_ms(lambda: mp.march_plane(*planes, *geom, march_axis=axis,
                                       sign=-1, s_base=-1, n_sweeps=3),
                args.reps)
    for axis in ("x", "y"):
        ms = {}
        for n_sweeps in (1, 2, 3):
            st = dict(march_axis=axis, sign=-1, s_base=-1, n_sweeps=n_sweeps)
            ms[n_sweeps] = time_ms(lambda: mp.march_plane(*planes, *geom,
                                                          **st), args.reps)
        slope = (ms[3] - ms[1]) / 2
        icept = ms[1] - slope
        res["march_plane"][axis] = {"ms": ms, "per_pass_ms": slope,
                                    "intercept_ms": icept}
        print(f"march_plane axis={axis} (B={B}, {n}x{n}, float64): "
              + ", ".join(f"n_sweeps {k}: {v:.4f} ms" for k, v in ms.items())
              + f"; per pass {slope:.4f} ms ({1e6 * slope / n:.1f} ns per "
              f"column step), intercept {icept:.4f} ms; bound "
              f"{bound['march_plane']:.4f} ms", flush=True)
        if split:
            st = dict(march_axis=axis, sign=-1, s_base=-1)
            scratch = mp.march_coeffs(*planes, *geom, **st)
            t_c = time_ms(lambda: mp.march_coeffs(*planes, *geom, **st),
                          args.reps)
            t_ch = time_ms(lambda: mp.march_chain(scratch, geom[1], n,
                                                  n_sweeps=3, **st),
                           args.reps)
            res["split"][axis] = {"march_coeffs_ms": t_c,
                                  "march_chain_ms": t_ch}
            print(f"  split axis={axis}: march_coeffs {t_c:.4f} ms (bound "
                  f"{bound['march_coeffs']:.4f}), march_chain (n_sweeps 3) "
                  f"{t_ch:.4f} ms (bound {bound['march_chain']:.4f})",
                  flush=True)
    if args.lines:
        res["lines"] = step_times(B, n, args.reps)
    if args.splits:
        res["splits"] = split_times(n, args.reps)
    mean3 = sum(res["march_plane"][a]["ms"][3] for a in ("x", "y")) / 2
    res["mean_ms_n_sweeps_3"] = mean3
    res["pct_of_bound"] = 100 * bound["march_plane"] / mean3
    print(f"mean over both axes at n_sweeps 3: {mean3:.4f} ms, "
          f"{res['pct_of_bound']:.1f} % of its bound; {smi}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
