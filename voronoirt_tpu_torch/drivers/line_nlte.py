"""Flagship NLTE Ly-alpha line driver.

Port of drivers/line_nlte.py (reference src/compare_line.jl, `regular()`
:9-47 and `voronoi()` :49-132): production configuration eps=1e-3,
maxiter=150, 51 bb + 2x20 bf wavelengths, ul7n12 quadrature; Voronoi
sites sampled from the invNH_invT density.  Works on the Bifrost
snapshot (--data) or the synthetic atmosphere.  The printed summary
carries the run's spans (observability.report(): the set-up's parts, and
the first iteration's and the other iterations' mean seconds by phase).

Usage:
  python -m voronoirt_tpu_torch.drivers.line_nlte [--data F]
        [--grid regular|voronoi] [--n-sites N] [--skip K] [--out out.h5]
        [--maxiter N] [--eps E] [--f32] [--device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from .. import observability
from ..atmosphere import get_atmos, synthetic_atmosphere
from ..config import Config
from ..device import torch_dtype
from ..engine import RegularEngine, VoronoiEngine
from ..engine.checkpoint import CheckpointFile
from ..grid import build_sites, initialise_sites, sample_sites
from ..grid.cache import default_cache_dir
from ..physics.atom import lyman_alpha_line
from . import pick_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--grid", choices=("regular", "voronoi"),
                    default="regular")
    ap.add_argument("--n-sites", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--nlam-bb", type=int, default=51)
    ap.add_argument("--nlam-bf", type=int, default=20)
    ap.add_argument("--quadrature", default="ul7n12")
    ap.add_argument("--seed", type=int, default=2022)
    ap.add_argument("--interpolation", default="linear",
                    choices=("linear", "bezier"),
                    help="formal-solution source interpolation; 'bezier'"
                         " = quadratic DELO-Bezier in the regular xy"
                         " sweep segments")
    ap.add_argument("--voronoi-order", default="layer",
                    choices=("layer", "wavefront"))
    ap.add_argument("--lambda-chunk", type=int, default=0,
                    help="stream wavelengths in blocks of this size "
                         "through profile->sweep->J (production-scale "
                         "memory bound); 0 = all at once")
    ap.add_argument("--f32", action="store_true",
                    help="float32 end to end (the production mode; "
                         "default is float64 for validation runs)")
    ap.add_argument("--boost", type=float, default=2.0e9,
                    help="collisional-rate boost (rates.jl:3; the "
                         "reference's 2e9 drives the destruction "
                         "probability to ~1 and the iteration "
                         "converges in a few steps -- lower it for "
                         "deep-NLTE convergence studies)")
    ap.add_argument("--rates-chunk", type=int, default=0,
                    help="stream the rates/SE update over slabs of this "
                         "many sites (z-planes on the regular grid), "
                         "the production memory path; 0 = all at once")
    ap.add_argument("--stream", action="store_true",
                    help="regular grid: lambda-streamed iteration "
                         "(cfg.stream_rates) -- no resident J cube, "
                         "second S buffer or Planck cube")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the tessellation/plan disk cache")
    ap.add_argument("--atmos", type=int, nargs=3, default=(32, 16, 16),
                    metavar=("NZ", "NX", "NY"),
                    help="synthetic-atmosphere shape when --data is "
                         "not given (the reference's half-res Bifrost "
                         "is 215 256 256)")
    ap.add_argument("--atmos-seed", type=int, default=5,
                    help="synthetic-atmosphere seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = pick_device(args.device)
    observability.reset()
    cfg = Config(eps=args.eps, maxiter=args.maxiter, nlam_bb=args.nlam_bb,
                 nlam_bf=args.nlam_bf, quadrature=args.quadrature,
                 seed=args.seed, boost=args.boost,
                 formal_interpolation=args.interpolation,
                 voronoi_order=args.voronoi_order,
                 lambda_chunk=args.lambda_chunk or None,
                 rates_site_chunk=args.rates_chunk or None,
                 stream_rates=bool(args.stream),
                 dtype="float32" if args.f32 else "float64",
                 cache_dir=None if args.no_cache else default_cache_dir())
    dtype = torch_dtype(cfg.dtype)

    if args.data:
        atmos = get_atmos(args.data, periodic=False, skip=args.skip)
    else:
        nz, nx, ny = args.atmos
        atmos = synthetic_atmosphere(nz=nz, nx=nx, ny=ny,
                                     seed=args.atmos_seed)

    t_start = time.perf_counter()
    ckpt = None
    if args.grid == "regular":
        T = torch.as_tensor(atmos.temperature, dtype=dtype, device=device)
        line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
        eng = RegularEngine(atmos, line, cfg, device=device)
        if args.out:
            ckpt = CheckpointFile(args.out)
            ckpt.create_regular(line, atmos, cfg.maxiter, cfg.dtype)
    else:
        n_sites = args.n_sites or (atmos.shape[0] * atmos.shape[1]
                                   * atmos.shape[2])
        print(f"---Sampling {n_sites} sites (invNH_invT)---")
        pos = sample_sites(atmos, n_sites, density="invNH_invT",
                           seed=cfg.seed)
        bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
                  atmos.y[0], atmos.y[-1])
        fields = initialise_sites(pos, atmos)
        t0 = time.perf_counter()
        sites = build_sites(pos, bounds, fields, cache_dir=cfg.cache_dir)
        print(f"---Tessellated in {time.perf_counter() - t0:.1f}s---")
        T = torch.as_tensor(sites.temperature, dtype=dtype, device=device)
        line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
        eng = VoronoiEngine(sites, line, cfg, device=device)
        if args.out:
            ckpt = CheckpointFile(args.out)
            ckpt.create_voronoi(line, sites, cfg.maxiter, cfg.dtype)

    res = eng.run(checkpoint=ckpt)
    wall = time.perf_counter() - t_start
    if ckpt is not None:
        ckpt.write_time(wall)

    summary = {
        "grid": args.grid, "iterations": res.iterations,
        "converged": res.converged, "wall_seconds": wall,
        "final_diff": res.convergence[-1],
        "mean_iteration_seconds": (float(np.mean(res.timings))
                                   if res.timings else None),
        "observability": observability.report(),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
