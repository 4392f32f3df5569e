"""Resume a crashed/killed NLTE run from its checkpoint file.

Port of drivers/recover.py (reference src/recover_simulation.jl,
recover_regular :4-101, recover_voronoi :103-206): rebuild all frozen
state from the inputs, read populations + S from the HDF5 output, scan
the convergence dataset for the first zero, and re-enter the Lambda
loop mid-stream.  The checkpoint stores the full atmosphere / site
fields, so everything is reloaded from the file itself; the
tessellation is re-derived from the stored positions.

Usage:
  python -m voronoirt_tpu_torch.drivers.recover out.h5 [--eps E]
        [--maxiter N] [--f32] [--device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..atmosphere import Atmosphere
from ..config import Config
from ..device import torch_dtype
from ..engine import RegularEngine, VoronoiEngine
from ..engine.checkpoint import CheckpointFile, recover
from ..grid import build_sites
from ..grid.cache import default_cache_dir
from ..physics.atom import lyman_alpha_line
from . import pick_device


def load_engine_from_checkpoint(path, cfg, device=None):
    """(engine, line) rebuilt from the fields stored in the checkpoint,
    on `device` (default: the CUDA card)."""
    import h5py
    device = pick_device(device)
    dtype = torch_dtype(cfg.dtype)

    with h5py.File(path, "r") as f:
        n_bb = int(f["n_bb"][0])
        n_bf = int(f["n_bf"][0])
        is_voronoi = "positions" in f
        fields = {k: np.asarray(f[k]) for k in
                  ("temperature", "electron_density",
                   "hydrogen_populations", "velocity_z", "velocity_x",
                   "velocity_y")}
        if is_voronoi:
            positions = np.asarray(f["positions"]).T
            bounds = tuple(np.asarray(f["boundaries"]))
        else:
            z = np.asarray(f["z"])
            x = np.asarray(f["x"])
            y = np.asarray(f["y"])

    T = torch.as_tensor(fields["temperature"], dtype=dtype, device=device)
    line = lyman_alpha_line(n_bb, n_bf, T)
    if is_voronoi:
        # resume hits the tessellation/plan disk cache (the first run
        # stored it under the same positions hash): no re-tessellation
        sites = build_sites(positions, bounds, fields,
                            cache_dir=cfg.cache_dir)
        return VoronoiEngine(sites, line, cfg, device=device), line
    atmos = Atmosphere(z=z, x=x, y=y, **fields)
    return RegularEngine(atmos, line, cfg, device=device), line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--quadrature", default="ul7n12")
    ap.add_argument("--voronoi-order", default="layer",
                    choices=("layer", "wavefront"))
    ap.add_argument("--lambda-chunk", type=int, default=0)
    ap.add_argument("--f32", action="store_true",
                    help="float32 end to end, as line_nlte --f32 ran "
                         "(the file's arrays are then float32)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--rates-chunk", type=int, default=0,
                    help="stream the rates/SE update over slabs "
                         "(production memory path; must be set when "
                         "resuming multi-million-site runs)")
    ap.add_argument("--stream", action="store_true",
                    help="regular grid: lambda-streamed iteration (a "
                         "resume always re-enters the standard loop, so "
                         "this does nothing here, as in the JAX driver)")
    ap.add_argument("--boost", type=float, default=2.0e9,
                    help="collisional-rate boost; MUST match the "
                         "original run's value")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import h5py
    ckpt = CheckpointFile(args.checkpoint)
    with h5py.File(args.checkpoint, "r") as f:
        n_bb, n_bf = int(f["n_bb"][0]), int(f["n_bf"][0])
    cfg = Config(eps=args.eps, maxiter=args.maxiter, nlam_bb=n_bb,
                 nlam_bf=n_bf, quadrature=args.quadrature,
                 boost=args.boost,
                 voronoi_order=args.voronoi_order,
                 lambda_chunk=args.lambda_chunk or None,
                 rates_site_chunk=args.rates_chunk or None,
                 stream_rates=bool(args.stream),
                 dtype="float32" if args.f32 else "float64",
                 cache_dir=None if args.no_cache else default_cache_dir())

    eng, _ = load_engine_from_checkpoint(args.checkpoint, cfg, args.device)
    it = ckpt.resume_iteration()
    print(f"---Resuming at iteration {it}---")
    t0 = time.perf_counter()
    res = recover(eng, args.checkpoint)
    summary = {"resumed_at": it, "iterations": res.iterations,
               "converged": res.converged,
               "wall_seconds": time.perf_counter() - t0}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
