"""LTE continuum disk-centre imaging driver.

Port of drivers/continuum.py (reference src/compare_continuum.jl:
LTE_regular :123-174, single-pass 500 nm disk-centre formal solutions,
and LTE_compare :12-120: sample sites from the extinction density,
tessellate, resample back to the regular grid, then solve -- isolating
grid-representation error).  Works on the Bifrost HDF5 snapshot
(--data), otherwise on the synthetic atmosphere.

Usage:
  python -m voronoirt_tpu_torch.drivers.continuum [--data FILE]
        [--n-sites N] [--skip K] [--out DIR] [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..atmosphere import get_atmos, synthetic_atmosphere
from ..grid import (build_sites, density_extinction, initialise_sites,
                    rejection_sampling)
from ..grid.interpolate import voronoi_to_raster_inv_dist
from ..physics.atom import lyman_alpha_line
from ..physics.lte import lte_populations
from ..physics.opacity import alpha_absorption, alpha_scattering
from ..physics.planck import B_lambda
from ..solvers.sweep_regular import short_characteristics
from . import pick_device

LAMBDA0 = 500e-9


def _load_atmos(args):
    if args.data:
        return get_atmos(args.data, periodic=False, skip=args.skip)
    nz, nx, ny = getattr(args, "atmos", None) or (48, 32, 32)
    return synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=1998)


def _fields(atmos, device):
    return tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
                 for a in (atmos.temperature, atmos.electron_density,
                           atmos.hydrogen_populations))


def lte_continuum_fields(atmos, device=None):
    """alpha_cont(500 nm) and S = B_lambda(T) from ad-hoc LTE populations
    (compare_continuum.jl:78-92), tensors on `device`."""
    T, ne, nH = _fields(atmos, pick_device(device))
    line = lyman_alpha_line(1, 1, T)
    lte = lte_populations(line, T, ne, nH)
    a = alpha_absorption(LAMBDA0, T, ne, lte[..., 0] + lte[..., 1],
                         lte[..., 2])
    a = a + alpha_scattering(LAMBDA0, ne, lte[..., 0])
    return a, B_lambda(LAMBDA0, T)


def disk_centre_image(atmos, alpha, S):
    """Vertical-ray formal solution -> top-of-atmosphere intensity
    (compare_continuum.jl:100-118), a numpy image."""
    k = np.array([-1.0, 0.0, 0.0])  # theta = 180: straight up
    T_bottom = torch.as_tensor(atmos.temperature[0], dtype=S.dtype,
                               device=S.device)
    I = short_characteristics(k, S, alpha, B_lambda(LAMBDA0, T_bottom),
                              atmos.z, atmos.dx, atmos.dy, up=True)
    return I[-1].cpu().numpy()


def run_regular(atmos, out_dir=None, tag="regular", device=None):
    t0 = time.perf_counter()
    alpha, S = lte_continuum_fields(atmos, device)
    img = disk_centre_image(atmos, alpha, S)
    dt = time.perf_counter() - t0
    print(f"LTE {tag}: {img.shape} image, mean {img.mean():.4g} "
          f"kW/m2/nm, {dt:.2f}s")
    if out_dir:
        np.save(os.path.join(out_dir, f"I_{tag}.npy"), img)
    return img


def run_voronoi(atmos, n_sites, out_dir=None, seed=1998, device=None):
    """Sites from the extinction density -> tessellate -> resample back ->
    regular-grid solve (compare_continuum.jl:40-118)."""
    T, ne, nH = _fields(atmos, pick_device(device))
    lte = lte_populations(lyman_alpha_line(1, 1, T), T, ne, nH)
    q = density_extinction(atmos, LAMBDA0, lte)
    t0 = time.perf_counter()
    pos = rejection_sampling(n_sites, atmos, q, seed=seed)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    fields = initialise_sites(pos, atmos)
    sites = build_sites(pos, bounds, fields)
    print(f"sampled+tessellated {n_sites} sites in "
          f"{time.perf_counter() - t0:.2f}s")

    # resample the site fields back to the regular grid (inverse distance,
    # k=2, p=1 -- compare_continuum.jl:80), all six in one call (one
    # neighbour query), and run the same formal solve
    names = ("temperature", "electron_density", "hydrogen_populations",
             "velocity_z", "velocity_x", "velocity_y")
    resampled = voronoi_to_raster_inv_dist(
        sites, atmos.z, atmos.x, atmos.y,
        np.stack([getattr(sites, name) for name in names]))
    atmos_v = dataclasses.replace(atmos, **dict(zip(names, resampled)))
    return run_regular(atmos_v, out_dir, tag=f"voronoi_{n_sites}",
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--n-sites", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--atmos", type=int, nargs=3, default=(48, 32, 32),
                    metavar=("NZ", "NX", "NY"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    atmos = _load_atmos(args)
    img_r = run_regular(atmos, args.out, device=args.device)
    summary = {"regular_mean": float(img_r.mean())}
    if args.n_sites:
        img_v = run_voronoi(atmos, args.n_sites, args.out,
                            device=args.device)
        summary["voronoi_mean"] = float(img_v.mean())
        summary["rel_diff"] = float(
            np.mean(np.abs(img_v - img_r) / np.abs(img_r)))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
