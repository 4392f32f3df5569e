"""Searchlight beam test driver.

Port of drivers/searchlight.py (reference src/compare_searchlight.jl:
searchlight_regular :154-225, searchlight_irregular :10-152).
Zero-opacity unit cube; a circular beam injected at a boundary must
emerge translated by the analytic offset with shape and total flux
preserved.

Usage:
  python -m voronoirt_tpu_torch.drivers.searchlight [--irregular]
        [--out DIR] [--n N] [--order layer|wavefront] [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..grid import build_sites, build_voronoi_plan
from ..grid.interpolate import voronoi_to_raster_nn
from ..quadrature import get_quadrature
from ..solvers.sweep_regular import short_characteristics
from ..solvers.sweep_voronoi import sweep_voronoi
from . import pick_device


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


def beam_mask(n, R0=0.1):
    """Reference beam (compare_searchlight.jl:182-190): xi = i/n, 1-based."""
    xi = np.arange(1, n + 1) / n - 0.5
    return (np.hypot(xi[:, None], xi[None, :]) < R0).astype(np.float64)


def analytic_center(k):
    """Expected beam centre after crossing the unit cube
    (src/plot_utils.jl:35-47)."""
    xr = (0.5 - np.sign(k[0]) * k[1] / k[0]) % 1.0
    yr = (0.5 - np.sign(k[0]) * k[2] / k[0]) % 1.0
    return xr, yr


def run_regular(n=51, out_dir=None, device=None):
    device = pick_device(device)
    quad = get_quadrature("ul7n12")
    ax = np.linspace(0, 1, n)
    S = torch.zeros((n, n - 2, n - 2), dtype=torch.float64, device=device)
    alpha = torch.zeros_like(S)
    I0_np = beam_mask(n)[1:-1, 1:-1]
    I0 = torch.as_tensor(I0_np, device=device)
    dx = ax[1] - ax[0]

    results = []
    total_t = 0.0
    for i in range(quad.n_angles):
        th, ph = quad.theta_deg[i], quad.phi_deg[i]
        k = quad.k[i]
        up = bool(quad.is_up[i])
        t0 = time.perf_counter()
        I = short_characteristics(k, S, alpha, I0, ax, dx, dx, up=up,
                                  n_sweeps=3)
        img = (I[-1] if up else I[0]).cpu().numpy()
        dt = time.perf_counter() - t0
        total_t += dt
        xr, yr = analytic_center(k)
        rec = dict(theta=th, phi=ph, flux_in=float(I0_np.sum()),
                   flux_out=float(img.sum()), center=[xr, yr], time=dt)
        results.append(rec)
        print(f"{int(th)}, {int(ph)}: flux {rec['flux_out']:.4f}/"
              f"{rec['flux_in']:.1f}  t={dt:.2f}s")
        if out_dir:
            np.save(os.path.join(
                out_dir, f"I_{int(th)}_{int(ph)}_regular.npy"), img)
    print(f"Total time {total_t:.2f} s -- avg {total_t / 12:.2f} s")
    return results


def run_irregular(n_side=51, out_dir=None, seed=1998, order="layer",
                  device=None):
    device = pick_device(device)
    n_sites = n_side ** 3
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n_sites, 3))
    fields = dict(temperature=np.ones(n_sites),
                  electron_density=np.zeros(n_sites),
                  hydrogen_populations=np.zeros(n_sites),
                  velocity_z=np.zeros(n_sites),
                  velocity_x=np.zeros(n_sites),
                  velocity_y=np.zeros(n_sites))
    t0 = time.perf_counter()
    sites = build_sites(pos, (0, 1, 0, 1, 0, 1), fields)
    print(f"grid preprocessing: {time.perf_counter() - t0:.2f} s for "
          f"{n_sites} sites")

    quad = get_quadrature("ul7n12")
    S = torch.zeros(n_sites, dtype=torch.float64, device=device)
    alpha = torch.zeros_like(S)
    R0 = 0.1
    img_axis = np.linspace(0, 1, 10 * n_side)

    results = []
    total_t = 0.0
    for i in range(quad.n_angles):
        th, ph = quad.theta_deg[i], quad.phi_deg[i]
        k = quad.k[i]
        up = bool(quad.is_up[i])
        plan = build_voronoi_plan(sites, k, up, order=order)
        bc = pos[plan.bc_sites]
        I0 = (np.hypot(bc[:, 1] - 0.5, bc[:, 2] - 0.5) < R0).astype(float)
        t0 = time.perf_counter()
        I = sweep_voronoi(plan, S, alpha, torch.as_tensor(I0, device=device),
                          n_sweeps=3).cpu().numpy()
        dt = time.perf_counter() - t0
        total_t += dt
        layers_out = sites.layers_down if up else sites.layers_up
        out_sites = layers_out == 1
        rec = dict(theta=th, phi=ph, mean_in=float(I0.mean()),
                   mean_out=float(I[out_sites].mean()), time=dt)
        results.append(rec)
        print(f"{int(th)}, {int(ph)}: mean I out {rec['mean_out']:.3f} "
              f"(in {rec['mean_in']:.3f})  t={dt:.2f}s")
        if out_dir:
            zq = np.array([1.0 if up else 0.0])
            img = voronoi_to_raster_nn(sites, zq, img_axis, img_axis, I)[0]
            np.save(os.path.join(
                out_dir, f"I_{int(th)}_{int(ph)}_voronoi.npy"), img)
    print(f"Total time {total_t:.2f} s -- avg {total_t / 12:.2f} s")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--irregular", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=51)
    ap.add_argument("--order", default="layer",
                    choices=("layer", "wavefront"),
                    help="irregular sweep ordering: 'layer' = reference-"
                         "parity BFS layers; 'wavefront' = exact "
                         "topological levels (conserves grazing beams)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.irregular:
        res = run_irregular(args.n, args.out, order=args.order,
                            device=args.device)
    else:
        res = run_regular(args.n, args.out, device=args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
