"""Disk-centre image / spectrum synthesis from a saved NLTE run.

Port of drivers/synthesize.py (reference src/plot_utils.jl `plotter`
:298-354, rebuilding S_lambda and alpha_tot from the checkpointed
populations, and `write_top_intensity` :99-140, the emergent intensity
cube and wavelength grid as .npy).  Voronoi checkpoints are rasterized
first with the inverse-distance resampler, like read_irregular
(plot_utils.jl:252-287).

The reconstruction is the JAX driver's: S_line from the populations,
S_cont = B_lambda(lam, T), the continuum extinction frozen at line
centre (the reference's fidelity trap), Voigt profiles with the
line-of-sight velocity along -k, S_lambda = (a_l S_l + a_c S_c)/(a_l +
a_c), alpha_tot = a_l + a_c, then one upward formal solution with the
bottom S_lambda plane as boundary.  JAX builds every (nlam, nz, nx, ny)
cube in one jitted call (10.26 GB each in float64 at 215x256x256 and 91
wavelengths); the port streams LAMBDA_BLOCK wavelengths at a time
through that chain and one sweep, and makes each block's extinction one
wavelength at a time.  Every operation is pointwise in wavelength, so
the values are those of the whole-array expression.

The checkpoint is read by key from any mapping of its datasets: an
h5py.File, or a dict of numpy arrays.

Usage:
  python -m voronoirt_tpu_torch.drivers.synthesize run.h5 --out DIR
        [--theta 180 --phi 0] [--raster NZ NX NY] [--no-plots]
        [--n-sweeps 3] [--device cpu]
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..analysis.plots import brightness_temperature, plot_top_intensity
from ..atmosphere import Atmosphere
from ..grid.interpolate import voronoi_to_raster_inv_dist
from ..physics.atom import (alpha_line, compute_profile,
                            line_of_sight_velocity, lyman_alpha_line,
                            source_line)
from ..physics.broadening import damping, gamma_constant
from ..physics.lte import lte_populations
from ..physics.opacity import alpha_absorption, alpha_scattering
from ..physics.planck import B_lambda
from ..solvers.sweep_regular import build_plan, sweep
from . import pick_device

# wavelengths per streamed block: the batch of one sweep, and the
# wavelength count of the block's S_lambda and alpha_tot buffers
LAMBDA_BLOCK = 13


def _direction(theta_deg, phi_deg):
    """k = [cos(theta), cos(phi) sin(theta), sin(phi) sin(theta)]
    (plot_utils.jl:113; theta > 90 deg means an upward sweep)."""
    th = np.deg2rad(theta_deg)
    ph = np.deg2rad(phi_deg)
    return np.array([np.cos(th), np.cos(ph) * np.sin(th),
                     np.sin(ph) * np.sin(th)])


class _RasterSites:
    """Minimal positions-only container for the resamplers."""

    def __init__(self, positions):
        self.positions = positions


def _load_regular(f):
    """Checkpoint mapping -> (Atmosphere, populations, wavelength [m])."""
    atmos = Atmosphere(
        z=np.asarray(f["z"]), x=np.asarray(f["x"]), y=np.asarray(f["y"]),
        temperature=np.asarray(f["temperature"]),
        electron_density=np.asarray(f["electron_density"]),
        hydrogen_populations=np.asarray(f["hydrogen_populations"]),
        velocity_z=np.asarray(f["velocity_z"]),
        velocity_x=np.asarray(f["velocity_x"]),
        velocity_y=np.asarray(f["velocity_y"]))
    pops = np.asarray(f["populations"])          # (nz, nx, ny, 3)
    lam = np.asarray(f["wavelength"]) * 1e-9     # nm on disk -> m
    return atmos, pops, lam


def _load_voronoi(f, raster):
    """Voronoi checkpoint mapping -> rasterized (Atmosphere, populations,
    lam), as read_irregular (plot_utils.jl:252-287): every per-site field
    AND the NLTE populations resampled by inverse distance onto a
    regular grid (raster (nz, nx, ny); None: a cube of side n^(1/3))."""
    positions = np.asarray(f["positions"]).T     # (n, 3) z,x,y
    bounds = np.asarray(f["boundaries"])         # z0 z1 x0 x1 y0 y1
    pops_sites = np.asarray(f["populations"])    # (n, 3)
    lam = np.asarray(f["wavelength"]) * 1e-9

    if raster is None:
        side = max(int(round(len(positions) ** (1.0 / 3.0))), 4)
        raster = (side, side, side)
    nz, nx, ny = raster
    z = np.linspace(bounds[0], bounds[1], nz)
    x = np.linspace(bounds[2], bounds[3], nx)
    y = np.linspace(bounds[4], bounds[5], ny)

    # the six fields and the three populations in one call (one
    # neighbour query)
    names = ("temperature", "electron_density", "hydrogen_populations",
             "velocity_z", "velocity_x", "velocity_y")
    out = voronoi_to_raster_inv_dist(
        _RasterSites(positions), z, x, y,
        np.concatenate([np.stack([np.asarray(f[n]) for n in names]),
                        pops_sites.T]))
    pops = np.moveaxis(out[len(names):], 0, -1)  # (nz, nx, ny, 3)
    atmos = Atmosphere(z=z, x=x, y=y, **dict(zip(names, out)))
    return atmos, pops, lam


def synthesize(atmos, populations, lam, theta=180.0, phi=0.0, n_sweeps=3,
               gamma_natural=4.702e8, n_bb=51, n_bf=20, device=None):
    """Emergent intensity cube I(lam, x, y) [IUNIT] from saved populations,
    as a numpy array, and the line rebuilt on the atmosphere: the
    plotter (plot_utils.jl:298-354) + write_top_intensity (:99-140)
    chain in one call, on `device` (default: the CUDA card), float64:
    the float32 populations of a float32 run's file are widened first
    (the JAX driver adds them in float32 before they meet its float64
    fields)."""
    device = pick_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    T, ne, nH = (t(atmos.temperature), t(atmos.electron_density),
                 t(atmos.hydrogen_populations))
    pops = t(populations)
    # the line rebuilt on this grid's temperature (Doppler widths); the
    # wavelengths come from the file (authoritative over the rebuilt
    # grid in case of forced-odd bb-count adjustments)
    line = dataclasses.replace(lyman_alpha_line(n_bb, n_bf, T),
                               lam=np.asarray(lam, dtype=np.float64))
    S_l = source_line(line, pops)                        # (nz, nx, ny)
    lte = lte_populations(line, T, ne, nH)
    a_c = alpha_absorption(line.lam0, T, ne, lte[..., 0] + lte[..., 1],
                           lte[..., 2])
    a_c = a_c + alpha_scattering(line.lam0, ne, lte[..., 0])
    gam = gamma_constant(line, T, pops[..., 0] + pops[..., 1], ne,
                         gamma_natural)
    k = _direction(theta, phi)
    v_los = line_of_sight_velocity(t(atmos.velocity_zxy()), -k)
    plan = build_plan(k, np.asarray(atmos.z), atmos.dx, atmos.dy, up=True)

    lam_t = line.lam_tensor()
    nz, nx, ny = T.shape
    I_top = np.empty((lam_t.shape[0], nx, ny))
    for b0 in range(0, lam_t.shape[0], LAMBDA_BLOCK):
        lam_b = lam_t[b0:b0 + LAMBDA_BLOCK]
        # the sweep's z-major layout (nz, block, nx, ny)
        S_t = torch.empty((nz, lam_b.shape[0], nx, ny), dtype=T.dtype,
                          device=device)
        a_t = torch.empty_like(S_t)
        for j in range(lam_b.shape[0]):
            lam_j = lam_b[j:j + 1]
            damp = damping(gam[None], lam_j.reshape(-1, 1, 1, 1),
                           line.dlamD[None])
            a_l = alpha_line(line, compute_profile(line, lam_j, damp, v_los),
                             pops[..., 1], pops[..., 0])[0]
            S_c = B_lambda(lam_j.reshape(-1, 1, 1, 1), T[None])[0]
            a_t[:, j] = a_l + a_c
            S_t[:, j] = (a_l * S_l + a_c * S_c) / a_t[:, j]
        # the boundary is the bottom S_lambda plane
        I = sweep(plan, S_t, a_t, S_t[0], n_sweeps=n_sweeps)
        I_top[b0:b0 + lam_b.shape[0]] = I[-1].cpu().numpy()
        del S_t, a_t, I
    return I_top, line


def _plot_profile(lam_nm, profile, n_bb, kind, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    order = np.argsort(lam_nm[:n_bb])
    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    ax.plot(lam_nm[:n_bb][order], profile[:n_bb][order])
    ax.set_xlabel("wavelength [nm]")
    ax.set_ylabel("intensity [kW m$^{-2}$ nm$^{-1}$]")
    ax.set_title(f"{kind}: spatially averaged Ly-alpha profile")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--out", required=True)
    ap.add_argument("--theta", type=float, default=180.0)
    ap.add_argument("--phi", type=float, default=0.0)
    ap.add_argument("--raster", type=int, nargs=3, default=None,
                    metavar=("NZ", "NX", "NY"))
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--n-sweeps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)

    import h5py
    with h5py.File(args.checkpoint, "r") as f:
        if "positions" in f:
            kind = "voronoi"
            atmos, pops, lam = _load_voronoi(f, args.raster)
        else:
            kind = "regular"
            atmos, pops, lam = _load_regular(f)
        n_bb = int(np.asarray(f["n_bb"])[0])
        n_bf = int(np.asarray(f["n_bf"])[0])

    I_top, line = synthesize(atmos, pops, lam, theta=args.theta,
                             phi=args.phi, n_sweeps=args.n_sweeps,
                             n_bb=n_bb, n_bf=n_bf, device=device)

    os.makedirs(args.out, exist_ok=True)
    lam_nm = np.asarray(lam) * 1e9
    np.save(os.path.join(args.out, f"{kind}.npy"), I_top)
    np.save(os.path.join(args.out, f"{kind}_wavelength.npy"), lam_nm)

    # spatially averaged line profile + brightness-temperature maps
    profile = I_top.mean(axis=(1, 2))
    np.save(os.path.join(args.out, f"{kind}_profile.npy"), profile)
    i_centre = int(np.argmin(np.abs(np.asarray(lam) - line.lam0)))
    i_wing = 0  # bluest bb wavelength = far wing (qwing=600 Doppler widths)
    Tb_centre = brightness_temperature(I_top[i_centre], float(lam[i_centre]))
    Tb_wing = brightness_temperature(I_top[i_wing], float(lam[i_wing]))
    np.save(os.path.join(args.out, f"{kind}_Tb_centre.npy"), Tb_centre)
    np.save(os.path.join(args.out, f"{kind}_Tb_wing.npy"), Tb_wing)

    if not args.no_plots:
        for label, idx in (("centre", i_centre), ("wing", i_wing)):
            plot_top_intensity(
                I_top[idx], atmos.x, atmos.y,
                out_png=os.path.join(args.out, f"{kind}_{label}.png"),
                title=f"{kind} {label} ({lam_nm[idx]:.4f} nm)")
        _plot_profile(lam_nm, profile, n_bb, kind,
                      os.path.join(args.out, f"{kind}_line_profile.png"))

    summary = {
        "kind": kind, "n_lambda": int(I_top.shape[0]),
        "image_shape": list(I_top.shape),
        "I_centre_mean": float(I_top[i_centre].mean()),
        "I_wing_mean": float(I_top[i_wing].mean()),
        "Tb_centre_mean": float(np.nanmean(Tb_centre)),
        "lambda_centre_nm": float(lam_nm[i_centre]),
        "lambda_wing_nm": float(lam_nm[i_wing]),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
