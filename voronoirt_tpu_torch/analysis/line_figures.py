"""Thesis-depth NLTE line figures: regular vs Voronoi comparison.

Port of analysis/line_figures.py (reference python/plot_line.py:
disk-centre Ly-alpha images at line centre / wing / continuum,
spatially averaged profiles, brightness-temperature maps, convergence
histories; :1-665).  From two finished line_nlte runs (one --grid
regular, one --grid voronoi, written by either package) it
re-synthesizes the emergent intensity cube at several mu values through
the port's drivers/synthesize.py and writes the same summary.json and
figures as the JAX script.

A run is read from an HDF5 path or from any mapping of the checkpoint's
datasets (h5py is imported for a path only); matplotlib is imported only
to draw, and nothing is drawn under --no-plots.  The syntheses run on
the CUDA card unless a device is named.

Usage:
  python -m voronoirt_tpu_torch.analysis.line_figures REG.h5 VOR.h5
        --out DIR [--raster NZ NX NY] [--mus 1.0 0.6 0.2] [--no-plots]
        [--device cpu]
"""

import argparse
import dataclasses
import json
import os

import numpy as np

from ..drivers import pick_device
from ..drivers.synthesize import _load_regular, _load_voronoi, synthesize
from .plots import _plt, brightness_temperature

# the mu of the disk-centre panels
DISK_CENTRE = 1.0


def load_run(src, raster=None):
    """A line_nlte checkpoint (HDF5 path or mapping of its datasets) as
    the dict the figures take: kind, the (rasterized, for a Voronoi run)
    atmosphere, populations and wavelengths [m], n_bb, n_bf, the
    convergence history without its unwritten zeros, and the run's
    seconds (None where the file has no time)."""
    if isinstance(src, (str, os.PathLike)):
        import h5py
        with h5py.File(src, "r") as f:
            return load_run(f, raster)
    kind = "voronoi" if "positions" in src else "regular"
    if kind == "voronoi":
        atmos, pops, lam = _load_voronoi(src, raster)
    else:
        atmos, pops, lam = _load_regular(src)
    conv = np.asarray(src["convergence"])
    return dict(kind=kind, atmos=atmos, pops=pops, lam=lam,
                n_bb=int(np.asarray(src["n_bb"])[0]),
                n_bf=int(np.asarray(src["n_bf"])[0]),
                convergence=conv[conv > 0],
                time=(float(np.asarray(src["time"])[0]) if "time" in src
                      else None))


def theta_for_mu(mu):
    """Upward sweeps have theta > 90 deg, mu = |cos theta|
    (lambda_iteration.jl:38-44)."""
    return float(np.degrees(np.arccos(-abs(mu))))


def synthesize_mu(run, mu, phi=0.0, n_sweeps=3, device=None):
    """The emergent intensity cube (lam, x, y) of `run` at mu, and the
    line rebuilt on its atmosphere, its Doppler-width field moved to the
    host: the cubes of a figure set are kept together, and their fields
    held on the card would add to every later synthesis's peak."""
    I_top, line = synthesize(run["atmos"], run["pops"], run["lam"],
                             theta=theta_for_mu(mu), phi=phi,
                             n_sweeps=n_sweeps, n_bb=run["n_bb"],
                             n_bf=run["n_bf"], device=device)
    return I_top, dataclasses.replace(line, dlamD=line.dlamD.cpu())


def _panels(runs, cubes):
    """Per run: (kind, disk-centre cube, wavelengths, (centre, wing,
    continuum) indices).  Wing = the bluest bb point (qwing = 600
    Doppler widths); continuum = the first bf point beyond the bb
    window (plot_line.py's lambda picks)."""
    panels = []
    for run in runs:
        I_top, line = cubes[(run["kind"], DISK_CENTRE)]
        lam = np.asarray(run["lam"])
        i_centre = int(np.argmin(np.abs(lam - line.lam0)))
        i_cont = run["n_bb"] if len(lam) > run["n_bb"] else len(lam) - 1
        panels.append((run["kind"], I_top, lam, (i_centre, 0, i_cont)))
    return panels


def figures(runs, mus, out=None, plots=True, device=None):
    """The regular-vs-Voronoi comparison of two loaded runs (regular
    first): each (kind, mu) cube synthesized once on `device` (default:
    the CUDA card).  Returns (summary, cubes), cubes[(kind, mu)] = (I_top,
    line); with `plots`, writes the five figures under `out`."""
    if [r["kind"] for r in runs] != ["regular", "voronoi"]:
        raise ValueError("pass the regular checkpoint first, the voronoi "
                         "one second")
    if DISK_CENTRE not in mus:
        raise ValueError(f"mus must hold {DISK_CENTRE} (the disk-centre "
                         f"panels)")
    if plots and out is None:
        raise ValueError("plots need an output directory")
    device = pick_device(device)
    cubes = {(run["kind"], mu): synthesize_mu(run, mu, device=device)
             for run in runs for mu in mus}

    summary = {"mus": list(mus), "profiles": {}}
    for run in runs:
        n_bb, kind = run["n_bb"], run["kind"]
        order = np.argsort(np.asarray(run["lam"])[:n_bb] * 1e9)
        for mu in mus:
            prof = cubes[(kind, mu)][0].mean(axis=(1, 2))
            summary["profiles"][f"{kind}_mu{mu:g}"] = \
                prof[:n_bb][order].tolist()

    # relative-difference map at line centre (grid-representation
    # error, the test_interpolation analog on the emergent intensity)
    panels = _panels(runs, cubes)
    (_, I0, _, (ic0, _, _)), (_, I1, _, (ic1, _, _)) = panels
    rel = None
    if I0[ic0].shape == I1[ic1].shape:
        rel = (I1[ic1] - I0[ic0]) / np.maximum(np.abs(I0[ic0]), 1e-30)
        summary["centre_rel_diff_rms"] = float(np.sqrt(np.mean(rel ** 2)))
    summary["iterations"] = {r["kind"]: int(len(r["convergence"]))
                             for r in runs}
    summary["final_diff"] = {r["kind"]: float(r["convergence"][-1])
                             for r in runs}
    summary["wall_seconds"] = {r["kind"]: r["time"] for r in runs}
    if plots:
        _draw(runs, mus, cubes, panels, rel, out)
    return summary, cubes


def _draw(runs, mus, cubes, panels, rel, out):
    """The JAX script's five figures (the last only where the two
    line-centre images share a shape)."""
    plt = _plt()

    def save(fig, name):
        fig.savefig(os.path.join(out, f"{name}.png"), bbox_inches="tight")
        plt.close(fig)

    # convergence histories (plot_utils.jl:357-392 analog)
    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    for run, style in zip(runs, ("o-", "s--")):
        ax.semilogy(np.arange(1, len(run["convergence"]) + 1),
                    run["convergence"], style, label=run["kind"], ms=3)
    ax.set_xlabel("iteration")
    ax.set_ylabel("max rel. change of S")
    ax.axhline(1e-3, color="k", lw=0.5, ls=":")
    ax.legend()
    ax.set_title("Lambda-iteration convergence")
    save(fig, "convergence")

    # multi-mu spatially averaged profiles (plot_line.py analog)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4), dpi=150, sharey=True)
    for ax, run in zip(axes, runs):
        lam_nm = np.asarray(run["lam"])[:run["n_bb"]] * 1e9
        order = np.argsort(lam_nm)
        for mu in mus:
            ax.plot(lam_nm[order], cubes[(run["kind"], mu)][0].mean(
                axis=(1, 2))[:run["n_bb"]][order], label=f"mu={mu:g}")
        ax.set_xlabel("wavelength [nm]")
        ax.set_title(run["kind"])
        ax.legend()
    axes[0].set_ylabel("mean intensity [kW m$^{-2}$ nm$^{-1}$]")
    fig.suptitle("Ly-alpha emergent profiles, centre-to-limb")
    save(fig, "profiles_multi_mu")

    # disk-centre images at line centre / wing / continuum
    fig, axes = plt.subplots(2, 3, figsize=(12, 7.5), dpi=150)
    for row, (kind, I_top, lam, idxs) in enumerate(panels):
        for col, (label, idx) in enumerate(zip(
                ("line centre", "far wing", "continuum"), idxs)):
            ax = axes[row, col]
            im = ax.imshow(I_top[idx].T, origin="lower", cmap="magma")
            ax.set_title(f"{kind}: {label}\n{lam[idx]*1e9:.3f} nm",
                         fontsize=9)
            fig.colorbar(im, ax=ax, shrink=0.8)
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle("Disk-centre Ly-alpha intensity [kW m$^{-2}$ nm$^{-1}$]")
    save(fig, "images_centre_wing_cont")

    # brightness-temperature maps at centre and wing
    fig, axes = plt.subplots(2, 2, figsize=(9, 7.5), dpi=150)
    for row, (kind, I_top, lam, (i_centre, i_wing, _)) in enumerate(panels):
        for col, (label, idx) in enumerate(
                zip(("centre", "wing"), (i_centre, i_wing))):
            ax = axes[row, col]
            im = ax.imshow(brightness_temperature(
                I_top[idx], float(lam[idx])).T, origin="lower",
                cmap="inferno")
            ax.set_title(f"{kind}: T$_b$ {label}", fontsize=9)
            fig.colorbar(im, ax=ax, shrink=0.8)
            ax.set_xticks([])
            ax.set_yticks([])
    save(fig, "brightness_temperature")

    if rel is not None:
        fig, ax = plt.subplots(figsize=(5.5, 4.5), dpi=150)
        im = ax.imshow(rel.T, origin="lower", cmap="RdBu_r", vmin=-0.5,
                       vmax=0.5)
        fig.colorbar(im, ax=ax, label="(voronoi - regular)/regular")
        ax.set_title("line-centre intensity: relative difference")
        ax.set_xticks([])
        ax.set_yticks([])
        save(fig, "relative_difference")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("regular")
    ap.add_argument("voronoi")
    ap.add_argument("--out", required=True)
    ap.add_argument("--raster", type=int, nargs=3, default=None,
                    metavar=("NZ", "NX", "NY"))
    ap.add_argument("--mus", type=float, nargs="+", default=[1.0, 0.6, 0.2])
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    runs = [load_run(args.regular, args.raster),
            load_run(args.voronoi, args.raster)]
    summary, _ = figures(runs, args.mus, out=args.out,
                         plots=not args.no_plots, device=device)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in
                      ("iterations", "final_diff", "wall_seconds",
                       "centre_rel_diff_rms") if k in summary}))
    return summary


if __name__ == "__main__":
    main()
