"""LTE continuum grid-convergence study (the plot_LTE harness).

Port of drivers/continuum_study.py (reference src/compare_continuum.jl:585,
the loop of `LTE_compare` over site counts, + `LTE_regular` at several
resolutions :123-174 + python/plot_LTE.py:18-52, the multi-size
disk-centre image comparison, the paper's key continuum result).
Artifacts use the reference's file names (I_irregular_<n>.npy,
I_regular_full/half/third/quarter.npy, study.json) so the reference's
own plotting scripts can read them.

For every Voronoi size: sample sites from the 500 nm extinction density,
tessellate, resample back to the full regular grid (inverse distance),
solve the vertical formal solution -- isolating grid-representation
error exactly like the reference.  For every regular resolution: stride
the atmosphere and solve.  The convergence metric is the relative L1
difference against the full-resolution regular image (coarse regular
images compare on their strided pixel subset).  Both solves are the
port's drivers/continuum.py.

Usage:
  python -m voronoirt_tpu_torch.drivers.continuum_study [--data F]
        [--n-sites 1e5,1e6,...] [--skips 1,2,3,4] --out DIR [--no-plots]
        [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from . import continuum as cont
from . import pick_device

_SKIP_NAME = {1: "full", 2: "half", 3: "third", 4: "quarter"}


def strided_atmosphere(atmos, skip):
    """Stride every axis/field by `skip` (the reference's get_atmos skip
    loading, atmosphere.jl:70-80, applied in-memory)."""
    if skip == 1:
        return atmos
    rep = {name: np.asarray(v)[::skip, ::skip, ::skip]
           for name, v in atmos.fields().items()}
    return dataclasses.replace(
        atmos, z=np.asarray(atmos.z)[::skip], x=np.asarray(atmos.x)[::skip],
        y=np.asarray(atmos.y)[::skip], **rep)


def rel_l1(img, ref):
    return float(np.mean(np.abs(img - ref)) / np.mean(np.abs(ref)))


def run_study(atmos, n_sites_list, skips, out_dir, seed=1998, device=None):
    """Every regular resolution (skip 1 always among them: the
    convergence reference), then every site count, on `device` (default:
    the CUDA card); writes the images and study.json to out_dir and
    returns (results, the full-resolution image)."""
    device = pick_device(device)
    os.makedirs(out_dir, exist_ok=True)
    results = {"regular": {}, "voronoi": {}}

    skips = sorted(set(skips) | {1})
    full_img = None
    for skip in skips:
        a_s = strided_atmosphere(atmos, skip)
        t0 = time.time()
        img = cont.run_regular(a_s, None, device=device)
        name = _SKIP_NAME.get(skip, f"skip{skip}")
        np.save(os.path.join(out_dir, f"I_regular_{name}.npy"), img)
        rec = {"skip": skip, "shape": list(img.shape),
               "seconds": time.time() - t0,
               "n_points": int(np.prod(a_s.shape))}
        if skip == 1:
            full_img = img
            rec["rel_l1_vs_full"] = 0.0
        else:
            rec["rel_l1_vs_full"] = rel_l1(img, full_img[::skip, ::skip])
        results["regular"][name] = rec

    for n in n_sites_list:
        t0 = time.time()
        img = cont.run_voronoi(atmos, int(n), None, seed=seed, device=device)
        np.save(os.path.join(out_dir, f"I_irregular_{int(n)}.npy"), img)
        results["voronoi"][str(int(n))] = {
            "n_sites": int(n), "seconds": time.time() - t0,
            "rel_l1_vs_full": rel_l1(img, full_img)}

    with open(os.path.join(out_dir, "study.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results, full_img


def plot_study(results, out_dir, full_img):
    """plot_LTE-style figure: image row + the convergence curve
    (matplotlib is imported here only)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sizes = sorted(int(k) for k in results["voronoi"])
    show = sizes[:: max(1, len(sizes) // 3)][:3]
    fig, axes = plt.subplots(1, len(show) + 1,
                             figsize=(3.1 * (len(show) + 1), 3.1),
                             constrained_layout=True)
    vmin, vmax = np.percentile(full_img, [2, 98])
    for ax, n in zip(axes, show):
        img = np.load(os.path.join(out_dir, f"I_irregular_{n}.npy"))
        ax.imshow(img.T, cmap="magma", origin="lower", vmin=vmin, vmax=vmax)
        ax.set_title(f"{n:,} sites")
        ax.set_xticks([]), ax.set_yticks([])
    axes[len(show)].imshow(full_img.T, cmap="magma", origin="lower",
                           vmin=vmin, vmax=vmax)
    axes[len(show)].set_title("regular (full)")
    axes[len(show)].set_xticks([]), axes[len(show)].set_yticks([])
    fig.savefig(os.path.join(out_dir, "LTE_images.png"), dpi=150)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(5, 3.5), constrained_layout=True)
    errs = [results["voronoi"][str(n)]["rel_l1_vs_full"] for n in sizes]
    ax.loglog(sizes, errs, "o-", label="Voronoi (extinction sampling)")
    for name, rec in results["regular"].items():
        if rec["skip"] == 1:
            continue
        ax.axhline(rec["rel_l1_vs_full"], ls="--", lw=0.8, color="gray")
        ax.annotate(f"regular {name} ({rec['n_points']:,} pts)",
                    (sizes[0], rec["rel_l1_vs_full"]), fontsize=7,
                    va="bottom")
    ax.set_xlabel("number of sites")
    ax.set_ylabel("rel. L1 vs full-res regular")
    ax.legend(fontsize=8)
    fig.savefig(os.path.join(out_dir, "LTE_convergence.png"), dpi=150)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--skip", type=int, default=1,
                    help="stride applied when loading --data")
    ap.add_argument("--n-sites", default="1e4,3e4,1e5,3e5,1e6",
                    help="comma list; the paper's study is 1e5...1.5e7")
    ap.add_argument("--skips", default="1,2,3,4")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=1998)
    ap.add_argument("--atmos", type=int, nargs=3, default=(48, 32, 32),
                    metavar=("NZ", "NX", "NY"),
                    help="synthetic-atmosphere shape when --data is "
                         "not given")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = pick_device(args.device)
    atmos = cont._load_atmos(args)
    n_list = [int(float(s)) for s in args.n_sites.split(",") if s]
    skips = [int(s) for s in args.skips.split(",") if s]
    results, full_img = run_study(atmos, n_list, skips, args.out,
                                  seed=args.seed, device=device)
    if not args.no_plots:
        plot_study(results, args.out, full_img)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
