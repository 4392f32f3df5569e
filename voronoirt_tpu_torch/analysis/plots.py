"""Analysis / figure helpers (L6).

Port of analysis/plots.py: the same functions, arguments and return
values (reference python/*.py thesis figures and src/plot_utils.jl):

  plot_searchlight       beam image + analytic circle overlay
                         (plot_utils.jl:25-59, python/plot_searchlight.py)
  plot_convergence       convergence history (plot_utils.jl:357-392)
  plot_top_intensity     disk-centre intensity images
                         (plot_utils.jl:61-140, python/plot_LTE.py)
  line_profile           spatially averaged emergent line profile
                         (python/plot_line.py)
  brightness_temperature Planck inversion of intensity
                         (python/brightness_temperature.py:5-29)
  plot_source_function   S cuts vs height (python/plot_source.py)
  plot_grid_layers       site/layer structure (python/plot_grid.py,
                         plot_layers.py)
  tau_unity_height       tau=1 surface for vertical and slanted rays
                         (plot_utils.jl:434-576)
  scaling_plot           chip/thread scaling (python/plot_threads_time.py)

A figure is drawn only when the call is given out_png, and matplotlib is
imported only then.  The tau=1 surfaces take numpy arrays or tensors and
compute in torch, float64, on the input's device: every column at once,
with torch.searchsorted on the monotone tau columns; they return a
tensor for a tensor and a numpy array otherwise.  The other helpers
compute in numpy, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import IUNIT_SI, c_0, h, k_B


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _numpy(a):
    """a on the host, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _float64(a, device=None):
    """a as a float64 tensor: on its own device for a tensor, else on
    `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def _at(cols, idx):
    """cols[i, idx[i]] for every column i."""
    return cols.gather(1, idx[:, None])[:, 0]


def analytic_beam_center(k):
    """Translated beam centre mod the unit box (plot_utils.jl:35-47)."""
    xr = (0.5 - np.sign(k[0]) * k[1] / k[0]) % 1.0
    yr = (0.5 - np.sign(k[0]) * k[2] / k[0]) % 1.0
    return xr, yr


def plot_searchlight(k, x, y, I, R0, title, out_png=None):
    xr, yr = analytic_beam_center(k)
    if out_png:
        plt = _plt()
        fig, ax = plt.subplots(dpi=150)
        ax.pcolormesh(x, y, I.T, vmin=0, vmax=1)
        th = np.linspace(0, 2 * np.pi, 500)
        ax.plot(xr + R0 * np.cos(th), yr + R0 * np.sin(th), "r", lw=2)
        ax.set(title=title, xlabel="x", ylabel="y", aspect="equal")
        fig.savefig(out_png)
        plt.close(fig)
    return xr, yr


def plot_convergence(convergence, out_png=None, label=None):
    """log-scale max relative S change per iteration."""
    conv = np.asarray(convergence)
    conv = conv[conv > 0]
    if out_png:
        plt = _plt()
        fig, ax = plt.subplots(dpi=150)
        ax.semilogy(np.arange(1, len(conv) + 1), conv, "o-", label=label)
        ax.set(xlabel="iteration", ylabel="max relative change in S")
        if label:
            ax.legend()
        fig.savefig(out_png)
        plt.close(fig)
    return conv


def brightness_temperature(I_lam, lam):
    """Invert Planck: T_b such that B_lambda(lam, T_b) = I.

    I in IUNIT (kW m^-2 nm^-1); mirrors
    python/brightness_temperature.py:5-29.
    """
    I_si = np.asarray(I_lam) * IUNIT_SI
    arg = 1.0 + 2.0 * h * c_0**2 / (lam**5 * np.maximum(I_si, 1e-300))
    return h * c_0 / (lam * k_B * np.log(arg))


def line_profile(S_or_I, axis=None):
    """Spatially averaged profile over all non-wavelength axes."""
    arr = np.asarray(S_or_I)
    axes = tuple(range(1, arr.ndim)) if axis is None else axis
    return arr.mean(axis=axes)


def plot_top_intensity(I_image, x, y, out_png=None, title="disk centre"):
    if out_png:
        plt = _plt()
        fig, ax = plt.subplots(dpi=150)
        im = ax.pcolormesh(x / 1e6, y / 1e6, I_image.T)
        fig.colorbar(im, label="I [kW m$^{-2}$ nm$^{-1}$]")
        ax.set(title=title, xlabel="x [Mm]", ylabel="y [Mm]",
               aspect="equal")
        fig.savefig(out_png)
        plt.close(fig)
    return I_image


def plot_source_function(S, z, lam_index, out_png=None):
    """Horizontally averaged S(z) at one wavelength."""
    prof = np.asarray(S)[lam_index].mean(axis=(1, 2))
    if out_png:
        plt = _plt()
        fig, ax = plt.subplots(dpi=150)
        ax.semilogy(z / 1e6, prof)
        ax.set(xlabel="z [Mm]", ylabel="S [kW m$^{-2}$ nm$^{-1}$]")
        fig.savefig(out_png)
        plt.close(fig)
    return prof


def tau_unity_height(alpha, z):
    """Height where vertical optical depth (integrated from the top)
    reaches 1 (plot_utils.jl:434-520, vertical variant).

    alpha: (nz, nx, ny); returns (nx, ny) heights.  tau is the reversed
    cumulative trapezoid from the top (functions.jl cumtrapz); each
    column's crossing is found by a left-sided search of its rising
    tau, clipped to the grid, and interpolated linearly in height (a
    column whose two bracketing tau are equal takes the lower height).
    """
    a = _float64(alpha)
    zt = _float64(z, a.device)
    nz = zt.shape[0]
    dz = zt[1:] - zt[:-1]
    tau = torch.zeros_like(a)
    tau[:-1] = torch.flip(torch.cumsum(torch.flip(
        0.5 * dz[:, None, None] * (a[:-1] + a[1:]), (0,)), 0), (0,))
    cols = tau.reshape(nz, -1).T                 # (columns, nz), falling
    rising = torch.flip(cols, (1,)).contiguous()
    found = torch.searchsorted(
        rising, torch.ones((rising.shape[0], 1), dtype=a.dtype,
                           device=a.device))[:, 0]
    idx = torch.clamp(nz - 1 - found, 0, nz - 2)
    t0, t1 = _at(cols, idx + 1), _at(cols, idx)
    f = (1.0 - t0) / (t1 - t0)
    heights = torch.where(t1 == t0, zt[idx],
                          zt[idx + 1] + f * (zt[idx] - zt[idx + 1]))
    heights = heights.reshape(a.shape[1:])
    return heights if isinstance(alpha, torch.Tensor) else \
        heights.cpu().numpy()


def tau_unity_height_slanted(alpha, z, x, y, k):
    """Height where optical depth along a slanted ray reaches 1.

    Reference parity: plot_utils.jl:521-576 (write_tau_unity, slanted
    variant) -- march from the top along direction k, bilinearly
    sampling alpha at the ray's periodic-wrapped (x, y) per level and
    accumulating tau over the path length.  Two reference quirks are
    corrected here (documented, not reproduced): its x/y periodic wrap
    assigns to misspelled variables (plot_utils.jl:553,560 `x_mrx`), and
    its horizontal offset is not accumulated along the ray (each level
    samples one step from the ORIGINAL column instead of following the
    characteristic).

    alpha: (nz, nx, ny); z ascending; k = (kz, kx, ky) with kz < 0 for a
    ray traced downward from the top.  Returns (nx, ny) heights.  The
    path and offsets are host scalars; each level's periodic bilinear
    sample is a torch.roll of the whole plane to the accumulated offset.
    """
    a = _float64(alpha)
    z, x, y = _numpy(z), _numpy(x), _numpy(y)
    nz, nx, ny = a.shape
    dx = x[1] - x[0]
    dy = y[1] - y[0]

    def sample(plane, ox, oy):
        """Bilinear at (x + ox, y + oy), periodic (uniform grid)."""
        fx, ix0 = np.modf(ox / dx % nx)
        fy, iy0 = np.modf(oy / dy % ny)
        p = torch.roll(plane, (-int(ix0), -int(iy0)), dims=(0, 1))
        p1 = torch.roll(p, -1, dims=0)
        py = (1 - fy) * p + fy * torch.roll(p, -1, dims=1)
        p1y = (1 - fy) * p1 + fy * torch.roll(p1, -1, dims=1)
        return (1 - fx) * py + fx * p1y

    # march from the top (z[-1]) downward; cumulative horizontal offset
    a_col = torch.empty_like(a)
    a_col[0] = a[-1]
    path = np.zeros(nz)
    ox = oy = 0.0
    for kk in range(1, nz):
        dz = z[nz - kk] - z[nz - kk - 1]
        r = abs(dz / k[0])
        path[kk] = path[kk - 1] + r
        ox -= r * k[1]
        oy -= r * k[2]
        a_col[kk] = sample(a[nz - kk - 1], ox, oy)

    dpath = torch.as_tensor(path[1:] - path[:-1], device=a.device)
    tau = torch.zeros_like(a)
    tau[1:] = torch.cumsum(
        0.5 * dpath[:, None, None] * (a_col[1:] + a_col[:-1]), 0)

    cols = tau.reshape(nz, -1).T.contiguous()    # (columns, nz), rising
    found = torch.searchsorted(
        cols, torch.ones((cols.shape[0], 1), dtype=a.dtype,
                         device=a.device))[:, 0]
    idx = torch.clamp(found, 1, nz - 1)
    t0, t1 = _at(cols, idx - 1), _at(cols, idx)
    f = torch.where(t1 == t0, 0.0, (1.0 - t0) / (t1 - t0))
    z_desc = torch.as_tensor(z[::-1].copy(), dtype=torch.float64,
                             device=a.device)
    heights = (z_desc[idx - 1] + f * (z_desc[idx] - z_desc[idx - 1])
               ).reshape(nx, ny)
    return heights if isinstance(alpha, torch.Tensor) else \
        heights.cpu().numpy()


def plot_grid_layers(sites, out_png=None):
    """Layer counts and neighbour statistics (python/plot_layers.py)."""
    stats = dict(
        n_sites=sites.n,
        layers_up=int(sites.layers_up.max()),
        layers_down=int(sites.layers_down.max()),
        mean_neighbours=float(sites.neighbours[:, 0].mean()),
        max_neighbours=int(sites.neighbours[:, 0].max()),
    )
    if out_png:
        plt = _plt()
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5), dpi=150)
        axes[0].hist(sites.layers_up, bins=sites.layers_up.max())
        axes[0].set(xlabel="BFS layer (up)", ylabel="sites")
        axes[1].hist(sites.neighbours[:, 0], bins=30)
        axes[1].set(xlabel="neighbour count", ylabel="sites")
        fig.tight_layout()
        fig.savefig(out_png)
        plt.close(fig)
    return stats


def scaling_plot(counts, times, out_png=None, xlabel="chips"):
    """Scaling efficiency table/plot (python/plot_threads_time.py analog).

    Returns the parallel efficiency per entry."""
    counts = np.asarray(counts, dtype=float)
    times = np.asarray(times, dtype=float)
    speedup = times[0] / times
    eff = speedup / (counts / counts[0])
    if out_png:
        plt = _plt()
        fig, ax = plt.subplots(dpi=150)
        ax.plot(counts, speedup, "o-", label="measured")
        ax.plot(counts, counts / counts[0], "k--", label="ideal")
        ax.set(xlabel=xlabel, ylabel="speedup")
        ax.legend()
        fig.savefig(out_png)
        plt.close(fig)
    return eff
