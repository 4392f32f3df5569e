"""Inputs of the benchmark, made from the seed: the model atmosphere.

`synthetic_atmosphere` is the repository's hermetic stand-in for the
Bifrost snapshot the published runs used (a FAL-C-like stratification
with sinusoidal horizontal structure and a smooth velocity field),
copied here so that the yardstick's inputs do not move with the program.
The seed sets only the two phases of the horizontal pattern: every seed
gives the same sizes and the same kinds of structure, in another place.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("temperature", "electron_density", "hydrogen_populations",
          "velocity_z", "velocity_x", "velocity_y")


def synthetic_atmosphere(nz, nx, ny, seed, z_top=2.0e6, z_bottom=-0.1e6,
                         horiz_extent=2.0e6, perturb=0.15):
    """{'z', 'x', 'y', field: (nz, nx, ny) float64} in SI units; z, x, y
    ascending, x and y equidistant."""
    rng = np.random.default_rng(seed)
    z = np.linspace(z_bottom, z_top, nz)
    x = np.linspace(0.0, horiz_extent, nx)
    y = np.linspace(0.0, horiz_extent, ny)

    zn = (z - z_bottom) / (z_top - z_bottom)
    T_strat = (6500.0 - 2300.0 * np.exp(-((zn - 0.28) / 0.18) ** 2)
               + 4500.0 * zn**3)
    nH_strat = 10 ** (23.0 - 6.0 * zn)
    ne_strat = 10 ** (19.5 - 4.0 * zn)

    kx = 2.0 * np.pi / horiz_extent
    X, Y = np.meshgrid(x, y, indexing="ij")
    phase1, phase2 = rng.uniform(0, 2 * np.pi, 2)
    horiz = (np.sin(kx * X + phase1) * np.cos(kx * Y + phase2))

    T = T_strat[:, None, None] * (1.0 + perturb * horiz[None])
    nH = nH_strat[:, None, None] * (1.0 - perturb * horiz[None])
    ne = ne_strat[:, None, None] * (1.0 - perturb * horiz[None])

    v_amp = 3.0e3  # m/s
    vz = v_amp * horiz[None] * np.sin(np.pi * zn)[:, None, None]
    vx = 0.5 * v_amp * np.cos(kx * Y)[None] * np.ones_like(T)
    vy = 0.5 * v_amp * np.sin(kx * X)[None] * np.ones_like(T)

    return dict(z=z, x=x, y=y, temperature=T, electron_density=ne,
                hydrogen_populations=nH, velocity_z=vz, velocity_x=vx,
                velocity_y=vy)


def trilinear(z_q, x_q, y_q, z, x, y, vals):
    """Trilinear interpolation of vals (nz, nx, ny) on ascending axes at
    the query points, clamped into the grid."""
    def locate(axis, q):
        return np.clip(np.searchsorted(axis, q, side="left") - 1, 0,
                       len(axis) - 2)

    iz, ix, iy = locate(z, z_q), locate(x, x_q), locate(y, y_q)
    zd = (z_q - z[iz]) / (z[iz + 1] - z[iz])
    xd = (x_q - x[ix]) / (x[ix + 1] - x[ix])
    yd = (y_q - y[iy]) / (y[iy + 1] - y[iy])
    c = 0.0
    for dz, wz in ((0, 1 - zd), (1, zd)):
        for dx, wx in ((0, 1 - xd), (1, xd)):
            for dy, wy in ((0, 1 - yd), (1, yd)):
                c = c + wz * wx * wy * vals[iz + dz, ix + dx, iy + dy]
    return c


DENSITIES = {
    # log10(n_H)^-2 T^(-2/5), the paper's production sampling density
    # (sample_grids.jl:223-230)
    "invNH_invT": lambda a: (np.log10(a["hydrogen_populations"]) ** -2.0
                             * a["temperature"] ** (-2.0 / 5.0)),
}


def sample_sites(atmos, n_sites, density, seed):
    """(positions (n, 3) ordered (z, x, y), bounds): accept-reject
    sampling with the named density (functions.jl:90-117)."""
    rng = np.random.default_rng(seed)
    q = DENSITIES[density](atmos)
    q_min, dq = q.min(), q.max() - q.min()
    z, x, y = atmos["z"], atmos["x"], atmos["y"]
    batch = max(4 * n_sites, 1024)
    out = np.empty((n_sites, 3))
    got = 0
    while got < n_sites:
        zq = rng.uniform(z[0], z[-1], batch)
        xq = rng.uniform(x[0], x[-1], batch)
        yq = rng.uniform(y[0], y[-1], batch)
        dens = trilinear(zq, xq, yq, z, x, y, q)
        sel = np.nonzero(dens > rng.uniform(0.0, 1.0, batch) * dq
                         + q_min)[0][:n_sites - got]
        out[got:got + len(sel)] = np.stack([zq[sel], xq[sel], yq[sel]], 1)
        got += len(sel)
    bounds = (z[0], z[-1], x[0], x[-1], y[0], y[-1])
    return out, tuple(float(b) for b in bounds)


def site_fields(pos, atmos):
    """Every field of the atmosphere trilinear at the sites."""
    return {k: trilinear(pos[:, 0], pos[:, 1], pos[:, 2], atmos["z"],
                         atmos["x"], atmos["y"], atmos[k]) for k in FIELDS}
