"""Grid <-> site resampling.

Reference parity: src/voronoi_utils.jl:407-860 -- `initialise` (trilinear
atmosphere -> sites), `Voronoi_to_Raster` (KDTree nearest-neighbour) and
`Voronoi_to_Raster_inv_dist` (inverse-distance-power, k=2 neighbours,
p=1) -- plus the trilinear/bilinear helpers of src/functions.jl:199-384.
Host-side numpy (preprocessing, not on the jit path), fully vectorized.

The port's own copy of voronoirt_tpu/grid/interpolate.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import numpy as np


def trilinear(z_q, x_q, y_q, z, x, y, vals):
    """Vectorized trilinear interpolation (functions.jl:199-292).

    z/x/y ascending axes; vals (nz, nx, ny); query points are clamped into
    the grid interior (the reference assumes in-bounds queries).
    """
    def locate(axis, q):
        i = np.searchsorted(axis, q, side="left") - 1
        return np.clip(i, 0, len(axis) - 2)

    iz, ix, iy = locate(z, z_q), locate(x, x_q), locate(y, y_q)
    zd = (z_q - z[iz]) / (z[iz + 1] - z[iz])
    xd = (x_q - x[ix]) / (x[ix + 1] - x[ix])
    yd = (y_q - y[iy]) / (y[iy + 1] - y[iy])

    c = 0.0
    for dz_, wz in ((0, 1 - zd), (1, zd)):
        for dx_, wx in ((0, 1 - xd), (1, xd)):
            for dy_, wy in ((0, 1 - yd), (1, yd)):
                c = c + wz * wx * wy * vals[iz + dz_, ix + dx_, iy + dy_]
    return c


def initialise_sites(positions, atmos, log_fields=()):
    """Per-site fields by trilinear interpolation of the atmosphere.

    Mirrors `initialise` (voronoi_utils.jl:686-708): plain trilinear for
    every field.  `log_fields` optionally interpolates chosen fields in
    log10 space (an accuracy option beyond the reference; off by default
    for parity).
    """
    zq, xq, yq = positions[:, 0], positions[:, 1], positions[:, 2]
    out = {}
    for name, vals in atmos.fields().items():
        if name in log_fields:
            out[name] = 10.0 ** trilinear(zq, xq, yq, atmos.z, atmos.x,
                                          atmos.y, np.log10(vals))
        else:
            out[name] = trilinear(zq, xq, yq, atmos.z, atmos.x, atmos.y,
                                  vals)
    return out


def initialise_nearest_corner(positions, atmos):
    """Per-site fields from the nearest cell corner.

    Mirrors `initialiseII` (voronoi_utils.jl:716-769): locate the grid
    cell containing each site, pick the closest of its 8 corners, and
    copy that corner's values.  (The reference's version also copies
    electron_density into N_H -- a bug not reproduced here.)
    """
    zq, xq, yq = positions[:, 0], positions[:, 1], positions[:, 2]

    def locate(axis, q):
        i = np.searchsorted(axis, q, side="left") - 1
        return np.clip(i, 0, len(axis) - 2)

    iz, ix, iy = (locate(atmos.z, zq), locate(atmos.x, xq),
                  locate(atmos.y, yq))
    best_d = None
    best = None
    for dz_ in (0, 1):
        for dx_ in (0, 1):
            for dy_ in (0, 1):
                d = ((atmos.z[iz + dz_] - zq) ** 2
                     + (atmos.x[ix + dx_] - xq) ** 2
                     + (atmos.y[iy + dy_] - yq) ** 2)
                corner = (iz + dz_, ix + dx_, iy + dy_)
                if best_d is None:
                    best_d, best = d, [np.array(c) for c in corner]
                else:
                    better = d < best_d
                    best_d = np.where(better, d, best_d)
                    best = [np.where(better, c, b)
                            for c, b in zip(corner, best)]
    bz, bx, by = best
    return {name: vals[bz, bx, by] for name, vals in atmos.fields().items()}


def _grid_query_points(z, x, y):
    Z, X, Y = np.meshgrid(z, x, y, indexing="ij")
    return np.stack([Z.ravel(), X.ravel(), Y.ravel()], axis=1)


def voronoi_to_raster_nn(sites, z, x, y, site_values):
    """Nearest-neighbour resample of per-site values onto a regular grid.

    Mirrors Voronoi_to_Raster (voronoi_utils.jl:437-454, KDTree nn).
    site_values: (..., n) -- trailing site axis; returns (..., nz, nx, ny).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(sites.positions)
    q = _grid_query_points(z, x, y)
    _, idx = tree.query(q)
    vals = np.asarray(site_values)[..., idx]
    return vals.reshape(vals.shape[:-1] + (len(z), len(x), len(y)))


def voronoi_to_raster_inv_dist(sites, z, x, y, site_values, k=2, p=1.0):
    """Inverse-distance-power resample (voronoi_utils.jl:773-816,
    `inv_dist_itp` :848-860: k=2 neighbours, power p=1)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(sites.positions)
    q = _grid_query_points(z, x, y)
    dist, idx = tree.query(q, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    w = 1.0 / np.maximum(dist, 1e-30) ** p
    w /= w.sum(axis=1, keepdims=True)
    vals = np.asarray(site_values)
    out = np.einsum("...qk,qk->...q", vals[..., idx], w)
    return out.reshape(vals.shape[:-1] + (len(z), len(x), len(y)))
