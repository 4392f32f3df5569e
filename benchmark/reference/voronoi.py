"""Plain reference of one Lambda iteration on a Voronoi grid.

Its own tessellation (the Delaunay neighbours of the sites, periodic in
x and y, walled in z, from scipy), its own BFS layers from the walls,
and per direction the two most upwind neighbours (the largest dot
products of the Delaunay lines with k, the second dropped where its dot
is not positive), blend weights d^p / sum d^p and min-image path
lengths.  The sweep is the published 'layer' order (irregular_ray_
tracing.jl:37-79): layer after layer, n_sweeps Gauss-Seidel passes a
layer over its sites in id order (descending for down sweeps), each
site's intensity the weighted two-point linear solutions from its
upwinds.  The passes run in parallel levels that keep that order's
reads exactly: a site reads an upwind that comes before it in the layer
after the upwind's update in the same pass, and one that comes after it
before.  Then J, S, the rates and the statistical equilibrium as on the
regular grid.  Plain PyTorch and numpy, float64; it imports nothing of
the program under test.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from . import physics as ph
from .regular import linear_weights

BOTTOM, TOP = -5, -6


# -------------------------------------------------------------- the grid

def neighbours(pos, bounds, margin_spacings=8.0):
    """Per-site sorted arrays of Delaunay neighbour ids (BOTTOM / TOP for
    the z walls): a Delaunay triangulation of the sites with their
    periodic images near the x and y sides and their mirror images
    across the z walls, within margin_spacings mean spacings."""
    from scipy.spatial import Delaunay
    z0, z1, x0, x1, y0, y1 = bounds
    Lx, Ly = x1 - x0, y1 - y0
    n = len(pos)
    m = margin_spacings * ((z1 - z0) * Lx * Ly / n) ** (1.0 / 3.0)
    z, x, y = pos[:, 0], pos[:, 1], pos[:, 2]
    pts, ids = [np.stack([x, y, z], 1)], [np.arange(n)]
    for ox in (-Lx, 0.0, Lx):
        for oy in (-Ly, 0.0, Ly):
            if ox == 0.0 and oy == 0.0:
                continue
            sel = np.ones(n, bool)
            if ox:
                sel &= (x - x0 < m) if ox > 0 else (x1 - x < m)
            if oy:
                sel &= (y - y0 < m) if oy > 0 else (y1 - y < m)
            pts.append(np.stack([x[sel] + ox, y[sel] + oy, z[sel]], 1))
            ids.append(np.nonzero(sel)[0])
    for wall, zw in ((BOTTOM, z0), (TOP, z1)):
        sel = np.abs(z - zw) < m
        pts.append(np.stack([x[sel], y[sel], 2 * zw - z[sel]], 1))
        ids.append(np.full(int(sel.sum()), wall))
    P, ID = np.concatenate(pts), np.concatenate(ids)
    indptr, indices = Delaunay(P).vertex_neighbor_vertices
    # the first n points are the sites themselves
    owner = np.repeat(np.arange(n), np.diff(indptr[:n + 1]))
    pair = np.unique(np.stack([owner, ID[indices[:indptr[n]]]], 1), axis=0)
    pair = pair[pair[:, 0] != pair[:, 1]]
    return np.split(pair[:, 1], np.searchsorted(pair[:, 0],
                                                np.arange(1, n)))


def cached_neighbours(pos, bounds, cache_dir):
    """padded(neighbours()), kept under the sites' own key in
    cache_dir."""
    key = hashlib.sha256(np.ascontiguousarray(pos).tobytes()
                         + np.asarray(bounds, np.float64).tobytes()
                         ).hexdigest()[:24]
    path = Path(cache_dir) / f"reference-neighbours-{key}.npy"
    if path.exists():
        return np.load(path)
    nb = padded(neighbours(pos, bounds))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, nb)
    tmp.replace(path)
    return nb


def bfs_layers(nb, wall):
    """1 for the sites touching the wall, then the graph distance + 1;
    nb: padded neighbour ids (n, W)."""
    n = len(nb)
    lay = np.zeros(n, np.int64)
    front = np.nonzero((nb == wall).any(1))[0]
    lay[front] = 1
    level = 1
    while front.size:
        cand = np.unique(nb[front].ravel())
        cand = cand[cand >= 0]
        cand = cand[lay[cand] == 0]
        lay[cand] = level + 1
        front = cand
        level += 1
    lay[lay == 0] = level + 1
    return lay


def padded(nb):
    """(n, W) int64 ids, -1 past each site's count."""
    counts = np.array([len(a) for a in nb])
    out = np.full((len(nb), counts.max()), -1, np.int64)
    out[np.arange(out.shape[1])[None, :] < counts[:, None]] = \
        np.concatenate(nb)
    return out


class Sites:
    """The reference's grid: positions (z, x, y), neighbours, layers and
    the per-site fields on the device."""

    def __init__(self, pos, bounds, fields, device, cache_dir):
        self.pos, self.bounds = np.asarray(pos, np.float64), bounds
        self.nb = cached_neighbours(self.pos, bounds, cache_dir)
        self.layers = {True: bfs_layers(self.nb, BOTTOM),
                       False: bfs_layers(self.nb, TOP)}
        # the Delaunay lines: unit vectors to each neighbour, min-image
        # in x and y
        self.valid = self.nb >= 0
        d = self.min_image(self.pos[np.where(self.valid, self.nb, 0)]
                           - self.pos[:, None, :])
        norm = np.linalg.norm(d, axis=-1)
        self.lines = d / np.where(norm > 0, norm, 1.0)[..., None]

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=device)
        self.T = f(fields["temperature"])
        self.ne = f(fields["electron_density"])
        self.nH = f(fields["hydrogen_populations"])
        self.v = torch.stack([f(fields["velocity_z"]), f(fields["velocity_x"]),
                              f(fields["velocity_y"])], -1)

    def min_image(self, d):
        """Displacements (..., 3) (z, x, y) to their periodic minimum."""
        z0, z1, x0, x1, y0, y1 = self.bounds
        d[..., 1] -= (x1 - x0) * np.round(d[..., 1] / (x1 - x0))
        d[..., 2] -= (y1 - y0) * np.round(d[..., 2] / (y1 - y0))
        return d


# ------------------------------------------------------------- the plans

def plan(sites, k, up, p):
    """(upwind (n, 2), weights (n, 2), r (n, 2), bc sites, level rows):
    level rows is the pass-ordered list of id arrays that one Jacobi
    update each reproduces the layer order's Gauss-Seidel passes with."""
    k = np.asarray(k, np.float64)
    nb, pos, valid = sites.nb, sites.pos, sites.valid
    n = len(pos)
    dots = np.where(valid, sites.lines @ k, -np.inf)
    order = np.argsort(-dots, axis=1, kind="stable")
    ar = np.arange(n)
    i1, i2 = order[:, 0], order[:, 1]
    d1, d2 = dots[ar, i1], dots[ar, i2]
    up1 = np.where(valid[ar, i1], nb[ar, i1], 0)
    up2 = np.where(valid[ar, i2], nb[ar, i2], up1)
    bad2 = ~np.isfinite(d2) | (d2 <= 0.0)
    up2 = np.where(bad2, up1, up2)
    d2 = np.where(bad2, 0.0, d2)
    d1 = np.maximum(np.where(np.isfinite(d1), d1, 0.0), 0.0)
    upwind = np.stack([up1, up2], 1)
    tot = d1**p + d2**p
    tot = np.where(tot > 0, tot, 1.0)
    weights = np.stack([d1**p / tot, d2**p / tot], 1)
    r = np.linalg.norm(sites.min_image(pos[upwind] - pos[:, None, :]),
                       axis=-1)

    layers = sites.layers[bool(up)]
    bc = np.nonzero(layers == 1)[0]
    # each layer's sites in id order (a stable sort keeps ids ascending)
    by_layer = np.argsort(layers, kind="stable")
    edges = np.searchsorted(layers[by_layer], np.arange(2, layers.max() + 2))
    rows = _gs_levels([ids if up else ids[::-1] for ids in
                       np.split(by_layer, edges)[1:-1] if len(ids)],
                      upwind, weights > 0.0, n)
    return upwind, weights, r, bc, rows


def _gs_levels(layers, upwind, active, n):
    """Each layer's sites (in iteration order) in levels: a site after
    every upwind of its layer that precedes it (it reads their new value)
    and no later than any that follows it (it reads their old value); the
    longest-path levels over those constraints, all layers at once.
    Returns [[ids of level 0, ids of level 1, ...] a layer]."""
    layer_of = np.full(n, -1, np.int64)
    pos_of = np.full(n, -1, np.int64)
    for li, ids in enumerate(layers):
        layer_of[ids] = li
        pos_of[ids] = np.arange(len(ids))
    sites = np.concatenate(layers)
    s2 = np.repeat(sites, 2)
    col = np.tile([0, 1], len(sites))
    u2 = upwind[s2, col]
    act = active[s2, col] & (layer_of[u2] == layer_of[s2])
    fwd = act & (pos_of[u2] < pos_of[s2])
    bwd = act & (pos_of[u2] > pos_of[s2])
    src = np.concatenate([u2[fwd], s2[bwd]])
    dst = np.concatenate([s2[fwd], u2[bwd]])
    inc = np.concatenate([np.ones(int(fwd.sum()), np.int64),
                          np.zeros(int(bwd.sum()), np.int64)])
    lev = np.zeros(n, np.int64)
    while True:
        new = lev.copy()
        np.maximum.at(new, dst, lev[src] + inc)
        if np.array_equal(new, lev):
            break
        lev = new
    out = []
    for ids in layers:
        L = lev[ids]
        order = np.argsort(L, kind="stable")
        cuts = np.searchsorted(L[order], np.arange(1, L.max() + 1))
        out.append(np.split(ids[order], cuts))
    return out


# ------------------------------------------------------------- iteration

def sweep(plan_, S_T, a_T, I0, n_sweeps):
    """I (n, B) along one direction: the boundary sites from I0, then each
    layer's n_sweeps passes, level after level, each level from the
    intensities as they stand before it."""
    upwind, weights, r, bc, rows = plan_
    dev = S_T.device
    up = torch.as_tensor(upwind, device=dev)
    w = torch.as_tensor(weights, device=dev, dtype=S_T.dtype)
    rr = torch.as_tensor(r, device=dev, dtype=S_T.dtype)
    I = torch.zeros_like(S_T)
    I[torch.as_tensor(bc, device=dev)] = I0
    levels = [[torch.as_tensor(ids, device=dev) for ids in layer]
              for layer in rows]
    for layer in levels:
        for _ in range(n_sweeps):
            for ids in layer:
                u = up[ids]
                dtau = rr[ids][..., None] * (a_T[ids][:, None]
                                             + a_T[u]) * 0.5
                aw, bw, ew = linear_weights(dtau)
                i_new = (w[ids][..., None] * (
                    ew * I[u] + aw * S_T[u] + bw * S_T[ids][:, None])).sum(1)
                I[ids] = i_new
    return I


def iterate(sites, line, frozen, S, populations, quad, plans, n_sweeps=3,
            gamma_natural=4.702e8, compat="fixed", block=1 << 16):
    """One Lambda iteration from (S (nlam, n), populations (n, 3)):
    (S_new, populations_new, criterion)."""
    gamma = ph.damping_rate(line, sites.T,
                            populations[..., 0] + populations[..., 1],
                            sites.ne, gamma_natural)
    k, w, is_up = quad
    lam = torch.as_tensor(line.lam, dtype=S.dtype, device=S.device)
    S_T = S.T.contiguous()
    J_T = torch.zeros_like(S_T)
    for i, plan_ in enumerate(plans):
        v_los = (sites.v * torch.as_tensor(-k[i], dtype=S.dtype,
                                           device=S.device)).sum(-1)
        a_T = torch.empty_like(S_T)
        for s0 in range(0, S_T.shape[0], block):
            c = slice(s0, s0 + block)
            a_T[c] = ph.extinction(
                line, lam, v_los[c], populations[c],
                ph.Frozen(lte=None, a_cont=frozen.a_cont[c], eps=None,
                          C=None, dlamD=frozen.dlamD[c]), gamma[c]).T
        bc = torch.as_tensor(plan_[3], device=S.device)
        I0 = (ph.planck(lam[None], sites.T[bc][:, None]) if is_up[i]
              else torch.zeros((len(bc), len(lam)), dtype=S.dtype,
                               device=S.device))
        J_T.add_(sweep(plan_, S_T, a_T, I0, n_sweeps), alpha=float(w[i]))
    J = J_T.T.contiguous()
    del J_T, S_T
    R = ph.radiative_rates(line, J, frozen, gamma, sites.T, compat)
    pops = ph.statistical_equilibrium(R, frozen.C, sites.nH)
    S_new = (1.0 - frozen.eps)[None] * J + frozen.eps[None] * ph.planck(
        lam[:, None], sites.T[None])
    denom = torch.where(S_new != 0.0, S_new, 1.0)
    diff = (torch.abs(S_new - S) / denom.abs()).max()
    return S_new, pops, diff
