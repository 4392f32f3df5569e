"""Voronoi (irregular) grid: sites container and static sweep plans.

Reference parity: src/voronoi_utils.jl -- VoronoiSites struct (:7-28),
read_cell (:36-85), BFS layer ordering (:93-174), Delaunay lines
(:186-245), reduce_layers (:253-269), smallest_angle upwind selection
(:282-396) -- recast TPU-first: everything direction-dependent (the two
upwind neighbours, blend weights, path lengths, layer schedule) is
precompiled host-side into padded fixed-shape arrays (a `VoronoiPlan`),
so the device sweep is a pure gather/FMA pipeline (SURVEY.md §7).

The port's own copy of voronoirt_tpu/grid/voronoi.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np


class GrazingLayerOrderWarning(UserWarning):
    """'layer' sweep ordering truncates grazing-angle beams."""


# empirical truncation bound of the BFS-layer + fixed-pass ordering: a
# zero-opacity searchlight beam at |mu| <= 0.42 loses most of its flux
# under 3 sweeps (docs/PARITY.md item 2; tests/test_sweep_voronoi.py)
GRAZING_MU = 0.45

from .neighbors import (voronoi_neighbors, bfs_layers, topo_levels,
                        BOTTOM_WALL, TOP_WALL)


@dataclasses.dataclass
class VoronoiSites:
    """Irregular-grid state (voronoi_utils.jl:7-28), SI units.

    positions: (n, 3) ordered (z, x, y); neighbours: (n, W+1) with
    column 0 = count then ids (0-based; -5/-6 walls); per-site physical
    fields as 1-D arrays.
    """
    positions: np.ndarray
    neighbours: np.ndarray
    delaunay_lines: np.ndarray   # (n, W, 3) unit vectors (z, x, y)
    layers_up: np.ndarray        # per-site BFS layer from the bottom wall
    layers_down: np.ndarray      # ... from the top wall
    temperature: np.ndarray
    electron_density: np.ndarray
    hydrogen_populations: np.ndarray
    velocity_z: np.ndarray
    velocity_x: np.ndarray
    velocity_y: np.ndarray
    bounds: tuple                # (z_min, z_max, x_min, x_max, y_min, y_max)
    content_key: str | None = None   # sha over (positions, bounds): the
    # tessellation/plan disk-cache key (grid/cache.py)

    @property
    def n(self):
        return len(self.positions)

    def velocity_zxy(self):
        return np.stack(
            [self.velocity_z, self.velocity_x, self.velocity_y], axis=-1)


def delaunay_lines(positions, neighbours, bounds):
    """Unit vectors site -> neighbour with x,y min-image wrap.

    Mirrors calc_Delaunay_lines (voronoi_utils.jl:186-245); the
    reference's pairwise around-the-box test is exactly the minimum-image
    convention, implemented here vectorized.
    """
    n, w1 = neighbours.shape
    W = w1 - 1
    z_min, z_max, x_min, x_max, y_min, y_max = bounds
    Lx, Ly = x_max - x_min, y_max - y_min

    idx = neighbours[:, 1:].astype(np.int64)
    valid = (np.arange(W)[None, :] < neighbours[:, :1]) & (idx >= 0)
    safe = np.where(valid, idx, 0)
    d = positions[safe]
    d -= positions[:, None, :]                        # (n, W, 3) in (z,x,y)
    d[..., 1] -= Lx * np.round(d[..., 1] / Lx)
    d[..., 2] -= Ly * np.round(d[..., 2] / Ly)
    norm = np.linalg.norm(d, axis=-1)
    norm = np.where(norm > 0, norm, 1.0)
    lines = d / norm[..., None]
    lines[~valid] = 0.0
    return lines, valid


def build_sites(positions, bounds, fields, max_nb=32, n_threads=0,
                cache_dir=None):
    """Run the native tessellation + layering and assemble VoronoiSites.

    The in-process equivalent of write_arrays -> voro subprocess ->
    read_cell (SURVEY.md §3.1 "PROCESS BOUNDARY").

    cache_dir: when set, the tessellation (neighbour matrix + BFS
    layers) is loaded from / saved to a content-addressed disk cache
    (grid/cache.py) -- the analog of the reference persisting and
    re-reading neighbours.txt (src/functions.jl:13-23, src/io.jl:8-40).
    Delaunay unit vectors are cheap and recomputed either way.
    """
    from . import cache as _cache
    skey = _cache.sites_key(positions, bounds)
    cached = (_cache.load_tessellation(cache_dir, skey)
              if cache_dir else None)
    if cached is not None:
        neighbours, lay_up, lay_dn = cached
    else:
        neighbours = voronoi_neighbors(positions, bounds, max_nb=max_nb,
                                       n_threads=n_threads)
        lay_up = bfs_layers(neighbours, BOTTOM_WALL)
        lay_dn = bfs_layers(neighbours, TOP_WALL)
        if cache_dir:
            _cache.save_tessellation(cache_dir, skey, neighbours,
                                     lay_up, lay_dn)
    lines, _ = delaunay_lines(positions, neighbours, bounds)
    return VoronoiSites(
        positions=np.asarray(positions, dtype=np.float64),
        neighbours=neighbours, delaunay_lines=lines,
        layers_up=lay_up, layers_down=lay_dn,
        temperature=fields["temperature"],
        electron_density=fields["electron_density"],
        hydrogen_populations=fields["hydrogen_populations"],
        velocity_z=fields["velocity_z"],
        velocity_x=fields["velocity_x"],
        velocity_y=fields["velocity_y"],
        bounds=tuple(float(b) for b in bounds),
        content_key=skey)


# ------------------------------------------------------------ sweep plan

@dataclasses.dataclass(frozen=True)
class VoronoiPlan:
    """Static per-direction sweep plan (padded, fixed shapes).

    layer_sites: (L, Wmax) int32 site ids per layer, padded with n
      (a dummy slot) -- layer 0 is the boundary layer (gets I0).
    upwind: (n, 2) the two most-upwind neighbour ids (smallest_angle,
      voronoi_utils.jl:360-396).
    weights: (n, 2) blend weights dot^p / sum dot^p
      (irregular_ray_tracing.jl:51).
    r: (n, 2) path lengths to the upwind sites; the reference uses the
      UNwrapped euclidean distance (irregular_ray_tracing.jl:66) -- that
      quirk is reproduced when compat='reference', min-image otherwise.
    bc_sites: (n_bc,) site ids of the boundary layer.

    order='wavefront' additionally fills exact_levels / relax_levels
    (see build_voronoi_plan); layer_sites then holds the concatenated
    schedule only for shape compatibility.
    """
    k: tuple
    up: bool
    layer_sites: np.ndarray
    upwind: np.ndarray
    weights: np.ndarray
    r: np.ndarray
    bc_sites: np.ndarray
    n: int
    exact_levels: np.ndarray | None = None   # (Lx, Wx): 1 pass each
    relax_levels: np.ndarray | None = None   # (Lr, Wr): n_sweeps each
    relax_repeats: int = 1       # global repeats of the relax schedule
    # (seam-wrapping chains re-enter earlier bins; one repeat per wrap)
    gs_levels: np.ndarray | None = None      # (R, Wg): exact Gauss-Seidel
    # row order for 'layer' mode (see _gs_layer_schedule), 1 pass per row
    gs_up_occ: np.ndarray | None = None      # (R, Wg, 2): flat occurrence
    # index of each upwind's target pass copy, -1 = resolve by site id


def _gs_layer_schedule_py(layer_lists, upwind, active, n, n_sweeps, up):
    """Pure-Python reference implementation of _gs_layer_schedule.

    Kept as the oracle for tests/test_sweep_voronoi.py (the vectorized
    version below must reproduce it array-for-array); the per-site dict
    loops do not scale past ~1e5 sites.

    The reference iterates each BFS layer's sites in permutation order
    (ascending site id for up sweeps, descending for down,
    irregular_ray_tracing.jl:41,122), updating in place over n_sweeps
    passes.  In pass p, a site s reading upwind u sees u's THIS-pass
    value iff u precedes s in iteration order, else u's pass-(p-1) value.
    Reproduced by levelling each layer's sites along the DAG of
      true deps  (u before s):  lev(s) >= lev(u) + 1
      anti deps  (u after  s):  lev(u) >= lev(s)   (same row is fine --
                                 a row's update reads pre-row values)
    (all edges point forward in iteration order, so one ordered pass
    computes the levels), then scheduling each layer's level blocks
    n_sweeps times in sequence.  Every site appears once PER PASS; a
    reader targets the occurrence of the pass its value must come from
    (this pass for true deps, the previous pass for anti deps -- pass 0
    anti deps target the not-yet-written pass-0 occurrence, which still
    holds the correct initial 0).

    Returns (sched (R, Wg) site ids padded with n,
             up_occ (R, Wg, 2) flat occurrence index row*Wg+col of each
             upwind's target occurrence, or -1 to resolve by site id
             (boundary/other-layer/skipped upwinds)).
    """
    row_sites = []     # list of lists of site ids, execution order
    row_pass = []      # pass index per row
    lev_of = {}
    layer_of = {}
    pos_of_all = {}
    per_layer = []     # (ids_order, D)
    for li, ids in enumerate(layer_lists):
        ids_order = [int(s) for s in (ids if up else ids[::-1])]
        pos_of = {s: j for j, s in enumerate(ids_order)}
        readers = {}
        for s in ids_order:
            for rn in range(2):
                if active[s, rn]:
                    u = int(upwind[s, rn])
                    if u in pos_of and pos_of[u] > pos_of[s]:
                        readers.setdefault(u, []).append(s)
        D = 0
        for s in ids_order:
            lv = 0
            for rn in range(2):
                if active[s, rn]:
                    u = int(upwind[s, rn])
                    if u in pos_of and pos_of[u] < pos_of[s]:
                        lv = max(lv, lev_of[u] + 1)
            for rdr in readers.get(s, ()):
                lv = max(lv, lev_of[rdr])
            lev_of[s] = lv
            layer_of[s] = li
            pos_of_all[s] = pos_of[s]
            D = max(D, lv + 1)
        per_layer.append((ids_order, D))

    occ = {}           # (site, pass) -> (row, col)
    for li, (ids_order, D) in enumerate(per_layer):
        sub = [[] for _ in range(D)]
        for s in ids_order:
            sub[lev_of[s]].append(s)
        for p in range(n_sweeps):
            for d in range(D):
                if not sub[d]:
                    continue
                r_idx = len(row_sites)
                row_sites.append(sub[d])
                row_pass.append(p)
                for c, s in enumerate(sub[d]):
                    occ[(s, p)] = (r_idx, c)

    if not row_sites:
        return (np.full((0, 1), n, dtype=np.int32),
                np.full((0, 1, 2), -1, dtype=np.int64))
    Wg = max(len(r) for r in row_sites)
    sched = np.full((len(row_sites), Wg), n, dtype=np.int32)
    up_occ = np.full((len(row_sites), Wg, 2), -1, dtype=np.int64)
    for r_idx, sites_r in enumerate(row_sites):
        p = row_pass[r_idx]
        for c, s in enumerate(sites_r):
            sched[r_idx, c] = s
            for rn in range(2):
                if not active[s, rn]:
                    continue
                u = int(upwind[s, rn])
                if layer_of.get(u) != layer_of[s]:
                    continue  # bc / other layer / skipped: by site id
                if pos_of_all[u] < pos_of_all[s]:
                    target = occ[(u, p)]            # true dep: this pass
                else:
                    target = occ[(u, max(p - 1, 0))]  # anti dep: previous
                up_occ[r_idx, c, rn] = target[0] * Wg + target[1]
    return sched, up_occ


def _gs_layer_schedule(layer_lists, upwind, active, n, n_sweeps, up):
    """Slot rows that reproduce the reference's in-layer Gauss-Seidel
    EXACTLY with parallel (Jacobi-read) row updates -- vectorized.

    Same contract and output as _gs_layer_schedule_py (see its docstring
    for the levelling semantics); this version replaces the per-site
    dict loops with numpy passes so the 'layer' parity schedule builds
    in seconds at the production 3.5e6-site scale:

      * levels by scatter-max fixpoint over the in-layer edge list
        (true deps lev(s) >= lev(u)+1, anti deps lev(u) >= lev(rdr);
        every edge points forward in iteration order, so the fixpoint
        converges in max-level rounds);
      * row/col assignment by one lexsort over (layer, level, pos);
      * occurrence targets by closed-form row arithmetic
        (row = base[layer] + pass * D[layer] + level -- levels 0..D-1
        are all non-empty: a site at level d needs an upwind at d-1 or
        an earlier reader at d, which recurses to a d-1 upwind).
    """
    n_layers = len(layer_lists)
    layer_of = np.full(n, -1, dtype=np.int64)
    pos_of = np.full(n, -1, dtype=np.int64)
    parts = []
    for li, ids in enumerate(layer_lists):
        ids_order = np.asarray(ids, dtype=np.int64)
        if not up:
            ids_order = ids_order[::-1]
        layer_of[ids_order] = li
        pos_of[ids_order] = np.arange(len(ids_order))
        parts.append(ids_order)
    if not any(len(a) for a in parts):
        return (np.full((0, 1), n, dtype=np.int32),
                np.full((0, 1, 2), -1, dtype=np.int64))
    sites = np.concatenate([a for a in parts if len(a)])

    # in-layer dependency edges over both upwind slots
    s2 = np.repeat(sites, 2)
    rn2 = np.tile(np.array([0, 1]), len(sites))
    u2 = upwind[s2, rn2].astype(np.int64)
    act = active[s2, rn2] & (layer_of[u2] == layer_of[s2])
    fwd = act & (pos_of[u2] < pos_of[s2])     # true dep: u before s
    bwd = act & (pos_of[u2] > pos_of[s2])     # anti dep: u after s
    src = np.concatenate([u2[fwd], s2[bwd]])
    dst = np.concatenate([s2[fwd], u2[bwd]])
    inc = np.concatenate([np.ones(int(fwd.sum()), dtype=np.int64),
                          np.zeros(int(bwd.sum()), dtype=np.int64)])

    lev = np.zeros(n, dtype=np.int64)
    for _ in range(len(sites) + 1):
        new = lev.copy()
        np.maximum.at(new, dst, lev[src] + inc)
        if np.array_equal(new, lev):
            break
        lev = new

    # per-layer depth and row bases (n_sweeps * D rows per layer)
    D = np.zeros(n_layers, dtype=np.int64)
    np.maximum.at(D, layer_of[sites], lev[sites] + 1)
    base = np.concatenate([[0], np.cumsum(n_sweeps * D)])[:-1]

    # column = rank by pos within the (layer, level) group
    order = np.lexsort((pos_of[sites], lev[sites], layer_of[sites]))
    ss = sites[order]
    grp = layer_of[ss] * (lev.max() + 1) + lev[ss]
    starts = np.nonzero(np.concatenate([[True], grp[1:] != grp[:-1]]))[0]
    group_id = np.cumsum(np.concatenate(
        [[0], (grp[1:] != grp[:-1]).astype(np.int64)]))
    col = np.arange(len(ss)) - starts[group_id]
    col_of = np.empty(n, dtype=np.int64)
    col_of[ss] = col
    counts = np.diff(np.concatenate([starts, [len(ss)]]))
    Wg = int(counts.max())

    n_rows = int(n_sweeps * D.sum())
    sched = np.full((n_rows, Wg), n, dtype=np.int32)
    up_occ = np.full((n_rows, Wg, 2), -1, dtype=np.int64)

    row0 = base[layer_of[sites]] + lev[sites]          # pass-0 row of s
    Dl = D[layer_of[sites]]
    passes = np.arange(n_sweeps, dtype=np.int64)
    rows_sp = row0[:, None] + passes[None, :] * Dl[:, None]
    sched[rows_sp.ravel(),
          np.repeat(col_of[sites], n_sweeps)] = np.repeat(sites, n_sweeps)

    sel = np.nonzero(act)[0]
    s_e, u_e, rn_e = s2[sel], u2[sel], rn2[sel]
    true_e = pos_of[u_e] < pos_of[s_e]
    row0_s = base[layer_of[s_e]] + lev[s_e]
    row0_u = base[layer_of[u_e]] + lev[u_e]
    Dl_e = D[layer_of[s_e]]
    for p_ in range(n_sweeps):
        pt = np.where(true_e, p_, max(p_ - 1, 0))
        up_occ[row0_s + p_ * Dl_e, col_of[s_e], rn_e] = (
            (row0_u + pt * Dl_e) * Wg + col_of[u_e])
    return sched, up_occ


def build_voronoi_plan(sites: VoronoiSites, k, up, p=7.0,
                       compat="reference", order="layer", n_sweeps=3,
                       cache_dir=None):
    """Compile the static upwind/ordering plan for direction k.

    cache_dir: when set (and the sites carry a content_key), the built
    plan is loaded from / saved to the disk cache (grid/cache.py), so
    repeated production launches and crash resume skip the host build.

    Upwind selection: for every site, the two neighbours whose Delaunay
    lines have the largest positive dot product with k; if the second
    best is <= 0 it is replaced by the first with zero weight
    (voronoi_utils.jl:390-393).

    order:
      'layer' (reference parity): BFS wall-distance layers, n_sweeps
        Gauss-Seidel passes per layer in the reference's permutation
        order, reproduced exactly by the occurrence-resolved gs schedule
        (irregular_ray_tracing.jl:37-79; _gs_layer_schedule).
      'wavefront': order sites by the 2-upwind dependency DAG itself.
        Every active edge strictly increases s = pos . k (unwrapped), so
        Kahn levelling yields exact levels -- one pass per level, every
        upwind already computed -- except for chains wrapping the
        periodic x/y seam, which are s-sorted into equal-count bins,
        one Jacobi pass per bin; sequencing comes from the bin order
        plus relax_repeats global repeats of the bin schedule (n_sweeps
        only feeds the exact-level cost heuristic).  Exact where the
        reference's fixed
        3 sweeps truncate (grazing angles lose most of the beam,
        tests/test_sweep_voronoi.py), and usually cheaper: one pass per
        level instead of n_sweeps per layer.  If the exact levels are
        too ragged (padded cost > n_sweeps x resolved sites), resolved
        sites are binned in level order instead (cost capped at the
        'layer' mode's).
    """
    k = np.asarray(k, dtype=np.float64)
    n = sites.n

    from . import cache as _cache
    pkey = None
    if cache_dir and sites.content_key:
        pkey = _cache.plan_key(sites.content_key, k, up, p, compat,
                               order, n_sweeps)
        hit = _cache.load_plan(cache_dir, pkey)
        if hit is not None and hit["n"] == n:
            return VoronoiPlan(k=tuple(k), up=up, **hit)

    nb = sites.neighbours
    W = nb.shape[1] - 1
    z_min, z_max, x_min, x_max, y_min, y_max = sites.bounds
    Lx_box, Ly_box = x_max - x_min, y_max - y_min

    # native selection kernel (bit-identical to the numpy path below;
    # the dots + streaming top-2 + path lengths are the hot half of the
    # host plan build at production site counts)
    from .neighbors import upwind_select
    native = upwind_select(sites.delaunay_lines, nb, sites.positions, k,
                           compat == "reference", Lx_box, Ly_box)
    if native is not None:
        upwind, d12, r_raw_pair, r_mi_pair = native
        d1, d2 = d12[:, 0].copy(), d12[:, 1].copy()
        r_mi = r_mi_pair
        r = r_raw_pair if compat == "reference" else r_mi_pair
        return _assemble_plan(sites, k, up, p, compat, order, n_sweeps,
                              upwind, d1, d2, r, r_mi, cache_dir, pkey)

    idx = nb[:, 1:].astype(np.int64)
    valid = (np.arange(W)[None, :] < nb[:, :1]) & (idx >= 0)

    # (n*W, 3) @ (3,) BLAS matvec: ~10x the strided einsum at 3.5e6 sites
    dots = (sites.delaunay_lines.reshape(-1, 3) @ k).reshape(n, W)
    dots = np.where(valid, dots, -np.inf)

    if compat == "reference":
        # the reference's smallest_angle (voronoi_utils.jl:360-396) is a
        # STREAMING selection over the stored neighbour order, not a true
        # top-2: a new maximum overwrites slot 1 without demoting the old
        # maximum to slot 2, so slot 2 ends up holding the best value seen
        # while it was NOT a running maximum.  Order-dependent; reproduced
        # column-by-column here (docs/PARITY.md).
        d1 = np.full(n, -1.0)
        d2 = np.full(n, -1.0)
        up1 = np.zeros(n, dtype=np.int64)
        up2 = np.zeros(n, dtype=np.int64)
        for w in range(W):
            d = dots[:, w]
            cand = idx[:, w]
            beats2 = d > d2
            beats1 = beats2 & (d > d1)
            take2 = beats2 & ~beats1
            d2 = np.where(take2, d, d2)
            up2 = np.where(take2, cand, up2)
            d1 = np.where(beats1, d, d1)
            up1 = np.where(beats1, cand, up1)
        up1 = np.where(d1 > -1.0, up1, 0)
        bad2 = d2 <= 0.0
    else:
        # true top-2 neighbours by dot product
        nb_order = np.argsort(-dots, axis=1)
        i1 = nb_order[:, 0]
        i2 = nb_order[:, 1] if W > 1 else nb_order[:, 0]
        ar = np.arange(n)
        d1 = dots[ar, i1]
        d2 = dots[ar, i2]
        up1 = np.where(valid[ar, i1], idx[ar, i1], 0)
        up2 = np.where(valid[ar, i2], idx[ar, i2], up1)
        bad2 = ~np.isfinite(d2) | (d2 <= 0.0)

    # reference fallback: second upwind invalid if its dot <= 0
    up2 = np.where(bad2, up1, up2)
    d2 = np.where(bad2, 0.0, d2)
    d1 = np.maximum(np.where(np.isfinite(d1), d1, 0.0), 0.0)

    # path lengths: one fancy-index pass; the min-image variant (r when
    # compat != 'reference'; always the wavefront bin resolution) derives
    # from the same deltas instead of re-gathering pos[upwind]
    pos = sites.positions
    upwind = np.stack([up1, up2], axis=1).astype(np.int32)
    d_vec = pos[upwind]
    d_vec -= pos[:, None, :]
    r_raw = (np.linalg.norm(d_vec, axis=-1)
             if compat == "reference" else None)
    # r_mi unconditionally: _assemble_plan's wavefront section consumes
    # it, and computing it here always (two vector ops at 3.5e6 sites)
    # is cheaper than guarding every (compat, order) combination that
    # might reach that section
    d_vec[..., 1] -= Lx_box * np.round(d_vec[..., 1] / Lx_box)
    d_vec[..., 2] -= Ly_box * np.round(d_vec[..., 2] / Ly_box)
    r_mi = np.linalg.norm(d_vec, axis=-1)
    r = r_raw if compat == "reference" else r_mi
    return _assemble_plan(sites, k, up, p, compat, order, n_sweeps,
                          upwind, d1, d2, r, r_mi, cache_dir, pkey)


def _assemble_plan(sites, k, up, p, compat, order, n_sweeps, upwind,
                   d1, d2, r, r_mi, cache_dir, pkey):
    """Blend weights + schedule construction from the selected upwinds
    (shared by the native and numpy selection paths)."""
    from . import cache as _cache
    n = sites.n
    pos = sites.positions
    z_min, z_max, x_min, x_max, y_min, y_max = sites.bounds
    Lx_box, Ly_box = x_max - x_min, y_max - y_min

    w1p = d1 ** p
    w2p = d2 ** p
    tot = w1p + w2p
    tot = np.where(tot > 0, tot, 1.0)
    weights = np.stack([w1p / tot, w2p / tot], axis=1)

    layers = sites.layers_up if up else sites.layers_down
    L = int(layers.max())
    counts = np.bincount(layers, minlength=L + 1)
    Wmax = int(counts[2:].max()) if L >= 2 else 1
    layer_sites = np.full((max(L - 1, 0), Wmax), n, dtype=np.int32)
    if L >= 2:
        ids_all = np.nonzero(layers >= 2)[0]
        lay = (layers[ids_all] - 2).astype(np.int64)
        order_ix = np.argsort(lay, kind="stable")   # keeps ids ascending
        ids_s, lay_s = ids_all[order_ix], lay[order_ix]
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(lay_s, minlength=L - 1))])[:-1]
        layer_sites[lay_s, np.arange(len(ids_s)) - starts[lay_s]] = ids_s
    bc_sites = np.nonzero(layers == 1)[0].astype(np.int32)

    if compat == "reference" and order != "wavefront" and L >= 2:
        # reduce_layers (voronoi_utils.jl:253-269) ends the offset vector
        # at n instead of n+1, so the final site of the sweep permutation
        # (the highest-index site of the top layer under stable sortperm)
        # is never updated and keeps I = 0 (docs/PARITY.md item 3).
        last = np.nonzero(layers == L)[0][-1]
        row = layer_sites[L - 2]
        layer_sites[L - 2] = np.where(row == last, n, row)

    if order != "wavefront":
        layer_lists = [row[row < n] for row in layer_sites]
        gs_levels, gs_up_occ = _gs_layer_schedule(
            layer_lists, upwind, weights > 0.0, n, n_sweeps, up)
        if abs(k[0]) < GRAZING_MU:
            warnings.warn(
                "voronoi_order='layer' truncates horizontal propagation "
                f"at grazing angles (|mu|={abs(k[0]):.2f} < {GRAZING_MU}): "
                "a low-opacity beam loses most of its flux, matching the "
                "reference's artifact (docs/PARITY.md item 2).  Use "
                "Config(voronoi_order='wavefront') for the exact "
                "upwind-DAG ordering.", GrazingLayerOrderWarning,
                stacklevel=2)
        plan = VoronoiPlan(k=tuple(k), up=up, layer_sites=layer_sites,
                           upwind=upwind, weights=weights, r=r,
                           bc_sites=bc_sites, n=n, gs_levels=gs_levels,
                           gs_up_occ=gs_up_occ)
        if pkey is not None:
            _cache.save_plan(cache_dir, pkey, plan)
        return plan

    is_bc = np.zeros(n, dtype=bool)
    is_bc[bc_sites] = True
    active = weights > 0.0
    lev = topo_levels(upwind, active, is_bc)

    # mean upwind-edge advance along k sets the relax-bin resolution;
    # always the min-image distance (the compat='reference' unwrapped r
    # is metres across the seam and would inflate the bin width)
    s = pos @ k
    ds_edge = (r_mi * np.stack([np.maximum(d1, 0.0),
                                np.maximum(d2, 0.0)], axis=1))[active]
    mean_ds = float(ds_edge.mean()) if ds_edge.size else 1.0

    resolved = lev >= 1
    n_res = int(resolved.sum())
    exact_levels = None
    use_exact = False
    if n_res:
        # Within a level all updates are independent (deps point to
        # strictly earlier levels), so levels wider than a cap can split
        # into several schedule rows without changing the result.  The
        # cap (row width) trades gather-row padding against scan-step
        # count: the sweep is gather-row-bound (~8 ns/row at the fast
        # >=364-byte lane width, measured on v5e) with a ~20 us fixed
        # cost per schedule row, so pick the ladder cap minimizing
        #   rows(cap) * (4 * cap * 8ns + 20us)
        # (4 gathered rows per slot row: 2 upwinds x {SA, I}).  The old
        # mean-width cap left 44% of rows as dummy padding at 3.5e6
        # sites (fill 0.56 -> ~0.9).
        Lx = int(lev[resolved].max())
        wx = np.bincount(lev[resolved], minlength=Lx + 1)[1:]
        best = None
        for cap_c in (128, 256, 512, 1024, 2048, 4096, 8192, 16384):
            rows_c = int(np.sum(-(-wx // cap_c)))
            cost = rows_c * (4 * cap_c * 8e-9 + 20e-6)
            if best is None or cost < best[0]:
                best = (cost, cap_c)
        cap = best[1]
        n_rows = int(np.sum(-(-wx // cap)))
        use_exact = n_rows * cap <= n_sweeps * n_res
        if use_exact:
            order_ids = np.argsort(lev[resolved], kind="stable")
            ids_sorted = np.nonzero(resolved)[0][order_ids]
            lev_s = lev[resolved][order_ids].astype(np.int64) - 1
            starts = np.concatenate([[0], np.cumsum(wx)])[:-1]
            within = np.arange(n_res) - starts[lev_s]
            row_base = np.concatenate(
                [[0], np.cumsum(-(-wx // cap))])[:-1]
            exact_levels = np.full((n_rows, cap), n, dtype=np.int32)
            exact_levels[row_base[lev_s] + within // cap,
                         within % cap] = ids_sorted

    # everything not exactly ordered: one s-sorted bin schedule
    # (most-upwind first -- upwind sites always have larger s because
    # the selection is dot(k, line) > 0)
    rest = np.nonzero(~is_bc & (~resolved if use_exact
                                else np.ones(n, dtype=bool)))[0]
    relax_levels = None
    relax_repeats = 1
    if rest.size:
        # bin width ~ half the mean edge advance: intra-bin chains are
        # then depth <= ~1, so one Jacobi pass per bin suffices and all
        # sequencing comes from the bin order + global repeats
        ids = rest[np.argsort(-s[rest], kind="stable")]
        span = abs(s[rest].max() - s[rest].min()) if rest.size > 1 else 0.0
        n_bins = max(1, min(int(np.ceil(span / (0.5 * mean_ds))),
                            len(ids)))
        Wr = -(-len(ids) // n_bins)
        relax_levels = np.concatenate(
            [ids, np.full(n_bins * Wr - len(ids), n, dtype=np.int64)]
        ).astype(np.int32).reshape(n_bins, Wr)
        # seam wraps: a chain crossing the periodic seam re-enters at
        # high s (an earlier, already-processed bin), costing one global
        # repeat of the schedule -- empirically ~3 repeats per wrap
        # converge the beam-conservation fixtures to the global fixed
        # point (tests/test_sweep_voronoi.py)
        zr = pos[rest, 0]
        span_z = float(zr.max() - zr.min()) if rest.size > 1 else 0.0
        if abs(k[0]) > 1e-12:
            travel = span_z / abs(k[0])
            wraps = travel * abs(k[1]) / Lx_box + travel * abs(k[2]) / Ly_box
        else:
            wraps = 10.0
        relax_repeats = int(min(2 + np.ceil(3.0 * wraps), 32))

    plan = VoronoiPlan(k=tuple(k), up=up, layer_sites=layer_sites,
                       upwind=upwind, weights=weights, r=r,
                       bc_sites=bc_sites, n=n,
                       exact_levels=exact_levels,
                       relax_levels=relax_levels,
                       relax_repeats=relax_repeats)
    if pkey is not None:
        _cache.save_plan(cache_dir, pkey, plan)
    return plan
