"""Voronoi neighbour lists: ctypes binding to the native C++ finder.

Native-preprocessing parity with the reference's voro++ subprocess
(rt_preprocessing/output_sites.cc, invoked via src/functions.jl:13-23):
container periodic in x,y, walled in z; bottom wall id -5, top wall -6.
Here the call is in-process (no text-file round trip) and returns a
fixed-stride neighbour matrix in the reference's layout
(src/voronoi_utils.jl:36-70: column 0 = count, then ids).

A scipy.spatial.Delaunay fallback (periodic 3x3 tiling in x,y) exists for
environments without the built library; it is ~50x slower and only used
for small test grids.

The port's own copy of voronoirt_tpu/grid/neighbors.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build",
                 "libvoronoirt.so"),
    os.path.join(os.path.dirname(__file__), "_native", "libvoronoirt.so"),
]

BOTTOM_WALL = -5
TOP_WALL = -6

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.vrt_build_neighbors.restype = ctypes.c_int
            lib.vrt_build_neighbors.argtypes = [
                ctypes.POINTER(ctypes.c_double)] * 3 + [
                ctypes.c_int64] + [ctypes.c_double] * 6 + [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.vrt_bfs_layers.restype = None
            lib.vrt_bfs_layers.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
            return lib
    return None


def build_native():
    """Build the C++ library in-tree (make native/)."""
    root = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native"))
    subprocess.run(["make", "-C", root], check=True)
    return _load_lib()


def _cp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ci(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def voronoi_neighbors(positions_zxy, bounds, max_nb=32, n_threads=0):
    """Neighbour matrix for sites in a z-walled, xy-periodic box.

    Args:
      positions_zxy: (n, 3) site positions ordered (z, x, y) [m]
        (the reference's positions layout, voronoi_utils.jl:8).
      bounds: (z_min, z_max, x_min, x_max, y_min, y_max).
      max_nb: initial neighbour-count cap (auto-doubles on overflow;
        reference warns at max_guess=70, voronoi_utils.jl:66-68).
    Returns:
      neighbours: (n, max_count+1) int32, column 0 = count, then ids
        (0-based sites; -5 bottom wall, -6 top wall).
    """
    lib = _load_lib()
    if lib is None:
        # Build in-tree on first use: the scipy fallback triangulates
        # degenerate (grid-aligned) configurations with diagonal edges
        # and must only be a last resort.
        try:
            lib = build_native()
        except Exception:
            lib = None
    pos = np.ascontiguousarray(positions_zxy, dtype=np.float64)
    n = len(pos)
    z_min, z_max, x_min, x_max, y_min, y_max = (float(b) for b in bounds)
    zs = np.ascontiguousarray(pos[:, 0])
    xs = np.ascontiguousarray(pos[:, 1])
    ys = np.ascontiguousarray(pos[:, 2])

    if lib is None:
        return _scipy_neighbors(zs, xs, ys, bounds, max_nb)

    while True:
        counts = np.zeros(n, dtype=np.int32)
        nbrs = np.zeros((n, max_nb), dtype=np.int32)
        ret = lib.vrt_build_neighbors(
            _cp(xs), _cp(ys), _cp(zs), n, x_min, x_max, y_min, y_max,
            z_min, z_max, max_nb, _ci(counts), _ci(nbrs), n_threads)
        if ret >= 0:
            max_count = int(ret)
            break
        max_nb *= 2

    out = np.zeros((n, max_count + 1), dtype=np.int32)
    out[:, 0] = counts
    out[:, 1:] = nbrs[:, :max_count]
    return out


def bfs_layers(neighbours, wall_id):
    """Per-site BFS layer index (1-based) from a wall.

    Mirrors src/voronoi_utils.jl:93-174 (_sort_by_layer_up/_down).
    """
    lib = _load_lib()
    n, w = neighbours.shape
    counts = np.ascontiguousarray(neighbours[:, 0], dtype=np.int32)
    nbrs = np.ascontiguousarray(neighbours[:, 1:], dtype=np.int32)
    if lib is None:
        return _py_bfs_layers(counts, nbrs, wall_id)
    out = np.zeros(n, dtype=np.int32)
    lib.vrt_bfs_layers(_ci(counts), _ci(nbrs), n, w - 1, wall_id, _ci(out))
    return out


def topo_levels(upwind, active, is_bc):
    """Kahn levels of the per-direction 2-upwind dependency DAG.

    Every active edge (upwind -> site) strictly increases s = pos . k in
    unwrapped coordinates, so the graph is a DAG except for chains that
    wrap the periodic x/y seam.  Returns per-site levels: 0 = boundary,
    >= 1 = exact topological level (all deps in strictly earlier
    levels), -1 = caught in a seam cycle.
    """
    lib = _load_lib()
    if lib is None:
        try:
            lib = build_native()
        except Exception:
            lib = None
    n = len(is_bc)
    up = np.ascontiguousarray(upwind, dtype=np.int32)
    act = np.ascontiguousarray(active, dtype=np.uint8)
    bc = np.ascontiguousarray(is_bc, dtype=np.uint8)
    out = np.empty(n, dtype=np.int32)
    # a stale libvoronoirt.so (built before this symbol existed; the .so
    # is gitignored and built lazily) must fall back, not AttributeError
    if lib is not None and getattr(lib, "vrt_topo_levels", None) is None:
        lib = None
    if lib is not None:
        if not hasattr(lib.vrt_topo_levels, "_configured"):
            lib.vrt_topo_levels.restype = None
            lib.vrt_topo_levels.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            lib.vrt_topo_levels._configured = True
        lib.vrt_topo_levels(
            _ci(up), act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, _ci(out))
        return out
    return _py_topo_levels(up, act, bc)


def upwind_select(lines, neighbours, positions, k, compat_reference,
                  Lx, Ly, n_threads=0):
    """Native per-direction upwind selection + path lengths.

    Returns (upwind (n,2) int32, d12 (n,2) cleaned dots, r_raw (n,2),
    r_mi (n,2)) or None when the native symbol is unavailable (caller
    falls back to the numpy path; the arithmetic is bit-identical --
    tests/test_native_plan.py pins it)."""
    lib = _load_lib()
    if lib is None:
        try:
            lib = build_native()
        except Exception:
            return None
    if lib is None or getattr(lib, "vrt_upwind_select", None) is None:
        return None
    fn = lib.vrt_upwind_select
    if not hasattr(fn, "_configured"):
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_double),       # lines
            ctypes.POINTER(ctypes.c_int32),        # neighbours
            ctypes.POINTER(ctypes.c_double),       # pos
            ctypes.c_int64, ctypes.c_int,          # n, W
            ctypes.POINTER(ctypes.c_double),       # k
            ctypes.c_int,                          # compat_reference
            ctypes.c_double, ctypes.c_double,      # Lx, Ly
            ctypes.POINTER(ctypes.c_int32),        # upwind out
            ctypes.POINTER(ctypes.c_double),       # d12 out
            ctypes.POINTER(ctypes.c_double),       # r_raw out
            ctypes.POINTER(ctypes.c_double),       # r_mi out
            ctypes.c_int]
        fn._configured = True
    n, w1 = neighbours.shape
    W = w1 - 1
    lines_c = np.ascontiguousarray(lines, dtype=np.float64)
    nb_c = np.ascontiguousarray(neighbours, dtype=np.int32)
    pos_c = np.ascontiguousarray(positions, dtype=np.float64)
    k_c = np.ascontiguousarray(k, dtype=np.float64)
    upwind = np.empty((n, 2), dtype=np.int32)
    d12 = np.empty((n, 2), dtype=np.float64)
    r_raw = np.empty((n, 2), dtype=np.float64)
    r_mi = np.empty((n, 2), dtype=np.float64)
    fn(_cp(lines_c), _ci(nb_c), _cp(pos_c), n, W, _cp(k_c),
       int(compat_reference), float(Lx), float(Ly),
       _ci(upwind), _cp(d12), _cp(r_raw), _cp(r_mi), int(n_threads))
    return upwind, d12, r_raw, r_mi


def _py_topo_levels(upwind, active, is_bc):
    """Pure-numpy fallback (round-per-level; fine for test sizes)."""
    n = len(is_bc)
    lev = np.full(n, -1, dtype=np.int32)
    dep = active.astype(bool) & (upwind != np.arange(n)[:, None])
    dep &= ~is_bc.astype(bool)[:, None]
    lev[is_bc.astype(bool)] = 0
    unres = lev < 0
    while unres.any():
        lu = lev[upwind]
        ok = np.where(dep, lu >= 0, True).all(axis=1) & unres
        if not ok.any():
            break
        cand = np.where(dep, lu, -1).max(axis=1) + 1
        lev[ok] = np.maximum(cand[ok], 1)
        unres &= ~ok
    return lev


def _py_bfs_layers(counts, nbrs, wall_id):
    n = len(counts)
    layers = np.zeros(n, dtype=np.int32)
    mask_rows = np.arange(nbrs.shape[1])[None, :] < counts[:, None]
    adj_wall = ((nbrs == wall_id) & mask_rows).any(axis=1)
    layers[adj_wall] = 1
    frontier = np.nonzero(adj_wall)[0]
    layer = 1
    while frontier.size:
        cand = nbrs[frontier]
        cand = cand[(cand >= 0) & mask_rows[frontier]]
        cand = np.unique(cand)
        cand = cand[layers[cand] == 0]
        layers[cand] = layer + 1
        frontier = cand
        layer += 1
    layers[layers == 0] = layer + 1
    return layers


def _scipy_neighbors(zs, xs, ys, bounds, max_nb):
    """Delaunay-based fallback: 3x3 periodic tiling in x,y + z walls.

    Wall contacts are detected from the Delaunay of the point set
    augmented with mirror points across the z walls.
    """
    from scipy.spatial import Delaunay

    z_min, z_max, x_min, x_max, y_min, y_max = (float(b) for b in bounds)
    n = len(xs)
    Lx, Ly = x_max - x_min, y_max - y_min
    pts = []
    ids = []
    for ox in (-Lx, 0.0, Lx):
        for oy in (-Ly, 0.0, Ly):
            pts.append(np.stack([xs + ox, ys + oy, zs], axis=1))
            ids.append(np.arange(n))
    # mirror across z walls (for wall adjacency): bottom -> -5, top -> -6
    pts.append(np.stack([xs, ys, 2 * z_min - zs], axis=1))
    ids.append(np.full(n, BOTTOM_WALL))
    pts.append(np.stack([xs, ys, 2 * z_max - zs], axis=1))
    ids.append(np.full(n, TOP_WALL))
    P = np.concatenate(pts)
    ID = np.concatenate(ids)
    # owner index for dedup: images 0..8 map to site id, walls map to wall
    tri = Delaunay(P)
    indptr, indices = tri.vertex_neighbor_vertices
    base = 4 * n  # the (0,0) tile block index start: tiles are in order
    # tiles order: (-Lx,-Ly),(-Lx,0),(-Lx,Ly),(0,-Ly),(0,0),(0,Ly),...
    out_lists = []
    for i in range(n):
        vi = base + i
        nb = indices[indptr[vi]:indptr[vi + 1]]
        raw = ID[nb]
        seen = []
        for v in raw:
            if v == i and False:
                continue
            if v not in seen and v != i:
                seen.append(int(v))
        out_lists.append(seen)
    width = max(len(s) for s in out_lists)
    out = np.zeros((n, width + 1), dtype=np.int32)
    for i, s in enumerate(out_lists):
        out[i, 0] = len(s)
        out[i, 1:1 + len(s)] = s
    return out
