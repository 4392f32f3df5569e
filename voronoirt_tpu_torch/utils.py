"""Small numeric and I/O utilities.

Reference parity: src/functions.jl cumtrapz (:507-519), the site
text-file writers of src/io.jl (:8-51) used to feed the voro++ CLI, and
xy_intersect/range_bounds live in solvers.sweep_regular.

The port's own copy of voronoirt_tpu/utils.py (numpy only): the port
imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

from __future__ import annotations

import numpy as np


def cumtrapz(x, y):
    """Cumulative trapezoid of y over coordinates x (functions.jl:507-519).

    out[i] = out[i-1] + 0.5 |x_i - x_{i-1}| (y_i + y_{i-1}); out[0] = 0.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    assert x.shape[0] == y.shape[0]
    steps = 0.5 * np.abs(np.diff(x)) * (y[1:] + y[:-1])
    out = np.zeros_like(y, dtype=np.float64)
    out[1:] = np.cumsum(steps)
    return out


def write_sites_text(x, y, z, fname):
    """Write sites as 'id x y z' rows (io.jl:8-40 write_arrays), the
    input format of the native CLI (and the reference's voro++ driver)."""
    x, y, z = (np.asarray(a) for a in (x, y, z))
    assert len(x) == len(y) == len(z), "Wrong shapes of input data"
    with open(fname, "w") as f:
        for i in range(len(z)):
            f.write(f"{i + 1}\t{x[i]}\t{y[i]}\t{z[i]}\n")


def write_boundaries_text(z_min, z_max, x_min, x_max, y_min, y_max, fname):
    """Boundary sidecar file (io.jl:42-51)."""
    with open(fname, "w") as f:
        for name, v in (("z_min", z_min), ("z_max", z_max),
                        ("x_min", x_min), ("x_max", x_max),
                        ("y_min", y_min), ("y_max", y_max)):
            f.write(f"{name} = {v}\n")


def read_neighbours_text(fname, n_sites):
    """Parse a CLI/voro++ '%i %n' neighbour file into the fixed-stride
    matrix layout (voronoi_utils.jl:36-70 read_cell), 0-based ids."""
    lists = [None] * n_sites
    with open(fname) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            idx = int(parts[0]) - 1
            nbs = [int(p) for p in parts[1:]]
            lists[idx] = [v - 1 if v > 0 else v for v in nbs]
    width = max(len(s) for s in lists if s is not None)
    out = np.zeros((n_sites, width + 1), dtype=np.int32)
    for i, s in enumerate(lists):
        if s:
            out[i, 0] = len(s)
            out[i, 1:1 + len(s)] = s
    return out
