"""The yardstick's frozen work counts: the bytes and operations of one
call of each layer, and the least time the card could take for them.

Copied from the chip smoke test's arithmetic (`_bound_ms`, `_bounds`,
`_group_work`, `_ext_work`, `_rates_work`, `_s_update_work`,
`_v1_stage_work`) and kept per layer call: bytes count each input read
once and each output written once, whatever a kernel reads again;
operations are counted from the algorithm (an fma as two; a division,
reciprocal, exp or cos as one), where they depend on the data (the
Humlicek region of each Voigt point) on the call's own inputs.  Later
changes to the program's kernels do not move these counts.

Peaks: one H100 SXM, NVIDIA's data sheet: 3.35 TB/s of HBM, 34 TFLOP/s
in float64 and 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}

# operations a point of each Humlicek region (I-IV), region tests
# included, real part only: the rates' evaluator and the extinction's
# (regions III and IV with one division fewer)
REGION_OPS = (17, 31, 63, 107)
E1_REGION_OPS = (17, 31, 60, 104)
# the extinction besides H: a point (with the per-cell gamma; with
# damping rows 3 fewer), a cell, a cell and direction (with the velocity
# field: v . k too)
ALPHA_OPS = {"point": 8, "rows_point": 5, "cell": 7, "angle": 2,
             "angle_velocity": 7}
# fields the extinction reads once a cell: g, n_i, n_j, a_cont, dlamD,
# and v_los (one direction) or the velocity's 3 components (a group)
ALPHA_FIELDS = {"alpha_tot": 6, "alpha_tot_group": 8}
# the rates besides H: a bound-bound point, a bound-free point, a cell
# and window; the S update a point and a cell
RATE_OPS = {"bb_point": 26, "bf_point": 19, "window_cell": 8}
S_UPDATE_OPS = {"point": 14, "cell": 1}
RATE_LEVELS = {"bf0": (0, 2), "bf1": (1, 2), "bb": (0, 1)}
RATE_KEYS = {"bf0": ((0, 2), (2, 0)), "bf1": ((1, 2), (2, 1)),
             "bb": ((0, 1), (1, 0))}
C_0 = 2.99792458e8


def least_s(nbytes, ops, dtype):
    """(seconds, 'bytes' | 'operations'): the larger of the bytes over
    the memory rate and the operations over the dtype's rate."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / OPS_PER_S[dtype]
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ------------------------------------------------------------ regular sweep

def march_plane(B, nx, ny, n_sweeps, esize):
    """K2, one z-plane of the yz / xz march (coefficients and chain):
    five planes read, one written."""
    pts = B * nx * ny
    return 6 * esize * pts, (50 + 5 * n_sweeps) * pts


def xy_segment(L, B, nx, ny, esize):
    """K1, L steps of an xy segment: each step's alpha and S plane read
    and its I plane written."""
    pts = B * nx * ny
    return 3 * esize * pts * L, 60 * pts * L


# -------------------------------------------------------------- the J emit

def group_emit(L, P, B, nx, ny, esize):
    """G1: L planes of P angles read, two J halves read and written."""
    pts = B * nx * ny
    return (P + 2) * L * pts * esize, 2 * P * L * pts


def group_stack(in_values, out_values, esize):
    """G2: each distinct input read once and the stack written once (the
    S stack: one chunk of S read, P copies written)."""
    return (in_values + out_values) * esize, 0


def group_fold(B, nx, ny, nz, esize):
    """G3: J_up, J_dn and J read, J written; two adds a point."""
    pts = B * nx * ny
    return 4 * nz * pts * esize, 2 * nz * pts


# -------------------------------------------------- Voigt regions, tallies

def region_map(a, v):
    """The Humlicek region (1-4) of each point at damping a, shift v."""
    av = v.abs()
    s = av + a
    r = torch.where(a >= 0.195 * av - 0.176, 3, 4).to(torch.int8)
    r = torch.where(s >= 5.5, 2, r).to(torch.int8)
    return torch.where(s >= 15.0, 1, r).to(torch.int8)


def tally(r):
    """Points of each region in r, as four ints."""
    counts = torch.bincount(r.reshape(-1).to(torch.int64), minlength=5)
    return [int(c) for c in counts[1:5].tolist()]


def _damping(g, lam, dlamD):
    return g * lam**2 / (4.0 * np.pi * C_0 * dlamD)


def extinction(kind, lam, lam0, g, dlamD, v_loses, esize, rows=False):
    """E1, one call: the extinction of the wavelengths lam (B,) for the
    directions whose line-of-sight velocities are v_loses (cells each;
    one for 'alpha_tot', the group's for 'alpha_tot_group'), from the
    per-cell gamma g (or, with rows, from damping rows made from it,
    which the call reads instead of g) and the Doppler width dlamD, in a
    type of esize bytes.  (bytes, ops)."""
    cells, es = dlamD.numel(), esize
    counts = [0] * 4
    for v_los in v_loses:
        for j in range(lam.shape[0]):
            lj = lam[j]
            a = _damping(g, lj, dlamD)
            v = (lj - lam0 + lam0 * v_los / C_0) / dlamD
            counts = [c + n for c, n in zip(counts, tally(region_map(a, v)))]
    P = len(v_loses)
    points = P * lam.shape[0] * cells
    h_ops = sum(n * o for n, o in zip(counts, E1_REGION_OPS))
    nbytes = es * ((ALPHA_FIELDS[kind] - rows) * cells
                   + rows * lam.shape[0] * cells + points)
    per_angle = ALPHA_OPS["angle_velocity" if kind == "alpha_tot_group"
                          else "angle"]
    ops = h_ops + (ALPHA_OPS["cell"] + P * per_angle) * cells \
        + points * ALPHA_OPS["rows_point" if rows else "point"]
    return nbytes, ops


# -------------------------------------------------------------- rates, S1

def window_pairs(lam_idx):
    i0, i1, i2, i3 = lam_idx
    return (((i1, i2 - 1), "bf0"), ((i2, i3 - 1), "bf1"),
            ((i0, i1 - 1), "bb"))


def chunk_windows(lam_idx, r0, n_rows):
    """(kind, first row, last row) of each rate window a block of n_rows
    rows from r0 holds a pair of."""
    out = []
    for (p0, p1), kind in window_pairs(lam_idx):
        a, b = max(p0, r0), min(p1, r0 + n_rows - 1)
        if a < b:
            out.append((kind, a, b))
    return out


def rates_chunk(lam, lam_idx, lam0, r0, n_rows, acc_keys, g, dlamD, esize):
    """R1, one call over rows [r0, r0 + n_rows) of the line: each J row
    read once, T and the LTE levels its windows use once a cell (g and
    dlamD too for the bound-bound window), each rate written once and,
    where it was there already, read once; operations with each
    bound-bound point's own Humlicek region; values of esize bytes.
    (bytes, ops)."""
    cells, es = dlamD.numel(), esize
    wins = chunk_windows(lam_idx, r0, n_rows)
    levels = {lv for kind, _, _ in wins for lv in RATE_LEVELS[kind]}
    bb = [(a, b) for kind, a, b in wins if kind == "bb"]
    rows = sum(b - a + 1 for _, a, b in wins)
    rates_io = sum(2 * (1 + (RATE_KEYS[kind][0] in acc_keys))
                   for kind, _, _ in wins)
    nbytes = es * cells * (rows + 1 + len(levels) + 2 * bool(bb) + rates_io)
    counts = [0] * 4
    for a, b in bb:
        for r in range(a, b + 1):
            counts = [c + n for c, n in zip(counts, tally(region_map(
                _damping(g, lam[r], dlamD), (lam[r] - lam0) / dlamD)))]
    n_bb = sum(b - a + 1 for a, b in bb)
    ops = (sum(n * o for n, o in zip(counts, REGION_OPS))
           + cells * (RATE_OPS["bb_point"] * n_bb
                      + RATE_OPS["bf_point"] * (rows - n_bb)
                      + RATE_OPS["window_cell"] * len(wins)))
    return nbytes, ops


def s_update(cells, nb, esize):
    """S1 over nb rows: J, S_old read and S_new written a point, eps and
    T read a cell."""
    return (esize * cells * (3 * nb + 2),
            cells * (S_UPDATE_OPS["point"] * nb + S_UPDATE_OPS["cell"]))


# ------------------------------------------------------------------- V1

def voronoi_stage(off, up_slot, up_site, row_site, passes, B, esize):
    """V1, one pass over a stage's levels in the formal form: per level,
    each distinct upwind I row and each distinct site's S and extinction
    read once, the rows' ids (int64) and geometry read once, the new rows
    written once; the I rows read and written again on each further
    pass; 32 operations a row and wavelength.  Host arrays."""
    off = np.asarray(off)
    level = np.repeat(np.arange(len(off) - 1), np.diff(off))

    def distinct(ids):
        return len(np.unique(level[:, None] * (int(ids.max()) + 1) + ids))

    R = int(off[-1])
    sites = np.concatenate([up_site, row_site[:, None]], 1)
    n_I, n_site = distinct(up_slot), distinct(sites)
    fields = (2 * n_site * B) * esize + R * (5 * 8 + 4 * esize)
    rows = (n_I + R) * B * esize
    return fields + passes * rows, passes * 32 * R * B
