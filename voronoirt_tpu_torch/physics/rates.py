"""Radiative (R) and collisional (C) rate structures for the 3-level atom.

Port of voronoirt_tpu/physics/rates.py (reference src/rates.jl).
R[(i, j)] = rate level i -> level j, 0-based, 2 = continuum.

compat == 'reference' keeps the reference's quirks (rates.jl:221-274,
427-431): the Rij pair sums carry (f_l + f_{l+1}) dlam / 1000, the Rji
sums (f_l + f_{l+1}) dlam, and sigma_ic takes the window's last
wavelength as its edge and n_eff from chi_j - chi_i for both levels.
compat == 'fixed' uses 0.5x trapezoids and per-level n_eff.

calculate_R_chunk, the streamed form that every rate path of the
engines takes (the streamed iteration's chunks, the standard loop's
rows at once or in slabs, entry()), wraps the kernel R1 (csrc/rates.cu
vrt_rates_chunk: a lambda block's rate integrals in one launch, added
into the running rates in place); calculate_R_chunk_plain is its plain
version, which a CPU tensor takes.  calculate_R, the counterpart of the
JAX package's, keeps E2 (voigt_rows) for its bound-bound profile and
runs on no iteration path.
"""

import ctypes

import numpy as np
import torch

from ..constants import (h, c_0, e, eps_0, m_e, hc, R_inf, E_inf, IUNIT_SI,
                         k_B)
from ..observability import layer
from .extinction import voigt_rows, voigt_rows_plain
from .broadening import damping
from .collisions import coll_exc_hydrogen_johnson, coll_ion_hydrogen_johnson
from .voigt import _SQRT_PI

# R1 launches so far (not counting the plain version)
LAUNCHES = 0
_LOG_2HC2_IUNIT = float(np.log(2.0 * h * c_0**2 / IUNIT_SI))


def _lam(lam, ref):
    return torch.as_tensor(np.asarray(lam), dtype=ref.dtype,
                           device=ref.device)


def gaunt_bf(lam, charge, n_eff):
    """Bound-free Gaunt factor, Seaton (1960) (src/rates.jl:562-572)."""
    x = 1.0 / (lam * R_inf * charge**2)
    x3 = x ** (1.0 / 3.0)
    nsqx = 1.0 / (n_eff**2 * x)
    return (1.0 + 0.1728 * x3 * (1.0 - 2.0 * nsqx)
            - 0.0496 * x3**2 * (1.0 - (1.0 - nsqx) * 0.66666667 * nsqx))


def _sigma_bb_const(line):
    return hc / (4.0 * np.pi * line.lam0) * line.Bij


def sigma_ij_bb(line, lam, damping_lam):
    """Bound-bound cross-section [m^2] per (lam, cell) (rates.jl:374-413);
    no Doppler shift, as in the reference's rate integral.  The profile
    is voigt_rows' (physics/extinction.py): its kernel on the card."""
    return _sigma_bb_const(line) * voigt_rows(line, _lam(lam, line.dlamD),
                                              damping_lam)


def sigma_ic(level, line, lam, compat="reference"):
    """Bound-free cross-section [m^2] per lam (rates.jl:422-438)."""
    lam = _lam(lam, line.dlamD)
    return _sigma_ic_rows(level, line, lam, lam[-1], compat)


def Gij(i, j, lam, temperature, lte_pops):
    """LTE/stimulated factor (rates.jl:449-484):
    (n_i/n_j)_LTE * exp(-h c / (lam k_B T))."""
    lam_b = _lam(lam, temperature).reshape((-1,) + (1,) * temperature.dim())
    n_ratio = lte_pops[..., i] / lte_pops[..., j]
    # (hc/k_B)/(lam T) grouping keeps float32 intermediates in range
    return n_ratio[None] * torch.exp(-(hc / k_B) / (lam_b * temperature[None]))


def _pair_sum(f, lam, compat):
    """Sum over wavelength pairs: (f_l + f_{l+1}) dlam [* 0.5 if fixed];
    the reference applies no 0.5 (rates.jl:219-221).  The pairs are
    added one by one in pair order from the first, the order R1 sums
    them in (a reduction over the pair axis would add them in an order
    of its own on the card)."""
    dlam = torch.diff(_lam(lam, f))
    contrib = (f[:-1] + f[1:]) * dlam.reshape((-1,) + (1,) * (f.dim() - 1))
    out = contrib[0]
    for c in contrib[1:]:
        out = out + c
    if compat == "fixed":
        out = 0.5 * out
    return out


def _planck_iunit(lam):
    """The Planck term's prefactor 2 h c^2 / lam^5 in IUNIT, in log space
    (float32-safe)."""
    return torch.exp(_LOG_2HC2_IUNIT - 5.0 * torch.log(lam))


def Rij_integral(J, sigma, lam, compat="reference"):
    """Excitation/ionization radiative rate [s^-1] (rates.jl:204-278);
    J in IUNIT."""
    lam_b = _lam(lam, J).reshape((-1,) + (1,) * (J.dim() - 1))
    f = lam_b * sigma * (J * IUNIT_SI)
    R = 2.0 * np.pi / hc * _pair_sum(f, lam, compat)
    if compat == "reference":
        R = R / 1000.0
    return R


def Rji_integral(J, sigma, G, lam, compat="reference"):
    """De-excitation/recombination radiative rate [s^-1]
    (rates.jl:280-364); the Planck term in IUNIT with a log-space
    prefactor (float32-safe)."""
    lam_b = _lam(lam, J).reshape((-1,) + (1,) * (J.dim() - 1))
    f = (sigma * lam_b * IUNIT_SI) * G * (_planck_iunit(lam_b) + J)
    return 2.0 * np.pi / hc * _pair_sum(f, lam, compat)


def calculate_R(line, J_lam, damping_lam, lte_pops, temperature,
                compat="reference"):
    """Full radiative-rate structure (rates.jl:96-201).

    J_lam, damping_lam: (nlam, ...); returns {(i, j): tensor}.
    """
    i0, i1, i2, i3 = line.lam_idx
    R = {}
    for level, (start, stop) in enumerate(((i1, i2), (i2, i3))):
        lam_w = line.lam[start:stop]
        sig = sigma_ic(level, line, lam_w, compat)
        sig_b = sig.reshape((-1,) + (1,) * (J_lam.dim() - 1))
        G = Gij(level, 2, lam_w, temperature, lte_pops)
        R[(level, 2)] = Rij_integral(J_lam[start:stop], sig_b, lam_w, compat)
        R[(2, level)] = Rji_integral(J_lam[start:stop], sig_b, G, lam_w,
                                     compat)
    lam_w = line.lam[i0:i1]
    sig = sigma_ij_bb(line, lam_w, damping_lam[i0:i1])
    G = Gij(0, 1, lam_w, temperature, lte_pops)
    R[(0, 1)] = Rij_integral(J_lam[i0:i1], sig, lam_w, compat)
    R[(1, 0)] = Rji_integral(J_lam[i0:i1], sig, G, lam_w, compat)
    return R


def _window_pairs(line):
    """Per-window global pair ranges [p0, p1): pair p integrates rows
    (p, p+1), both inside the window."""
    i0, i1, i2, i3 = line.lam_idx
    return (((i1, i2 - 1), "bf0"), ((i2, i3 - 1), "bf1"),
            ((i0, i1 - 1), "bb"))


_RATE_KEYS = {"bf0": ((0, 2), (2, 0)), "bf1": ((1, 2), (2, 1)),
              "bb": ((0, 1), (1, 0))}


def _chunk_windows(line, r0, n_rows):
    """The rate windows a block of n_rows rows from global row r0 holds a
    pair of: (kind, first row a, last row b, the window's last pair p1),
    rows global, b > a."""
    out = []
    for (p0, p1), kind in _window_pairs(line):
        a = max(p0, r0)
        b = min(p1, r0 + n_rows - 1)
        if a < b:
            out.append((kind, a, b, p1))
    return out


@layer("rates")
def calculate_R_chunk(line, acc, J_blk, r0, g_cell, lte_pops,
                      temperature, compat="reference", lead=None):
    """Accumulate one lambda block's contribution to the rate integrals
    (streaming form of calculate_R).

    J_blk: (nb, ...) J rows covering global lambda rows [r0, r0+nb), or,
    with lead (1, ...) -- the previous chunk's last row, which leads the
    block so boundary pairs integrate once -- rows [r0 + 1, r0 + 1 + nb)
    after it.  acc: running {(i, j): tensor}, or None to start.  g_cell:
    per-cell damping gamma.  Sum over chunks == calculate_R up to float
    addition order.

    On the card one R1 launch (csrc/rates.cu) adds the block's rates
    into acc's tensors in place (a key new to acc gets a new tensor); on
    the CPU calculate_R_chunk_plain.  J_blk's cells must be contiguous
    within a row (rows any stride apart), the other tensors contiguous.
    """
    _check_chunk(line, acc, J_blk, r0, g_cell, lte_pops, temperature,
                 compat, lead)
    if J_blk.device.type == "cpu":
        return calculate_R_chunk_plain(line, acc, J_blk, r0, g_cell,
                                       lte_pops, temperature, compat, lead)
    return _launch_r1(line, acc, J_blk, r0, g_cell, lte_pops, temperature,
                      compat, lead)


def calculate_R_chunk_plain(line, acc, J_blk, r0, g_cell, lte_pops,
                            temperature, compat="reference", lead=None):
    """The plain PyTorch version of calculate_R_chunk: new tensors, acc
    left as it was."""
    if lead is not None:
        J_blk = torch.cat([lead, J_blk], 0)
    lam_all = np.asarray(line.lam)
    out = dict(acc) if acc is not None else {}

    def add(key, val):
        out[key] = val if key not in out else out[key] + val

    for kind, a, b, p1 in _chunk_windows(line, r0, int(J_blk.shape[0])):
        rows = slice(a - r0, b - r0 + 1)       # J rows a..b inclusive
        lam_w = lam_all[a:b + 1]
        J_w = J_blk[rows]
        key_ij, key_ji = _RATE_KEYS[kind]
        if kind == "bb":
            lam_b = _lam(lam_w, g_cell).reshape((-1,) + (1,) * g_cell.dim())
            damp = damping(g_cell[None], lam_b, line.dlamD[None])
            sig = _sigma_bb_const(line) * voigt_rows_plain(
                line, _lam(lam_w, line.dlamD), damp)
            G = Gij(0, 1, lam_w, temperature, lte_pops)
        else:
            level = 0 if kind == "bf0" else 1
            # compat sigma_ic uses lam[end] of the WINDOW as the edge
            sig = _sigma_ic_rows(level, line, _lam(lam_w, J_w),
                                 float(lam_all[p1]), compat)
            sig = sig.reshape((-1,) + (1,) * (J_w.dim() - 1))
            G = Gij(level, 2, lam_w, temperature, lte_pops)
        add(key_ij, Rij_integral(J_w, sig, lam_w, compat))
        add(key_ji, Rji_integral(J_w, sig, G, lam_w, compat))
    return out


def _same_as(ref, name, t):
    if t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"{name} must be {ref.dtype} on {ref.device}, got "
                         f"{t.dtype} on {t.device}")


def _check_chunk(line, acc, J_blk, r0, g_cell, lte_pops, temperature,
                 compat, lead):
    if temperature.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {temperature.dtype}")
    if compat not in ("reference", "fixed"):
        raise ValueError(f"compat must be 'reference' or 'fixed', got "
                         f"{compat!r}")
    cells = tuple(temperature.shape)
    named = [("J_blk", J_blk, None), ("g_cell", g_cell, cells),
             ("line.dlamD", line.dlamD, cells)]
    if lead is not None:
        named.append(("lead", lead, (1,) + cells))
    named += [(f"acc[{k}]", v, cells) for k, v in (acc or {}).items()]
    for name, t, shape in named + [("lte_pops", lte_pops, None)]:
        _same_as(temperature, name, t)
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if J_blk.dim() != len(cells) + 1 or tuple(J_blk.shape[1:]) != cells:
        raise ValueError(f"J_blk must be (nb,) + {cells}, got "
                         f"{tuple(J_blk.shape)}")
    if tuple(lte_pops.shape[:-1]) != cells or lte_pops.shape[-1] < 3:
        raise ValueError(f"lte_pops must be {cells} + (levels >= 3,), got "
                         f"{tuple(lte_pops.shape)}")
    n_rows = J_blk.shape[0] + (lead is not None)
    if r0 < 0 or r0 + n_rows > len(line.lam):
        raise ValueError(f"rows [{r0}, {r0 + n_rows}) are not rows of the "
                         f"line's {len(line.lam)}")


def _cells_contiguous(t):
    """t's cells (every axis after the first) lie contiguously a row."""
    want = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


# R1's row tables, one a line (its wavelengths and energies), compat,
# dtype and device: {key: (lam, dlam, sig, planck)} over all the line's
# rows.  A table's wavelengths cross to the card by a copy that
# synchronises the stream, so each is made once and every launch slices
# its rows from it, whatever line object (a slab's dlamD) it comes with.
_R1_ROWS = {}


def _r1_rows(line, r0, n_rows, ref, compat):
    """What an R1 launch reads besides the tensors: the block's windows as
    (kind, first row, last row), rows of the block, and its rows' lam,
    dlam (lam[r + 1] - lam[r]), bf sigma (0 on other rows) and Planck
    prefactor, sliced from the line's table (_r1_line_table; not to be
    written)."""
    key = (np.asarray(line.lam).tobytes(), tuple(line.lam_idx), line.chi_i,
           line.chi_j, line.chi_inf, line.Z, compat, ref.dtype, ref.device)
    if key not in _R1_ROWS:
        _R1_ROWS[key] = _r1_line_table(line, ref, compat)
    lam, dlam, sig, planck = _R1_ROWS[key]
    rows = slice(r0, r0 + n_rows)
    wins = [(kind, a - r0, b - r0)
            for kind, a, b, _ in _chunk_windows(line, r0, n_rows)]
    return wins, lam[rows], dlam[r0:r0 + n_rows - 1], sig[rows], planck[rows]


def _r1_line_table(line, ref, compat):
    """The line's rows' lam, dlam, bf sigma and Planck prefactor, made
    with the plain version's elementwise ops on ref's device."""
    lam_all = np.asarray(line.lam)
    lam = _lam(lam_all, ref)
    sig = torch.zeros_like(lam)
    for kind, a, b, p1 in _chunk_windows(line, 0, len(lam_all)):
        if kind != "bb":
            sig[a:b + 1] = _sigma_ic_rows(
                0 if kind == "bf0" else 1, line, lam[a:b + 1],
                float(lam_all[p1]), compat)
    return lam, torch.diff(lam), sig, _planck_iunit(lam)


def _launch_r1(line, acc, J_blk, r0, g_cell, lte_pops, temperature, compat,
               lead):
    """One R1 launch: the block's windows added into acc's tensors (new
    keys' tensors made here)."""
    from ..kernels import build
    fields = (g_cell, lte_pops, temperature, line.dlamD, lead) + tuple(
        (acc or {}).values())
    if not _cells_contiguous(J_blk) or not all(
            t.is_contiguous() for t in fields if t is not None):
        raise ValueError("rates_chunk kernel inputs must be contiguous (J "
                         "rows: their cells)")
    out = dict(acc) if acc is not None else {}
    wins, lam, dlam, sig, planck = _r1_rows(
        line, r0, J_blk.shape[0] + (lead is not None), temperature, compat)
    if not wins:
        return out
    win, outs = [], []
    for kind, lo, hi in wins:
        add = [key in out for key in _RATE_KEYS[kind]]
        if add[0] != add[1]:
            raise ValueError(f"acc holds one of the keys {_RATE_KEYS[kind]}")
        for key in _RATE_KEYS[kind]:
            if key not in out:
                out[key] = torch.empty_like(temperature)
            outs.append(out[key].data_ptr())
        win += [lo, hi, ("bf0", "bf1", "bb").index(kind), add[0]]
    n = temperature.numel()
    if n == 0:
        return out
    win_arr = np.asarray(win, dtype=np.int32)
    outs_arr = (ctypes.c_void_p * len(outs))(*outs)
    fn = build.launch_fn("vrt_rates_chunk", temperature.dtype)
    global LAUNCHES
    with torch.cuda.device(temperature.device):
        err = fn(J_blk.data_ptr(), None if lead is None else lead.data_ptr(),
                 lam.data_ptr(), dlam.data_ptr(), sig.data_ptr(),
                 planck.data_ptr(), g_cell.data_ptr(), line.dlamD.data_ptr(),
                 temperature.data_ptr(), lte_pops.data_ptr(),
                 ctypes.addressof(outs_arr), win_arr.ctypes.data, len(wins),
                 n, J_blk.stride(0), lte_pops.shape[-1],
                 int(compat == "fixed"), int(compat == "reference"),
                 line.lam0, _SQRT_PI, 4.0 * np.pi * c_0,
                 _sigma_bb_const(line), IUNIT_SI, -(hc / k_B),
                 2.0 * np.pi / hc, 1.0 / 1000.0,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rates_chunk")
    LAUNCHES += 1
    return out


def _sigma_ic_rows(level, line, lam, lam_edge_ref, compat):
    """sigma_ic over a row subset of a bf window (lam a tensor); the
    reference variant's edge wavelength is the window's last lambda,
    which a chunk may not contain, so it is passed in."""
    if compat == "reference":
        lam_edge = lam_edge_ref
        neff = np.sqrt(E_inf / (line.chi_j - line.chi_i))
    else:
        chi_level = line.chi_i if level == 0 else line.chi_j
        lam_edge = hc / (line.chi_inf - chi_level)
        neff = line.Z * np.sqrt(E_inf / (line.chi_inf - chi_level))
    lam3_ratio = (lam / lam_edge) ** 3
    charge = line.Z
    sigma_const = 4.0 * e**2 / (3.0 * np.pi * np.sqrt(3.0) * eps_0
                                * m_e * c_0**2 * R_inf)
    return (sigma_const * charge**4 * neff * lam3_ratio
            * gaunt_bf(lam, charge, neff))


def Cij(i, j, electron_density, temperature, lte_pops, boost=2.0e9):
    """Collisional rate i -> j [s^-1], 0-based levels (rates.jl:496-551)."""
    ionized = 2  # 0-based index of the continuum "level"
    if i < j:
        if j < ionized:
            C = coll_exc_hydrogen_johnson(i + 1, j + 1, electron_density,
                                          temperature)
        else:
            C = coll_ion_hydrogen_johnson(i + 1, electron_density,
                                          temperature)
    else:
        if i < ionized:
            C = coll_exc_hydrogen_johnson(j + 1, i + 1, electron_density,
                                          temperature)
        else:
            C = coll_ion_hydrogen_johnson(j + 1, electron_density,
                                          temperature)
        C = C * lte_pops[..., j] / lte_pops[..., i]
    return C * boost


def calculate_C(electron_density, temperature, lte_pops, boost=2.0e9):
    """Full collisional-rate structure (rates.jl:11-85)."""
    C = {}
    for level in (0, 1):
        C[(level, 2)] = Cij(level, 2, electron_density, temperature,
                            lte_pops, boost)
        C[(2, level)] = Cij(2, level, electron_density, temperature,
                            lte_pops, boost)
    C[(0, 1)] = Cij(0, 1, electron_density, temperature, lte_pops, boost)
    C[(1, 0)] = Cij(1, 0, electron_density, temperature, lte_pops, boost)
    return C
