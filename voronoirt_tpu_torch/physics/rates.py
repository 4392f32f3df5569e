"""Radiative (R) and collisional (C) rate structures for the 3-level atom.

Port of voronoirt_tpu/physics/rates.py (reference src/rates.jl).
R[(i, j)] = rate level i -> level j, 0-based, 2 = continuum.

compat == 'reference' keeps the reference's quirks (rates.jl:221-274,
427-431): the Rij pair sums carry (f_l + f_{l+1}) dlam / 1000, the Rji
sums (f_l + f_{l+1}) dlam, and sigma_ic takes the window's last
wavelength as its edge and n_eff from chi_j - chi_i for both levels.
compat == 'fixed' uses 0.5x trapezoids and per-level n_eff.
"""

import numpy as np
import torch

from ..constants import (h, c_0, e, eps_0, m_e, hc, R_inf, E_inf, IUNIT_SI,
                         k_B)

from .extinction import voigt_rows
from .broadening import damping
from .collisions import coll_exc_hydrogen_johnson, coll_ion_hydrogen_johnson


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


def sigma_ij_bb(line, lam, damping_lam):
    """Bound-bound cross-section [m^2] per (lam, cell) (rates.jl:374-413);
    no Doppler shift, as in the reference's rate integral.  The profile
    is voigt_rows' (physics/extinction.py): its kernel on the card."""
    sigma_const = hc / (4.0 * np.pi * line.lam0) * line.Bij
    return sigma_const * voigt_rows(line, _lam(lam, line.dlamD), damping_lam)


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
    the reference applies no 0.5 (rates.jl:219-221)."""
    dlam = torch.diff(_lam(lam, f))
    contrib = (f[:-1] + f[1:]) * dlam.reshape((-1,) + (1,) * (f.dim() - 1))
    out = torch.sum(contrib, dim=0)
    if compat == "fixed":
        out = 0.5 * out
    return out


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
    planck_iunit = torch.exp(
        float(np.log(2.0 * h * c_0**2 / IUNIT_SI)) - 5.0 * torch.log(lam_b))
    f = (sigma * lam_b * IUNIT_SI) * G * (planck_iunit + J)
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


def calculate_R_chunk(line, acc, J_blk, r0, g_cell, lte_pops,
                      temperature, compat="reference"):
    """Accumulate one lambda block's contribution to the rate integrals
    (streaming form of calculate_R).

    J_blk: (nb, ...) J rows covering global lambda rows [r0, r0+nb) (the
    previous chunk's last row leads, so boundary pairs integrate once).
    acc: running {(i, j): tensor}, or None to start.  g_cell: per-cell
    damping gamma.  Sum over chunks == calculate_R up to float addition
    order.
    """
    nb = int(J_blk.shape[0])
    lam_all = np.asarray(line.lam)
    out = dict(acc) if acc is not None else {}

    def add(key, val):
        out[key] = val if key not in out else out[key] + val

    for (p0, p1), kind in _window_pairs(line):
        a = max(p0, r0)
        b = min(p1, r0 + nb - 1)
        if a >= b:
            continue
        rows = slice(a - r0, b - r0 + 1)       # J rows a..b inclusive
        lam_w = lam_all[a:b + 1]
        J_w = J_blk[rows]
        if kind == "bb":
            lam_b = _lam(lam_w, g_cell).reshape((-1,) + (1,) * g_cell.dim())
            damp = damping(g_cell[None], lam_b, line.dlamD[None])
            sig = sigma_ij_bb(line, lam_w, damp)
            G = Gij(0, 1, lam_w, temperature, lte_pops)
            add((0, 1), Rij_integral(J_w, sig, lam_w, compat))
            add((1, 0), Rji_integral(J_w, sig, G, lam_w, compat))
        else:
            level = 0 if kind == "bf0" else 1
            # compat sigma_ic uses lam[end] of the WINDOW as the edge
            we = p1 + 1
            sig = _sigma_ic_rows(level, line, _lam(lam_w, J_w),
                                 float(lam_all[we - 1]), compat)
            sig_b = sig.reshape((-1,) + (1,) * (J_w.dim() - 1))
            G = Gij(level, 2, lam_w, temperature, lte_pops)
            add((level, 2), Rij_integral(J_w, sig_b, lam_w, compat))
            add((2, level), Rji_integral(J_w, sig_b, G, lam_w, compat))
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
