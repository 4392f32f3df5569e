"""Collisional line broadening (damping gamma) recipes.

Port of voronoirt_tpu/physics/broadening.py (reference
src/broadening.jl and the Transparency.jl helpers it calls).  The
atmosphere-independent constants stay numpy host code.
"""

import numpy as np

from ..constants import (h, k_B, e, a_0, m_e, m_u, Ry, E_inf, alpha_p,
                         inv_4pi_eps0, mass_H, mass_He, abund_He, c_0)


def n_eff(chi_inf, chi, Z):
    """Effective principal quantum number (Transparency.jl n_eff)."""
    return Z * np.sqrt(E_inf / (chi_inf - chi))


def c4_traving(line):
    """Quadratic-Stark C4 interaction constant [m^4 s^-1]
    (src/broadening.jl:7-13)."""
    nu = n_eff(line.chi_inf, line.chi_j, line.Z)
    nl = n_eff(line.chi_inf, line.chi_i, line.Z)
    C4 = (e**2 * inv_4pi_eps0 * a_0**3 * 2.0 * np.pi / (h * 18.0 * line.Z**4)
          * ((nu * (5.0 * nu**2 + 1.0))**2 - (nl * (5.0 * nl**2 + 1.0))**2))
    return C4


def const_unsold(line, H_scaling=1.0, He_scaling=1.0):
    """Atmosphere-independent Unsold constant (src/broadening.jl:24-35)."""
    d_r = Ry**2 * (1.0 / (line.chi_inf - line.chi_j)**2
                   - 1.0 / (line.chi_inf - line.chi_i)**2)
    C6 = (2.5 * e**2 * alpha_p * inv_4pi_eps0**2 * 2.0 * np.pi
          * (line.Z * a_0)**2 / h * d_r)
    v_rel_const = 8.0 * k_B / (np.pi * line.atom_weight)
    v_rel_H = v_rel_const * (1.0 + line.atom_weight / mass_H)
    v_rel_He = v_rel_const * (1.0 + line.atom_weight / mass_He)
    return (8.08 * (H_scaling * v_rel_H**0.3
                    + He_scaling * abund_He * v_rel_He**0.3) * C6**0.4)


def const_quadratic_stark(line, mean_atomic_weight=28.0 * m_u, scaling=1.0):
    """Height-independent quadratic-Stark constant
    (src/broadening.jl:52-61)."""
    C = 8.0 * k_B / (np.pi * line.atom_weight)
    Cm = ((1.0 + line.atom_weight / m_e) ** (1.0 / 6.0)
          + (1.0 + line.atom_weight / mean_atomic_weight) ** (1.0 / 6.0))
    C4 = c4_traving(line)
    cStark23 = 11.37 * (scaling * C4) ** (2.0 / 3.0)
    return C ** (1.0 / 6.0) * cStark23 * Cm


def gamma_unsold(const, T, n_h1):
    """Van der Waals broadening: gamma = const * T^0.3 * n(H I) [s^-1]."""
    return const * T**0.3 * n_h1


def gamma_linear_stark(n_e, n_upper, n_lower):
    """Linear Stark broadening for hydrogen, Sutton (1978) / RH broad.c."""
    a1 = 0.642 if (n_upper - n_lower == 1) else 1.0
    return 0.6 * a1 * (n_upper**2 - n_lower**2) * (n_e * 1e-6) ** (2.0 / 3.0)


def gamma_quadratic_stark(n_e, T, stark_constant):
    """Quadratic Stark: gamma = const * T^(1/6) * n_e [s^-1]."""
    return stark_constant * T ** (1.0 / 6.0) * n_e


def gamma_constant(line, T, n_h_neutral, n_e, gamma_natural=4.702e8):
    """Total damping rate gamma [s^-1] per cell (src/broadening.jl:63-82):
    Unsold + (hard-coded) natural + linear Stark + quadratic Stark."""
    unsold_c = const_unsold(line)
    quad_c = const_quadratic_stark(line)
    g = gamma_unsold(unsold_c, T, n_h_neutral)
    g = g + gamma_natural
    g = g + gamma_linear_stark(n_e, 2, 1)
    g = g + gamma_quadratic_stark(n_e, T, quad_c)
    return g


def damping(gamma, lam, dlamD):
    """Voigt damping parameter a = gamma lam^2 / (4 pi c dlamD)
    (src/broadening.jl:87-89)."""
    return gamma * lam**2 / (4.0 * np.pi * c_0 * dlamD)
