"""Continuum opacity recipes.

Port of voronoirt_tpu/physics/opacity.py (reference src/radiation.jl:
28-56): H- free-free (Bell & Berrington 1987), H- bound-free (Wishart
1979 x Saha), hydrogenic free-free, H2+ free-free and bound-free, Thomson
and Rayleigh.  Same formulae and float32-safe groupings; the recipe
provenance is documented in the JAX module.  All inputs SI (m, K, m^-3);
outputs are extinction in m^-1.  A wavelength may be a Python number.
"""

import warnings

import numpy as np
import torch

from ..constants import h, c_0, k_B, m_e, sigma_T

from . import tensors


def thomson(n_e):
    """Thomson scattering extinction [m^-1]."""
    return sigma_T * n_e


_RAYLEIGH_EDGE = 121.77e-9  # m; redward-of-Lyman-alpha validity edge


def rayleigh_h(lam, n_h1):
    """Rayleigh scattering off neutral hydrogen [m^-1]; 0 below the
    121.77 nm edge (src/radiation.jl:54)."""
    lam, n_h1 = tensors(lam, n_h1)
    lA = lam * 1e10
    sigma_cm2 = 5.799e-13 / lA**4 + 1.422e-6 / lA**6 + 2.784 / lA**8
    sigma = sigma_cm2 * 1e-4  # -> m^2
    return torch.where(lam > _RAYLEIGH_EDGE, sigma * n_h1, 0.0)


# Gray (2005) eq. 8.13 coefficients (Bell & Berrington 1987 fit).
_BB_F0 = (-2.2763, -1.6850, 0.76661, -0.053346)
_BB_F1 = (15.2827, -9.2846, 1.99381, -0.142631)
_BB_F2 = (-197.789, 190.266, -67.9775, 10.6913, -0.625151)


def _poly_log(loglam, coefs):
    out = 0.0
    for i, c in enumerate(coefs):
        out = out + c * loglam**i
    return out


def hminus_ff(lam, T, n_h1, n_e):
    """H- free-free extinction [m^-1] (Bell & Berrington 1987 fit,
    lambda clamped to its 2600-113900 A validity range)."""
    lam, T = tensors(lam, T)
    lA = torch.clamp(lam * 1e10, 2600.0, 113900.0)
    loglam = torch.log10(lA)
    logth = torch.log10(5040.0 / T)
    f = (_poly_log(loglam, _BB_F0)
         + _poly_log(loglam, _BB_F1) * logth
         + _poly_log(loglam, _BB_F2) * logth**2)
    p_e = (n_e * 1e-6) * 1.380649e-16 * T
    return (1e-24 * p_e) * 10.0**f * (n_h1 * 1e-6)


# Wishart (1979) cross-section fit, Gray (2005) eq. 8.11; lambda in
# Angstrom, sigma in 1e-18 cm^2.  Photodetachment edge at 16444 A.
_WISHART = (1.99654, -1.18267e-5, 2.64243e-6, -4.40524e-10,
            3.23992e-14, -1.39568e-18, 2.78701e-23)
_CHI_HMINUS = 0.754195 * 1.602176634e-19   # H- binding energy [J]


def hminus_bf_sigma(lam):
    """H- photodetachment cross-section [m^2] (Wishart 1979 fit)."""
    (lam,) = tensors(lam)
    lA = lam * 1e10
    s = 0.0
    for i, a in enumerate(_WISHART):
        s = s + a * lA**i
    s = torch.where((lA < 16444.0) & (s > 0.0), s, 0.0)
    return s * 1e-18 * 1e-4  # 1e-18 cm^2 -> m^2


_LAMDB3_C = float((h**2 / (2.0 * np.pi * m_e * k_B)) ** 1.5)  # ~4.1e-22
_CHI_HM_OVER_K = float(_CHI_HMINUS / k_B)


def hminus_saha_factor(T, n_e):
    """LTE n(H-)/n(H I) by Saha inversion (g(H-)=1, g(HI)=2)."""
    return (0.25 * _LAMDB3_C) * n_e * T ** -1.5 * torch.exp(
        torch.clamp(_CHI_HM_OVER_K / T, 0.0, 500.0))


def hminus_bf(lam, T, n_h1, n_e):
    """H- bound-free extinction with stimulated emission [m^-1]."""
    lam, T = tensors(lam, T)
    stim = -torch.expm1(-(h * c_0 / k_B) / (lam * T))
    return hminus_bf_sigma(lam) * hminus_saha_factor(T, n_e) * n_h1 * stim


def gaunt_ff(lam, T):
    """Free-free Gaunt factor, Gray (2005) eq. 8.6."""
    lamR = lam * 1.0968e7
    return 1.0 + 0.3456 / lamR ** (1.0 / 3.0) * (
        lam * k_B * T / (h * c_0) + 0.5)


_HFF_C = float(3.6923e-2 / c_0**3)   # ~1.37e-27


def hydrogenic_ff(nu, T, n_e, n_ion, Z=1):
    """Hydrogenic (H II) free-free extinction [m^-1] (Kramers with
    Gaunt factor and stimulated emission; Transparency.jl
    hydrogenic_ff)."""
    nu, T = tensors(nu, T)
    lam = c_0 / nu
    stim = -torch.expm1(-(h / k_B) * nu / T)
    return ((_HFF_C * n_e) * (lam**3 * n_ion)
            * (Z**2 * gaunt_ff(lam, T) / torch.sqrt(T)) * stim)


_H2P_D0 = 2.65 * 1.602176634e-19    # H2+ dissociation energy [J]
_MU_HP = 0.5 * 1.6726219e-27        # reduced mass of H + p [kg]
_H2P_LAMDB3_C = float((h**2 / (2.0 * np.pi * _MU_HP * k_B)) ** 1.5)
_H2P_D0_OVER_K = float(_H2P_D0 / k_B)
_H2P_THETA_VIB = 2297.0 * 1.4388   # K
_H2P_THETA_ROT = 29.8 * 1.4388     # K


def _h2plus_equilibrium(T, n_h1, n_p):
    """LTE n(H2+) from n(H I) n(p) via molecular Saha, capped by the
    parent pools."""
    q_rot = T / (2.0 * _H2P_THETA_ROT)
    q_vib = 1.0 / -torch.expm1(-_H2P_THETA_VIB / T)
    q_int = 2.0 * q_rot * q_vib
    boltz = torch.exp(torch.clamp(_H2P_D0_OVER_K / T, 0.0, 500.0))
    n_lte = ((_H2P_LAMDB3_C * n_h1) * T ** -1.5) * n_p * 0.5 * q_int * boltz
    return torch.minimum(n_lte, torch.minimum(n_h1, n_p))


def h2plus_bf(lam, T, n_h1, n_p):
    """H2+ photodissociation extinction [m^-1] (log-normal
    cross-section approximating Bates 1952)."""
    lam, T = tensors(lam, T)
    sigma = 2e-22 * torch.exp(-((torch.log(lam / 110e-9) / 0.25) ** 2))
    stim = -torch.expm1(-(h * c_0 / k_B) / (lam * T))
    return _h2plus_equilibrium(T, n_h1, n_p) * sigma * stim


def h2plus_ff(lam, T, n_h1, n_p):
    """H2+ free-free extinction [m^-1] (Bates 1952 magnitude)."""
    lam, T = tensors(lam, T)
    return ((2e-26 * n_h1) * (1e-23 * n_p)
            * (lam / 1e-6) ** 3 * torch.sqrt(6000.0 / T))


_CHI_HION_OVER_K = float(h * c_0 * 109677.617e2 / k_B)  # H ionization [K]


def warn_charge_inconsistency(temperature, electron_density,
                              hydrogen_density, factor=100.0, frac=0.01):
    """Warn when n_e sits more than `factor` below the pure-H Saha proton
    density over more than `frac` of cells (the H2+ recipes assume
    n_e ~ n_p).  Host-side; returns the offending cell fraction.

    Python's warnings filter reports each call site once, which takes
    the place of the JAX module's global warned-once flag."""
    T = temperature.double().cpu().numpy().ravel()
    n_e = electron_density.double().cpu().numpy().ravel()
    n_H = hydrogen_density.double().cpu().numpy().ravel()
    phi = 2.0 * ((2.0 * np.pi * m_e * k_B / h**2) * T) ** 1.5 \
        * np.exp(-np.clip(_CHI_HION_OVER_K / T, None, 690.0))
    n_p_saha = 0.5 * (-phi + np.sqrt(phi * phi + 4.0 * phi * n_H))
    bad = float(np.mean(n_e * factor < n_p_saha))
    if bad > frac:
        warnings.warn(
            f"atmosphere n_e is >{factor:.0f}x below the charge-consistent "
            f"Saha proton density in {100 * bad:.1f}% of cells; the H2+ "
            "continuum recipes assume n_e ~ n_p and their share of the "
            "continuum is unreliable there (docs/PARITY.md section 1)",
            stacklevel=2)
    return bad


def alpha_absorption(lam, T, n_e, n_h_neutral, n_proton):
    """Total thermal-absorption extinction [m^-1] (src/radiation.jl:
    28-40): H- ff + H- bf + hydrogenic ff + H2+ ff + H2+ bf."""
    lam, T = tensors(lam, T)
    a = hminus_ff(lam, T, n_h_neutral, n_e)
    a = a + hminus_bf(lam, T, n_h_neutral, n_e)
    a = a + hydrogenic_ff(c_0 / lam, T, n_e, n_proton, 1)
    a = a + h2plus_ff(lam, T, n_h_neutral, n_proton)
    a = a + h2plus_bf(lam, T, n_h_neutral, n_proton)
    return a


def alpha_scattering(lam, n_e, n_h1):
    """Scattering extinction [m^-1] (src/radiation.jl:49-56)."""
    return thomson(n_e) + rayleigh_h(lam, n_h1)
