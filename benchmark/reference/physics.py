"""Plain physics of the reference: the hydrogenic line, LTE, continuum
opacity, collisions, broadening, the Voigt profile, radiative rates and
the three-level statistical equilibrium.

Plain PyTorch in float64, written after the published method (VoronoiRT,
arXiv:2306.01041; the Julia code's src/line.jl, populations.jl,
radiation.jl, rates.jl, broadening.jl) with its documented quirks
(compat 'reference': the rate pair sums without 1/2, the bound-free
edge of each window at its last wavelength).  It imports nothing of the
program under test and takes nothing it made.  Units: SI, intensities
in kW m^-2 nm^-1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# CODATA 2018
h = 6.62607015e-34
c_0 = 2.99792458e8
k_B = 1.380649e-23
e = 1.602176634e-19
m_e = 9.1093837015e-31
m_u = 1.66053906660e-27
eps_0 = 8.8541878128e-12
a_0 = 5.29177210903e-11
R_inf = 10973731.568160
sigma_T = 6.6524587321e-29
hc = h * c_0
E_inf = R_inf * c_0 * h
alpha_p = 4.5 * 4 * np.pi * eps_0 * a_0**3
inv_4pi_eps0 = 1.0 / (4 * np.pi * eps_0)
mass_H = 1.008 * m_u
mass_He = 4.003 * m_u
abund_He = 10**10.99 / 10**12
IUNIT_SI = 1.0e12
SQRT_PI = float(np.sqrt(np.pi))
LOG_2HC2_IUNIT = float(np.log(2.0 * h * c_0**2 / IUNIT_SI))


# ------------------------------------------------------------- the line

@dataclasses.dataclass(frozen=True)
class Line:
    Aji: float
    Bji: float
    Bij: float
    lam0: float
    lam: np.ndarray          # (nlam,) [m]
    lam_idx: tuple           # (0, n_bb, n_bb + n_bf, n_bb + 2 n_bf)
    chi_i: float
    chi_j: float
    chi_inf: float
    g_i: int
    g_j: int
    atom_weight: float
    Z: int


def _energy(chi_cm):
    return hc * chi_cm * 100.0


def _transition(chi1, chi2):
    return hc / (chi2 - chi1)


def _lambda_line(nlam, lam0, qwing=600.0, qcore=15.0):
    if nlam > 0 and nlam % 2 == 0:
        nlam += 1
    if 1 < nlam < 5:
        nlam = 5
    lam = np.empty(nlam)
    if nlam == 1:
        lam[0] = lam0
        return lam
    n = nlam / 2.0
    beta = qwing / (2.0 * qcore)
    y = beta + np.sqrt(beta * beta + (beta - 1.0) * n + 2.0 - 3.0 * beta)
    b = 2.0 * np.log(y) / (n - 1.0)
    a = qwing / (n - 2.0 + y * y)
    center = nlam // 2
    lam[center] = lam0
    q_to_lam = lam0 * 2.5e3 / c_0
    for w in range(1, nlam // 2 + 1):
        dlam = a * (w + (np.exp(b * w) - 1.0)) * q_to_lam
        lam[center - w] = lam0 - dlam
        lam[center + w] = lam0 + dlam
    return lam


def _lambda_bf(nlam, lam_min, chi_l, chi_inf):
    lam_max = _transition(chi_l, chi_inf)
    if nlam == 1:
        return np.array([lam_max])
    return np.linspace(lam_min, lam_max, nlam)


def lyman_alpha(nlam_bb, nlam_bf):
    """H Ly-alpha with its two bound-free continua (src/line.jl:232-247)."""
    chi_l, chi_u, chi_inf = (_energy(0.0), _energy(82258.211),
                             _energy(109677.617))
    g_u, g_l, f_value = 8, 2, 4.162e-1
    lam0 = _transition(chi_l, chi_u)
    lam_bb = _lambda_line(nlam_bb, lam0)
    edge = _transition(chi_l, chi_inf)
    lam = np.concatenate([
        lam_bb,
        _lambda_bf(nlam_bf, edge * 0.25 + 0.001e-9, chi_l, chi_inf),
        _lambda_bf(nlam_bf, edge + 0.001e-9, chi_u, chi_inf)])
    n_bb = len(lam_bb)
    Aul = (2.0 * np.pi * e**2 / (eps_0 * m_e * c_0 * lam0**2)
           * (g_l / g_u) * f_value)
    Bul = Aul * lam0**5 / (2.0 * h * c_0**2)
    return Line(Aji=float(Aul), Bji=float(Bul), Bij=float(g_u / g_l * Bul),
                lam0=float(lam0), lam=lam,
                lam_idx=(0, n_bb, n_bb + nlam_bf, n_bb + 2 * nlam_bf),
                chi_i=float(chi_l), chi_j=float(chi_u),
                chi_inf=float(chi_inf), g_i=g_l, g_j=g_u,
                atom_weight=float(mass_H), Z=1)


def doppler_width(line, T):
    return line.lam0 / c_0 * torch.sqrt(2.0 * k_B * T / line.atom_weight)


def planck(lam, T):
    """B_lambda [kW m^-2 nm^-1]; lam and T broadcast."""
    x = torch.clamp((h * c_0 / k_B) / (lam * T), min=1e-9)
    return torch.exp(LOG_2HC2_IUNIT - 5.0 * torch.log(lam)) / torch.expm1(x)


# ------------------------------------------------------------ LTE, C, eps

def lte_populations(line, T, ne, nH):
    """Saha-Boltzmann (n1, n2, n_HII), level axis last."""
    saha = 2.0 * ((k_B / h) * (2.0 * np.pi * m_e) / h * T) ** 1.5 / ne
    n2 = line.g_j / line.g_i * torch.exp(-torch.clamp(
        (line.chi_j - line.chi_i) / (k_B * T), max=690.0))
    n3 = 1.0 / line.g_i * torch.exp(-torch.clamp(
        (line.chi_inf - line.chi_i) / (k_B * T), max=690.0)) * saha
    n1 = torch.ones_like(T)
    total = n1 + n2 + n3
    return torch.stack([n1, n2, n3], -1) / total[..., None] * nH[..., None]


def _poly(x, coefs):
    out = 0.0
    for i, c in enumerate(coefs):
        out = out + c * x**i
    return out


def continuum_absorption(lam, T, ne, n_h1, n_p):
    """H- ff and bf, hydrogenic ff, H2+ ff and bf [m^-1]
    (src/radiation.jl:28-40)."""
    lA = torch.clamp(torch.as_tensor(lam * 1e10, dtype=T.dtype,
                                     device=T.device), 2600.0, 113900.0)
    loglam, logth = torch.log10(lA), torch.log10(5040.0 / T)
    f = (_poly(loglam, (-2.2763, -1.6850, 0.76661, -0.053346))
         + _poly(loglam, (15.2827, -9.2846, 1.99381, -0.142631)) * logth
         + _poly(loglam, (-197.789, 190.266, -67.9775, 10.6913, -0.625151))
         * logth**2)
    hm_ff = (1e-24 * ((ne * 1e-6) * 1.380649e-16 * T)) * 10.0**f \
        * (n_h1 * 1e-6)

    lamA = lam * 1e10
    s = _poly(lamA, (1.99654, -1.18267e-5, 2.64243e-6, -4.40524e-10,
                     3.23992e-14, -1.39568e-18, 2.78701e-23))
    sigma = (s if (lamA < 16444.0 and s > 0.0) else 0.0) * 1e-22
    stim = -torch.expm1(-(h * c_0 / k_B) / (lam * T))
    saha_hm = (0.25 * (h**2 / (2.0 * np.pi * m_e * k_B)) ** 1.5) * ne \
        * T ** -1.5 * torch.exp(torch.clamp(
            (0.754195 * 1.602176634e-19 / k_B) / T, 0.0, 500.0))
    hm_bf = sigma * saha_hm * n_h1 * stim

    nu = c_0 / lam
    lam_nu = c_0 / nu
    gaunt = 1.0 + 0.3456 / (lam_nu * 1.0968e7) ** (1.0 / 3.0) * (
        lam_nu * k_B * T / (h * c_0) + 0.5)
    h_ff = ((3.6923e-2 / c_0**3 * ne) * (lam_nu**3 * n_p)
            * (gaunt / torch.sqrt(T)) * -torch.expm1(-(h / k_B) * nu / T))

    h2_ff = ((2e-26 * n_h1) * (1e-23 * n_p) * (lam / 1e-6) ** 3
             * torch.sqrt(6000.0 / T))
    mu = 0.5 * 1.6726219e-27
    q_int = 2.0 * (T / (2.0 * 29.8 * 1.4388)) \
        * (1.0 / -torch.expm1(-2297.0 * 1.4388 / T))
    boltz = torch.exp(torch.clamp((2.65 * 1.602176634e-19 / k_B) / T,
                                  0.0, 500.0))
    n_h2 = (((h**2 / (2.0 * np.pi * mu * k_B)) ** 1.5 * n_h1) * T ** -1.5) \
        * n_p * 0.5 * q_int * boltz
    n_h2 = torch.minimum(n_h2, torch.minimum(n_h1, n_p))
    h2_bf = n_h2 * (2e-22 * np.exp(-((np.log(lam / 110e-9) / 0.25) ** 2))) \
        * stim
    return hm_ff + hm_bf + h_ff + h2_ff + h2_bf


def continuum_scattering(lam, ne, n_h1):
    """Thomson plus Rayleigh on H I (zero below 121.77 nm)."""
    lA = lam * 1e10
    sigma = (5.799e-13 / lA**4 + 1.422e-6 / lA**6 + 2.784 / lA**8) * 1e-4
    return sigma_T * ne + (sigma * n_h1 if lam > 121.77e-9 else 0.0)


def _E1(x):
    xs = torch.clamp(x, min=1e-30)
    a = (-0.57721566, 0.99999193, -0.24991055, 0.05519968, -0.00976004,
         0.00107857)
    small = -torch.log(xs) + (a[0] + xs * (a[1] + xs * (a[2] + xs * (
        a[3] + xs * (a[4] + xs * a[5])))))
    xl = torch.clamp(x, min=1.0)
    num = xl**4 + 8.5733287401 * xl**3 + 18.059016973 * xl**2 \
        + 8.6347608925 * xl + 0.2677737343
    den = xl**4 + 9.5733223454 * xl**3 + 25.6329561486 * xl**2 \
        + 21.0996530827 * xl + 3.9584969228
    large = torch.exp(-torch.clamp(xl, max=690.0)) / xl * num / den
    return torch.where(x <= 1.0, small, large)


def _E2(x):
    return torch.exp(-torch.clamp(x, 1e-30, 690.0)) - x * _E1(x)


def _johnson(n):
    if n == 1:
        g = (1.1330, -0.4059, 0.07014)
    elif n == 2:
        g = (1.0785, -0.2319, 0.02947)
    else:
        g = (0.9935 + 0.2328 / n - 0.1296 / n**2,
             -(0.6282 - 0.5598 / n + 0.5299 / n**2) / n,
             (0.3887 - 1.181 / n + 1.470 / n**2) / n**2)
    rn = 0.45 if n == 1 else 1.94 * n ** (-1.57)
    bn = -0.603 if n == 1 else \
        (4.0 - 18.63 / n + 36.24 / n**2 - 28.09 / n**3) / n
    return g, rn, bn


def coll_excitation(n, m, ne, T):
    """Johnson (1972) excitation n -> m [s^-1]."""
    (g0, g1, g2), rn, bn = _johnson(n)
    x = 1.0 - (n / m) ** 2
    f_nm = (32.0 / (3.0 * np.sqrt(3.0) * np.pi) * n / m**3 / x**3
            * (g0 + g1 / x + g2 / x**2))
    A = 2.0 * n**2 * f_nm / x
    B = 4.0 * n**4 / (m**3 * x**2) * (1.0 + 4.0 / (3.0 * x) + bn / x**2)
    y = x * (E_inf / n**2) / (k_B * T)
    z = rn * x + y
    vbar = float(np.sqrt(8.0 / np.pi)) * torch.sqrt(k_B * T / m_e)
    bracket = (A * ((1.0 / y + 0.5) * _E1(y) - (1.0 / z + 0.5) * _E1(z))
               + (B - A * np.log(2.0 * n**2 / x))
               * (_E2(y) / y - _E2(z) / z))
    rate = vbar * 2.0 * n**2 / x * (np.pi * a_0**2) * y**2 * bracket * ne
    return torch.clamp(rate, min=0.0)


def coll_ionisation(n, ne, T):
    """Johnson (1972) ionisation from level n [s^-1]."""
    (g0, g1, g2), rn, bn = _johnson(n)
    An = 32.0 / (3.0 * np.sqrt(3.0) * np.pi) * n * (g0 / 3.0 + g1 / 4.0
                                                     + g2 / 5.0)
    Bn = 2.0 / 3.0 * n**2 * (5.0 + bn)
    yn = (E_inf / n**2) / (k_B * T)
    zn = rn + yn

    def xi(t):
        return torch.exp(-torch.clamp(t, 1e-30, 690.0)) / t - 2.0 * _E1(t) \
            + _E2(t)

    vbar = float(np.sqrt(8.0 / np.pi)) * torch.sqrt(k_B * T / m_e)
    bracket = (An * (_E1(yn) / yn - _E1(zn) / zn)
               + (Bn - An * np.log(2.0 * n**2)) * (xi(yn) - xi(zn)))
    rate = vbar * 2.0 * n**2 * (np.pi * a_0**2) * yn**2 * bracket * ne
    return torch.clamp(rate, min=0.0)


def collisional_rates(ne, T, lte, boost):
    """{(i, j): C_ij} for levels 0, 1 and the continuum 2; downward rates
    by detailed balance at LTE; each times the boost."""
    C = {}
    for lv in (0, 1):
        up = coll_ionisation(lv + 1, ne, T)
        C[(lv, 2)] = up * boost
        C[(2, lv)] = up * lte[..., lv] / lte[..., 2] * boost
    up = coll_excitation(1, 2, ne, T)
    C[(0, 1)] = up * boost
    C[(1, 0)] = up * lte[..., 0] / lte[..., 1] * boost
    return C


def destruction(line, lte, ne, T, boost):
    """eps(lam0) = C21 / (C21 + A21 + B21 B(lam0)) (Rutten 3.98)."""
    C21 = coll_excitation(1, 2, ne, T) * lte[..., 0] / lte[..., 1] * boost
    B0 = planck(torch.as_tensor(line.lam0, dtype=T.dtype, device=T.device),
                T)
    return C21 / (C21 + line.Aji + line.Bji * IUNIT_SI * B0)


# ----------------------------------------------------------- broadening

def _n_eff(line, chi):
    return line.Z * np.sqrt(E_inf / (line.chi_inf - chi))


def damping_rate(line, T, n_h1, ne, gamma_natural):
    """gamma [s^-1]: van der Waals (Unsold) + natural + linear and
    quadratic Stark (src/broadening.jl:63-82)."""
    d_r = E_inf**2 * (1.0 / (line.chi_inf - line.chi_j) ** 2
                      - 1.0 / (line.chi_inf - line.chi_i) ** 2)
    C6 = (2.5 * e**2 * alpha_p * inv_4pi_eps0**2 * 2.0 * np.pi
          * (line.Z * a_0) ** 2 / h * d_r)
    v_rel = 8.0 * k_B / (np.pi * line.atom_weight)
    unsold = 8.08 * ((v_rel * (1.0 + line.atom_weight / mass_H)) ** 0.3
                     + abund_He * (v_rel * (1.0 + line.atom_weight
                                            / mass_He)) ** 0.3) * C6**0.4
    nu, nl = _n_eff(line, line.chi_j), _n_eff(line, line.chi_i)
    C4 = (e**2 * inv_4pi_eps0 * a_0**3 * 2.0 * np.pi / (h * 18.0 * line.Z**4)
          * ((nu * (5.0 * nu**2 + 1.0)) ** 2 - (nl * (5.0 * nl**2 + 1.0))
             ** 2))
    Cm = ((1.0 + line.atom_weight / m_e) ** (1.0 / 6.0)
          + (1.0 + line.atom_weight / (28.0 * m_u)) ** (1.0 / 6.0))
    stark = (8.0 * k_B / (np.pi * line.atom_weight)) ** (1.0 / 6.0) \
        * 11.37 * C4 ** (2.0 / 3.0) * Cm
    g = unsold * T**0.3 * n_h1 + gamma_natural
    g = g + 0.6 * 0.642 * (2**2 - 1**2) * (ne * 1e-6) ** (2.0 / 3.0)
    return g + stark * T ** (1.0 / 6.0) * ne


def damping(gamma, lam, dlamD):
    return gamma * lam**2 / (4.0 * np.pi * c_0 * dlamD)


def _w_region(region, t):
    """Humlicek's w of one region at t = a - i v."""
    u = t * t
    if region == 1:
        return t * 0.5641896 / (0.5 + u)
    if region == 2:
        return t * (1.410474 + u * 0.5641896) / (0.75 + u * (3.0 + u))
    if region == 3:
        return (16.4955 + t * (20.20933 + t * (11.96482 + t * (
            3.778987 + t * 0.5642236)))) / (16.4955 + t * (38.82363 + t * (
                39.27121 + t * (21.69274 + t * (6.699398 + t)))))
    numer = t * (36183.31 - u * (3321.9905 - u * (1540.787 - u * (
        219.0313 - u * (35.76683 - u * (1.320522 - u * 0.56419))))))
    denom = 32066.6 - u * (24322.84 - u * (9022.228 - u * (
        2186.181 - u * (364.2191 - u * (61.57037 - u * (1.841439 - u))))))
    return torch.exp(u) - numer / denom


def voigt_H(a, v):
    """Re w(v + i a), Humlicek (1982) w4: region I where |v| + a >= 15,
    II where it is >= 5.5, else III where a >= 0.195 |v| - 0.176 and IV
    elsewhere; each point evaluated in its own region."""
    a, v = torch.broadcast_tensors(a, v)
    av = torch.abs(v)
    s = av + a
    region = torch.where(s >= 15.0, 1, torch.where(
        s >= 5.5, 2, torch.where(a >= 0.195 * av - 0.176, 3, 4)))
    out = torch.empty_like(a)
    fa, fv, fo, fr = a.reshape(-1), v.reshape(-1), out.view(-1), \
        region.reshape(-1)
    for r in (1, 2, 3, 4):
        idx = torch.nonzero(fr == r).squeeze(1)
        if idx.numel():
            fo[idx] = _w_region(r, torch.complex(fa[idx], -fv[idx])).real
    return out


# --------------------------------------------------- frozen set-up, rates

@dataclasses.dataclass
class Frozen:
    """What stays fixed through the iteration (lambda_iteration.jl:
    124-154): LTE populations, continuum extinction at line centre,
    eps(lam0), the collisional rates, the Doppler widths."""
    lte: torch.Tensor
    a_cont: torch.Tensor
    eps: torch.Tensor
    C: dict
    dlamD: torch.Tensor


def frozen_setup(line, T, ne, nH, boost):
    lte = lte_populations(line, T, ne, nH)
    n_h1 = lte[..., 0] + lte[..., 1]
    a_cont = continuum_absorption(line.lam0, T, ne, n_h1, lte[..., 2]) \
        + continuum_scattering(line.lam0, ne, lte[..., 0])
    return Frozen(lte=lte, a_cont=a_cont,
                  eps=destruction(line, lte, ne, T, boost),
                  C=collisional_rates(ne, T, lte, boost),
                  dlamD=doppler_width(line, T))


def line_factor(line, populations, dlamD):
    """hc/(4 pi lam0) (n_i Bij - n_j Bji) / (sqrt(pi) dlamD): the line
    extinction per unit H(a, v)."""
    return (hc / (4.0 * np.pi * line.lam0)) * (
        populations[..., 0] * line.Bij - populations[..., 1] * line.Bji) \
        / (SQRT_PI * dlamD)


def extinction(line, lam, v_los, populations, frozen, gamma):
    """alpha(lam, cell) = H(a, v) f + alpha_cont, (nlam,) + cells, for
    the line-of-sight velocity v_los (the direction's -k folded in)."""
    shape = (-1,) + (1,) * v_los.dim()
    lam_b = torch.as_tensor(lam, dtype=v_los.dtype,
                            device=v_los.device).reshape(shape)
    a = damping(gamma[None], lam_b, frozen.dlamD[None])
    v = (lam_b - line.lam0 + line.lam0 * v_los[None] / c_0) \
        / frozen.dlamD[None]
    return voigt_H(a, v) * line_factor(line, populations, frozen.dlamD)[None] \
        + frozen.a_cont[None]


def _gaunt_bf(lam, n_eff):
    x = 1.0 / (lam * R_inf)
    x3 = x ** (1.0 / 3.0)
    nsqx = 1.0 / (n_eff**2 * x)
    return (1.0 + 0.1728 * x3 * (1.0 - 2.0 * nsqx)
            - 0.0496 * x3**2 * (1.0 - (1.0 - nsqx) * 0.66666667 * nsqx))


def sigma_bf(line, lam, level, compat):
    """Bound-free cross-section [m^2] over a window (rates.jl:422-438).
    compat 'reference': the window's last wavelength as its edge and
    n_eff from chi_j - chi_i for both levels; 'fixed': the level's own
    edge and n_eff."""
    if compat == "reference":
        edge = lam[-1]
        neff = np.sqrt(E_inf / (line.chi_j - line.chi_i))
    else:
        chi = line.chi_i if level == 0 else line.chi_j
        edge = hc / (line.chi_inf - chi)
        neff = line.Z * np.sqrt(E_inf / (line.chi_inf - chi))
    const = 4.0 * e**2 / (3.0 * np.pi * np.sqrt(3.0) * eps_0 * m_e
                          * c_0**2 * R_inf)
    return const * line.Z**4 * neff * (lam / edge) ** 3 \
        * _gaunt_bf(lam, neff)


def radiative_rates(line, J, frozen, gamma, T, compat, cells=None):
    """{(i, j): R_ij} from J (nlam,) + cells (rates.jl:96-364): the pair
    sums (f_l + f_l+1) dlam of compat 'reference' (Rij also / 1000), or
    the trapezoids of 'fixed'.  cells: a slice of the first spatial axis
    to compute on (J given whole)."""
    sl = (slice(None),) + ((cells,) if cells is not None else ())
    J = J[sl]
    idx = (cells,) if cells is not None else (...,)
    Tc, lte, dlamD, g = T[idx], frozen.lte[idx], frozen.dlamD[idx], \
        gamma[idx]
    i0, i1, i2, i3 = line.lam_idx
    lam_all = torch.as_tensor(line.lam, dtype=T.dtype, device=T.device)
    shape = (-1,) + (1,) * Tc.dim()
    R = {}

    def integrals(rows, sigma, lower, upper):
        lam = lam_all[rows].reshape(shape)
        Jw = J[rows]
        G = (lte[..., lower] / lte[..., upper])[None] * torch.exp(
            -(hc / k_B) / (lam * Tc[None]))
        f_ij = lam * sigma * (Jw * IUNIT_SI)
        f_ji = (sigma * lam * IUNIT_SI) * G * (
            torch.exp(LOG_2HC2_IUNIT - 5.0 * torch.log(lam)) + Jw)
        dlam = torch.diff(lam_all[rows]).reshape(shape)
        half = 1.0 if compat == "reference" else 0.5
        s_ij = half * ((f_ij[:-1] + f_ij[1:]) * dlam).sum(0)
        s_ji = half * ((f_ji[:-1] + f_ji[1:]) * dlam).sum(0)
        R[(lower, upper)] = 2.0 * np.pi / hc * s_ij / (
            1000.0 if compat == "reference" else 1.0)
        R[(upper, lower)] = 2.0 * np.pi / hc * s_ji

    for level, (a, b) in enumerate(((i1, i2), (i2, i3))):
        sig = sigma_bf(line, lam_all[a:b], level, compat).reshape(shape)
        integrals(slice(a, b), sig, level, 2)
    lam_bb = lam_all[i0:i1].reshape(shape)
    a = damping(g[None], lam_bb, dlamD[None])
    v = (lam_bb - line.lam0) / dlamD[None]
    sig = (hc / (4.0 * np.pi * line.lam0) * line.Bij) * voigt_H(a, v) \
        / (SQRT_PI * dlamD[None])
    integrals(slice(i0, i1), sig, 0, 1)
    return R


def statistical_equilibrium(R, C, nH):
    """The three-level balance: each level's share is the sum of the rate
    products of the spanning trees into it (the 2x2 Cramer solve of
    populations.jl:147-221, with nothing that cancels)."""
    P = {k: R[k] + C[k] for k in R}
    P01, P10, P02 = P[(0, 1)], P[(1, 0)], P[(0, 2)]
    P20, P12, P21 = P[(2, 0)], P[(1, 2)], P[(2, 1)]
    num1 = P10 * P20 + P12 * P20 + P10 * P21
    num2 = P01 * P20 + P01 * P21 + P02 * P21
    num3 = P02 * P10 + P02 * P12 + P01 * P12
    det = num1 + num2 + num3
    return torch.stack([nH * (num1 / det), nH * (num2 / det),
                        nH * (num3 / det)], -1)


def quadrature(rows):
    """(k (n, 3) ordered (z, x, y), weights (n,), up (n,)) from rows of
    (weight, theta_deg, phi_deg): theta > 90 deg sweeps up."""
    rows = np.asarray(rows, dtype=np.float64)
    th, ph = np.deg2rad(rows[:, 1]), np.deg2rad(rows[:, 2])
    k = np.stack([np.cos(th), np.cos(ph) * np.sin(th),
                  np.sin(ph) * np.sin(th)], -1)
    return k, rows[:, 0], rows[:, 1] > 90.0
