"""Electron-impact collision rates for hydrogen (Johnson 1972).

Port of voronoirt_tpu/physics/collisions.py (Transparency.jl
coll_exc_hydrogen_johnson / coll_ion_hydrogen_johnson, called from
src/rates.jl:507-517).  E1/E2 use the Abramowitz & Stegun 5.1.53/5.1.56
rational approximations.
"""

import numpy as np
import torch

from ..constants import k_B, m_e, a_0, E_inf

_SQRT8_PI = float(np.sqrt(8.0 / np.pi))
_PI_A0_SQ = float(np.pi * a_0**2)


def expint_E1(x):
    """E1(x) for x > 0 (A&S 5.1.53 / 5.1.56)."""
    xs = torch.clamp(x, min=1e-30)
    # small-x series (x <= 1)
    a = (-0.57721566, 0.99999193, -0.24991055,
         0.05519968, -0.00976004, 0.00107857)
    small = -torch.log(xs) + (a[0] + xs * (a[1] + xs * (a[2] + xs * (
        a[3] + xs * (a[4] + xs * a[5])))))
    # large-x rational (x > 1)
    xl = torch.clamp(x, min=1.0)
    num = xl**4 + 8.5733287401 * xl**3 + 18.059016973 * xl**2 \
        + 8.6347608925 * xl + 0.2677737343
    den = xl**4 + 9.5733223454 * xl**3 + 25.6329561486 * xl**2 \
        + 21.0996530827 * xl + 3.9584969228
    large = torch.exp(-torch.clamp(xl, max=690.0)) / xl * num / den
    return torch.where(x <= 1.0, small, large)


def expint_E2(x):
    """E2(x) = exp(-x) - x E1(x)."""
    return torch.exp(-torch.clamp(x, 1e-30, 690.0)) - x * expint_E1(x)


def _g_coeffs(n):
    """Johnson (1972) g0, g1, g2 for level n."""
    if n == 1:
        return 1.1330, -0.4059, 0.07014
    if n == 2:
        return 1.0785, -0.2319, 0.02947
    g0 = 0.9935 + 0.2328 / n - 0.1296 / n**2
    g1 = -(0.6282 - 0.5598 / n + 0.5299 / n**2) / n
    g2 = (0.3887 - 1.181 / n + 1.470 / n**2) / n**2
    return g0, g1, g2


def _rn(n):
    return 0.45 if n == 1 else 1.94 * n ** (-1.57)


def _bn(n):
    if n == 1:
        return -0.603
    return (4.0 - 18.63 / n + 36.24 / n**2 - 28.09 / n**3) / n


def coll_exc_hydrogen_johnson(n, np_, n_e, T):
    """Collisional excitation rate n -> np_ (upward) [s^-1], Johnson
    (1972) eq. (36); n, np_ principal quantum numbers."""
    if not np_ > n:
        raise ValueError(f"excitation needs np_ > n, got {n} -> {np_}")
    g0, g1, g2 = _g_coeffs(n)
    x = 1.0 - (n / np_) ** 2
    rn = _rn(n)
    bn = _bn(n)
    f_nn = (32.0 / (3.0 * np.sqrt(3.0) * np.pi) * n / np_**3 / x**3
            * (g0 + g1 / x + g2 / x**2))
    A = 2.0 * n**2 * f_nn / x
    B = 4.0 * n**4 / (np_**3 * x**2) * (1.0 + 4.0 / (3.0 * x) + bn / x**2)

    E_n = E_inf / n**2                       # ionization energy of level n
    y = x * E_n / (k_B * T)
    z = rn * x + y

    vbar = _SQRT8_PI * torch.sqrt(k_B * T / m_e)
    bracket = (A * ((1.0 / y + 0.5) * expint_E1(y)
                    - (1.0 / z + 0.5) * expint_E1(z))
               + (B - A * np.log(2.0 * n**2 / x))
               * (expint_E2(y) / y - expint_E2(z) / z))
    rate = vbar * 2.0 * n**2 / x * _PI_A0_SQ * y**2 * bracket * n_e
    return torch.clamp(rate, min=0.0)


def coll_ion_hydrogen_johnson(n, n_e, T):
    """Collisional ionization rate from level n [s^-1], Johnson (1972)
    eq. (39)."""
    g0, g1, g2 = _g_coeffs(n)
    rn = _rn(n)
    bn = _bn(n)
    An = 32.0 / (3.0 * np.sqrt(3.0) * np.pi) * n * (g0 / 3.0 + g1 / 4.0 + g2 / 5.0)
    Bn = 2.0 / 3.0 * n**2 * (5.0 + bn)

    E_n = E_inf / n**2
    yn = E_n / (k_B * T)
    zn = rn + yn

    def xi(t):
        E0 = torch.exp(-torch.clamp(t, 1e-30, 690.0)) / t
        return E0 - 2.0 * expint_E1(t) + expint_E2(t)

    vbar = _SQRT8_PI * torch.sqrt(k_B * T / m_e)
    bracket = (An * (expint_E1(yn) / yn - expint_E1(zn) / zn)
               + (Bn - An * np.log(2.0 * n**2)) * (xi(yn) - xi(zn)))
    rate = vbar * 2.0 * n**2 * _PI_A0_SQ * yn**2 * bracket * n_e
    return torch.clamp(rate, min=0.0)
