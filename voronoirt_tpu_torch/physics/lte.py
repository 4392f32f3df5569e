"""LTE (Saha-Boltzmann) populations for the 3-level H model atom.

Port of voronoirt_tpu/physics/lte.py (reference src/populations.jl:
77-138).  Level axis LAST: [n1, n2, n_HII].
"""

import numpy as np
import torch

from ..constants import h, k_B, m_e


def lte_populations(line, temperature, electron_density, hydrogen_density):
    """Saha-Boltzmann populations, shape = temperature.shape + (3,)."""
    chi = (line.chi_i, line.chi_j, line.chi_inf)
    g = (line.g_i, line.g_j, 1.0)

    T = temperature
    saha_const = (k_B / h) * (2.0 * np.pi * m_e) / h
    saha_factor = 2.0 * (saha_const * T) ** 1.5 / electron_density

    n_rel_1 = torch.ones_like(T)
    n_rel_2 = g[1] / g[0] * torch.exp(-torch.clamp(
        (chi[1] - chi[0]) / (k_B * T), max=690.0))
    n_rel_3 = g[2] / g[0] * torch.exp(-torch.clamp(
        (chi[2] - chi[0]) / (k_B * T), max=690.0)) * saha_factor

    total = n_rel_1 + n_rel_2 + n_rel_3
    n_rel = torch.stack([n_rel_1, n_rel_2, n_rel_3], dim=-1) / total[..., None]
    return n_rel * hydrogen_density[..., None]
