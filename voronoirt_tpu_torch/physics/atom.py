"""Hydrogenic two-level-plus-continuum atom and wavelength sampling.

Port of voronoirt_tpu/physics/atom.py (reference src/line.jl).  The
wavelength builders and Einstein coefficients are numpy host code,
carried over verbatim (the JAX module imports jax at its top, so the
port cannot import them) and held equal to the originals by the tests.
The per-cell Doppler width dlamD is a tensor on the device of the
temperature the line is bound to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (h, c_0, k_B, e, eps_0, m_e, hc, mass_H, IUNIT_SI)
from ..device import require_cuda
from .planck import B_lambda
from .voigt import voigt_profile


def wavenumber_to_energy(chi_cm):
    """cm^-1 -> J (Transparency.jl wavenumber_to_energy)."""
    return hc * chi_cm * 100.0


def transition_lambda(chi1, chi2):
    """Wavelength [m] of the chi1->chi2 energy gap (src/line.jl:354-356)."""
    return hc / (chi2 - chi1)


def calc_Aji(lam0, g_ratio, f_value):
    """Einstein A from the oscillator strength [s^-1]
    (Transparency.jl calc_Aji)."""
    return (2.0 * np.pi * e**2 / (eps_0 * m_e * c_0 * lam0**2)
            * g_ratio * f_value)


def calc_Bji(lam0, Aji):
    """Einstein B (stimulated emission, per J_lambda in SI W m^-3)."""
    return Aji * lam0**5 / (2.0 * h * c_0**2)


def sample_lambda_line(nlam, lam0, qwing=600.0, qcore=15.0):
    """RH-style logarithmic bb wavelength grid [m] (src/line.jl:259-305):
    forced odd count, vmicro_char = 2.5 km/s."""
    if nlam > 0 and nlam % 2 == 0:
        nlam += 1
    if 1 < nlam < 5:
        nlam = 5
    lam = np.empty(nlam, dtype=np.float64)
    if nlam == 1:
        lam[0] = lam0
        return lam
    vmicro_char = 2.5e3  # m/s
    n = nlam / 2.0
    beta = qwing / (2.0 * qcore)
    y = beta + np.sqrt(beta * beta + (beta - 1.0) * n + 2.0 - 3.0 * beta)
    b = 2.0 * np.log(y) / (n - 1.0)
    a = qwing / (n - 2.0 + y * y)
    center = nlam // 2
    lam[center] = lam0
    q_to_lam = lam0 * vmicro_char / c_0
    for w in range(1, nlam // 2 + 1):
        dlam = a * (w + (np.exp(b * w) - 1.0)) * q_to_lam
        lam[center - w] = lam0 - dlam
        lam[center + w] = lam0 + dlam
    return lam


def sample_lambda_boundfree(nlam, lam_min, chi_l, chi_inf):
    """Linearly sampled bf wavelength grid [m] (src/line.jl:316-345)."""
    lam_max = transition_lambda(chi_l, chi_inf)
    if nlam == 1:
        return np.array([lam_max])
    return np.linspace(lam_min, lam_max, nlam)


@dataclasses.dataclass(frozen=True, eq=False)
class HydrogenicLine:
    """Two-level-plus-continuum hydrogenic line (src/line.jl:14-72).

    Energies in J, wavelengths in m; Bij/Bji per SI J_lambda.  lam is
    the host (numpy) wavelength grid; dlamD the per-cell Doppler width
    tensor.
    """
    Aji: float
    Bji: float
    Bij: float
    lam0: float
    lam: np.ndarray          # (nlam,) wavelengths [m]
    lam_idx: tuple           # (0, n_bb, n_bb+n_bf, n_bb+2 n_bf)
    chi_i: float
    chi_j: float
    chi_inf: float
    g_i: int
    g_j: int
    f_value: float
    atom_weight: float
    Z: int
    dlamD: torch.Tensor      # Doppler width per cell [m]

    @property
    def n_lambda(self):
        return len(self.lam)

    @property
    def Bji_iunit(self):
        """Bji per intensity in IUNIT (kW m^-2 nm^-1)."""
        return self.Bji * IUNIT_SI

    def lam_tensor(self):
        """The wavelength grid on dlamD's device and dtype."""
        return torch.as_tensor(self.lam, dtype=self.dlamD.dtype,
                               device=self.dlamD.device)


def doppler_width(lam0, atom_weight, temperature):
    """Doppler width dlamD = lam0/c sqrt(2kT/m) [m] (Transparency.jl)."""
    return lam0 / c_0 * torch.sqrt(2.0 * k_B * temperature / atom_weight)


def lyman_alpha_line(nlam_bb, nlam_bf, temperature):
    """H Ly-alpha test atom (src/line.jl:232-247) bound to a temperature
    tensor (for the Doppler-width field); a temperature that is not a
    tensor goes to the CUDA card."""
    chi_l = wavenumber_to_energy(0.0)
    chi_u = wavenumber_to_energy(82258.211)
    chi_inf = wavenumber_to_energy(109677.617)
    return make_line(chi_u, chi_l, chi_inf, nlam_bb, nlam_bf,
                     g_u=8, g_l=2, f_value=4.162e-1,
                     atom_weight=mass_H, Z=1, temperature=temperature)


def make_line(chi_u, chi_l, chi_inf, nlam_bb, nlam_bf, g_u, g_l, f_value,
              atom_weight, Z, temperature):
    """Build a HydrogenicLine (ctor logic of src/line.jl:31-71)."""
    if not chi_inf > chi_u > chi_l:
        raise ValueError("need chi_inf > chi_u > chi_l")
    if not (g_u > 0 and g_l > 0 and f_value > 0):
        raise ValueError("statistical weights and f_value must be > 0")

    lam0 = transition_lambda(chi_l, chi_u)
    lam_bb = sample_lambda_line(nlam_bb, lam0)
    n_bb = len(lam_bb)
    # bf grids "from Ida" (src/line.jl:52-58): both levels use chi_l's
    # edge for the minimum-wavelength scaling
    lam1_min = transition_lambda(chi_l, chi_inf) * (1.0 / 2.0) ** 2 + 0.001e-9
    lam2_min = transition_lambda(chi_l, chi_inf) * (2.0 / 2.0) ** 2 + 0.001e-9
    lam_bf_l = sample_lambda_boundfree(nlam_bf, lam1_min, chi_l, chi_inf)
    lam_bf_u = sample_lambda_boundfree(nlam_bf, lam2_min, chi_u, chi_inf)
    lam = np.concatenate([lam_bb, lam_bf_l, lam_bf_u])
    lam_idx = (0, n_bb, n_bb + nlam_bf, n_bb + 2 * nlam_bf)

    Aul = calc_Aji(lam0, g_l / g_u, f_value)
    Bul = calc_Bji(lam0, Aul)
    Blu = g_u / g_l * Bul
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.as_tensor(temperature, device=require_cuda())
    dlamD = doppler_width(lam0, atom_weight, temperature)

    return HydrogenicLine(
        Aji=float(Aul), Bji=float(Bul), Bij=float(Blu), lam0=float(lam0),
        lam=lam, lam_idx=lam_idx, chi_i=float(chi_l), chi_j=float(chi_u),
        chi_inf=float(chi_inf), g_i=g_l, g_j=g_u, f_value=float(f_value),
        atom_weight=float(atom_weight), Z=Z, dlamD=dlamD)


def pad_line(line, n_lambda):
    """Pad the wavelength grid to n_lambda by duplicating the last point
    (JAX: physics/atom.py:180-194).

    Helper of the lambda split (parallel/lam.py): the wavelength count
    must divide the number of ranks.  The padded wavelengths ride through
    profiles and sweeps as ordinary batch entries and lie past
    lam_idx[-1], so the rate integrals' windows never read them.
    """
    extra = n_lambda - len(line.lam)
    if extra < 0:
        raise ValueError("cannot shrink the wavelength grid")
    if extra == 0:
        return line
    lam = np.concatenate([line.lam, np.repeat(line.lam[-1:], extra)])
    return dataclasses.replace(line, lam=lam)


# ------------------------------------------------------- per-cell fields

def line_of_sight_velocity(velocity_zxy, k):
    """v_los = v . k for field components stacked last (..., 3) [m/s];
    k ordered (k_z, k_x, k_y) (src/line.jl:175-208)."""
    k = [float(c) for c in k]
    return (velocity_zxy[..., 0] * k[0] + velocity_zxy[..., 1] * k[1]
            + velocity_zxy[..., 2] * k[2])


def compute_profile(line, lam, damping_lam, v_los):
    """Voigt profile [1/m] for wavelengths lam (nlam,) over a cell field.

    v = (lam - lam0 + lam0 v_los / c) / dlamD, with the -k line-of-sight
    velocity already folded into v_los (src/line.jl:85).  Shapes: lam
    (nlam,), damping_lam (nlam, ...), v_los (...); returns (nlam, ...).
    """
    lam = torch.as_tensor(lam, dtype=v_los.dtype, device=v_los.device)
    lam_b = lam.reshape((-1,) + (1,) * v_los.dim())
    v = (lam_b - line.lam0 + line.lam0 * v_los[None] / c_0) / line.dlamD[None]
    return voigt_profile(damping_lam, v, line.dlamD[None])


def alpha_line(line, profile, n_j, n_i):
    """Line extinction [m^-1] (src/line.jl:219-225):
    h c/(4 pi lam0) * phi * (n_i Bij - n_j Bji)."""
    const = hc / (4.0 * np.pi * line.lam0)
    return const * profile * (n_i * line.Bij - n_j * line.Bji)


def destruction(lte_pops, electron_density, temperature, line, boost=2.0e9):
    """Photon destruction probability eps_lam0 (Rutten 3.98;
    src/line.jl:367-376), with the collisional boost folded in."""
    from .collisions import coll_exc_hydrogen_johnson
    A21 = line.Aji
    B21_iunit = line.Bji_iunit
    C12 = coll_exc_hydrogen_johnson(1, 2, electron_density, temperature)
    # downward rate by LTE detailed balance (rates.jl Cij i>j branch)
    C21 = C12 * lte_pops[..., 0] / lte_pops[..., 1] * boost
    B_lam0 = B_lambda(line.lam0, temperature)
    return C21 / (C21 + A21 + B21_iunit * B_lam0)


def source_line(line, populations):
    """Line source function from level populations (src/line.jl:383-395).

    Returns S in IUNIT; populations[..., 0] = n_l, [..., 1] = n_u.
    """
    gl, gu = 2.0, 8.0
    nl = populations[..., 0]
    nu = populations[..., 1]
    ratio = gu * nl / (gl * nu)
    return 2.0 * h * c_0**2 / line.lam0**5 / (ratio - 1.0) / IUNIT_SI
