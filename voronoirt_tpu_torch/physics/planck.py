"""Planck functions.

Port of voronoirt_tpu/physics/planck.py (reference src/radiation.jl:
7-19).  Intensity unit: kW m^-2 nm^-1 (constants.IUNIT_SI).  The
float32-safe groupings of the JAX package are kept, so float32 runs
stay finite at the 22.8 nm bound-free wavelengths.
"""

import numpy as np
import torch

from ..constants import h, c_0, k_B, IUNIT_SI

from . import tensors

_HC_OVER_K = float(h * c_0 / k_B)                     # ~1.44e-2 m K
_LOG_2HC2_IUNIT = float(np.log(2.0 * h * c_0**2 / IUNIT_SI))


def B_lambda(lam, T):
    """Planck spectral radiance per wavelength [kW m^-2 nm^-1].

    lam [m] and T [K] broadcast against each other; either may be a
    Python number.
    """
    lam, T = tensors(lam, T)
    x = _HC_OVER_K / (lam * T)
    x = torch.clamp(x, min=1e-9)
    prefac = torch.exp(_LOG_2HC2_IUNIT - 5.0 * torch.log(lam))
    return prefac / torch.expm1(x)


def B_nu(nu, T):
    """Planck spectral radiance per frequency [W m^-2 Hz^-1 sr^-1]."""
    nu, T = tensors(nu, T)
    x = (h / k_B) * nu / T
    x = torch.clamp(x, min=1e-9)
    prefac = torch.exp(float(np.log(2.0 * h / c_0**2)) + 3.0 * torch.log(nu))
    return prefac / torch.expm1(x)
