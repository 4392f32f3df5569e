"""voronoirt_tpu_torch: the PyTorch + CUDA port of voronoirt_tpu.

Covers the regular-grid Lambda iteration (the main path of
voronoirt_tpu's `__graft_entry__.entry()`): frozen physics set-up,
per-angle Voigt extinction, the short-characteristics formal solution
for every quadrature direction batched over wavelength, J, the S update,
radiative rates and the 2x2 statistical equilibrium.

The package imports torch and never jax.  From the JAX package it takes
only the jax-free host layer (config, constants, quadrature, atmosphere),
re-exported here.  The two Pallas kernels of the regular sweep are
hand-written CUDA kernels for Hopper (csrc/), built with nvcc at first
use (kernels/build.py); on CPU tensors their plain PyTorch versions run.
"""

from voronoirt_tpu.config import Config
from voronoirt_tpu.quadrature import get_quadrature
from voronoirt_tpu.atmosphere import Atmosphere, synthetic_atmosphere

from .device import require_cuda, torch_dtype

__all__ = ["Config", "get_quadrature", "Atmosphere", "synthetic_atmosphere",
           "require_cuda", "torch_dtype"]
