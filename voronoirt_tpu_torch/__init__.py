"""voronoirt_tpu_torch: the PyTorch + CUDA port of voronoirt_tpu.

Covers the regular-grid Lambda iteration (the main path of
voronoirt_tpu's `__graft_entry__.entry()`): frozen physics set-up,
per-angle Voigt extinction, the short-characteristics formal solution
for every quadrature direction batched over wavelength, J, the S update,
radiative rates and the 2x2 statistical equilibrium; and the Voronoi
Lambda iteration on the same physics.

The package imports torch and never jax, and nothing of the JAX
package: the host layer (config, constants, quadrature, atmosphere, the
Voronoi grid's host half) is the port's own copy, held equal to the
original by tests/test_torch_host_copies.py.  The two Pallas kernels of
the regular sweep are hand-written CUDA kernels for Hopper (csrc/),
built with nvcc at first use (kernels/build.py); on CPU tensors their
plain PyTorch versions run.  Entry points run on the CUDA card unless
the caller names another device.
"""

from .atmosphere import Atmosphere, synthetic_atmosphere
from .config import Config
from .device import require_cuda, torch_dtype
from .quadrature import get_quadrature

__all__ = ["Config", "get_quadrature", "Atmosphere", "synthetic_atmosphere",
           "require_cuda", "torch_dtype"]
