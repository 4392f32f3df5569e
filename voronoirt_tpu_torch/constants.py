"""Physical constants (CODATA 2018, SI) and unit conventions.

The reference (meudnaes/VoronoiRT) carries units through Unitful.jl with
PhysicalConstants.CODATA2018 (src/VoronoiRT.jl:19-29).  This framework is
units-free: every array is in the SI unit documented here, checked by tests
instead of by a type system.

Unit conventions
----------------
length            m
temperature       K
number density    m^-3
velocity          m s^-1
extinction        m^-1
wavelength        m  (converted to nm only at the I/O boundary)
rates             s^-1
intensity / source function / Planck B_lambda:
                  **kW m^-2 nm^-1** == 1e12 W m^-3  ("IUNIT")

The intensity unit follows the reference's output convention
(src/io.jl:61,67) and keeps radiative-transfer fields in a float32-friendly
range (~1e-10..1e2 for solar atmospheres).

The port's own copy of voronoirt_tpu/constants.py, which imports no jax:
the port imports nothing of the JAX package.  tests/test_torch_host_copies.py
holds the two equal.
"""

import numpy as np

# --- CODATA 2018 ---
h = 6.62607015e-34        # Planck constant [J s] (exact)
c_0 = 2.99792458e8        # speed of light [m s^-1] (exact)
k_B = 1.380649e-23        # Boltzmann constant [J K^-1] (exact)
e = 1.602176634e-19       # elementary charge [C] (exact)
m_e = 9.1093837015e-31    # electron mass [kg]
m_u = 1.66053906660e-27   # atomic mass unit [kg]
eps_0 = 8.8541878128e-12  # vacuum permittivity [F m^-1]
a_0 = 5.29177210903e-11   # Bohr radius [m]
R_inf = 10973731.568160   # Rydberg constant [m^-1]
sigma_T = 6.6524587321e-29  # Thomson cross-section [m^2]

# --- derived (mirrors reference src/atmosphere.jl:1-8) ---
hc = h * c_0                          # [J m]
E_inf = R_inf * c_0 * h               # Rydberg energy [J]
Ry = E_inf
alpha_p = 4.5 * 4 * np.pi * eps_0 * a_0**3   # H polarisability [F m^2]
inv_4pi_eps0 = 1.0 / (4 * np.pi * eps_0)
mass_H = 1.008 * m_u                  # [kg]
mass_He = 4.003 * m_u                 # [kg]
abund_He = 10**10.99 / 10**12         # He abundance relative to H (RH)

# --- intensity unit scale ---
# IUNIT converts SI spectral radiance per wavelength [W m^-3] into the
# framework intensity unit kW m^-2 nm^-1:  I[IUNIT] = I[W m^-3] / IUNIT_SI.
IUNIT_SI = 1.0e12   # 1 kW m^-2 nm^-1 = 1e12 W m^-3
