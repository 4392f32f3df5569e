"""Voronoi site sampling: rejection sampling and the densities.

Port of voronoirt_tpu/grid/sampling.py (reference src/sample_grids.jl
and src/functions.jl:79-197 `rejection_sampling`).  The numpy half --
`rejection_sampling` and the five numpy densities, the paper's
production `density_invNH_invT` among them -- is copied from the JAX
module (tests/test_torch_host_copies.py holds the copies equal).  The
four physics densities (`density_extinction`, `density_destruction`,
`density_total_extinction`, `density_avg_extinction`), which the JAX
module evaluates with jnp, run on the port's torch physics.

Densities are set-up code: they run in float64 on the CPU and return
numpy arrays shaped like the atmosphere, as the JAX ones do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c_0
from ..physics.atom import (alpha_line, destruction, line_of_sight_velocity,
                            lyman_alpha_line)
from ..physics.broadening import damping, gamma_constant
from ..physics.lte import lte_populations
from ..physics.opacity import alpha_absorption, alpha_scattering
from ..physics.voigt import voigt_profile
from ..quadrature import get_quadrature
from .interpolate import trilinear


def rejection_sampling(n_sites, atmos, quantity, seed=2022, batch=None):
    """Accept-reject sample of site positions with density ~ quantity.

    quantity: (nz, nx, ny) non-negative-ish field (compared against a
    uniform reference scaled to [q_min, q_max], functions.jl:90-117).
    Returns (n_sites, 3) positions ordered (z, x, y).
    """
    rng = np.random.default_rng(seed)
    q = np.asarray(quantity, dtype=np.float64)
    q_min, q_max = q.min(), q.max()
    dq = q_max - q_min

    z0, z1 = atmos.z[0], atmos.z[-1]
    x0, x1 = atmos.x[0], atmos.x[-1]
    y0, y1 = atmos.y[0], atmos.y[-1]

    if batch is None:
        batch = max(4 * n_sites, 1024)
    out = np.empty((n_sites, 3))
    got = 0
    while got < n_sites:
        zq = rng.uniform(z0, z1, batch)
        xq = rng.uniform(x0, x1, batch)
        yq = rng.uniform(y0, y1, batch)
        dens = trilinear(zq, xq, yq, atmos.z, atmos.x, atmos.y, q)
        accept = dens > rng.uniform(0.0, 1.0, batch) * dq + q_min
        sel = np.nonzero(accept)[0][: n_sites - got]
        take = len(sel)
        out[got:got + take, 0] = zq[sel]
        out[got:got + take, 1] = xq[sel]
        out[got:got + take, 2] = yq[sel]
        got += take
    return out


# ----------------------------------------------------- sampling densities

def density_invNH_invT(atmos):
    """log10(N_H)^-2 * T^(-2/5) (sample_grids.jl:223-230; the paper's
    production density)."""
    return (np.log10(atmos.hydrogen_populations) ** -2.0
            * atmos.temperature ** (-2.0 / 5.0))


def density_logNH_invT(atmos):
    """log10(N_H) * T^(-2/5) (sample_grids.jl:198-205)."""
    return np.log10(atmos.hydrogen_populations) * atmos.temperature ** (-0.4)


def density_logNH_invT_rootv(atmos):
    """log10(N_H) T^(-2/5) (v^2)^(1/3) (sample_grids.jl:208-221)."""
    v2 = (atmos.velocity_x ** 2 + atmos.velocity_y ** 2
          + atmos.velocity_z ** 2)
    return (np.log10(atmos.hydrogen_populations)
            * atmos.temperature ** (-0.4) * v2 ** (1.0 / 3.0))


def density_temp_gradient(atmos):
    """|dT/dz| forward differences (sample_grids.jl:97-120)."""
    T, z = atmos.temperature, atmos.z
    g = np.empty_like(T)
    g[:-1] = (T[1:] - T[:-1]) / (z[1:] - z[:-1])[:, None, None]
    g[-1] = (T[-1] - T[-2]) / (z[-1] - z[-2])
    return np.abs(g)


def density_ionised_hydrogen(atmos, lte_pops):
    """log10(n_HII) in LTE (sample_grids.jl:123-134)."""
    return np.log10(lte_pops[..., 2])


# ---------------------------------------------- physics densities (torch)

def _t(a):
    """A float64 CPU tensor of a numpy array (or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def density_extinction(atmos, lam0, lte_pops):
    """log10(alpha_cont(lam0)) (sample_grids.jl:24-49)."""
    lte = _t(lte_pops)
    T, ne = _t(atmos.temperature), _t(atmos.electron_density)
    a = alpha_absorption(float(lam0), T, ne, lte[..., 0] + lte[..., 1],
                         lte[..., 2])
    a = a + alpha_scattering(float(lam0), ne, lte[..., 0])
    return np.log10(a.numpy())


def density_destruction(atmos, line, lte_pops, boost=2.0e9):
    """Photon destruction probability eps (sample_grids.jl:6-22)."""
    eps = destruction(_t(lte_pops), _t(atmos.electron_density),
                      _t(atmos.temperature), line, boost)
    return eps.numpy()


def _line_centre_profile(atmos, line, populations, k):
    """Voigt profile at lam0 along k, damping from the populations'
    neutral hydrogen (sample_grids.jl:51-86, :136-196)."""
    T, ne = _t(atmos.temperature), _t(atmos.electron_density)
    dlamD = _t(line.dlamD)
    g = gamma_constant(line, T, populations[..., 0] + populations[..., 1],
                       ne)
    a = damping(g, line.lam0, dlamD)
    v_los = line_of_sight_velocity(_t(atmos.velocity_zxy()), -np.asarray(k))
    v = line.lam0 * v_los / c_0 / dlamD
    return voigt_profile(a, v, dlamD)


def density_total_extinction(atmos, lte_pops=None, line=None):
    """log10(alpha_line(lam0, vertical LOS) + alpha_cont(lam0))
    (sample_grids.jl:51-86)."""
    T = _t(atmos.temperature)
    if line is None:
        line = lyman_alpha_line(1, 1, T)
    if lte_pops is None:
        lte_pops = lte_populations(line, T, _t(atmos.electron_density),
                                   _t(atmos.hydrogen_populations))
    lte = _t(lte_pops)
    k = np.array([-1.0, 0.0, 0.0])   # straight up
    profile = _line_centre_profile(atmos, line, lte, k)
    a_line = alpha_line(line, profile, lte[..., 1], lte[..., 0])
    a_cont = 10.0 ** density_extinction(atmos, line.lam0, lte)
    return np.log10(a_line.numpy() + a_cont)


def density_avg_extinction(atmos, populations, S_lam, line,
                           quadrature="ul7n12"):
    """Quadrature-weighted line+continuum extinction at line centre
    (sample_grids.jl:136-196 sample_from_avg_ext); needs a previous run's
    populations."""
    T = _t(atmos.temperature)
    lte = lte_populations(line, T, _t(atmos.electron_density),
                          _t(atmos.hydrogen_populations))
    pops = _t(populations)
    a_cont = 10.0 ** density_extinction(atmos, line.lam0, lte)
    quad = get_quadrature(quadrature)
    alpha_int = np.zeros(atmos.shape)
    for i in range(quad.n_angles):
        profile = _line_centre_profile(atmos, line, pops, quad.k[i])
        a_line = alpha_line(line, profile, pops[..., 1], pops[..., 0])
        alpha_int += quad.weights[i] * (a_line.numpy() + a_cont)
    return np.log10(alpha_int)


DENSITIES = {
    "invNH_invT": density_invNH_invT,
    "logNH_invT": density_logNH_invT,
    "logNH_invT_rootv": density_logNH_invT_rootv,
    "temp_gradient": density_temp_gradient,
    "total_extinction": density_total_extinction,
}


def sample_sites(atmos, n_sites, density="invNH_invT", seed=2022):
    """Sample site positions with a named density (host-side)."""
    q = DENSITIES[density](atmos)
    return rejection_sampling(n_sites, atmos, q, seed=seed)
