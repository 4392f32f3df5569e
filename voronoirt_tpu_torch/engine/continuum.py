"""Single-wavelength continuum scattering Lambda iteration.

Port of voronoirt_tpu/engine/continuum.py (the working equivalent of the
reference's src/lambda_continuum.jl): a 500 nm scattering iteration
S = (1 - eps) J + eps B with eps = alpha_abs / alpha_tot and convergence
masked to cells with eps > eps_mask, on both grids with the port's
formal solvers.  The sweeps carry a batch of ONE wavelength.

Each function takes an explicit `device`; None means the CUDA card
(require_cuda()).  The convergence mask and its maximum are taken on
the device: one scalar is read back per iteration.  Results are tensors
on the device.  The Voronoi iteration uses the port's unpadded slot
plans (the JAX package's share_plan_shapes has no counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..device import require_cuda
from ..grid.voronoi import build_voronoi_plan
from ..physics.lte import lte_populations
from ..physics.opacity import alpha_absorption, alpha_scattering
from ..physics.planck import B_lambda
from ..quadrature import get_quadrature
from ..solvers.sweep_regular import build_plan, sweep
from ..solvers.sweep_voronoi import sweep_voronoi


def continuum_setup(line, temperature, electron_density, hydrogen_density,
                    lam=500e-9, device=None):
    """alpha_tot, eps, B at one wavelength from ad-hoc LTE.  The fields
    are numpy arrays or tensors; they go to `device` (None: the CUDA
    card) in line.dlamD's dtype."""
    device = torch.device(device) if device is not None else require_cuda()
    T, ne, nH = (torch.as_tensor(a, dtype=line.dlamD.dtype, device=device)
                 for a in (temperature, electron_density, hydrogen_density))
    lte = lte_populations(line, T, ne, nH)
    a_abs = alpha_absorption(lam, T, ne, lte[..., 0] + lte[..., 1],
                             lte[..., 2])
    a_scat = alpha_scattering(lam, ne, lte[..., 0])
    a_tot = a_abs + a_scat
    eps = a_abs / a_tot
    B = B_lambda(lam, T)
    return a_tot, eps, B


def _iterate(cfg, eps, B, eps_mask, compute_J):
    """The shared iteration: S = (1 - eps) J(S) + eps B until the masked
    relative change drops below cfg.eps.  Returns (S, J, history)."""
    mask = eps > eps_mask
    if not bool(mask.any()):
        mask = torch.ones_like(mask)
    S = B
    J = None
    history = []
    for _ in range(cfg.maxiter):
        J = compute_J(S)
        S_new = (1.0 - eps) * J + eps * B
        rel = torch.abs(1.0 - S / S_new)
        # a NaN stays visible in the maximum, as in the host-side mask
        diff = float(torch.where(mask, rel, 0.0).max())
        history.append(diff)
        S = S_new
        if diff < cfg.eps:
            break
    return S, J, history


def lambda_continuum_regular(atmos, line, cfg: Config, lam=500e-9,
                             eps_mask=1e-4, device=None):
    """Iterate S = (1-eps) J + eps B at a single wavelength, regular grid.

    Convergence: max relative S change over cells with eps > eps_mask
    (the reference's destruction-probability mask,
    lambda_continuum.jl:80,133).  Returns (S, J, history), S and J
    tensors (nz, nx, ny) on the device.
    """
    a_tot, eps, B = continuum_setup(
        line, atmos.temperature, atmos.electron_density,
        atmos.hydrogen_populations, lam, device)
    T_bottom = torch.as_tensor(atmos.temperature[0], dtype=B.dtype,
                               device=B.device)
    quad = get_quadrature(cfg.quadrature)
    z = np.asarray(atmos.z)
    plans = [build_plan(quad.k[i], z, atmos.dx, atmos.dy,
                        bool(quad.is_up[i])) for i in range(quad.n_angles)]
    a_t = a_tot[:, None].contiguous()     # (nz, 1, nx, ny) batch of one
    I0_up = B_lambda(lam, T_bottom)[None]
    I0_down = torch.zeros_like(I0_up)

    def compute_J(S):
        J = torch.zeros_like(S)
        S_t = S[:, None].contiguous()
        for i, plan in enumerate(plans):
            I = sweep(plan, S_t, a_t, I0_up if plan.up else I0_down,
                      n_sweeps=cfg.n_sweeps)
            J.add_(float(quad.weights[i]) * I[:, 0])
        return J

    return _iterate(cfg, eps, B, eps_mask, compute_J)


def lambda_continuum_voronoi(sites, line, cfg: Config, lam=500e-9,
                             eps_mask=1e-4, device=None):
    """Single-wavelength scattering iteration on the irregular grid.
    Returns (S, J, history), S and J tensors (n,) on the device."""
    a_tot, eps, B = continuum_setup(
        line, sites.temperature, sites.electron_density,
        sites.hydrogen_populations, lam, device)
    quad = get_quadrature(cfg.quadrature)
    plans = [build_voronoi_plan(sites, quad.k[i], bool(quad.is_up[i]),
                                p=cfg.upwind_exponent, compat=cfg.compat)
             for i in range(quad.n_angles)]
    T = torch.as_tensor(sites.temperature, dtype=B.dtype, device=B.device)
    I0 = []
    for plan in plans:
        bc = torch.as_tensor(np.asarray(plan.bc_sites, dtype=np.int64),
                             device=B.device)
        I0.append(B_lambda(lam, T[bc]) if plan.up
                  else torch.zeros(len(bc), dtype=B.dtype, device=B.device))

    def compute_J(S):
        J = torch.zeros_like(S)
        for i, plan in enumerate(plans):
            I = sweep_voronoi(plan, S, a_tot, I0[i], n_sweeps=cfg.n_sweeps)
            J.add_(float(quad.weights[i]) * I)
        return J

    return _iterate(cfg, eps, B, eps_mask, compute_J)
