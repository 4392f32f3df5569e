"""Small-problem entry point: the port's counterpart of
__graft_entry__.entry().

entry() returns (step, example_args) like the JAX one: step(S,
populations) is one full Lambda-iteration update on the regular grid --
damping -> per-angle Voigt + extinction -> formal solution for every
quadrature direction, batched over wavelengths -> J -> S update ->
radiative rates -> statistical-equilibrium populations.

Both functions run on the CUDA card unless the caller asks for another
device (device="cpu", as the CPU tests do); with no card visible and no
device given they raise.
"""

from __future__ import annotations

import torch

from .atmosphere import synthetic_atmosphere
from .config import Config
from .device import require_cuda
from .engine.lambda_iter import (RegularEngine, _rates_and_populations,
                                 _update_S)
from .physics.atom import lyman_alpha_line


def small_problem(nz=12, nx=8, ny=8, nlam_bb=5, nlam_bf=3,
                  quadrature="ul2n3", device=None):
    """(cfg, atmos, line, engine) of the small test problem on device
    (default: the CUDA card)."""
    if device is None:
        device = require_cuda()
    cfg = Config(nlam_bb=nlam_bb, nlam_bf=nlam_bf, quadrature=quadrature)
    atmos = synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=7)
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64,
                        device=device)
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    return cfg, atmos, line, RegularEngine(atmos, line, cfg, device=device)


def entry(device=None):
    """(step, example_args): one Lambda-iteration update of the small
    problem on `device` (default: the CUDA card); example_args = (B0,
    LTE populations)."""
    cfg, atmos, line, eng = small_problem(device=device)

    def step(S, populations):
        damping_lam = eng.damping_lam(populations)
        J = eng.compute_J(S, populations, damping_lam)
        S_new = _update_S(eng.line, eng.eps, J, eng.B0)
        pops_new = _rates_and_populations(eng.line, J, damping_lam, eng.lte,
                                          eng.C, eng.T, eng.nH, cfg.compat)
        return S_new, pops_new

    return step, (eng.B0, eng.lte)
