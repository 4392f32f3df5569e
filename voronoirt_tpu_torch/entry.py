"""Small-problem entry point: the port's counterpart of
__graft_entry__.entry().

entry() returns (step, example_args) like the JAX one: step(S,
populations) is one full Lambda-iteration update on the regular grid --
damping -> per-angle Voigt + extinction -> formal solution for every
quadrature direction, batched over wavelengths -> J -> S update ->
radiative rates -> statistical-equilibrium populations.

dryrun_multichip(n_ranks) is the counterpart of
__graft_entry__.dryrun_multichip: one Lambda iteration of both engines
with the wavelength axis split over n_ranks processes
(parallel/lam.py), each held against the unsharded iteration, then the
Voronoi angle distribution.

All three run on the CUDA card unless the caller asks for another
device (device="cpu", as the CPU tests do); with no card visible and no
device given they raise.

    python -m voronoirt_tpu_torch.entry [dryrun [N]] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from .atmosphere import synthetic_atmosphere
from .config import Config
from .device import require_cuda
from .engine.lambda_iter import (RegularEngine, VoronoiEngine,
                                 _rates_and_populations, _update_S)
from .grid import build_sites, initialise_sites, sample_sites
from .parallel import distribute_angles
from .parallel.lam import gather_lambda, spawn
from .physics.atom import lyman_alpha_line, pad_line
from .quadrature import get_quadrature


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


# ------------------------------------------------------------ dry run


def _padded_line(temperature, device, n_ranks):
    """The small problem's line on `device`, padded to a multiple of
    n_ranks wavelengths (__graft_entry__.py:104-105)."""
    T = torch.as_tensor(temperature, dtype=torch.float64, device=device)
    line = lyman_alpha_line(5, 3, T)
    return pad_line(line, -(-line.n_lambda // n_ranks) * n_ranks)


def _hold(what, S, P, ref):
    """S to rtol 1e-10 and populations to 1e-8 against the unsharded
    result, both finite (the bars of __graft_entry__.dryrun_multichip)."""
    if not (bool(torch.isfinite(S).all()) and bool(torch.isfinite(P).all())):
        raise RuntimeError(f"{what}: S or populations not finite")
    if not torch.allclose(S, ref.S, rtol=1e-10, atol=0.0):
        raise RuntimeError(f"{what}: S diverges from unsharded")
    if not torch.allclose(P, ref.populations, rtol=1e-8, atol=0.0):
        raise RuntimeError(f"{what}: populations diverge from unsharded")


def _dryrun_rank(group, atmos, sites):
    """One rank of dryrun_multichip: one iteration of each engine on its
    lambda block; rank 0 also runs the unsharded iterations and the
    angle distribution, and returns the report lines."""
    n, dev = group.size, group.device
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3", maxiter=1,
                 eps=0.0)
    lines = []
    line = _padded_line(atmos.temperature, dev, n)
    res = RegularEngine(atmos, line, cfg, device=dev, lam_group=group).run()
    S = gather_lambda(res.S, group)
    if group.rank == 0:
        _hold("regular", S, res.populations,
              RegularEngine(atmos, line, cfg, device=dev).run())
        lines.append(f"dryrun_multichip regular OK on {n} ranks (λ={n}, "
                     f"{group.backend} on {dev}, sharded == unsharded)")

    vline = _padded_line(sites.temperature, dev, n)
    plans = VoronoiEngine.build_plans(sites, get_quadrature(cfg.quadrature),
                                      cfg)
    res = VoronoiEngine(sites, vline, cfg, plans=plans, device=dev,
                        lam_group=group).run()
    S = gather_lambda(res.S, group)
    if group.rank == 0:
        ref = VoronoiEngine(sites, vline, cfg, plans=plans, device=dev).run()
        _hold("voronoi", S, res.populations, ref)
        lines.append(f"dryrun_multichip voronoi OK on {n} ranks (λ={n}, "
                     f"{sites.n} sites, sharded == unsharded)")
        # the angle distribution (parallel/angles.py), over slots of
        # rank 0's device
        n_ang = min(n, len(plans))
        eng = distribute_angles(VoronoiEngine(sites, vline, cfg,
                                              plans=plans, device=dev),
                                [dev] * n_ang)
        res = eng.run()
        _hold("voronoi angle distribution", res.S, res.populations, ref)
        lines.append(f"dryrun_multichip voronoi angle-MPMD OK on {n_ang} "
                     f"slots of {dev} ({len(plans)} angles round-robin, "
                     f"MPMD == unsharded)")
    return lines


def dryrun_multichip(n_ranks, device=None, backend=None):
    """One Lambda iteration of BOTH engines with the wavelength axis split
    over n_ranks processes, each held against the unsharded iteration
    (S rtol 1e-10, populations 1e-8), then the Voronoi angle
    distribution against the same; the counterpart of
    __graft_entry__.dryrun_multichip on JAX's tiny shapes (regular:
    nz=10, nx=ny=2 n_ranks, 5 + 2x3 wavelengths padded to a multiple of
    n_ranks, ul2n3, seed 7; Voronoi: 64 n_ranks sites, seed 21).

    device: the ranks' device (default: the CUDA card); backend: 'nccl'
    (one card a rank, the default on cards) or 'gloo' (the CPU, or
    ranks sharing one card).  The sites are built here and sent to the
    ranks.  Prints and returns the three report lines; a rank that fails
    makes it raise.
    """
    device = torch.device(device) if device is not None else require_cuda()
    atmos = synthetic_atmosphere(nz=10, nx=2 * n_ranks, ny=2 * n_ranks,
                                 seed=7)
    pos = sample_sites(atmos, 64 * n_ranks, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = build_sites(pos, bounds, initialise_sites(pos, atmos))
    lines = spawn(_dryrun_rank, n_ranks, args=(atmos, sites), device=device,
                  backend=backend, timeout=900.0,
                  threads=1 if device.type == "cpu" else None)[0]
    for text in lines:
        print(text, flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description="the small entry step, or "
                                 "the lambda-split dry run")
    ap.add_argument("command", nargs="?", choices=("dryrun",))
    ap.add_argument("n_ranks", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.command == "dryrun":
        return dryrun_multichip(args.n_ranks, device=args.device,
                                backend=args.backend)
    step, example = entry(device=args.device)
    out = step(*example)
    print("entry OK:", [tuple(o.shape) for o in out])
    return out


if __name__ == "__main__":
    # the ranks unpickle _dryrun_rank by this module's import name
    from voronoirt_tpu_torch.entry import main as _main
    _main(sys.argv[1:])
