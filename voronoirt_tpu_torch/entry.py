"""Small-problem entry point: the port's counterpart of
__graft_entry__.entry().

entry() returns (step, example_args) like the JAX one: step(S,
populations) is one full Lambda-iteration update on the regular grid --
damping -> per-angle Voigt + extinction -> formal solution for every
quadrature direction, batched over wavelengths -> J -> S update ->
radiative rates -> statistical-equilibrium populations.

dryrun_multichip(n_ranks) is the counterpart of
__graft_entry__.dryrun_multichip: one Lambda iteration of both engines
on a mesh of n_ranks processes (parallel/mesh.py) factored as JAX
factors its devices -- lam = 2 (else 3, else 1) wavelength blocks times
y (regular grid) or site (Voronoi grid) shards -- each held against the
unsharded iteration, then the Voronoi angle distribution.

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
from .parallel.mesh import gather_space, make_mesh
from .physics.atom import lyman_alpha_line, pad_line
from .quadrature import get_quadrature
from .solvers import sweep_voronoi, voronoi_level


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
        # the rates from the per-cell gamma: one R1 launch on the card
        pops_new = _rates_and_populations(
            eng.line, J, eng._gamma_cell(populations), eng.lte, eng.C,
            eng.T, eng.nH, cfg.compat)
        return S_new, pops_new

    return step, (eng.B0, eng.lte)


# ------------------------------------------------------------ dry run


def _lam_shards(n_ranks):
    """The "lam" extent of the dry run's mesh: 2, else 3, else 1
    (__graft_entry__.py:92-98)."""
    return next((f for f in (2, 3) if n_ranks % f == 0), 1)


def _padded_line(temperature, device, n_lam):
    """The small problem's line on `device`, padded to a multiple of
    n_lam wavelengths (__graft_entry__.py:104-105)."""
    T = torch.as_tensor(temperature, dtype=torch.float64, device=device)
    line = lyman_alpha_line(5, 3, T)
    return pad_line(line, -(-line.n_lambda // n_lam) * n_lam)


def _moved(mesh, S):
    """Rank 0's halo and gather traffic of its iteration, beside the
    bytes of its own block of S (the field the JAX package's finding
    compares site-sharding traffic with)."""
    t = mesh.tally
    field = S.numel() * S.element_size()
    return ", ".join(
        f"{k} {t[k]['calls']} calls {t[k]['bytes']} B "
        f"({t[k]['bytes'] / field:.1f}x the rank's S)" for k in t
        if t[k]["calls"]) or "no spatial split"


def _gathered(res, mesh, space_dims, pop_dims):
    """A split run's S and populations, whole, on every rank."""
    S = res.S if mesh.lam is None else gather_lambda(res.S, mesh.lam)
    return (gather_space(S, mesh, space_dims),
            gather_space(res.populations, mesh, pop_dims))


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
    share of a (lam, y) and a (lam, site) mesh; rank 0 also runs the
    unsharded iterations and the angle distribution, and returns the
    report lines."""
    n, dev = group.size, group.device
    n_lam = _lam_shards(n)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3", maxiter=1,
                 eps=0.0)
    lines = []
    line = _padded_line(atmos.temperature, dev, n_lam)
    mesh = make_mesh((n_lam, n // n_lam), ("lam", "y"), world=group)
    res = RegularEngine(atmos, line, cfg, device=dev, mesh=mesh).run()
    moved = _moved(mesh, res.S)
    S, P = _gathered(res, mesh, (-2, -1), (1, 2))
    if group.rank == 0:
        _hold("regular", S, P,
              RegularEngine(atmos, line, cfg, device=dev).run())
        lines.append(f"dryrun_multichip regular OK on {n} ranks (mesh "
                     f"lam={n_lam} x y={n // n_lam}, {group.backend} on "
                     f"{dev}, sharded == unsharded; {moved})")

    vline = _padded_line(sites.temperature, dev, n_lam)
    plans = VoronoiEngine.build_plans(sites, get_quadrature(cfg.quadrature),
                                      cfg)
    vmesh = make_mesh((n_lam, n // n_lam), ("lam", "site"), world=group)
    v1 = (voronoi_level.LAUNCHES, sweep_voronoi.STAGE_CALLS,
          sweep_voronoi.LEVEL_STEPS)
    res = VoronoiEngine(sites, vline, cfg, plans=plans, device=dev,
                        mesh=vmesh).run()
    v1, calls, steps = (b - a for a, b in zip(v1, (
        voronoi_level.LAUNCHES, sweep_voronoi.STAGE_CALLS,
        sweep_voronoi.LEVEL_STEPS)))
    moved = _moved(vmesh, res.S)
    S, P = _gathered(res, vmesh, (-1,), (0,))
    if group.rank == 0:
        ref = VoronoiEngine(sites, vline, cfg, plans=plans, device=dev).run()
        _hold("voronoi", S, P, ref)
        lines.append(f"dryrun_multichip voronoi OK on {n} ranks (mesh "
                     f"lam={n_lam} x site={n // n_lam}, {sites.n} sites, "
                     f"sharded == unsharded; {moved}; {v1} level-kernel "
                     f"launches, {calls} stage calls, {steps} level steps "
                     f"on rank 0)")
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
    """One Lambda iteration of BOTH engines on a mesh of n_ranks
    processes, lam = 2 (else 3, else 1) wavelength blocks times y shards
    of the regular grid or site shards of the Voronoi grid, each held
    against the unsharded iteration (S rtol 1e-10, populations 1e-8),
    then the Voronoi angle distribution against the same; the
    counterpart of __graft_entry__.dryrun_multichip on JAX's tiny shapes
    (regular: nz=10, nx=ny=2 y, 5 + 2x3 wavelengths padded to a multiple
    of lam, ul2n3, seed 7; Voronoi: 64 n_ranks sites, seed 21).

    device: the ranks' device (default: the CUDA card); backend: 'nccl'
    (one card a rank, the default on cards) or 'gloo' (the CPU, or
    ranks sharing one card).  The sites are built here and sent to the
    ranks.  Prints and returns the three report lines; a rank that fails
    makes it raise.
    """
    device = torch.device(device) if device is not None else require_cuda()
    n_y = n_ranks // _lam_shards(n_ranks)
    atmos = synthetic_atmosphere(nz=10, nx=2 * n_y, ny=2 * n_y, seed=7)
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
                                 "the dry run on a mesh of processes")
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
