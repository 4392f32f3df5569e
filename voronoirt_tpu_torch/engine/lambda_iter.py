"""NLTE Lambda-iteration engines, regular and Voronoi grid.

Port of voronoirt_tpu/engine/lambda_iter.py (reference
src/lambda_iteration.jl: J_lambda_regular :1-58, J_lambda_voronoi
:60-113, Lambda_regular :116-205, Lambda_voronoi :207-297, criterion
:299-349).

Iteration scheme (identical to the reference): LTE populations, the
continuum extinction at line centre, the destruction probability
eps(lam0) and the collisional rates C are computed once and frozen.
Each iteration: damping(gamma(populations)) -> per-angle Voigt profiles
with the -k line-of-sight velocity -> alpha_tot -> formal solution for
every (angle, wavelength) -> J -> S = (1 - eps) J + eps B -> radiative
rates R(J) -> statistical equilibrium.

Wavelengths ride the sweep's batch axis in chunks of cfg.lambda_chunk;
mirror-quadrant angles ride it too, one batched sweep per plan group.
PyTorch runs eagerly, so the JAX package's dispatch backpressure and
buffer-donation tricks have no counterpart here: where JAX donated a
buffer, this module updates in place (the J accumulation and the S chunk
write of the streamed update) and says so at each site.  The angle-
distributed (MPMD) path and the site-slabbed rates are not ported.
RegularEngine and VoronoiEngine share the frozen set-up, the per-cell
fields and load_state through one base class, and run() through one
outer loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Config
from ..device import torch_dtype
from ..grid.voronoi import build_voronoi_plan
from ..physics.atom import (alpha_line, compute_profile, destruction,
                            line_of_sight_velocity)
from ..physics.broadening import damping, gamma_constant
from ..physics.lte import lte_populations
from ..physics.opacity import (alpha_absorption, alpha_scattering,
                               warn_charge_inconsistency)
from ..physics.planck import B_lambda
from ..physics.rates import calculate_C, calculate_R, calculate_R_chunk
from ..physics.stateq import get_revised_populations
from ..quadrature import get_quadrature
from ..solvers.sweep_regular import (build_plan, group_plans, sweep,
                                     sweep_group_J)
from ..solvers.sweep_voronoi import device_plan, sweep_voronoi_t

_C_KEYS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))


@dataclasses.dataclass
class NLTEResult:
    """Outcome of a Lambda iteration; fields are tensors on the engine's
    device (J is None for the streamed loop)."""
    J: torch.Tensor
    S: torch.Tensor
    alpha_cont: torch.Tensor
    populations: torch.Tensor
    convergence: list
    iterations: int
    converged: bool
    timings: list


# ------------------------------------------------------------- setup


def frozen_setup(line, temperature, electron_density, hydrogen_density,
                 cfg: Config):
    """LTE pops, alpha_cont(lam0), eps(lam0), C, B_0 -- all frozen
    (lambda_iteration.jl:124-154)."""
    warn_charge_inconsistency(temperature, electron_density,
                              hydrogen_density)
    lte = lte_populations(line, temperature, electron_density,
                          hydrogen_density)
    a_cont = alpha_absorption(line.lam0, temperature, electron_density,
                              lte[..., 0] + lte[..., 1], lte[..., 2])
    a_cont = a_cont + alpha_scattering(line.lam0, electron_density,
                                       lte[..., 0])
    eps = destruction(lte, electron_density, temperature, line,
                      boost=cfg.boost)
    C = calculate_C(electron_density, temperature, lte, boost=cfg.boost)
    lam = line.lam_tensor()
    B0 = B_lambda(lam.reshape((-1,) + (1,) * temperature.dim()),
                  temperature[None])
    return lte, a_cont, eps, C, B0


def _lambda_chunks(n_lambda, chunk):
    """Slices covering the lambda axis in blocks of `chunk`."""
    if not chunk or chunk >= n_lambda:
        return [slice(0, n_lambda)]
    return [slice(i, min(i + chunk, n_lambda))
            for i in range(0, n_lambda, chunk)]


def _update_S(line, eps, J, B0):
    return (1.0 - eps)[None] * J + eps[None] * B0


def _s_update_stream(line, S, Jc, eps, T, lam_c, start):
    """Streamed S update of one lambda chunk: S_new = (1-eps) J + eps B
    with the Planck chunk recomputed (no resident B0 cube), the
    criterion's partial max, and the write of S_new over the S_old chunk
    IN PLACE -- the chunk's sweep has consumed S_old by now (the JAX
    package donates S instead).  Returns (S, partial_max) with the max a
    0-d tensor."""
    S_old_c = S[start:start + Jc.shape[0]]
    B0_c = B_lambda(lam_c.reshape((-1,) + (1,) * T.dim()), T[None])
    S_new_c = ((1.0 - eps)[None] * Jc + eps[None] * B0_c).to(S.dtype)
    denom = torch.where(S_new_c != 0.0, S_new_c, 1.0)
    m = torch.max(torch.abs(S_new_c - S_old_c) / torch.abs(denom))
    S_old_c.copy_(S_new_c)
    return S, m


def _rates_accum(line, acc, carry, Jc, r0, g_cell, lte, T, compat):
    """Accumulate one lambda chunk's radiative-rate contributions; carry
    is the previous chunk's last J row (None for the first chunk)."""
    J_blk = Jc if carry is None else torch.cat([carry, Jc], 0)
    return calculate_R_chunk(line, acc, J_blk, r0, g_cell, lte, T,
                             compat=compat)


def _rates_and_populations(line, J, damping_lam, lte, C, temperature,
                           hydrogen_density, compat):
    R = calculate_R(line, J, damping_lam, lte, temperature, compat=compat)
    return get_revised_populations(R, C, hydrogen_density)


def _criterion(S_new, S_old):
    """max over lam of max |1 - S_old/S_new| (lambda_iteration.jl:
    299-349); cells where S_new is exactly 0 compare by absolute
    difference."""
    denom = torch.where(S_new != 0.0, S_new, 1.0)
    return float(torch.max(torch.abs(S_new - S_old) / torch.abs(denom)))


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# -------------------------------------------------------------- engines


class _Engine:
    """What both engines share: the working dtype and device, the line
    bound to them, the quadrature, the frozen set-up on per-cell (or
    per-site) fields, the damping and the state loaded to start from.

    device: where every field lives (default: the device of
    line.dlamD).  cfg.dtype is the working type of physics and
    transport alike; a different cfg.transport_dtype is refused (float32
    transport is not accurate yet, ROADMAP C3).
    """

    def __init__(self, line, cfg: Config, quadrature, device):
        self.cfg = cfg
        self.device = torch.device(device if device is not None
                                   else line.dlamD.device)
        self.dtype = torch_dtype(cfg.dtype)
        if cfg.sweep_dtype != cfg.dtype:
            raise NotImplementedError(
                f"transport_dtype={cfg.transport_dtype!r} differs from "
                f"dtype={cfg.dtype!r}: only one working type is ported")
        self.line = dataclasses.replace(
            line, dlamD=line.dlamD.to(self.device, self.dtype))
        self.quad = get_quadrature(quadrature or cfg.quadrature)

    def _frozen_setup(self, fields):
        """The per-cell fields of `fields` (an Atmosphere or
        VoronoiSites) on the device, and the frozen set-up on them."""
        self.T = self._field(fields.temperature)
        self.ne = self._field(fields.electron_density)
        self.nH = self._field(fields.hydrogen_populations)
        self.v = self._field(fields.velocity_zxy())
        (self.lte, self.a_cont, self.eps, self.C,
         self.B0) = frozen_setup(self.line, self.T, self.ne, self.nH,
                                 self.cfg)
        self.S_start = None
        self.populations_start = None

    def _field(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def load_state(self, arrays):
        """Replace the frozen fields with given numpy arrays.

        Keys: 'lte', 'a_cont', 'eps', 'B0' and 'C_01', 'C_10', 'C_02',
        'C_20', 'C_12', 'C_21' (any subset), plus optionally 'S' and
        'populations', which become the starting state of run().  The
        counterpart of tests/test_nlte_parity.py::_inject_frozen: it
        lets the port start from the JAX engine's state.
        """
        known = {"lte", "a_cont", "eps", "B0", "S", "populations"} | {
            f"C_{i}{j}" for i, j in _C_KEYS}
        unknown = set(arrays) - known
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        for name in ("lte", "a_cont", "eps", "B0"):
            if name in arrays:
                setattr(self, name, self._field(arrays[name]))
        for i, j in _C_KEYS:
            if f"C_{i}{j}" in arrays:
                self.C[(i, j)] = self._field(arrays[f"C_{i}{j}"])
        if "S" in arrays:
            self.S_start = self._field(arrays["S"])
        if "populations" in arrays:
            self.populations_start = self._field(arrays["populations"])

    def _gamma_cell(self, populations):
        """Per-cell damping rate gamma (lambda-independent)."""
        return gamma_constant(self.line, self.T,
                              populations[..., 0] + populations[..., 1],
                              self.ne, self.cfg.gamma_natural)

    def damping_lam(self, populations):
        """The full (nlam, ...) damping cube."""
        lam = self.line.lam_tensor().reshape((-1,) + (1,) * self.T.dim())
        return damping(self._gamma_cell(populations)[None], lam,
                       self.line.dlamD[None])


# --------------------------------------------------------- regular grid


class RegularEngine(_Engine):
    """Lambda iteration on the regular grid.

    Field layout: (nlam, nz, nx, ny); sweeps run on (nz, nlam, nx, ny).
    Besides the _Engine rules: any cfg.formal_interpolation but 'linear'
    is refused; cfg.group_max_angles caps the angles per batched group
    sweep when set, and unset, groups are not capped.
    """

    def __init__(self, atmos, line, cfg: Config, quadrature=None,
                 device=None):
        super().__init__(line, cfg, quadrature, device)
        if cfg.formal_interpolation != "linear":
            raise NotImplementedError(
                f"formal_interpolation={cfg.formal_interpolation!r}: only "
                f"the linear formal solution is ported")
        self.atmos = atmos
        z = np.asarray(atmos.z)
        self.plans = [build_plan(self.quad.k[i], z, atmos.dx, atmos.dy,
                                 bool(self.quad.is_up[i]))
                      for i in range(self.quad.n_angles)]
        # mirror-quadrant angles share one batched sweep
        self.plan_groups = group_plans(self.quad.k, self.quad.is_up, z,
                                       atmos.dx, atmos.dy,
                                       max_group=cfg.group_max_angles)
        self._frozen_setup(atmos)

    # ---- extinction

    def _alpha_tot_t(self, k, lam_c, populations, damp_c=None, g_cell=None):
        """alpha_line(profile(-k)) + alpha_cont for wavelengths lam_c, in
        the z-major sweep layout (nz, nlam, nx, ny).

        One wavelength at a time: the values are those of the whole-chunk
        expression (every op is pointwise), while the Voigt temporaries
        stay one wavelength plane in size.  damp_c: the chunk's damping
        rows, or None to compute them from the per-cell g_cell.
        """
        line = self.line
        v_los = line_of_sight_velocity(self.v, -np.asarray(k))
        nz, nx, ny = self.T.shape
        out = torch.empty((nz, lam_c.shape[0], nx, ny), dtype=self.dtype,
                          device=self.device)
        n_i, n_j = populations[..., 0], populations[..., 1]
        for j in range(lam_c.shape[0]):
            lam_j = lam_c[j:j + 1]
            if damp_c is not None:
                damp = damp_c[j:j + 1]
            else:
                damp = damping(g_cell[None], lam_j.reshape(-1, 1, 1, 1),
                               line.dlamD[None])
            profile = compute_profile(line, lam_j, damp, v_los)
            out[:, j] = alpha_line(line, profile, n_j, n_i)[0] + self.a_cont
        return out

    def _I0(self, lam_c, up):
        """Boundary plane: hot bottom B(T_bottom) for up sweeps, dark top
        for down sweeps (lambda_iteration.jl:38-52)."""
        if up:
            return B_lambda(lam_c[:, None, None], self.T[0][None])
        nx, ny = self.T.shape[1:]
        return torch.zeros((lam_c.shape[0], nx, ny), dtype=self.dtype,
                           device=self.device)

    # ---- J

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_regular).

        Wavelengths stream in blocks of cfg.lambda_chunk; each mirror-
        quadrant angle group runs as one batched sweep.  damping_lam=None
        computes the damping per chunk from the per-cell gamma.
        """
        lam = self.line.lam_tensor()
        chunks = _lambda_chunks(self.line.n_lambda, self.cfg.lambda_chunk)
        g_cell = self._gamma_cell(populations) if damping_lam is None \
            else None
        J = None
        if len(chunks) > 1:
            J = torch.empty((self.line.n_lambda,) + tuple(S.shape[1:]),
                            dtype=S.dtype, device=S.device)
        for sl in chunks:
            damp_sl = damping_lam[sl] if damping_lam is not None else None
            Jc = self._J_chunk_grouped(S[sl], populations, damp_sl, lam[sl],
                                       g_cell=g_cell)
            if J is None:
                return Jc
            J[sl] = Jc
        return J

    def _J_chunk_grouped(self, S_c, populations, damp_c, lam_c,
                         g_cell=None):
        """One lambda chunk of J with mirror-angle groups batched: per
        group, each angle's extinction, flipped to the canonical
        quadrant and stacked along the batch axis, runs ONE sweep whose
        planes reduce into the quadrature-weighted J as they are made."""
        quad = self.quad
        Jc = torch.zeros_like(S_c)
        S_t = S_c.transpose(0, 1)          # (nz, chunk, nx, ny)
        for group in self.plan_groups:
            if len(group) == 1:
                (i, _, _) = group[0]
                plan = self.plans[i]
                a_t = self._alpha_tot_t(quad.k[i], lam_c, populations,
                                        damp_c, g_cell)
                I = sweep(plan, S_t, a_t, self._I0(lam_c, plan.up),
                          n_sweeps=self.cfg.n_sweeps)
                # in-place J accumulation
                Jc.add_(float(quad.weights[i]) * I.transpose(0, 1))
                continue
            a_list = [self._alpha_tot_t(quad.k[i], lam_c, populations,
                                        damp_c, g_cell)
                      for (i, _, _) in group]
            # the boundary follows the ORIGINAL direction (fz = originally
            # down, z-flip-canonicalized)
            I0_list = [self._I0(lam_c, not fz)
                       for (_, _, (_, _, fz)) in group]
            I_g = sweep_group_J(
                tuple(p for (_, p, _) in group), S_t, a_list, I0_list,
                [float(quad.weights[i]) for (i, _, _) in group],
                n_sweeps=self.cfg.n_sweeps,
                flips=tuple(f for (_, _, f) in group))
            del a_list      # free before the next group's extinction
            # in-place J accumulation
            Jc.add_(I_g.transpose(0, 1))
        return Jc

    def bottom_boundary(self):
        return B_lambda(self.line.lam_tensor()[:, None, None],
                        self.T[0][None])

    def iterate_streamed(self, S, populations):
        """One Lambda iteration, lambda-streamed: each chunk flows J ->
        rate-integral accumulation -> S update written into S in place,
        so no full J cube, second S buffer or Planck cube exists.  S is
        overwritten.  Returns (S_new, pops_new, criterion_diff)."""
        line, cfg = self.line, self.cfg
        lam = line.lam_tensor()
        g_cell = self._gamma_cell(populations)
        acc = carry = None
        diff = torch.zeros((), dtype=self.dtype, device=self.device)
        for ci, sl in enumerate(_lambda_chunks(line.n_lambda,
                                               cfg.lambda_chunk)):
            Jc = self._J_chunk_grouped(S[sl], populations, None, lam[sl],
                                       g_cell=g_cell)
            r0 = sl.start if ci == 0 else sl.start - 1
            acc = _rates_accum(line, acc, carry, Jc, r0, g_cell, self.lte,
                               self.T, cfg.compat)
            carry = Jc[-1:].clone()     # a view would keep all of Jc alive
            S, m = _s_update_stream(line, S, Jc, self.eps, self.T, lam[sl],
                                    sl.start)
            diff = torch.maximum(diff, m)
            del Jc
        pops = get_revised_populations(acc, self.C, self.nH)
        return S, pops, float(diff)

    def run(self):
        if self.cfg.stream_rates:
            return _run_iteration_streamed(self)
        return _run_iteration(self)


# --------------------------------------------------------- voronoi grid

# points per block of the Voronoi extinction: the eager Voigt's complex
# temporaries stay one voigt_H slab in size
_EXT_POINTS = 1 << 24


class VoronoiEngine(_Engine):
    """Lambda iteration on the irregular grid (J_lambda_voronoi,
    Lambda_voronoi).

    Field layout: (nlam, n_sites); the sweeps run site-major, (n, B).
    plans: optionally the per-direction VoronoiPlans, in quadrature
    order (the JAX engine's `plans` list serves as is); else they are
    built with cfg.voronoi_order, disk-cached under cfg.cache_dir.  The
    Voronoi sweep is linear whatever cfg.formal_interpolation says, as
    in the JAX package.  cfg.stream_rates does not apply.
    """

    def __init__(self, sites, line, cfg: Config, quadrature=None,
                 plans=None, device=None):
        super().__init__(line, cfg, quadrature, device)
        self.sites = sites
        self.plans = list(plans) if plans is not None else \
            self.build_plans(sites, self.quad, cfg)
        self._frozen_setup(sites)
        self._bc_sites = [torch.as_tensor(np.asarray(p.bc_sites,
                                                     dtype=np.int64),
                                          device=self.device)
                          for p in self.plans]
        # the slot plans and their device arrays, built here rather
        # than in the first J pass
        for p in self.plans:
            device_plan(p, cfg.n_sweeps, self.device, self.dtype)

    @staticmethod
    def build_plans(sites, quad, cfg: Config):
        """Host-side plan construction for every quadrature direction
        (disk-cached when cfg.cache_dir is set)."""
        return [build_voronoi_plan(
            sites, quad.k[i], bool(quad.is_up[i]), p=cfg.upwind_exponent,
            compat=cfg.compat, order=cfg.voronoi_order,
            n_sweeps=cfg.n_sweeps, cache_dir=cfg.cache_dir)
            for i in range(quad.n_angles)]

    def _alpha_tot_T(self, k, lam_c, populations, damp_c=None,
                     g_cell=None):
        """alpha_line(profile(-k)) + alpha_cont for wavelengths lam_c,
        site-major (n, B): the counterpart of the JAX package's
        _alpha_tot_g_T.  Computed in blocks of wavelengths of about
        _EXT_POINTS points (every op is pointwise, so the values are
        those of the whole-chunk expression); damp_c: the chunk's damping
        rows, or None to compute them from the per-site g_cell."""
        line = self.line
        v_los = line_of_sight_velocity(self.v, -np.asarray(k))
        n, nlam = self.T.shape[0], lam_c.shape[0]
        out = torch.empty((n, nlam), dtype=self.dtype, device=self.device)
        n_i, n_j = populations[..., 0], populations[..., 1]
        step = max(1, _EXT_POINTS // max(n, 1))
        for j0 in range(0, nlam, step):
            j1 = min(j0 + step, nlam)
            lam_j = lam_c[j0:j1]
            if damp_c is not None:
                damp = damp_c[j0:j1]
            else:
                damp = damping(g_cell[None], lam_j[:, None],
                               line.dlamD[None])
            profile = compute_profile(line, lam_j, damp, v_los)
            out[:, j0:j1] = (alpha_line(line, profile, n_j, n_i)
                             + self.a_cont).T
        return out

    def _I0(self, i, lam_c):
        """Boundary intensity on plan i's bc sites: B(T) at the bottom
        layer for up sweeps, dark for down sweeps
        (lambda_iteration.jl:99-102)."""
        bc = self._bc_sites[i]
        if self.plans[i].up:
            return B_lambda(lam_c[:, None], self.T[bc][None])
        return torch.zeros((lam_c.shape[0], bc.shape[0]), dtype=self.dtype,
                           device=self.device)

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_voronoi).

        Wavelengths stream in blocks of cfg.lambda_chunk; within a chunk
        everything is site-major: S is transposed once, each direction's
        extinction is made as (n, B), and the quadrature-weighted J
        accumulates into one (n, B) buffer.  damping_lam=None computes
        the damping per chunk from the per-site gamma.
        """
        lam = self.line.lam_tensor()
        chunks = _lambda_chunks(self.line.n_lambda, self.cfg.lambda_chunk)
        g_cell = self._gamma_cell(populations) if damping_lam is None \
            else None
        J = None
        if len(chunks) > 1:
            J = torch.empty_like(S)
        for sl in chunks:
            damp_c = damping_lam[sl] if damping_lam is not None else None
            Jc_T = self._J_chunk_T(S[sl], populations, damp_c, lam[sl],
                                   g_cell)
            if J is None:
                return Jc_T.T.contiguous()
            J[sl] = Jc_T.T
        return J

    def _J_chunk_T(self, S_c, populations, damp_c, lam_c, g_cell):
        """One lambda chunk of J, site-major (n, B)."""
        quad, cfg = self.quad, self.cfg
        S_T = S_c.T.contiguous()
        Jc_T = torch.zeros_like(S_T)
        for i, plan in enumerate(self.plans):
            a_T = self._alpha_tot_T(quad.k[i], lam_c, populations, damp_c,
                                    g_cell)
            I_T = sweep_voronoi_t(plan, S_T, a_T, self._I0(i, lam_c),
                                  n_sweeps=cfg.n_sweeps,
                                  relax_tol=cfg.voronoi_relax_tol)
            del a_T
            # in-place J accumulation (the JAX package donates J to a
            # fused J + w * I)
            Jc_T.add_(I_T.mul_(float(quad.weights[i])))
        return Jc_T

    def run(self):
        return _run_iteration(self)


# --------------------------------------------------------- outer loop


def _run_iteration(engine, start_iteration=0, S_init=None,
                   populations_init=None):
    """Host-side while loop: iterate until converged (Lambda_regular and
    Lambda_voronoi, lambda_iteration.jl:116-297).  Starts from S_init /
    populations_init, else the engine's loaded state, else B0 / LTE."""
    cfg = engine.cfg
    line = engine.line
    if cfg.rates_site_chunk:
        raise NotImplementedError("rates_site_chunk is not ported")

    populations = populations_init if populations_init is not None else (
        engine.populations_start if engine.populations_start is not None
        else engine.lte)
    S_new = S_init if S_init is not None else (
        engine.S_start if engine.S_start is not None else engine.B0)
    S_old = torch.zeros_like(S_new)

    convergence = []
    timings = []
    J = None
    i = start_iteration
    while True:
        diff = _criterion(S_new, S_old)
        convergence.append(diff)
        if np.isnan(diff):
            print(f"NaN convergence at iteration {i}")
        if i > 0:
            print(f"   Rel. diff.: {diff}")
        print(f"Iteration {i + 1}...")
        if not (diff > cfg.eps and i < cfg.maxiter):
            break

        t0 = time.perf_counter()
        S_old = S_new
        J = None    # drop the previous J before the new J pass
        damping_lam = engine.damping_lam(populations)
        J = engine.compute_J(S_old, populations, damping_lam)
        S_new = _update_S(line, engine.eps, J, engine.B0)
        populations = _rates_and_populations(
            line, J, damping_lam, engine.lte, engine.C, engine.T,
            engine.nH, cfg.compat)
        _sync(populations)
        timings.append(time.perf_counter() - t0)
        i += 1

    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=J, S=S_new, alpha_cont=engine.a_cont,
                      populations=populations, convergence=convergence,
                      iterations=i, converged=converged, timings=timings)


def _run_iteration_streamed(engine):
    """The host loop for cfg.stream_rates: the iteration state is ONE
    full S buffer, updated in place, plus the populations.  The first
    convergence entry of the standard loop, criterion(B0, 0), is
    identically 1.0 and recorded as such.  The engine's B0 (or loaded
    S) is CONSUMED as the initial S: engine.B0 is set to None, so no
    Planck cube sits next to the iteration state."""
    cfg = engine.cfg
    populations = (engine.populations_start
                   if engine.populations_start is not None else engine.lte)
    S = engine.S_start if engine.S_start is not None else engine.B0
    engine.B0 = engine.S_start = None
    convergence = [1.0]
    timings = []
    print("Iteration 1...")
    i = 0
    diff = float("inf")
    while diff > cfg.eps and i < cfg.maxiter:
        t0 = time.perf_counter()
        S, populations, diff = engine.iterate_streamed(S, populations)
        _sync(populations)
        timings.append(time.perf_counter() - t0)
        convergence.append(diff)
        i += 1
        if np.isnan(diff):
            print(f"NaN convergence at iteration {i}")
        print(f"   Rel. diff.: {diff}")
        if diff > cfg.eps and i < cfg.maxiter:
            print(f"Iteration {i + 1}...")
    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=None, S=S, alpha_cont=engine.a_cont,
                      populations=populations, convergence=convergence,
                      iterations=i, converged=converged, timings=timings)
