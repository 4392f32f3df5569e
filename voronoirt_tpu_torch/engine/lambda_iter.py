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
write of the streamed update) and says so at each site.  With
parallel.distribute_angles applied, compute_J deals the quadrature
angles over the engine's angle_devices (parallel/angles.py).  With a
lambda group (parallel/lam.py; JAX: a "lam" mesh axis) the engine holds
one block of the line's wavelengths: its frozen B0, S and J are the
block's rows, its chunks run over the block, and the rate integrals and
the criterion are reduced over the group's ranks.  RegularEngine and
VoronoiEngine share the frozen set-up, the per-cell fields and
load_state through one base class, and run() through one outer loop,
which writes to a checkpoint store when given one
(engine/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Config
from ..device import torch_dtype
from ..grid.voronoi import build_voronoi_plan
from ..parallel import angles as _ang
from ..parallel import lam as _lam
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
    device (J is None for the streamed loop).  With a lambda group, S
    and J are the rank's block of wavelengths (parallel/lam.gather_lambda
    assembles them); convergence and populations are the same on every
    rank."""
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
                 cfg: Config, block=slice(None)):
    """LTE pops, alpha_cont(lam0), eps(lam0), C, B_0 -- all frozen
    (lambda_iteration.jl:124-154); B_0 over the wavelength rows `block`
    only."""
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
    lam = line.lam_tensor()[block]
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
    S = (1.0 - eps)[None] * J
    # the second product is added in place: one cube-sized temporary
    # less than the plain expression, the same arithmetic
    return S.add_(eps[None] * B0)


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


def _edge_pair(engine, acc, prev, first, g_cell):
    """Add to acc the trapezoid pair across a lambda block's lower edge,
    rows (lo - 1, lo): prev is row lo - 1 (from the rank before,
    parallel/lam.previous_row; None on rank 0 and without a lambda
    group), first the block's row lo."""
    if prev is None:
        return acc
    return calculate_R_chunk(
        engine.line, acc, torch.cat([prev, first]),
        engine.lam_block.start - 1, g_cell, engine.lte, engine.T,
        compat=engine.cfg.compat)


def _rates_and_populations(line, J, damping_lam, lte, C, temperature,
                           hydrogen_density, compat):
    R = calculate_R(line, J, damping_lam, lte, temperature, compat=compat)
    return get_revised_populations(R, C, hydrogen_density)


def _rates_and_populations_slabbed(line, J, g_cell, lte, C, temperature,
                                   hydrogen_density, compat, site_chunk,
                                   group=None, lo=0):
    """The rates / statistical-equilibrium update streamed over slabs of
    site_chunk entries of the first spatial axis (sites, or z-planes of
    the regular grid; one slab when site_chunk is None): the damping is
    recomputed per slab from the per-cell gamma, so the full damping
    cube and the rates' temporaries never sit next to J.  Pointwise in
    space; each slab's rate integrals are written into the rates in
    place.  J holds the line's rows [lo, lo + len(J)).  With a lambda
    group (J the rank's block) the previous rank's last row leads each
    slab, so the pair across the block's lower edge integrates here, and
    the rate integrals are summed over the ranks before the statistical
    equilibrium, which every rank then solves on the same inputs."""
    prev = _lam.previous_row(group, J[-1:])
    n = temperature.shape[0]
    step = site_chunk or n
    R = {}
    for s0 in range(0, n, step):
        sl = slice(s0, min(s0 + step, n))
        J_sl = J[:, sl] if prev is None else torch.cat([prev[:, sl],
                                                         J[:, sl]])
        acc = calculate_R_chunk(
            dataclasses.replace(line, dlamD=line.dlamD[sl]), None, J_sl,
            lo if prev is None else lo - 1, g_cell[sl], lte[sl],
            temperature[sl], compat=compat)
        for k, v in acc.items():
            R.setdefault(k, torch.zeros_like(temperature))[sl] = v
    R = _lam.all_reduce_rates(group, R, temperature)
    return get_revised_populations(R, C, hydrogen_density)


# elements per block of the criterion: its temporaries stay this size
# beside the two S cubes
_CRIT_POINTS = 1 << 27


def _criterion(S_new, S_old, group=None):
    """max over lam of max |1 - S_old/S_new| (lambda_iteration.jl:
    299-349); cells where S_new is exactly 0 compare by absolute
    difference.  Taken in blocks along the wavelength axis and reduced
    on the device: one scalar is read back.  With a lambda group, S is
    the rank's block and the maximum is taken over the ranks."""
    rows = max(1, _CRIT_POINTS // max(S_new[0].numel(), 1))
    diff = None
    for new, old in zip(S_new.split(rows), S_old.split(rows)):
        denom = torch.where(new != 0.0, new, 1.0)
        m = torch.max(torch.abs(new - old) / torch.abs(denom))
        diff = m if diff is None else torch.maximum(diff, m)
    return _lam.global_max(group, diff)


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
    transport is not accurate yet, ROADMAP C3).  lam_group: a
    parallel.lam.LamGroup, whose block of the line (lam_block, global
    rows) this engine then owns; the line itself stays whole, since the
    rate windows read it by global index.
    """

    def __init__(self, line, cfg: Config, quadrature, device, lam_group):
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
        # set by parallel.distribute_angles
        self.angle_devices = None
        self._angle_static = None
        self.lam_group = None
        self.lam_block = slice(0, self.line.n_lambda)
        if lam_group is not None:
            _lam.attach(self, lam_group)

    def _slots(self, **state):
        """The per-angle loops' view of where each angle runs: (state,
        static), one entry per slot of angle_devices -- the per-iteration
        tensors broadcast to the slot's device, and the slot's static
        copies.  Undistributed, the one slot is the engine's own tensors
        (static None)."""
        if not self.angle_devices:
            return [state], [None]
        return (_ang.broadcast_state(self.angle_devices, **state),
                self._angle_static)

    def _frozen_setup(self, fields):
        """The per-cell fields of `fields` (an Atmosphere or
        VoronoiSites) on the device, and the frozen set-up on them."""
        self.T = self._field(fields.temperature)
        self.ne = self._field(fields.electron_density)
        self.nH = self._field(fields.hydrogen_populations)
        self.v = self._field(fields.velocity_zxy())
        (self.lte, self.a_cont, self.eps, self.C,
         self.B0) = frozen_setup(self.line, self.T, self.ne, self.nH,
                                 self.cfg, self.lam_block)
        self.S_start = None
        self.populations_start = None

    def _field(self, a):
        """A numpy array, or a tensor on any device, as a tensor of the
        working dtype on the engine's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def load_state(self, arrays):
        """Replace the frozen fields with given numpy arrays.

        Keys: 'lte', 'a_cont', 'eps', 'B0' and 'C_01', 'C_10', 'C_02',
        'C_20', 'C_12', 'C_21' (any subset), plus optionally 'S' and
        'populations', which become the starting state of run().  The
        counterpart of tests/test_nlte_parity.py::_inject_frozen: it
        lets the port start from the JAX engine's state.  With a lambda
        group, a 'B0' or 'S' of the whole line is cut to the block.
        """
        known = {"lte", "a_cont", "eps", "B0", "S", "populations"} | {
            f"C_{i}{j}" for i, j in _C_KEYS}
        unknown = set(arrays) - known
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        for name in ("lte", "a_cont", "eps"):
            if name in arrays:
                setattr(self, name, self._field(arrays[name]))
        if "B0" in arrays:
            self.B0 = self._field(self._rows(arrays["B0"]))
        for i, j in _C_KEYS:
            if f"C_{i}{j}" in arrays:
                self.C[(i, j)] = self._field(arrays[f"C_{i}{j}"])
        if "S" in arrays:
            self.S_start = self._field(self._rows(arrays["S"]))
        if "populations" in arrays:
            self.populations_start = self._field(arrays["populations"])

    def _rows(self, a):
        """The lambda block's rows of an array over the whole line."""
        return a[self.lam_block] if len(a) == self.line.n_lambda else a

    def block_lam(self):
        """The wavelengths of the engine's lambda block (all of the
        line's without a lambda group), on the device."""
        return self.line.lam_tensor()[self.lam_block]

    def _gamma_cell(self, populations):
        """Per-cell damping rate gamma (lambda-independent)."""
        return gamma_constant(self.line, self.T,
                              populations[..., 0] + populations[..., 1],
                              self.ne, self.cfg.gamma_natural)

    def damping_lam(self, populations):
        """The (nlam, ...) damping cube of the lambda block."""
        lam = self.block_lam().reshape((-1,) + (1,) * self.T.dim())
        return damping(self._gamma_cell(populations)[None], lam,
                       self.line.dlamD[None])


# --------------------------------------------------------- regular grid


class RegularEngine(_Engine):
    """Lambda iteration on the regular grid.

    Field layout: (nlam, nz, nx, ny); sweeps run on (nz, nlam, nx, ny).
    cfg.group_max_angles caps the angles per batched group sweep when
    set, and unset, groups are not capped.  cfg.formal_interpolation =
    'bezier' and angle distribution both sweep angle by angle; the
    lambda-streamed iteration is linear and undistributed only.
    """

    def __init__(self, atmos, line, cfg: Config, quadrature=None,
                 device=None, lam_group=None):
        super().__init__(line, cfg, quadrature, device, lam_group)
        if cfg.formal_interpolation not in ("linear", "bezier"):
            raise ValueError(
                f"unknown formal_interpolation {cfg.formal_interpolation!r}")
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

    def _alpha_tot_t(self, k, lam_c, populations, damp_c=None, g_cell=None,
                     static=None):
        """alpha_line(profile(-k)) + alpha_cont for wavelengths lam_c, in
        the z-major sweep layout (nz, nlam, nx, ny).

        One wavelength at a time: the values are those of the whole-chunk
        expression (every op is pointwise), while the Voigt temporaries
        stay one wavelength plane in size.  damp_c: the chunk's damping
        rows, or None to compute them from the per-cell g_cell.  static:
        an angle slot's copies of the velocity, the continuum extinction
        and the line (parallel/angles.py), else the engine's own.
        """
        v, a_cont, line = (
            (static["v"], static["a_cont"], static["line"]) if static
            else (self.v, self.a_cont, self.line))
        v_los = line_of_sight_velocity(v, -np.asarray(k))
        nz, nx, ny = self.T.shape
        out = torch.empty((nz, lam_c.shape[0], nx, ny), dtype=self.dtype,
                          device=v.device)
        n_i, n_j = populations[..., 0], populations[..., 1]
        for j in range(lam_c.shape[0]):
            lam_j = lam_c[j:j + 1]
            if damp_c is not None:
                damp = damp_c[j:j + 1]
            else:
                damp = damping(g_cell[None], lam_j.reshape(-1, 1, 1, 1),
                               line.dlamD[None])
            profile = compute_profile(line, lam_j, damp, v_los)
            out[:, j] = alpha_line(line, profile, n_j, n_i)[0] + a_cont
        return out

    def _I0(self, lam_c, up, static=None):
        """Boundary plane: hot bottom B(T_bottom) for up sweeps, dark top
        for down sweeps (lambda_iteration.jl:38-52)."""
        if up:
            T_bottom = static["T_bottom"] if static else self.T[0]
            return B_lambda(lam_c[:, None, None], T_bottom[None])
        nx, ny = self.T.shape[1:]
        return torch.zeros((lam_c.shape[0], nx, ny), dtype=self.dtype,
                           device=lam_c.device)

    # ---- J

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_regular).

        Wavelengths stream in blocks of cfg.lambda_chunk; each mirror-
        quadrant angle group runs as one batched sweep, unless Bezier
        interpolation or angle distribution (parallel/angles.py) asks
        for per-angle sweeps.  damping_lam=None computes the damping per
        chunk from the per-cell gamma; angle distribution broadcasts the
        materialised cube instead.
        """
        lam = self.block_lam()
        chunks = _lambda_chunks(lam.shape[0], self.cfg.lambda_chunk)
        if damping_lam is None and self.angle_devices:
            damping_lam = self.damping_lam(populations)
        g_cell = self._gamma_cell(populations) if damping_lam is None \
            else None
        per_angle = (self.cfg.formal_interpolation != "linear"
                     or bool(self.angle_devices))
        J_chunk = self._J_chunk_per_angle if per_angle \
            else self._J_chunk_grouped
        J = None
        if len(chunks) > 1:
            J = torch.empty((lam.shape[0],) + tuple(S.shape[1:]),
                            dtype=S.dtype, device=S.device)
        for sl in chunks:
            damp_sl = damping_lam[sl] if damping_lam is not None else None
            Jc = J_chunk(S[sl], populations, damp_sl, lam[sl], g_cell=g_cell)
            if J is None:
                return Jc
            J[sl] = Jc
        return J

    def _J_chunk_per_angle(self, S_c, populations, damp_c, lam_c,
                           g_cell=None):
        """One lambda chunk of J, one single-direction sweep per angle
        (the only sweep that takes cfg.formal_interpolation), each on the
        slot that owns the angle; the slots' partial sums are reduced on
        S's device."""
        quad, cfg = self.quad, self.cfg
        state, static = self._slots(S_t=S_c.transpose(0, 1), damping=damp_c,
                                    populations=populations, lam=lam_c)
        partials = {}
        for i, plan in enumerate(self.plans):
            slot = _ang.angle_device(self, i) if self.angle_devices else 0
            st, dst = state[slot], static[slot]
            a_t = self._alpha_tot_t(quad.k[i], st["lam"], st["populations"],
                                    st["damping"], g_cell, static=dst)
            I = sweep(plan, st["S_t"], a_t, self._I0(st["lam"], plan.up, dst),
                      n_sweeps=cfg.n_sweeps,
                      interpolation=cfg.formal_interpolation)
            del a_t
            # the partial sums stay in the sweep's z-major layout
            _ang.partial_accumulate(partials, slot,
                                    I.mul_(float(quad.weights[i])))
        J_t = _ang.reduce_partials(partials, _ang.target_device(S_c))
        return J_t.transpose(0, 1).contiguous()

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
        return B_lambda(self.block_lam()[:, None, None], self.T[0][None])

    def iterate_streamed(self, S, populations):
        """One Lambda iteration, lambda-streamed: each chunk flows J ->
        rate-integral accumulation -> S update written into S in place,
        so no full J cube, second S buffer or Planck cube exists.  S is
        overwritten.  Returns (S_new, pops_new, criterion_diff).  The
        angle-distributed path and the Bezier formal solution are not
        supported here (use the standard loop), as in the JAX package.
        With a lambda group, S is the rank's block and the chunks run
        over it; the rate integrals start at the block's first row (rows
        are global for calculate_R_chunk), the pair across the block's
        lower edge waits for the previous rank's last row, and the rates
        and the criterion are then reduced over the ranks."""
        line, cfg, group = self.line, self.cfg, self.lam_group
        _refuse_streamed(self)
        lam = self.block_lam()
        lo = self.lam_block.start
        g_cell = self._gamma_cell(populations)
        acc = carry = first = None
        diff = torch.zeros((), dtype=self.dtype, device=self.device)
        for ci, sl in enumerate(_lambda_chunks(lam.shape[0],
                                               cfg.lambda_chunk)):
            Jc = self._J_chunk_grouped(S[sl], populations, None, lam[sl],
                                       g_cell=g_cell)
            r0 = lo + (sl.start if ci == 0 else sl.start - 1)
            acc = _rates_accum(line, acc, carry, Jc, r0, g_cell, self.lte,
                               self.T, cfg.compat)
            if ci == 0 and group is not None:
                first = Jc[:1].clone()
            carry = Jc[-1:].clone()     # a view would keep all of Jc alive
            S, m = _s_update_stream(line, S, Jc, self.eps, self.T, lam[sl],
                                    sl.start)
            diff = torch.maximum(diff, m)
            del Jc
        acc = _edge_pair(self, acc, _lam.previous_row(group, carry), first,
                         g_cell)
        acc = _lam.all_reduce_rates(group, acc, self.T)
        pops = get_revised_populations(acc, self.C, self.nH)
        return S, pops, _lam.global_max(group, diff)

    def run(self, checkpoint=None):
        if self.cfg.stream_rates:
            return _run_iteration_streamed(self, checkpoint)
        return _run_iteration(self, checkpoint)


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
                 plans=None, device=None, lam_group=None):
        super().__init__(line, cfg, quadrature, device, lam_group)
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
                     g_cell=None, static=None):
        """alpha_line(profile(-k)) + alpha_cont for wavelengths lam_c,
        site-major (n, B): the counterpart of the JAX package's
        _alpha_tot_g_T.  Computed in blocks of wavelengths of about
        _EXT_POINTS points (every op is pointwise, so the values are
        those of the whole-chunk expression); damp_c: the chunk's damping
        rows, or None to compute them from the per-site g_cell; static:
        an angle slot's copies (parallel/angles.py), else the engine's
        own."""
        v, a_cont, line = (
            (static["v"], static["a_cont"], static["line"]) if static
            else (self.v, self.a_cont, self.line))
        v_los = line_of_sight_velocity(v, -np.asarray(k))
        n, nlam = self.T.shape[0], lam_c.shape[0]
        out = torch.empty((n, nlam), dtype=self.dtype, device=v.device)
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
                             + a_cont).T
        return out

    def _I0(self, i, lam_c, static=None):
        """Boundary intensity on plan i's bc sites: B(T) at the bottom
        layer for up sweeps, dark for down sweeps
        (lambda_iteration.jl:99-102)."""
        bc = self._bc_sites[i].to(lam_c.device)
        if self.plans[i].up:
            T = static["T"] if static else self.T
            return B_lambda(lam_c[:, None], T[bc][None])
        return torch.zeros((lam_c.shape[0], bc.shape[0]), dtype=self.dtype,
                           device=lam_c.device)

    def compute_J(self, S, populations, damping_lam=None):
        """J accumulation over the quadrature (J_lambda_voronoi).

        Wavelengths stream in blocks of cfg.lambda_chunk; within a chunk
        everything is site-major: S is transposed once, each direction's
        extinction is made as (n, B), and the quadrature-weighted J
        accumulates into one (n, B) buffer per angle slot.
        damping_lam=None computes the damping per chunk from the per-site
        gamma; angle distribution (parallel/angles.py) broadcasts the
        materialised cube instead.
        """
        lam = self.block_lam()
        chunks = _lambda_chunks(lam.shape[0], self.cfg.lambda_chunk)
        if damping_lam is None and self.angle_devices:
            damping_lam = self.damping_lam(populations)
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
        """One lambda chunk of J, site-major (n, B): each angle on the
        slot that owns it, the slots' partial sums reduced on S's
        device (undistributed: one slot, the engine's own tensors)."""
        quad, cfg = self.quad, self.cfg
        state, static = self._slots(S_T=S_c.T.contiguous(), damping=damp_c,
                                    populations=populations, lam=lam_c)
        partials = {}
        for i, plan in enumerate(self.plans):
            slot = _ang.angle_device(self, i) if self.angle_devices else 0
            st, dst = state[slot], static[slot]
            a_T = self._alpha_tot_T(quad.k[i], st["lam"], st["populations"],
                                    st["damping"], g_cell, static=dst)
            I_T = sweep_voronoi_t(plan, st["S_T"], a_T,
                                  self._I0(i, st["lam"], dst),
                                  n_sweeps=cfg.n_sweeps,
                                  relax_tol=cfg.voronoi_relax_tol)
            del a_T
            # in-place J accumulation (the JAX package donates J to a
            # fused J + w * I)
            _ang.partial_accumulate(partials, slot,
                                    I_T.mul_(float(quad.weights[i])))
        return _ang.reduce_partials(partials, _ang.target_device(S_c))

    def run(self, checkpoint=None):
        return _run_iteration(self, checkpoint)


# --------------------------------------------------------- outer loop


def _refuse_streamed(engine):
    """The lambda-streamed iteration sweeps in batched groups, which are
    linear and undistributed only (the JAX package asserts the first
    and runs a distributed engine's streamed iteration undistributed
    without a word)."""
    if engine.cfg.formal_interpolation != "linear":
        raise NotImplementedError(
            "stream_rates supports the linear formal solution only")
    if engine.angle_devices:
        raise ValueError(
            "stream_rates does not take an engine with angle distribution")


def _refuse_lam_checkpoint(engine, checkpoint):
    """A lambda-split engine holds one block of S, and write_state needs
    the whole S: checkpoints of such runs are not ported (ROADMAP)."""
    if checkpoint is not None and engine.lam_group is not None:
        raise NotImplementedError(
            "checkpoints of an engine with a lambda group are not ported: "
            "write_state needs the whole S, and each rank holds one block")


def _run_iteration(engine, checkpoint=None, start_iteration=0, S_init=None,
                   populations_init=None):
    """Host-side while loop: iterate until converged (Lambda_regular and
    Lambda_voronoi, lambda_iteration.jl:116-297), checkpointing like the
    reference (lambda_iteration.jl:188-189,280-281): the criterion of
    every loop head goes to checkpoint.write_convergence, the state to
    checkpoint.write_state every cfg.checkpoint_every iterations (the
    only iterations that copy S to the host).  Starts from S_init /
    populations_init (numpy arrays or tensors, placed on the engine's
    device), else the engine's loaded state, else B0 / LTE.  On a resume
    (start_iteration > 0) the first criterion compares against zeros and
    records a spurious 1.0, as the JAX package does."""
    cfg = engine.cfg
    line = engine.line
    _refuse_lam_checkpoint(engine, checkpoint)

    if populations_init is not None:
        populations = engine._field(populations_init)
    elif engine.populations_start is not None:
        populations = engine.populations_start
    else:
        populations = engine.lte
    if S_init is not None:
        S_new = engine._field(S_init)
    elif engine.S_start is not None:
        S_new = engine.S_start
    else:
        S_new = engine.B0
    S_old = torch.zeros_like(S_new)

    convergence = []
    timings = []
    J = None
    i = start_iteration
    while True:
        diff = _criterion(S_new, S_old, engine.lam_group)
        convergence.append(diff)
        if checkpoint is not None:
            checkpoint.write_convergence(i + 1, diff)
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
        if cfg.rates_site_chunk or engine.lam_group is not None:
            # production-memory path: damping per lambda chunk inside
            # compute_J, rates streamed over slabs -- the full damping
            # cube never sits next to J; with a lambda group, the rates
            # over the block, then summed over the ranks
            g_cell = engine._gamma_cell(populations)
            J = engine.compute_J(S_old, populations, None)
            S_new = _update_S(line, engine.eps, J, engine.B0)
            populations = _rates_and_populations_slabbed(
                line, J, g_cell, engine.lte, engine.C, engine.T,
                engine.nH, cfg.compat, cfg.rates_site_chunk,
                engine.lam_group, engine.lam_block.start)
            del g_cell
        else:
            damping_lam = engine.damping_lam(populations)
            J = engine.compute_J(S_old, populations, damping_lam)
            S_new = _update_S(line, engine.eps, J, engine.B0)
            populations = _rates_and_populations(
                line, J, damping_lam, engine.lte, engine.C, engine.T,
                engine.nH, cfg.compat)
            del damping_lam
        _sync(populations)
        timings.append(time.perf_counter() - t0)

        if checkpoint is not None and i % cfg.checkpoint_every == 0:
            checkpoint.write_state(populations, S_new)
        i += 1

    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=J, S=S_new, alpha_cont=engine.a_cont,
                      populations=populations, convergence=convergence,
                      iterations=i, converged=converged, timings=timings)


def _run_iteration_streamed(engine, checkpoint=None):
    """The host loop for cfg.stream_rates: the iteration state is ONE
    full S buffer, updated in place, plus the populations.  The first
    convergence entry of the standard loop, criterion(B0, 0), is
    identically 1.0 and recorded as such.  The engine's B0 (or loaded
    S) is CONSUMED as the initial S: engine.B0 is set to None, so no
    Planck cube sits next to the iteration state.  Writes to
    `checkpoint` as _run_iteration does."""
    cfg = engine.cfg
    _refuse_streamed(engine)
    _refuse_lam_checkpoint(engine, checkpoint)
    populations = (engine.populations_start
                   if engine.populations_start is not None else engine.lte)
    S = engine.S_start if engine.S_start is not None else engine.B0
    engine.B0 = engine.S_start = None
    convergence = [1.0]
    timings = []
    if checkpoint is not None:
        checkpoint.write_convergence(1, 1.0)
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
        if checkpoint is not None:
            checkpoint.write_convergence(i + 1, diff)
            if (i - 1) % cfg.checkpoint_every == 0:
                checkpoint.write_state(populations, S)
        if diff > cfg.eps and i < cfg.maxiter:
            print(f"Iteration {i + 1}...")
    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=None, S=S, alpha_cont=engine.a_cont,
                      populations=populations, convergence=convergence,
                      iterations=i, converged=converged, timings=timings)
