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
the criterion are reduced over the group's ranks.  On a mesh
(parallel/mesh.py) it also holds one (x, y) tile of the regular grid, or
one block of the Voronoi sites, of every field and of S, J and the
populations: the sweeps exchange halos or gather what they read, the
rates stay local to a cell and are summed over the "lam" axis only, and
the criterion is reduced over the whole mesh.  RegularEngine and
VoronoiEngine share the frozen set-up, the per-cell fields and
load_state through one base class, and run() through one outer loop,
which writes to a checkpoint store when given one
(engine/checkpoint.py); a split run's state is gathered to the host of
rank 0, which alone writes.  Config.dtype is the one working type:
float64, or float32 end to end (the JAX package's production mode, in
which the sweeps launch the kernels' float32 builds).
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
from ..parallel.mesh import gather_space
from ..physics.atom import destruction, line_of_sight_velocity
from ..physics.broadening import damping, gamma_constant
from ..physics.extinction import alpha_tot, alpha_tot_group
from ..physics.lte import lte_populations
from ..physics.opacity import (alpha_absorption, alpha_scattering,
                               warn_charge_inconsistency)
from ..physics.planck import B_lambda
from ..physics.rates import calculate_C, calculate_R_chunk
from ..physics.stateq import get_revised_populations
from ..quadrature import get_quadrature
from ..solvers.sweep_regular import (build_plan, group_plans, sweep,
                                     sweep_group_J, sweep_group_J_stack)
from ..solvers.sweep_voronoi import device_plan, sweep_voronoi_t
from . import s_update as _s1

_C_KEYS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))


@dataclasses.dataclass
class NLTEResult:
    """Outcome of a Lambda iteration; fields are tensors on the engine's
    device (J is None for the streamed loop).  With a lambda group, S
    and J are the rank's block of wavelengths (parallel/lam.gather_lambda
    assembles them); on a mesh's spatial axes, S, J, populations and
    alpha_cont are the rank's tile or block of sites
    (parallel/mesh.gather_space assembles them).  Convergence is the same
    on every rank, and so are the populations across a lambda group."""
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
    0-d tensor on S's device: one S1 launch on the card
    (engine/s_update.py)."""
    return _s1.s_update_stream(S, Jc, eps, T, lam_c, start)


def _rates_accum(line, acc, carry, Jc, r0, g_cell, lte, T, compat):
    """Accumulate one lambda chunk's radiative-rate contributions; carry
    is the previous chunk's last J row (None for the first chunk), which
    leads the chunk's rows: one R1 launch on the card, into acc's
    tensors in place."""
    return calculate_R_chunk(line, acc, Jc, r0, g_cell, lte, T,
                             compat=compat, lead=carry)


def _edge_pair(engine, acc, prev, first, g_cell):
    """Add to acc the trapezoid pair across a lambda block's lower edge,
    rows (lo - 1, lo): prev is row lo - 1 (from the rank before,
    parallel/lam.previous_row; None on rank 0 and without a lambda
    group), first the block's row lo."""
    if prev is None:
        return acc
    return calculate_R_chunk(
        engine.line, acc, first, engine.lam_block.start - 1, g_cell,
        engine.lte, engine.T, compat=engine.cfg.compat, lead=prev)


def _rates_and_populations(line, J, g_cell, lte, C, temperature,
                           hydrogen_density, compat):
    """The standard loop's rates and statistical equilibrium: the rate
    integrals over all of J's rows from the per-cell gamma, one R1
    launch on the card (calculate_R_chunk), as calculate_R computes them
    from the damping cube (the JAX package's _rates_and_populations)."""
    return _rates_and_populations_slabbed(line, J, g_cell, lte, C,
                                          temperature, hydrogen_density,
                                          compat, None)


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
        acc = calculate_R_chunk(
            dataclasses.replace(line, dlamD=line.dlamD[sl]), None, J[:, sl],
            lo if prev is None else lo - 1, g_cell[sl], lte[sl],
            temperature[sl], compat=compat,
            lead=None if prev is None else prev[:, sl])
        if step >= n:
            R = acc     # one slab: its rates are the rates
            break
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
    difference (in float32, B_lambda at the 22.8 nm bound-free edge
    underflows to 0 in cold cells, as the JAX package notes).  Taken in
    blocks along the wavelength axis and reduced
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
    line.dlamD).  cfg.dtype ('float64' or 'float32', the JAX package's
    production mode) is the working type of physics and transport alike:
    every field, the line, the extinction (complex64 Voigt in float32),
    the sweeps' kernels, the rates and S; a different
    cfg.transport_dtype is refused.  lam_group: a
    parallel.lam.LamGroup, whose block of the line (lam_block, global
    rows) this engine then owns; the line itself stays whole, since the
    rate windows read it by global index.  mesh: a parallel.mesh.Mesh,
    whose "lam" sub-group becomes lam_group and whose spatial axes give
    the engine its tile (regular) or block of sites (Voronoi).
    """

    def __init__(self, line, cfg: Config, quadrature, device, lam_group,
                 mesh=None):
        self.cfg = cfg
        self.device = torch.device(device if device is not None
                                   else line.dlamD.device)
        self.dtype = torch_dtype(cfg.dtype)
        if cfg.sweep_dtype != cfg.dtype:
            raise NotImplementedError(
                f"transport_dtype={cfg.transport_dtype!r} differs from "
                f"dtype={cfg.dtype!r}: the JAX package declares the field "
                f"and never reads it, so there is no mixed-type engine to "
                f"port; set dtype alone")
        self.line = dataclasses.replace(
            line, dlamD=line.dlamD.to(self.device, self.dtype))
        self.quad = get_quadrature(quadrature or cfg.quadrature)
        # set by parallel.distribute_angles
        self.angle_devices = None
        self._angle_static = None
        self.lam_group = None
        self.lam_block = slice(0, self.line.n_lambda)
        self.mesh = None
        if lam_group is not None and mesh is not None:
            raise ValueError("give lam_group or a mesh (which carries its "
                             "lambda group), not both")
        if lam_group is not None:
            _lam.attach(self, lam_group)

    def _attach_mesh(self, mesh):
        """Make this engine one rank's part of `mesh`: the "lam" axis's
        block of the line and the spatial axes' share of the grid
        (_split_space).  Angle slots are refused, as with a lambda
        group."""
        if self.mesh is not None:
            raise ValueError("the engine already has a mesh")
        if mesh.lam is not None:
            _lam.attach(self, mesh.lam)
        elif self.angle_devices:
            raise ValueError("an engine takes a mesh or angle distribution "
                             "(parallel/angles.py), not both")
        elif self.lam_group is not None:
            raise ValueError("the engine already has a lambda group")
        self.mesh = mesh
        self._split_space(mesh)

    def _world(self):
        """The group that spans every rank of the run (the criterion's
        maximum, checkpoints), or None for a run on one rank."""
        return self.mesh.world if self.mesh is not None else self.lam_group

    def _cut_fields(self):
        """Keep the rank's share of fields set up whole (shard_regular,
        shard_voronoi): the tile or block of sites of every per-cell
        field, and the lambda block's rows of B0 and a loaded S."""
        for name in ("T", "ne", "nH", "v", "lte", "a_cont", "eps",
                     "populations_start"):
            a = getattr(self, name)
            if a is not None:
                setattr(self, name, self._cut(a).contiguous())
        self.C = {k: self._cut(v).contiguous() for k, v in self.C.items()}
        self._cut_line()
        for name in ("B0", "S_start"):
            a = getattr(self, name)
            if a is not None:
                # .clone(): the whole cube is freed
                setattr(self, name, self._cut(self._rows(a), 1).clone())

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
        self._cut_line()
        self.T = self._field(self._cut(fields.temperature))
        self.ne = self._field(self._cut(fields.electron_density))
        self.nH = self._field(self._cut(fields.hydrogen_populations))
        self.v = self._field(self._cut(fields.velocity_zxy()))
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
        group, a 'B0' or 'S' of the whole line is cut to the block; on a
        mesh's spatial axes, an array of the whole grid to the rank's
        tile or block of sites.
        """
        known = {"lte", "a_cont", "eps", "B0", "S", "populations"} | {
            f"C_{i}{j}" for i, j in _C_KEYS}
        unknown = set(arrays) - known
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        for name in ("lte", "a_cont", "eps"):
            if name in arrays:
                setattr(self, name, self._field(self._cut(arrays[name])))
        if "B0" in arrays:
            self.B0 = self._field(self._cut(self._rows(arrays["B0"]), 1))
        for i, j in _C_KEYS:
            if f"C_{i}{j}" in arrays:
                self.C[(i, j)] = self._field(self._cut(arrays[f"C_{i}{j}"]))
        if "S" in arrays:
            self.S_start = self._field(self._cut(self._rows(arrays["S"]), 1))
        if "populations" in arrays:
            self.populations_start = self._field(
                self._cut(arrays["populations"]))

    def _cut_line(self):
        """The line's per-cell Doppler widths cut to the rank's share."""
        self.line = dataclasses.replace(
            self.line, dlamD=self._cut(self.line.dlamD).contiguous())

    def _rows(self, a):
        """The lambda block's rows of an array over the whole line."""
        return a[self.lam_block] if len(a) == self.line.n_lambda else a

    def _cut(self, a, lead=0):
        """The rank's tile (or block of sites) of an array over the whole
        grid whose spatial dims follow `lead` leading dims (1 for a
        (nlam, ...) array); an array already cut is returned as it is."""
        grid = self.grid_shape()
        if tuple(a.shape[lead:lead + len(grid)]) != grid:
            return a
        return a[(slice(None),) * lead + self._space_index()]

    def block_lam(self):
        """The wavelengths of the engine's lambda block (all of the
        line's without a lambda group), on the device."""
        return self.line.lam_tensor()[self.lam_block]

    def _gamma_cell(self, populations):
        """Per-cell damping rate gamma (lambda-independent)."""
        return gamma_constant(self.line, self.T,
                              populations[..., 0] + populations[..., 1],
                              self.ne, self.cfg.gamma_natural)

    def _alpha_tot(self, k, lam_c, populations, damp_c=None, g_cell=None,
                   static=None):
        """alpha_line(profile(-k)) + alpha_cont for wavelengths lam_c in
        the sweep's layout, the wavelength axis second: (nz, nlam, nx,
        ny) on the regular grid, (n, nlam) on the sites.  One alpha_tot
        call (physics/extinction.py), the counterpart of the JAX package's
        _alpha_tot_g_t and _alpha_tot_g_T.
        damp_c: the chunk's damping rows, or None to compute them from
        the per-cell g_cell; static: an angle slot's copies of the
        velocity, the continuum extinction and the line
        (parallel/angles.py), else the engine's own."""
        v, a_cont, line = (
            (static["v"], static["a_cont"], static["line"]) if static
            else (self.v, self.a_cont, self.line))
        v_los = line_of_sight_velocity(v, -np.asarray(k))
        return alpha_tot(line, lam_c, v_los, populations.contiguous(),
                         a_cont, g_cell=g_cell if damp_c is None else None,
                         damp=damp_c)

    def _alpha_tot_group(self, group, lam_c, populations, damp_c=None,
                         g_cell=None):
        """A mirror group's (group_plans) extinction stack for wavelengths
        lam_c, (nz, P*nlam, nx, ny), each angle's block flipped into the
        group's canonical quadrant: one alpha_tot_group call, the
        counterpart of the JAX package's per-angle _alpha_tot_g_t and the
        flipped concatenation in its sweep_group_J."""
        return alpha_tot_group(
            self.line, lam_c, self.v.contiguous(),
            [self.quad.k[i] for (i, _, _) in group],
            [f for (_, _, f) in group], populations.contiguous(),
            self.a_cont, g_cell=g_cell if damp_c is None else None,
            damp=damp_c)

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
                 device=None, lam_group=None, mesh=None):
        super().__init__(line, cfg, quadrature, device, lam_group, mesh)
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
        self.tile = (slice(None), slice(None))
        self.halo = None
        if mesh is not None:
            self._attach_mesh(mesh)
        self._frozen_setup(atmos)

    def _split_space(self, mesh):
        """The (x, y) tile of the mesh's "x" and "y" axes, and the halo
        its sweeps exchange: one cell, two for the Bezier xy step."""
        if mesh.size("site") > 1:
            raise ValueError("the regular grid splits over 'x' and 'y', "
                             "not 'site'")
        _, nx, ny = self.atmos.shape
        self.tile = (mesh.block("x", nx), mesh.block("y", ny))
        self.halo = mesh.halo(
            2 if self.cfg.formal_interpolation == "bezier" else 1)

    def _space_index(self):
        return (slice(None),) + self.tile

    def grid_shape(self):
        """The whole grid's shape, (nz, nx, ny)."""
        return tuple(self.atmos.shape)

    def _pad(self, A):
        """A tile (..., nx, ny) padded with its halos on a split grid."""
        return self.halo.pad(A) if self.halo is not None else A

    def _strip(self, A):
        return self.halo.strip(A) if self.halo is not None else A

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
        state, static = self._slots(S_t=self._pad(S_c.transpose(0, 1)),
                                    damping=damp_c, populations=populations,
                                    lam=lam_c)
        partials = {}
        for i, plan in enumerate(self.plans):
            slot = _ang.angle_device(self, i) if self.angle_devices else 0
            st, dst = state[slot], static[slot]
            a_t = self._pad(self._alpha_tot(
                quad.k[i], st["lam"], st["populations"], st["damping"],
                g_cell, static=dst))
            I = sweep(plan, st["S_t"], a_t,
                      self._pad(self._I0(st["lam"], plan.up, dst)),
                      n_sweeps=cfg.n_sweeps,
                      interpolation=cfg.formal_interpolation, halo=self.halo)
            del a_t
            # the partial sums stay in the sweep's z-major layout
            _ang.partial_accumulate(partials, slot, self._strip(I).mul_(
                float(quad.weights[i])))
        J_t = _ang.reduce_partials(partials, _ang.target_device(S_c))
        return J_t.transpose(0, 1).contiguous()

    def _J_chunk_grouped(self, S_c, populations, damp_c, lam_c,
                         g_cell=None):
        """One lambda chunk of J with mirror-angle groups batched: per
        group, each angle's extinction, flipped to the canonical
        quadrant and stacked along the batch axis, runs ONE sweep whose
        planes reduce into the quadrature-weighted J halves as they are
        made (group_emit, G1); group_fold (G3) adds each group's halves
        into Jc."""
        quad, pad = self.quad, self._pad
        Jc = torch.zeros_like(S_c)
        # (nz, chunk, nx, ny); on a split grid a padded tile, its halos
        # filled once for the chunk
        S_t = pad(S_c.transpose(0, 1))
        for group in self.plan_groups:
            if len(group) == 1:
                (i, _, _) = group[0]
                plan = self.plans[i]
                a_t = pad(self._alpha_tot(quad.k[i], lam_c, populations,
                                          damp_c, g_cell))
                I = sweep(plan, S_t, a_t, pad(self._I0(lam_c, plan.up)),
                          n_sweeps=self.cfg.n_sweeps, halo=self.halo)
                # in-place J accumulation (one direction: no J halves,
                # so no group_fold)
                Jc.add_(float(quad.weights[i])
                        * self._strip(I).transpose(0, 1))
                continue
            # the boundary follows the ORIGINAL direction (fz = originally
            # down, z-flip-canonicalized)
            I0_list = [pad(self._I0(lam_c, not fz))
                       for (_, _, (_, _, fz)) in group]
            args = (tuple(p for (_, p, _) in group), S_t)
            kw = dict(I0_list=I0_list,
                      w=[float(quad.weights[i]) for (i, _, _) in group],
                      n_sweeps=self.cfg.n_sweeps,
                      flips=tuple(f for (_, _, f) in group), halo=self.halo,
                      out=Jc)
            if self.halo is None:
                # one launch writes every angle's extinction into its
                # flipped block of the group's stack, which the sweep
                # frees (passed as an argument only)
                sweep_group_J_stack(*args, self._alpha_tot_group(
                    group, lam_c, populations, damp_c, g_cell), **kw)
            else:
                # a split grid: each angle's tile is padded with its halos
                # and flipped locally (Halo.with_flips acts per tile), so
                # the extinctions stay per angle, padded and stacked by
                # sweep_group_J; G3 adds the tiles' interiors into Jc
                sweep_group_J(*args, [pad(self._alpha_tot(
                    quad.k[i], lam_c, populations, damp_c, g_cell))
                    for (i, _, _) in group], **kw)
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
        return S, pops, _lam.global_max(self._world(), diff)

    def run(self, checkpoint=None):
        if self.cfg.stream_rates:
            return _run_iteration_streamed(self, checkpoint)
        return _run_iteration(self, checkpoint)


# --------------------------------------------------------- voronoi grid

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
                 plans=None, device=None, lam_group=None, mesh=None):
        super().__init__(line, cfg, quadrature, device, lam_group, mesh)
        self.sites = sites
        self.plans = list(plans) if plans is not None else \
            self.build_plans(sites, self.quad, cfg)
        self.site_block = slice(0, sites.n)
        self._T_sites = None
        if mesh is not None:
            self._attach_mesh(mesh)
        self._frozen_setup(sites)
        self._bc_sites = [torch.as_tensor(np.asarray(p.bc_sites,
                                                     dtype=np.int64),
                                          device=self.device)
                          for p in self.plans]
        # the slot plans and their device arrays, built here rather
        # than in the first J pass
        for p in self.plans:
            device_plan(p, cfg.n_sweeps, self.device, self.dtype)

    def _split_space(self, mesh):
        """The block of sites of the mesh's site axis; the boundary
        sites' temperatures of every plan stay whole (_T_sites)."""
        axis = mesh.site_axis()
        if axis is not None and mesh.size(axis) > 1:
            self.site_block = mesh.block(axis, self.sites.n)
            self._T_sites = self._field(self.sites.temperature)

    def _space_index(self):
        return (self.site_block,)

    def grid_shape(self):
        """The whole grid's shape, (n_sites,)."""
        return (self.sites.n,)

    def _site_split(self):
        return self._T_sites is not None

    @staticmethod
    def build_plans(sites, quad, cfg: Config):
        """Host-side plan construction for every quadrature direction
        (disk-cached when cfg.cache_dir is set)."""
        return [build_voronoi_plan(
            sites, quad.k[i], bool(quad.is_up[i]), p=cfg.upwind_exponent,
            compat=cfg.compat, order=cfg.voronoi_order,
            n_sweeps=cfg.n_sweeps, cache_dir=cfg.cache_dir)
            for i in range(quad.n_angles)]

    def _alpha_tot_T(self, *args, **kwargs):
        """The extinction site-major, (n, nlam), the counterpart of the
        JAX package's _alpha_tot_g_T: compute_J's one call of it, which
        tools/profile_voronoi.py times apart."""
        return self._alpha_tot(*args, **kwargs)

    def _I0(self, i, lam_c, static=None):
        """Boundary intensity on plan i's bc sites: B(T) at the bottom
        layer for up sweeps, dark for down sweeps
        (lambda_iteration.jl:99-102)."""
        bc = self._bc_sites[i].to(lam_c.device)
        if self.plans[i].up:
            T = static["T"] if static else (
                self._T_sites if self._site_split() else self.T)
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
        # on a split site axis the sweeps read every site: S and each
        # direction's extinction are gathered, J is kept for the block
        def whole(A):
            return (gather_space(A, self.mesh, dims=(0,))
                    if self._site_split() else A)

        state, static = self._slots(S_T=whole(S_c.T.contiguous()),
                                    damping=damp_c, populations=populations,
                                    lam=lam_c)
        partials = {}
        for i, plan in enumerate(self.plans):
            slot = _ang.angle_device(self, i) if self.angle_devices else 0
            st, dst = state[slot], static[slot]
            a_T = whole(self._alpha_tot_T(
                quad.k[i], st["lam"], st["populations"], st["damping"],
                g_cell, static=dst))
            I_T = sweep_voronoi_t(plan, st["S_T"], a_T,
                                  self._I0(i, st["lam"], dst),
                                  n_sweeps=cfg.n_sweeps,
                                  relax_tol=cfg.voronoi_relax_tol)[
                                      self.site_block]
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


def _placement(engine, rank):
    """(rows, index, lam_index) of a world rank's share: its rows of the
    line, the index of its tile (or block of sites) in an array over the
    whole grid, and its coordinate on the lambda axis."""
    n_lam = engine.line.n_lambda
    if engine.mesh is None:           # a lambda group spanning the world
        k = n_lam // engine.lam_group.size
        return slice(rank * k, (rank + 1) * k), (slice(None),), rank
    mesh = engine.mesh
    at = mesh.coords_of(rank)
    if hasattr(engine, "atmos"):
        _, nx, ny = engine.atmos.shape
        index = (slice(None), mesh.block("x", nx, rank),
                 mesh.block("y", ny, rank))
    else:
        axis = mesh.site_axis()
        index = ((mesh.block(axis, engine.sites.n, rank),) if axis
                 else (slice(None),))
    return mesh.block("lam", n_lam, rank), index, at.get("lam", 0)


def _host_state(engine, populations, S):
    """The whole populations and S of a split run as numpy arrays of the
    working dtype on world rank 0 ((None, None) on the others): each
    rank's rows of S, one row at a time, and the populations of each
    tile (from the rank at lambda coordinate 0), each one broadcast, so
    no whole cube is ever on the card."""
    world = engine._world()
    root = world.rank == 0
    whole = engine.grid_shape()
    host = np.dtype(engine.cfg.dtype)
    S_host = (np.empty((engine.line.n_lambda,) + whole, host)
              if root else None)
    P_host = np.empty(whole + (3,), host) if root else None
    for r in range(world.size):
        rows, index, lam_index = _placement(engine, r)
        for j in range(rows.stop - rows.start):
            row = _lam._broadcast(world, S[j], r)
            if root:
                S_host[(rows.start + j,) + index] = row.cpu().numpy()
        if lam_index == 0:
            tile = _lam._broadcast(world, populations, r)
            if root:
                P_host[index] = tile.cpu().numpy()
    return P_host, S_host


def _write_state(engine, checkpoint, populations, S):
    """checkpoint.write_state of the whole state: on one rank directly;
    in a split run gathered to rank 0 (_host_state), which alone
    writes."""
    world = engine._world()
    if world is None:
        checkpoint.write_state(populations, S)
        return
    P_host, S_host = _host_state(engine, populations, S)
    if world.rank == 0:
        checkpoint.write_state(P_host, S_host)


def _write_convergence(engine, checkpoint, iteration, diff):
    """checkpoint.write_convergence on rank 0 of a split run (every
    rank holds the same criterion), else directly."""
    world = engine._world()
    if world is None or world.rank == 0:
        checkpoint.write_convergence(iteration, diff)


def _run_iteration(engine, checkpoint=None, start_iteration=0, S_init=None,
                   populations_init=None):
    """Host-side while loop: iterate until converged (Lambda_regular and
    Lambda_voronoi, lambda_iteration.jl:116-297), checkpointing like the
    reference (lambda_iteration.jl:188-189,280-281): the criterion of
    every loop head goes to checkpoint.write_convergence, the state to
    checkpoint.write_state every cfg.checkpoint_every iterations (the
    only iterations that copy S to the host).  Starts from S_init /
    populations_init (numpy arrays or tensors over the whole grid and
    line, cut to the rank's share and placed on the engine's device),
    else the engine's loaded state, else B0 / LTE.  On a resume
    (start_iteration > 0) the first criterion compares against zeros and
    records a spurious 1.0, as the JAX package does.  A split run writes
    through rank 0 (_write_state, _write_convergence); every rank runs
    the gathers."""
    cfg = engine.cfg
    line = engine.line

    if populations_init is not None:
        populations = engine._field(engine._cut(populations_init))
    elif engine.populations_start is not None:
        populations = engine.populations_start
    else:
        populations = engine.lte
    if S_init is not None:
        S_new = engine._field(engine._cut(engine._rows(S_init), 1))
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
        diff = _criterion(S_new, S_old, engine._world())
        convergence.append(diff)
        if checkpoint is not None:
            _write_convergence(engine, checkpoint, i + 1, diff)
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
            # the damping cube for the J pass; the rates take the
            # per-cell gamma (one R1 launch over all of J's rows)
            damping_lam = engine.damping_lam(populations)
            J = engine.compute_J(S_old, populations, damping_lam)
            del damping_lam
            g_cell = engine._gamma_cell(populations)
            S_new = _update_S(line, engine.eps, J, engine.B0)
            populations = _rates_and_populations(
                line, J, g_cell, engine.lte, engine.C, engine.T,
                engine.nH, cfg.compat)
            del g_cell
        _sync(populations)
        timings.append(time.perf_counter() - t0)

        if checkpoint is not None and i % cfg.checkpoint_every == 0:
            _write_state(engine, checkpoint, populations, S_new)
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
    populations = (engine.populations_start
                   if engine.populations_start is not None else engine.lte)
    S = engine.S_start if engine.S_start is not None else engine.B0
    engine.B0 = engine.S_start = None
    convergence = [1.0]
    timings = []
    if checkpoint is not None:
        _write_convergence(engine, checkpoint, 1, 1.0)
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
            _write_convergence(engine, checkpoint, i + 1, diff)
            if (i - 1) % cfg.checkpoint_every == 0:
                _write_state(engine, checkpoint, populations, S)
        if diff > cfg.eps and i < cfg.maxiter:
            print(f"Iteration {i + 1}...")
    converged = convergence[-1] <= cfg.eps
    print(("Converged in %d iterations" % i) if converged
          else "Did not converge inside scope")
    return NLTEResult(J=None, S=S, alpha_cont=engine.a_cont,
                      populations=populations, convergence=convergence,
                      iterations=i, converged=converged, timings=timings)
