"""Regular-grid short-characteristics sweep.

Port of voronoirt_tpu/solvers/sweep_regular.py (reference
src/characteristics.jl short_characteristics_up/_down and its six
*_ray kernels).  The numpy plan builders are carried over verbatim (the
JAX module imports jax at its top) and held equal to the originals by
the tests.

Field layout: (nz, B, Nx, Ny), B any batch (wavelengths, or angles x
wavelengths in a group sweep); boundary intensity I0: (B, Nx, Ny).

Every z-step goes through one of the kernel wrappers:
  * xy case (upwind point in the previous plane): xy_segment.xy_segment,
    one launch a segment, or a piece of one of at most
    xy_segment.piece_steps() planes (the JAX package's lax.scan over
    the segment); on a split grid xy_plane.xy_plane, one launch a plane;
  * yz / xz cases (in-plane dependency, the reference's n_sweeps
    Gauss-Seidel passes with its one-line buffer): march_plane.march_plane,
    one launch a plane.
All take the direction geometry per batch element, so the single-
direction `sweep` is the batched sweep with one plan.  A mirror group's
sweep (sweep_group_J) goes through solvers/group_emit.py around them:
group_stack (G2) makes its flipped S and I0 stacks, group_emit (G1)
reduces each piece or plane the sweep makes over the angles into the J
halves, group_fold (G3) adds the halves into the chunk's J.

Reference quirks reproduced (see the JAX module): the yz/xz upwind
column is at ix + sign while the line buffer holds the previous line;
the buffer starts at zero once and persists across passes; xz_down
reads its centre alpha/S from the upper plane.

interpolation='bezier' (the single-direction `sweep` only, as in the JAX
package) runs each xy segment with the quadratic-Bezier update (the JAX
package runs it as plain XLA outside any Pallas kernel): on an unsplit
grid through xy_bezier_segment.xy_bezier_segment, one launch a segment,
written straight into the sweep's output; on a split grid, or a plane whose band does not fit
that kernel (xy_bezier_segment.fits, a rule of the shape taken before
any launch), through xy_bezier.xy_bezier, one launch a plane (X1).  The
marching segments stay linear and go through march_plane as ever.

halo: on a grid split over ranks in x and / or y (parallel/mesh.Halo),
S, alpha and I0 are the rank's padded tiles, halos filled.  An xy step
runs on the padded planes unchanged (its periodic wrap spoils only the
halo cells of its output) and the carried plane's halo is refilled
after it.  A yz / xz segment gathers the carried plane and each alpha
and S plane it reads over the split axes, marches on the whole planes
(on every rank alike) and keeps its tile of every plane it makes.  The
emitted planes are padded tiles; their interior is the rank's share.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .group_emit import flip_field, group_emit, group_fold, group_stack
from .march_plane import march_plane
from .xy_bezier import xy_bezier
from .xy_bezier_segment import fits as bezier_fits
from .xy_bezier_segment import xy_bezier_segment
from .xy_plane import xy_plane
from .xy_segment import piece_steps, xy_segment


# --------------------------------------------------------------- planning

def xy_intersect(k):
    """Loop-direction signs from the k quadrant (functions.jl:430-457)."""
    if k[1] > 0 and k[2] > 0:
        return -1, -1
    if k[1] < 0 and k[2] > 0:
        return 1, -1
    if k[1] < 0 and k[2] < 0:
        return 1, 1
    if k[1] > 0 and k[2] < 0:
        return -1, 1
    return 1, 1


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of z-steps sharing one plane-cut case."""
    case: str              # 'xy' | 'yz' | 'xz'
    steps: tuple           # z indices of the planes computed (march order)
    r: tuple               # path length per step [m]
    fx: tuple              # x stencil fraction per step (xy case)
    fy: tuple              # y stencil fraction per step (xy case)
    w_cur: tuple           # current-plane z-interp weight (yz/xz case)


@dataclasses.dataclass(frozen=True)
class RegularPlan:
    """Static sweep plan for one direction over one z grid."""
    k: tuple
    up: bool
    sign_x: int            # march/loop signs (xy_intersect)
    sign_y: int
    sxs: int               # stencil base shift in x: 0 if k_x>=0 else -1
    sys: int               # stencil base shift in y
    r_x: float             # dx/|k_x|
    r_y: float             # dy/|k_y|
    fy_line: float         # static y fraction for the yz case
    fx_line: float         # static x fraction for the xz case
    segments: tuple        # of Segment


def build_plan(k, z, dx, dy, up):
    """Compile the sweep schedule for direction k (host side): the
    per-z `plane_cut = argmin([r_z, r_x, r_y])` dispatch of
    characteristics.jl:71,160 with all interpolation geometry."""
    k = np.asarray(k, dtype=np.float64)
    sign_x, sign_y = xy_intersect(k)
    r_x = abs(dx / k[1]) if k[1] != 0 else np.inf
    r_y = abs(dy / k[2]) if k[2] != 0 else np.inf
    sxs = 0 if k[1] >= 0 else -1
    sys = 0 if k[2] >= 0 else -1

    # static in-line fractions for the marching cases
    if np.isfinite(r_x):
        uy = r_x * k[2]
        fy_line = float(np.clip(uy / dy - sys, 0.0, 1.0))
    else:
        fy_line = 1.0
    if np.isfinite(r_y):
        ux = r_y * k[1]
        fx_line = float(np.clip(ux / dx - sxs, 0.0, 1.0))
    else:
        fx_line = 1.0

    nz = len(z)
    if up:
        steps = range(1, nz)
        dz_of = lambda i: z[i] - z[i - 1]
    else:
        steps = range(nz - 2, -1, -1)
        dz_of = lambda i: z[i + 1] - z[i]

    raw = []
    for i in steps:
        dz = dz_of(i)
        r_z = abs(dz / k[0]) if k[0] != 0 else np.inf
        case = ("xy", "yz", "xz")[int(np.argmin([r_z, r_x, r_y]))]
        if case == "xy":
            r = r_z
            fx = np.clip(r * k[1] / dx - sxs, 0.0, 1.0) if np.isfinite(r) else 1.0
            fy = np.clip(r * k[2] / dy - sys, 0.0, 1.0) if np.isfinite(r) else 1.0
            w_cur = 0.0
        else:
            # z interp weight of the CURRENT plane row (see the JAX module)
            r = r_x if case == "yz" else r_y
            fx = fy = 0.0
            t = r * abs(k[0]) / dz
            w_cur = 1.0 - t
        raw.append((case, i, float(r), float(fx), float(fy), float(w_cur)))

    segments = []
    for (case, i, r, fx, fy, wc) in raw:
        if segments and segments[-1][0] == case:
            segments[-1][1].append((i, r, fx, fy, wc))
        else:
            segments.append([case, [(i, r, fx, fy, wc)]])
    segs = tuple(Segment(case=case,
                         steps=tuple(it[0] for it in items),
                         r=tuple(it[1] for it in items),
                         fx=tuple(it[2] for it in items),
                         fy=tuple(it[3] for it in items),
                         w_cur=tuple(it[4] for it in items))
                 for case, items in segments)

    return RegularPlan(k=tuple(k), up=up, sign_x=sign_x, sign_y=sign_y,
                       sxs=sxs, sys=sys, r_x=float(r_x), r_y=float(r_y),
                       fy_line=fy_line, fx_line=fx_line, segments=segs)


def plan_signature(plan: RegularPlan):
    """Structural identity of a plan: plans with equal signatures share
    one batched sweep."""
    return (plan.up, plan.sign_x, plan.sign_y, plan.sxs, plan.sys,
            tuple((s.case, s.steps) for s in plan.segments))


def canonical_flips(k):
    """Axis flips taking direction k to the canonical quadrant."""
    return bool(k[1] < 0), bool(k[2] < 0)


def group_plans(ks, ups, z, dx, dy, max_group=None):
    """Bucket quadrature directions by canonical plan signature.

    Returns a list of groups, each a list of (angle_index,
    canonical_plan, (flip_x, flip_y, flip_z)).  Down sweeps are
    z-flip-canonicalized into up sweeps; max_group caps the angles per
    group.  Same grouping as the JAX package.
    """
    z = np.asarray(z)
    # z-flipped axis: ascending, with the dz sequence reversed
    zf = z[0] + (z[-1] - z[::-1])
    groups = {}
    for i, (k, up) in enumerate(zip(ks, ups)):
        fx, fy = canonical_flips(k)
        fz = not bool(up)
        kc = np.array([-abs(k[0]), abs(k[1]), abs(k[2])])
        plan = build_plan(kc, zf if fz else z, dx, dy, True)
        sig = plan_signature(plan)
        groups.setdefault(sig, []).append((i, plan, (fx, fy, fz)))
    out = list(groups.values())
    if max_group is not None and max_group >= 1:
        out = [g[j:j + max_group] for g in out
               for j in range(0, len(g), max_group)]
    return out


# ----------------------------------------------------------------- sweep

def _per_element(vals, B_lam, ref):
    """P per-plan values (scalars, or per-step tuples of length L) ->
    (P*B_lam,) or (L, P*B_lam) tensor, each plan's value repeated over
    its B_lam batch block."""
    a = np.asarray(vals, dtype=np.float64)
    a = np.repeat(a.T if a.ndim == 2 else a, B_lam, axis=-1)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=ref.dtype,
                           device=ref.device)


def _xy_step_bezier(plan, I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp,
                    r, fx, fy, r_prev, fx_prev, fy_prev, first):
    """xy plane update with quadratic-Bezier source integration
    (sweep_regular._xy_step_bezier of the JAX package) through
    xy_bezier.xy_bezier, X1 on a CUDA tensor, with the plan's stencil
    base shifts."""
    return xy_bezier(I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp, r, fx,
                     fy, r_prev, fx_prev, fy_prev, first, plan.sxs, plan.sys)


def _xy_segment_bezier(plan, seg, S, alpha, carry, emit, refill,
                       out=None):
    """One xy segment of a single-direction sweep, Bezier update; returns
    the carried plane after it.  The second-upwind plane index is
    clamped at the boundary; at the segment's first step the previous
    step's ray geometry repeats this step's and `first` selects the
    secant slope.

    out: the sweep's output cube, on an unsplit grid whose plane fits
    xy_bezier_segment: one launch for the segment, each plane written
    into out at its index (emit is not called for them).  None (a split grid, or a plane that does not fit): one
    X1 launch a plane, each emitted; refill is then the carried plane's
    halo refill on a split grid (two cells: the second-upwind sample
    composes two one-sided stencils), else the identity."""
    nz = S.shape[0]
    dirn = 1 if plan.up else -1
    if out is not None:
        return xy_bezier_segment(alpha, S, carry, seg.steps, dirn, seg.r,
                                 seg.fx, seg.fy, plan.sxs, plan.sys, out)
    for j, t in enumerate(seg.steps):
        jp = max(j - 1, 0)
        t2 = min(max(t - 2 * dirn, 0), nz - 1)
        carry = refill(_xy_step_bezier(
            plan, carry, alpha[t], alpha[t - dirn], S[t], S[t - dirn],
            alpha[t2], S[t2], seg.r[j], seg.fx[j], seg.fy[j],
            seg.r[jp], seg.fx[jp], seg.fy[jp], 1.0 if j == 0 else 0.0))
        emit((t,), carry[None])
    return carry


def _xy_segment_pieces(plan, seg, S, alpha, carry, r, fx, fy, emit):
    """One linear xy segment on an unsplit grid: one xy_segment launch a
    piece of at most xy_segment.piece_steps() planes, then one
    emit(steps, planes) for the piece's planes.  Returns the carried
    plane after the segment."""
    dirn = 1 if plan.up else -1
    L = len(seg.steps)
    n = min(L, piece_steps(*carry.shape, carry.dtype))
    buf = torch.empty((n,) + tuple(carry.shape), dtype=carry.dtype,
                      device=carry.device)
    for j0 in range(0, L, n):
        j1 = min(j0 + n, L)
        out = xy_segment(alpha, S, carry, seg.steps[j0:j1], dirn, r[j0:j1],
                         fx[j0:j1], fy[j0:j1], plan.sxs, plan.sys,
                         buf[:j1 - j0])
        emit(seg.steps[j0:j1], out)
        # the next piece reuses buf: carry a copy of its last plane
        carry = out[-1].clone() if j1 < L else out[-1]
    return carry


def _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags, emit,
                        interpolation="linear", halo=None, out=None):
    """Shared body of sweep / sweep_batched / sweep_batched_J.

    Runs the batched multi-angle sweep and calls emit(steps, planes) on
    the computed intensity planes, (L, P*B, Nx, Ny) for the L
    consecutive z indices `steps` (a piece of an xy segment at once, a
    march or split-grid step and the boundary plane one at a time), so
    that every plane is emitted once.
    interpolation='bezier' is for one plan only (`sweep`), whose output
    cube `out` the Bezier xy segments write into directly on an unsplit
    grid (their planes are not emitted).  halo: the split grid's
    parallel/mesh.Halo (S, alpha, I0 and the planes padded tiles), or
    None.
    """
    lead = plans[0]
    nz = S.shape[0]
    B_lam = S.shape[1] // len(plans)
    if down_flags is None:
        down_flags = tuple(not p.up for p in plans)
    if halo is not None and interpolation == "bezier" and halo.width < 2:
        raise ValueError("the Bezier xy step needs a halo of 2 cells")
    refill = halo.refill if halo is not None else (lambda P: P)
    S, alpha = S.contiguous(), alpha.contiguous()
    carry = I0.contiguous()
    emit((0 if lead.up else nz - 1,), carry[None])
    dirn = 1 if lead.up else -1

    for si, seg in enumerate(lead.segments):
        segs_p = [p.segments[si] for p in plans]
        if seg.case == "xy" and interpolation == "bezier":
            direct = out if halo is None and bezier_fits(*S.shape[2:]) \
                else None
            carry = _xy_segment_bezier(lead, seg, S, alpha, carry, emit,
                                       refill, direct)
            continue
        if seg.case == "xy":
            r = _per_element([s.r for s in segs_p], B_lam, S)
            fx = _per_element([s.fx for s in segs_p], B_lam, S)
            fy = _per_element([s.fy for s in segs_p], B_lam, S)
            if halo is None:
                carry = _xy_segment_pieces(lead, seg, S, alpha, carry, r,
                                           fx, fy, emit)
                continue
            # split grid: one plane a launch, the carried plane's halo
            # refilled after each (the padded tiles are not periodic)
            for j, t in enumerate(seg.steps):
                carry = refill(xy_plane(alpha[t - dirn], alpha[t],
                                        S[t - dirn], S[t], carry, r[j],
                                        fx[j], fy[j], lead.sxs, lead.sys))
                emit((t,), carry[None])
            continue
        if seg.case == "yz":
            f_line = _per_element([p.fy_line for p in plans], B_lam, S)
            r = _per_element([p.r_x for p in plans], B_lam, S)
            statics = dict(march_axis="x", sign=lead.sign_x,
                           s_base=lead.sys, n_sweeps=n_sweeps)
        else:
            f_line = _per_element([p.fx_line for p in plans], B_lam, S)
            r = _per_element([p.r_y for p in plans], B_lam, S)
            statics = dict(march_axis="y", sign=lead.sign_y,
                           s_base=lead.sxs, n_sweeps=n_sweeps)
        # the xz centre quirk: originally-down angles read centre alpha/S
        # from the upper plane = the prev plane in canonical (z-flipped)
        # coordinates; a 0/1 per-element blend keeps mixed groups exact
        c_prev = _per_element(
            [float(d and seg.case == "xz") for d in down_flags], B_lam, S)
        w_cur = _per_element([s.w_cur for s in segs_p], B_lam, S)
        if halo is None:
            for j, t in enumerate(seg.steps):
                carry = march_plane(alpha[t - dirn], alpha[t], S[t - dirn],
                                    S[t], carry, r, f_line, w_cur[j], c_prev,
                                    **statics)
                emit((t,), carry[None])
            continue
        # split grid: march on whole planes, gathered as the march
        # reaches them (each upper plane is the next step's lower one)
        t0 = seg.steps[0]
        whole = halo.gather(carry)
        a_p, s_p = halo.gather(alpha[t0 - dirn]), halo.gather(S[t0 - dirn])
        for j, t in enumerate(seg.steps):
            a_c, s_c = halo.gather(alpha[t]), halo.gather(S[t])
            whole = march_plane(a_p, a_c, s_p, s_c, whole, r, f_line,
                                w_cur[j], c_prev, **statics)
            carry = halo.slab(whole)
            emit((t,), carry[None])
            a_p, s_p = a_c, s_c


def _stacker(out):
    def emit(steps, planes):
        for t, plane in zip(steps, planes):
            out[t] = plane
    return emit


def sweep(plan: RegularPlan, S, alpha, I0, n_sweeps=3,
          interpolation="linear", halo=None):
    """Formal solution along direction plan.k over the whole grid.

    S, alpha: (nz, B, Nx, Ny); I0: (B, Nx, Ny) boundary intensity
    (bottom plane for up sweeps, top for down; lambda_iteration.jl:38-52).
    interpolation: 'linear' (reference parity) or 'bezier' (quadratic
    DELO-Bezier source integration in the xy segments; the marching
    segments stay linear, their one-line buffer has no second-upwind
    sample).  Returns I: (nz, B, Nx, Ny).  Equivalent of
    short_characteristics_up/_down (characteristics.jl:19,110).  halo:
    on a split grid (parallel/mesh.Halo), S, alpha, I0 and I are padded
    tiles.
    """
    if interpolation not in ("linear", "bezier"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    out = torch.empty(S.shape, dtype=S.dtype, device=S.device)
    _sweep_batched_impl((plan,), S, alpha, I0, n_sweeps, None, _stacker(out),
                        interpolation, halo, out)
    return out


def sweep_batched(plans, S, alpha, I0, n_sweeps=3, down_flags=None):
    """One sweep for several same-signature (canonical) directions.

    S, alpha: (nz, P*B, Nx, Ny), the per-angle fields (already flipped)
    stacked along the batch axis; I0: (P*B, Nx, Ny); down_flags: which
    plans were originally down sweeps.  Returns I: (nz, P*B, Nx, Ny).
    """
    out = torch.empty(S.shape, dtype=S.dtype, device=S.device)
    _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags,
                        _stacker(out))
    return out


def sweep_batched_J(plans, S, alpha, I0, w, n_sweeps=3, down_flags=None,
                    unflips=None, halo=None):
    """Batched multi-angle sweep emitting the weighted J contribution.

    The planes are reduced over the P angle blocks as the sweep makes
    them, one group_emit (G1) a piece of an xy segment or a plane of the
    march: J_up[t] = sum over the originally-up angles e of w[e] *
    unflip_xy(I[t][e*B:(e+1)*B]), J_dn[t] over the originally-down ones,
    so the (nz, P*B, Nx, Ny) intensity cube never exists.  Every plane
    is emitted once, so G1 writes J_up and J_dn whole.  Returns (J_up,
    J_dn), each (nz, B, Nx, Ny) in canonical z order.  halo: on a split
    grid, the batch's parallel/mesh.Halo with each element's flips
    (fields, planes and J padded tiles).
    """
    P = len(plans)
    B_lam = S.shape[1] // P
    if unflips is None:
        unflips = tuple((False, False) for _ in plans)
    if down_flags is None:
        down_flags = tuple(not p.up for p in plans)
    w = torch.as_tensor(w, dtype=S.dtype, device=S.device)
    shape = (S.shape[0], B_lam) + tuple(S.shape[2:])
    J_up = torch.empty(shape, dtype=S.dtype, device=S.device)
    J_dn = torch.empty_like(J_up)

    def emit(steps, planes):
        group_emit(planes, steps, w, down_flags, unflips, J_up, J_dn)

    _sweep_batched_impl(plans, S, alpha, I0, n_sweeps, down_flags, emit,
                        halo=halo)
    return J_up, J_dn


def sweep_group_J(plans, S, a_list, I0_list, w, n_sweeps=3, flips=None,
                  halo=None, out=None):
    """One angle group's weighted J contribution from raw fields.

    S: shared source function (nz, B, Nx, Ny); a_list: P per-angle
    extinctions of S's shape; I0_list: P boundary planes (B, Nx, Ny);
    w: (P,) quadrature weights; flips: P (flip_x, flip_y, flip_z) from
    group_plans.  Returns the group's J (nz, B, Nx, Ny), physical
    orientation; with `out`, adds it into out instead (see
    sweep_group_J_stack).  halo: on a split grid, the grid's
    parallel/mesh.Halo; S, the extinctions, I0 and J are then padded
    tiles (a padded tile flipped locally is the mirrored position's
    padded tile of the flipped field, so the flips stay local).  The
    extinctions are flipped and stacked here; sweep_group_J_stack takes
    the stack made already (physics/extinction.py alpha_tot_group).
    """
    if flips is None:
        flips = tuple((False, False, False) for _ in plans)
    # the stack passed as an argument only, so the callee frees it
    return sweep_group_J_stack(
        plans, S, torch.cat([flip_field(a, *f) for a, f in zip(a_list, flips)],
                            dim=1), I0_list, w, n_sweeps, flips, halo, out)


def sweep_group_J_stack(plans, S, a_b, I0_list, w, n_sweeps=3, flips=None,
                        halo=None, out=None):
    """sweep_group_J from the group's extinction stack a_b (nz, P*B, Nx,
    Ny): angle e's extinction flipped by flips[e], in block [:, e*B:(e +
    1)*B].  group_stack (G2) makes the S and I0 stacks from S (any
    strides, e.g. the transposed view of a lambda chunk's S) and the
    boundary planes, the sweep emits the J halves through group_emit
    (G1), and group_fold (G3) adds J_up + flip_z(J_dn) into a (B, nz,
    Nx, Ny) tensor: `out`, the lambda chunk's J (on a split grid the
    tile's interior), which is returned, or else a zeroed one whose
    transpose, the group's J (nz, B, Nx, Ny) (the padded tile on a split
    grid), is returned.  The stacks are freed before the fold, so a
    caller that passes a_b as an argument expression frees it there."""
    if flips is None:
        flips = tuple((False, False, False) for _ in plans)
    strip = (lambda A: A) if halo is None or out is None else halo.strip
    if halo is not None:
        B_lam = S.shape[1]
        mask = [torch.tensor([f[a] for f in flips for _ in range(B_lam)],
                             device=S.device) for a in (0, 1)]
        halo = halo.with_flips(*mask)
    S_b = group_stack([S] * len(flips), flips)
    I0_b = group_stack(list(I0_list), [f[:2] for f in flips])
    J_up, J_dn = sweep_batched_J(plans, S_b, a_b, I0_b, w,
                                 n_sweeps=n_sweeps,
                                 down_flags=tuple(f[2] for f in flips),
                                 unflips=tuple((f[0], f[1]) for f in flips),
                                 halo=halo)
    del S_b, a_b, I0_b
    if out is not None:
        return group_fold(out, strip(J_up), strip(J_dn))
    nz, B_lam = J_up.shape[:2]
    J = torch.zeros((B_lam, nz) + tuple(J_up.shape[2:]), dtype=J_up.dtype,
                    device=J_up.device)
    return group_fold(J, J_up, J_dn).transpose(0, 1)


# ------------------------------------------------------------ public API

def short_characteristics(k, S, alpha, I0, z, dx, dy, up, n_sweeps=3,
                          plan=None, interpolation="linear"):
    """Convenience wrapper building (or reusing) the plan.

    S/alpha: (nz, Nx, Ny) or (nz, B, Nx, Ny) tensors; I0 (Nx, Ny) or
    (B, Nx, Ny).  Returns the intensity with matching shape.
    """
    squeeze = S.dim() == 3
    if squeeze:
        S, alpha, I0 = S[:, None], alpha[:, None], I0[None]
    if plan is None:
        plan = build_plan(k, np.asarray(z), dx, dy, up)
    I = sweep(plan, S, alpha, I0, n_sweeps=n_sweeps,
              interpolation=interpolation)
    return I[:, 0] if squeeze else I
