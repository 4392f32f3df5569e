"""Line-plus-continuum extinction and the bound-bound Voigt profile:
CUDA kernel wrappers + plain versions.

Counterpart of voronoirt_tpu/engine/lambda_iter.py:122-171
(_alpha_tot, _alpha_tot_g_impl, _alpha_tot_g_t, _alpha_tot_g_T), which
the JAX package compiles into one program a lambda chunk and direction,
of the flipped concatenation of a mirror group's extinctions in
voronoirt_tpu/solvers/sweep_regular.py sweep_group_J, and of the
profile in voronoirt_tpu/physics/rates.py sigma_ij_bb.

alpha_tot computes, for every cell of a per-cell field and every
wavelength of a chunk,

  damping  a     = g lam^2 / (4 pi c dlamD)         (or the rows `damp`)
  shift    v     = (lam - lam0 + lam0 v_los / c) / dlamD
  line     f     = hc/(4 pi lam0) (n_i Bij - n_j Bji) / (sqrt(pi) dlamD)
  alpha          = H(a, v) f + alpha_cont

written straight into the sweep's layout: the wavelength axis second,
(nz, B, nx, ny) for a regular grid's (nz, nx, ny) fields, (n, B) for a
Voronoi grid's (n,) sites.  alpha_tot_group does the same for the P
angles of a mirror group at once, from the velocity field (v_los = v .
(-k) for each angle), each angle's block flipped into the canonical
quadrant of the group's stack (nz, P B, nx, ny) that sweep_group_J_stack
sweeps.  voigt_rows is the rates' profile alone, H(a, v) / (sqrt(pi)
dlamD) with v = (lam - lam0) / dlamD, in the (nb, ...) layout of its
damping rows.

Kernels: csrc/extinction.cu (vrt_alpha_tot for both E1 wrappers,
vrt_voigt_rows), one launch a call; one thread a cell loops over the
angles and wavelengths and evaluates only its own Humlicek region, in
the plain version's arithmetic on the card, so the two agree bit for
bit there.  E1 has its own Humlicek evaluator (_e1_H: the real part of
regions III's and IV's quotient with one division) and folds the
profile's denominator into the per-cell f; E2's is physics/voigt.py's.
The plain versions are eager PyTorch: one wavelength plane at a time on
a regular grid, blocks of about _EXT_POINTS points on the sites, the
rates' profile through voigt_profile's slabs.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c_0, hc
from .atom import line_of_sight_velocity
from .broadening import damping
from .voigt import _SLAB, _SQRT_PI, voigt_profile

# kernel launches so far (not counting the plain versions)
LAUNCHES = 0            # alpha_tot
GROUP_LAUNCHES = 0      # alpha_tot_group
VOIGT_LAUNCHES = 0      # voigt_rows
# the most angles of one alpha_tot_group launch (E1_MAX_ANGLES of
# csrc/extinction.cu): a mirror group holds at most the 4 xy quadrants
# of an up and a down direction
MAX_ANGLES = 8
# points per block of the plain site-major extinction: the eager Voigt's
# complex temporaries stay one voigt_H slab in size
_EXT_POINTS = 1 << 24


def out_shape(cells, B):
    """The sweep layout of B wavelengths over fields of shape `cells`:
    the wavelength axis second."""
    return (cells[0], B) + tuple(cells[1:])


def _re_quot(n, d):
    """Re(n / d) with one division, as csrc/extinction.cu re_quot."""
    return (n.real * d.real + n.imag * d.imag) / (d.real * d.real
                                                 + d.imag * d.imag)


def _e1_H_slab(a, v):
    # humlicek_w's regions and tests (physics/voigt.py), with the real
    # part of regions III's and IV's quotient taken by _re_quot
    t = torch.complex(a, -v)
    av = torch.abs(v)
    s = av + a
    w1 = (t * 0.5641896 / (0.5 + t * t)).real
    u = t * t
    w2 = (t * (1.410474 + u * 0.5641896) / (0.75 + u * (3.0 + u))).real
    w3 = _re_quot(
        16.4955 + t * (20.20933 + t * (11.96482 + t * (
            3.778987 + t * 0.5642236))),
        16.4955 + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (
            6.699398 + t)))))
    # Re u clipped so exp never overflows in the unselected points
    uc = torch.complex(torch.clamp(u.real, -690.0, 690.0), u.imag)
    numer = t * (36183.31 - u * (3321.9905 - u * (1540.787 - u * (
        219.0313 - u * (35.76683 - u * (1.320522 - u * 0.56419))))))
    denom = 32066.6 - u * (24322.84 - u * (9022.228 - u * (
        2186.181 - u * (364.2191 - u * (61.57037 - u * (1.841439 - u))))))
    w4 = torch.exp(uc).real - _re_quot(numer, denom)
    return torch.where(s >= 15.0, w1,
           torch.where(s >= 5.5, w2,
           torch.where(a >= 0.195 * av - 0.176, w3, w4)))


def _e1_H(a, v):
    """E1's Voigt function H(a, v), the plain version of csrc/
    extinction.cu e1_H, evaluated slab-wise like voigt_H."""
    a, v = torch.broadcast_tensors(a, v)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    fa, fv, fo = a.reshape(-1), v.reshape(-1), out.view(-1)
    for s in range(0, fo.numel(), _SLAB):
        fo[s:s + _SLAB] = _e1_H_slab(fa[s:s + _SLAB], fv[s:s + _SLAB])
    return out


def _line_factor(line, populations):
    """The per-cell f = hc/(4 pi lam0) (n_i Bij - n_j Bji) / (sqrt(pi)
    dlamD), rounded as the kernel takes it."""
    pop = populations[..., 0] * line.Bij - populations[..., 1] * line.Bji
    return (pop * (hc / (4.0 * np.pi * line.lam0))) / (line.dlamD * _SQRT_PI)


def alpha_tot_plain(line, lam, v_los, populations, a_cont=None,
                    g_cell=None, damp=None):
    """The plain PyTorch version of alpha_tot."""
    cells = tuple(v_los.shape)
    out = torch.empty(out_shape(cells, lam.shape[0]), dtype=v_los.dtype,
                      device=v_los.device)
    f = _line_factor(line, populations)[None]
    # one wavelength plane a step on a grid, blocks of wavelengths on
    # sites: every op is pointwise, so the values are those of the whole
    # chunk's expression
    step = 1 if len(cells) > 1 else max(1, _EXT_POINTS // max(cells[0], 1))
    for j0 in range(0, lam.shape[0], step):
        lam_j = lam[j0:j0 + step].reshape((-1,) + (1,) * len(cells))
        if damp is not None:
            d = damp[j0:j0 + step]
        else:
            d = damping(g_cell[None], lam_j, line.dlamD[None])
        v = (lam_j - line.lam0 + line.lam0 * v_los[None] / c_0) \
            / line.dlamD[None]
        a = _e1_H(d, v) * f
        if a_cont is not None:
            a = a + a_cont
        out[:, j0:j0 + step] = a.movedim(0, 1)
    return out


def _flip(a, flip_x, flip_y, flip_z):
    """An angle's block (nz, B, nx, ny) mirrored into the group's
    canonical quadrant, as solvers/sweep_regular.py flip_field."""
    dims = [d for d, on in ((0, flip_z), (-2, flip_x), (-1, flip_y)) if on]
    return torch.flip(a, dims) if dims else a


def alpha_tot_group_plain(line, lam, velocity, ks, flips, populations,
                          a_cont=None, g_cell=None, damp=None):
    """The plain PyTorch version of alpha_tot_group: each angle's
    alpha_tot_plain, flipped into its block of the stack."""
    B = lam.shape[0]
    cells = tuple(velocity.shape[:-1])
    out = torch.empty(out_shape(cells, len(ks) * B), dtype=velocity.dtype,
                      device=velocity.device)
    for e, (k, fl) in enumerate(zip(ks, flips)):
        a = alpha_tot_plain(
            line, lam, line_of_sight_velocity(velocity, -np.asarray(k)),
            populations, a_cont, g_cell, damp)
        out[:, e * B:(e + 1) * B] = _flip(a, *fl)
    return out


def voigt_rows_plain(line, lam, damp):
    """The plain PyTorch version of voigt_rows."""
    lam_b = lam.reshape((-1,) + (1,) * line.dlamD.dim())
    v = (lam_b - line.lam0) / line.dlamD[None]
    return voigt_profile(damp, v, line.dlamD[None])


def _same(ref, *ts):
    for t in ts:
        if t is not None and (t.dtype != ref.dtype or t.device != ref.device):
            raise ValueError("all inputs must share dtype and device")


def _need_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_lam(lam):
    if lam.dim() != 1:
        raise ValueError(f"lam must be (B,), got {tuple(lam.shape)}")
    if lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {lam.dtype}")


def _check(line, lam, v_los, populations, a_cont, g_cell, damp):
    _check_lam(lam)
    if (g_cell is None) == (damp is None):
        raise ValueError("give exactly one of g_cell and damp")
    _same(lam, v_los, populations, a_cont, g_cell, damp, line.dlamD)
    cells = tuple(v_los.shape)
    if not cells:
        raise ValueError("v_los must have at least one axis")
    if populations.dim() != len(cells) + 1 or \
            tuple(populations.shape[:-1]) != cells or \
            populations.shape[-1] < 2:
        raise ValueError(f"populations must be {cells} + (levels >= 2,), "
                         f"got {tuple(populations.shape)}")
    _need_shape("line.dlamD", line.dlamD, cells)
    if a_cont is not None:
        _need_shape("a_cont", a_cont, cells)
    if g_cell is not None:
        _need_shape("g_cell", g_cell, cells)
    else:
        _need_shape("damp", damp, (lam.shape[0],) + cells)


def _kernel_inputs(name, *ts):
    """The tensors' device pointers (None stays NULL), once each is
    known to be a contiguous CUDA tensor."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {ts[0].device}")
    if not all(t.is_contiguous() for t in ts if t is not None):
        raise ValueError(f"{name} kernel inputs must be contiguous")
    return [None if t is None else t.data_ptr() for t in ts]


def _launch_e1(line, lam, vel, populations, a_cont, g_cell, damp, out,
               cells, P, ks=None, flips=None):
    """One vrt_alpha_tot launch into `out` over the cells (nz, nx, ny) --
    a site-major or 2-d grid as (cells[0], 1, rest) -- for P angles: the
    velocity (cells, 3) and the angles' ks and flips, or (P = 1) the
    v_los field given as vel.  Returns False, launching nothing, when
    `out` is empty."""
    from ..kernels import build
    ptrs = _kernel_inputs("alpha_tot", vel, lam, g_cell, damp, populations,
                          a_cont, line.dlamD)
    if out.numel() == 0:
        return False
    vel_p, lam_p, g_p, damp_p, pop_p, ac_p, dD_p = ptrs
    nz = cells[0]
    nx, ny = cells[1:] if len(cells) == 3 else (1, int(np.prod(cells[1:])))
    k_arr = np.ascontiguousarray(-np.asarray(ks, dtype=np.float64)) \
        if ks is not None else None
    f_arr = np.asarray([int(fx) | int(fy) << 1 | int(fz) << 2
                        for fx, fy, fz in flips],
                       dtype=np.int32) if flips is not None else None
    fn = build.launch_fn("vrt_alpha_tot", lam.dtype)
    with torch.cuda.device(out.device):
        # PyTorch's CUDA kernel divides by the scalar c_0 as a multiply
        # by 1/c_0 taken in float64 and cast to the tensor's type
        err = fn(lam_p, g_p, damp_p, vel_p, pop_p, ac_p, dD_p,
                 out.data_ptr(), lam.shape[0], P, nz, nx, ny,
                 populations.shape[-1], int(ks is not None),
                 None if k_arr is None else k_arr.ctypes.data,
                 None if f_arr is None else f_arr.ctypes.data,
                 line.lam0, 1.0 / c_0, 4.0 * np.pi * c_0, _SQRT_PI,
                 hc / (4.0 * np.pi * line.lam0), line.Bij, line.Bji,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "alpha_tot")
    return True


def alpha_tot(line, lam, v_los, populations, a_cont=None, *, g_cell=None,
              damp=None):
    """Total extinction [m^-1] of the wavelengths lam (B,) for one
    direction, in the sweep layout out_shape(v_los.shape, B).

    v_los: the line-of-sight velocity a cell (the -k direction folded
    in), shape `cells`; populations: cells + (levels,), n_i = [..., 0],
    n_j = [..., 1]; a_cont: the continuum extinction a cell, or None for
    the line's alone; the damping from exactly one of g_cell (the
    per-cell gamma, cells) and damp (the chunk's rows, (B,) + cells).
    line.dlamD must be of shape `cells`.
    """
    _check(line, lam, v_los, populations, a_cont, g_cell, damp)
    if v_los.device.type == "cpu":
        return alpha_tot_plain(line, lam, v_los, populations, a_cont,
                               g_cell, damp)
    cells = tuple(v_los.shape)
    out = torch.empty(out_shape(cells, lam.shape[0]), dtype=lam.dtype,
                      device=lam.device)
    global LAUNCHES
    LAUNCHES += _launch_e1(line, lam, v_los, populations, a_cont, g_cell,
                           damp, out, cells, 1)
    return out


def _check_group(line, lam, velocity, ks, flips, populations, a_cont,
                 g_cell, damp):
    if velocity.dim() != 4 or velocity.shape[-1] != 3:
        raise ValueError(f"velocity must be (nz, nx, ny, 3), got "
                         f"{tuple(velocity.shape)}")
    if len(ks) != len(flips) or not ks:
        raise ValueError(f"one flip triple an angle: {len(ks)} ks, "
                         f"{len(flips)} flips")
    if len(ks) > MAX_ANGLES:
        raise ValueError(f"at most {MAX_ANGLES} angles a group, got "
                         f"{len(ks)}")
    if any(np.shape(k) != (3,) for k in ks) or \
            any(len(f) != 3 for f in flips):
        raise ValueError("each k is (k_z, k_x, k_y), each flip "
                         "(flip_x, flip_y, flip_z)")
    _check(line, lam, velocity[..., 0], populations, a_cont, g_cell, damp)
    # on every device, so the plain version takes what the kernel takes
    if not all(t.is_contiguous() for t in (velocity, populations, a_cont,
                                           g_cell, damp, line.dlamD)
               if t is not None):
        raise ValueError("alpha_tot_group inputs must be contiguous")


def alpha_tot_group(line, lam, velocity, ks, flips, populations,
                    a_cont=None, *, g_cell=None, damp=None):
    """A mirror group's extinction stack [m^-1], (nz, P B, nx, ny) for
    the P = len(ks) directions and the wavelengths lam (B,): angle e's
    block [:, e B:(e + 1) B] is alpha_tot of v_los_e =
    line_of_sight_velocity(velocity, -ks[e]), flipped by flips[e] =
    (flip_x, flip_y, flip_z) as solvers/sweep_regular.py flip_field
    flips it -- the stack sweep_group_J_stack sweeps.

    velocity: (nz, nx, ny, 3), ordered (v_z, v_x, v_y); ks: P
    directions (k_z, k_x, k_y); the other arguments as alpha_tot's, on
    the cells (nz, nx, ny).
    """
    _check_group(line, lam, velocity, ks, flips, populations, a_cont,
                 g_cell, damp)
    if velocity.device.type == "cpu":
        return alpha_tot_group_plain(line, lam, velocity, ks, flips,
                                     populations, a_cont, g_cell, damp)
    cells = tuple(velocity.shape[:-1])
    out = torch.empty(out_shape(cells, len(ks) * lam.shape[0]),
                      dtype=lam.dtype, device=lam.device)
    global GROUP_LAUNCHES
    GROUP_LAUNCHES += _launch_e1(line, lam, velocity, populations, a_cont,
                                 g_cell, damp, out, cells, len(ks), ks,
                                 flips)
    return out


def voigt_rows(line, lam, damp):
    """The Voigt profile [1/m] H(a, v) / (sqrt(pi) dlamD) with v = (lam -
    lam0) / dlamD and no Doppler shift, for the wavelengths lam (nb,)
    and their damping rows damp (nb,) + line.dlamD.shape; returns that
    shape."""
    _check_lam(lam)
    _same(lam, damp, line.dlamD)
    _need_shape("damp", damp, (lam.shape[0],) + tuple(line.dlamD.shape))
    if lam.device.type == "cpu":
        return voigt_rows_plain(line, lam, damp)
    lam_p, damp_p, dD_p = _kernel_inputs("voigt_rows", lam, damp,
                                         line.dlamD)
    from ..kernels import build
    out = torch.empty_like(damp)
    if out.numel() == 0:
        return out
    fn = build.launch_fn("vrt_voigt_rows", lam.dtype)
    global VOIGT_LAUNCHES
    with torch.cuda.device(out.device):
        VOIGT_LAUNCHES += 1
        err = fn(lam_p, damp_p, dD_p, out.data_ptr(), lam.shape[0],
                 line.dlamD.numel(), line.lam0, _SQRT_PI,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "voigt_rows")
    return out
