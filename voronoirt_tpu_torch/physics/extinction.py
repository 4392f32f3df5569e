"""Line-plus-continuum extinction and the bound-bound Voigt profile:
CUDA kernel wrappers + plain versions.

Counterpart of voronoirt_tpu/engine/lambda_iter.py:122-171
(_alpha_tot, _alpha_tot_g_impl, _alpha_tot_g_t, _alpha_tot_g_T), which
the JAX package compiles into one program a lambda chunk and direction,
and of the profile in voronoirt_tpu/physics/rates.py sigma_ij_bb.

alpha_tot computes, for every cell of a per-cell field and every
wavelength of a chunk,

  damping  a     = g lam^2 / (4 pi c dlamD)         (or the rows `damp`)
  shift    v     = (lam - lam0 + lam0 v_los / c) / dlamD
  profile  phi   = H(a, v) / (sqrt(pi) dlamD)
  alpha          = hc/(4 pi lam0) phi (n_i Bij - n_j Bji) + alpha_cont

written straight into the sweep's layout: the wavelength axis second,
(nz, B, nx, ny) for a regular grid's (nz, nx, ny) fields, (n, B) for a
Voronoi grid's (n,) sites.  voigt_rows is the rates' profile alone, v =
(lam - lam0) / dlamD, in the (nb, ...) layout of its damping rows.

Kernels: csrc/extinction.cu (vrt_alpha_tot, vrt_voigt_rows), one launch
a call; one thread a cell loops over the wavelengths and evaluates only
its own Humlicek region, in the plain version's arithmetic on the card,
so the two agree bit for bit there.  The plain versions are the port's
eager code (physics/atom.py, physics/voigt.py): one wavelength plane at
a time on a regular grid, blocks of about _EXT_POINTS points on the
sites, the rates' profile through voigt_profile's slabs.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c_0, hc
from .atom import alpha_line, compute_profile
from .broadening import damping
from .voigt import _SQRT_PI, voigt_profile

# kernel launches so far (not counting the plain versions)
LAUNCHES = 0            # alpha_tot
VOIGT_LAUNCHES = 0      # voigt_rows
# points per block of the plain site-major extinction: the eager Voigt's
# complex temporaries stay one voigt_H slab in size
_EXT_POINTS = 1 << 24


def out_shape(cells, B):
    """The sweep layout of B wavelengths over fields of shape `cells`:
    the wavelength axis second."""
    return (cells[0], B) + tuple(cells[1:])


def alpha_tot_plain(line, lam, v_los, populations, a_cont=None,
                    g_cell=None, damp=None):
    """The plain PyTorch version of alpha_tot."""
    n_i, n_j = populations[..., 0], populations[..., 1]
    cells = tuple(v_los.shape)
    out = torch.empty(out_shape(cells, lam.shape[0]), dtype=v_los.dtype,
                      device=v_los.device)
    # one wavelength plane a step on a grid, blocks of wavelengths on
    # sites: every op is pointwise, so the values are those of the whole
    # chunk's expression
    step = 1 if len(cells) > 1 else max(1, _EXT_POINTS // max(cells[0], 1))
    for j0 in range(0, lam.shape[0], step):
        lam_j = lam[j0:j0 + step]
        if damp is not None:
            d = damp[j0:j0 + step]
        else:
            d = damping(g_cell[None], lam_j.reshape((-1,) + (1,) * len(cells)),
                        line.dlamD[None])
        a = alpha_line(line, compute_profile(line, lam_j, d, v_los), n_j, n_i)
        if a_cont is not None:
            a = a + a_cont
        out[:, j0:j0 + step] = a.movedim(0, 1)
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
    ptrs = _kernel_inputs("alpha_tot", v_los, lam, g_cell, damp,
                          populations, a_cont, line.dlamD)
    from ..kernels import build
    cells, B = tuple(v_los.shape), lam.shape[0]
    out = torch.empty(out_shape(cells, B), dtype=lam.dtype,
                      device=lam.device)
    if out.numel() == 0:
        return out
    n = v_los.numel()
    inner = n // cells[0]
    v_p, lam_p, g_p, damp_p, pop_p, ac_p, dD_p = ptrs
    fn = build.launch_fn("vrt_alpha_tot", lam.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        # PyTorch's CUDA kernel divides by the scalar c_0 as a multiply
        # by 1/c_0 taken in float64 and cast to the tensor's type
        err = fn(lam_p, g_p, damp_p, v_p, pop_p, ac_p, dD_p, out.data_ptr(),
                 B, n, populations.shape[-1], inner,
                 line.lam0, 1.0 / c_0, 4.0 * np.pi * c_0, _SQRT_PI,
                 hc / (4.0 * np.pi * line.lam0), line.Bij, line.Bji,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "alpha_tot")
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
