"""The Bezier xy plane step (X1): CUDA kernel wrapper + plain version.

One z-plane of the regular sweep's xy plane-cut case with the
quadratic-Bezier source integration: what the JAX package's
sweep_regular._xy_step_bezier computes as the body of the lax.scan over
an xy segment in its jitted sweep (plain XLA there; no Pallas kernel):

  st(A, f, g) = lerp_x(lerp_y(A)) at (x + sxs + f, y + sys + g)
  I_up, S_up, a_up  = st(I_p | S_p | alpha_p, fx, fy)
  S_uu, a_uu        = st(st(S_pp | alpha_pp, fx_prev, fy_prev), fx, fy)
  dtau = r (alpha_c + a_up) / 2,  dtau_uu = r_prev (a_up + a_uu) / 2
  I_new = e I_up + w_up S_up + w_c S_c + w_ctrl C(S_uu, S_up, S_c, ...)

The control point needs the source and extinction one more interval
upstream along the ray: the second-upwind point, on the plane two
z-steps back, is sampled by composing the previous step's stencil
(inside) with this step's (outside).  r, fx, fy and their _prev
counterparts are one direction's Python floats; first is 1.0 where there
is no upstream sample (a segment's first step) and the control point
falls back to the secant slope.

Kernel: csrc/xy_bezier.cu, one thread per output point, one launch per
z-plane, bit-equal to the plain version on the card.  Its bound is HBM
bytes: seven planes read and one written, 64 B a point in float64.  The
sweep takes it on split grids and on planes that do not fit
xy_bezier_segment's band; elsewhere a segment is one launch
of xy_bezier_segment.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numbers

import torch

from .formal import bezier_control, bezier_weights
from .xy_plane import stencil_xy

# kernel launches so far (not counting the plain version)
LAUNCHES = 0


def xy_bezier_plain(I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp, r, fx,
                    fy, r_prev, fx_prev, fy_prev, first, sxs, sys):
    """The plain PyTorch version (the JAX package's _xy_step_bezier)."""
    def st(A, f, g):
        return stencil_xy(A, sxs, sys, f, g)

    a_up = st(alpha_p, fx, fy)
    S_up = st(S_p, fx, fy)
    I_up = st(I_p, fx, fy)
    a_uu = st(st(alpha_pp, fx_prev, fy_prev), fx, fy)
    S_uu = st(st(S_pp, fx_prev, fy_prev), fx, fy)
    dtau = r * (alpha_c + a_up) * 0.5
    dtau_uu = r_prev * (a_up + a_uu) * 0.5
    C = bezier_control(S_uu, S_up, S_c, dtau_uu, dtau, first)
    wu, wc, wk, ew = bezier_weights(dtau)
    return ew * I_up + wu * S_up + wc * S_c + wk * C


def _check(planes, scalars, shifts):
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (B, Nx, Ny), got {tuple(ref.shape)}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    for t in planes:
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError("all planes must share dtype and device")
        if t.shape != ref.shape:
            raise ValueError("planes must share one shape")
        if not t.is_contiguous():
            raise ValueError("xy_bezier takes contiguous planes")
    for v in scalars:
        if not isinstance(v, numbers.Real) or isinstance(v, bool):
            raise TypeError(f"the step's geometry is Python floats, got "
                            f"{type(v).__name__}")
    for s in shifts:
        if s not in (0, -1) or isinstance(s, bool):
            raise ValueError(f"a stencil base shift is 0 or -1, got {s!r}")


def xy_bezier(I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp, r, fx, fy,
              r_prev, fx_prev, fy_prev, first, sxs, sys):
    """One Bezier xy-case z-plane update; (B, Nx, Ny) planes in, the new
    I plane out.

    I_p: the carried plane; alpha_c, S_c this plane's, alpha_p, S_p the
    previous plane's, alpha_pp, S_pp the second-upwind plane's.  r, fx,
    fy, r_prev, fx_prev, fy_prev, first: Python floats; sxs, sys: the
    integer stencil base shifts (0 or -1).
    """
    planes = [I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp]
    scalars = [r, fx, fy, r_prev, fx_prev, fy_prev, first]
    _check(planes, scalars, (sxs, sys))
    if I_p.device.type == "cpu":
        return xy_bezier_plain(*planes, *scalars, sxs, sys)
    if I_p.device.type != "cuda":
        raise ValueError(f"no xy_bezier kernel for device {I_p.device}")
    from ..kernels import build
    out = torch.empty_like(I_p)
    B, nx, ny = out.shape
    fn = build.launch_fn("vrt_xy_bezier", out.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        err = fn(*(t.data_ptr() for t in planes), out.data_ptr(), B, nx, ny,
                 int(sxs), int(sys), *(float(v) for v in scalars),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "xy_bezier")
    return out
