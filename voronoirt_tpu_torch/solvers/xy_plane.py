"""One z-plane of the xy plane-cut case: CUDA kernel wrapper + plain version.

Replaces voronoirt_tpu/solvers/pallas_xy.py (xy_plane_pallas, kernel
_xy_kernel) and computes what sweep_regular._xy_step computes, with the
direction geometry taken per batch element, as the JAX package's
batched group sweep does (sweep_regular.py:706-717):

  bil(A) = lerp_x(lerp_y(A)) at (x + sxs + fx[b], y + sys + fy[b])
  dtau   = r[b]/2 * (alpha_c + bil(alpha_p))
  I_new  = e(dtau) bil(I_p) + a(dtau) bil(S_p) + b(dtau) S_c

Kernel: csrc/xy_plane.cu, one thread per output point, one launch per
z-plane: the split sweep's (its padded tiles need the carried plane's
halo refilled after every step); the unsplit sweep runs whole segments
through xy_segment.  Its bound on the card is HBM bytes: in float64 it reads five
(B, Nx, Ny) planes and writes one, 48 B a point, against ~40 flops and
one exp; the stencil re-reads are served by L1/L2, so HBM sees each
plane about once.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from .formal import linear_weights

# kernel launches so far (not counting the plain version)
LAUNCHES = 0


def _shift(A, sx, sy):
    """A[..., x+sx, y+sy] with periodic wrap."""
    if sx:
        A = torch.roll(A, -sx, dims=-2)
    if sy:
        A = torch.roll(A, -sy, dims=-1)
    return A


def stencil_xy(A, sxs, sys, fx, fy):
    """Bilinear periodic sample at (x + sxs + fx, y + sys + fy) as
    lerp_x(lerp_y(A)) (sweep_regular._stencil_xy); fx, fy broadcast
    against A."""
    Ay = (1.0 - fy) * _shift(A, 0, sys) + fy * _shift(A, 0, sys + 1)
    return (1.0 - fx) * _shift(Ay, sxs, 0) + fx * _shift(Ay, sxs + 1, 0)


def xy_plane_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, fx, fy, sxs, sys):
    """The plain PyTorch version: r, fx, fy are (B,) per-element."""
    r, fx, fy = (v.reshape(-1, 1, 1) for v in (r, fx, fy))
    a_up = stencil_xy(alpha_p, sxs, sys, fx, fy)
    dtau = r * (alpha_c + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    S_up = stencil_xy(S_p, sxs, sys, fx, fy)
    I_up = stencil_xy(I_p, sxs, sys, fx, fy)
    return ew * I_up + aw * S_up + bw * S_c


def _check(planes, geom):
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (B, Nx, Ny), got {tuple(ref.shape)}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    for t in planes + geom:
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError("all inputs must share dtype and device")
    for t in planes:
        if t.shape != ref.shape:
            raise ValueError("planes must share one shape")
    for t in geom:
        if t.shape != (ref.shape[0],):
            raise ValueError(f"per-element geometry must be ({ref.shape[0]},),"
                             f" got {tuple(t.shape)}")


def xy_plane(alpha_p, alpha_c, S_p, S_c, I_p, r, fx, fy, sxs, sys):
    """One xy-case z-plane update; (B, Nx, Ny) planes in, new I plane out.

    r, fx, fy: (B,) tensors (path length, stencil fractions per batch
    element); sxs, sys: the integer stencil base shifts (0 or -1) shared
    by the batch.
    """
    planes = [alpha_p, alpha_c, S_p, S_c, I_p]
    geom = [r, fx, fy]
    _check(planes, geom)
    if alpha_p.device.type == "cpu":
        return xy_plane_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, fx, fy,
                              sxs, sys)
    if alpha_p.device.type != "cuda":
        raise ValueError(f"no xy_plane kernel for device {alpha_p.device}")
    if not all(t.is_contiguous() for t in planes + geom):
        raise ValueError("xy_plane kernel inputs must be contiguous")
    from ..kernels import build
    out = torch.empty_like(alpha_p)
    B, nx, ny = out.shape
    fn = build.launch_fn("vrt_xy_plane", out.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        err = fn(*(t.data_ptr() for t in planes + geom), out.data_ptr(),
                 B, nx, ny, int(sxs), int(sys),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "xy_plane")
    return out
