"""One z-plane of the yz/xz in-plane march: CUDA kernel wrapper + plain version.

Replaces voronoirt_tpu/solvers/pallas_march.py (march_plane_pallas,
kernel _march_kernel) and computes what sweep_regular._march_plane /
_march_step compute (the reference's characteristics.jl:420-483
relaxation with its one-line buffer), with the direction geometry per
batch element as the JAX package's batched group sweep takes it
(sweep_regular.py:398-416, 721-745): path length r, line fraction
f_line, current-plane weight w_cur and the 0/1 centre blend c_prev
(the xz-down quirk, characteristics.jl:794,804), each (B,).

Planes are (B, Nx, Ny).  march_axis 'x' is the yz case (march over x,
lines along y); 'y' is the xz case (march over y, lines along x).

Kernel: csrc/march_plane.cu.  Both it and the plain version use the
pass-invariant regrouping of _march_step: I_new = coeff LI(buf) + const,
with coeff and const computed once per plane (the kernel keeps them in
a (B, 2, Nx*Ny) scratch tensor this wrapper allocates), then n_sweeps *
N sequential column steps.  Its bound on the card is the latency of
that chain, not HBM bytes: one block per batch element, threads over the
line, the line buffer double-buffered in shared memory with one barrier
a step.  At production (B = 4 angles x 13 wavelengths) that is 52 blocks
on 132 SMs: under-filled.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .formal import linear_weights

# kernel launches so far (not counting the plain version)
LAUNCHES = 0

MAX_LINE = 2048   # csrc/march_plane.cu kMaxLine


def gather_order(N, sign):
    """March order, upwind-column order (periodic) and the inverse of
    the march order along an axis."""
    order = np.arange(N) if sign > 0 else np.arange(N - 1, -1, -1)
    upwind = (order + sign) % N
    inv = np.argsort(order)
    return order, upwind, inv


def _line_interp(col, s_base, f):
    """(1-f) col[..., y+s_base] + f col[..., y+s_base+1], periodic."""
    lo = torch.roll(col, -s_base, dims=-1) if s_base else col
    return (1.0 - f) * lo + f * torch.roll(col, -(s_base + 1), dims=-1)


def march_step(r, f_line, s_base, n_sweeps, w_cur, cols, centre_cols,
               I_prev_cols):
    """The plain march over columns in march order (sweep_regular.
    _march_step).

    cols: upwind columns (alpha_p, alpha_c, S_p, S_c), each (N, B, M);
    centre_cols: (alpha, S) centre columns; I_prev_cols: previous-plane
    intensity at the upwind columns.  r, f_line, w_cur broadcast as
    (B, 1).  Returns the last pass's lines (N, B, M) in march order.
    """
    alpha_pw, alpha_cw, S_pw, S_cw = cols
    alpha_c0, S_c0 = centre_cols
    wp = 1.0 - w_cur

    def LI(A):
        return _line_interp(A, s_base, f_line)

    # pass-invariant plane-wide precompute (one exp evaluation)
    a_up = wp * LI(alpha_pw) + w_cur * LI(alpha_cw)
    dtau = r * (alpha_c0 + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    s_up = wp * LI(S_pw) + w_cur * LI(S_cw)
    const = ew * (wp * LI(I_prev_cols)) + aw * s_up + bw * S_c0
    coeff = ew * w_cur

    n_cols = alpha_pw.shape[0]
    lines = torch.empty_like(const)
    buf = torch.zeros_like(alpha_c0[0])
    for _ in range(n_sweeps):
        for j in range(n_cols):
            buf = coeff[j] * LI(buf) + const[j]
            lines[j] = buf
    return lines


def march_plane_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line, w_cur,
                      c_prev, *, march_axis, sign, s_base, n_sweeps):
    """The plain PyTorch version of march_plane."""
    ax = -2 if march_axis == "x" else -1
    N = alpha_c.shape[ax]
    order, upwind, inv = (torch.as_tensor(a, device=alpha_c.device)
                          for a in gather_order(N, sign))

    def take(A, idx):
        # (B, Nx, Ny) -> (N, B, M), march axis leading
        return torch.movedim(torch.index_select(A, ax, idx), ax, 0)

    cp = c_prev.reshape(-1, 1, 1)
    centre_a = cp * alpha_p + (1.0 - cp) * alpha_c
    centre_s = cp * S_p + (1.0 - cp) * S_c
    cols = (take(alpha_p, upwind), take(alpha_c, upwind),
            take(S_p, upwind), take(S_c, upwind))
    centre_cols = (take(centre_a, order), take(centre_s, order))
    lines = march_step(r.reshape(-1, 1), f_line.reshape(-1, 1), s_base,
                       n_sweeps, w_cur.reshape(-1, 1), cols, centre_cols,
                       take(I_p, upwind))
    # un-permute the march order and put the axis back
    lines = torch.index_select(lines, 0, inv)
    return torch.movedim(lines, 0, ax).contiguous()


def _check(planes, geom, march_axis, sign, s_base, n_sweeps):
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
    if march_axis not in ("x", "y") or sign not in (1, -1) \
            or s_base not in (0, -1) or n_sweeps < 1:
        raise ValueError(f"bad march statics: axis={march_axis!r} "
                         f"sign={sign} s_base={s_base} n_sweeps={n_sweeps}")


def march_plane(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line, w_cur, c_prev,
                *, march_axis, sign, s_base, n_sweeps):
    """One marching z-plane update; (B, Nx, Ny) planes in, new I plane out.

    alpha_p/S_p: previous (upwind) z-plane; alpha_c/S_c: current plane;
    I_p: previous-plane intensity.  r, f_line, w_cur, c_prev: (B,) per
    element.  march_axis 'x' (yz case) or 'y' (xz case); sign the march
    direction; s_base the line stencil base shift (0 or -1); n_sweeps
    the Gauss-Seidel passes.
    """
    planes = [alpha_p, alpha_c, S_p, S_c, I_p]
    geom = [r, f_line, w_cur, c_prev]
    _check(planes, geom, march_axis, sign, s_base, n_sweeps)
    statics = dict(march_axis=march_axis, sign=sign, s_base=s_base,
                   n_sweeps=n_sweeps)
    if alpha_p.device.type == "cpu":
        return march_plane_plain(*planes, *geom, **statics)
    if alpha_p.device.type != "cuda":
        raise ValueError(f"no march_plane kernel for device {alpha_p.device}")
    if not all(t.is_contiguous() for t in planes + geom):
        raise ValueError("march_plane kernel inputs must be contiguous")
    B, nx, ny = alpha_p.shape
    line = ny if march_axis == "x" else nx
    if line > MAX_LINE:
        raise ValueError(f"march_plane kernel takes lines up to {MAX_LINE} "
                         f"points, got {line}")
    from ..kernels import build
    out = torch.empty_like(alpha_p)
    scratch = torch.empty((B, 2, nx * ny), dtype=out.dtype,
                          device=out.device)
    fn = build.launch_fn("vrt_march_plane", out.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        err = fn(*(t.data_ptr() for t in planes + geom), out.data_ptr(),
                 scratch.data_ptr(), B, nx, ny, int(march_axis == "x"),
                 int(sign), int(s_base), int(n_sweeps),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "march_plane")
    return out
