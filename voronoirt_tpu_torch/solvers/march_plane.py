"""One z-plane of the yz/xz in-plane march: CUDA kernel wrappers + plain
versions.

Replaces voronoirt_tpu/solvers/pallas_march.py (march_plane_pallas,
kernel _march_kernel) and computes what sweep_regular._march_plane /
_march_step compute (the reference's characteristics.jl:420-483
relaxation with its one-line buffer), with the direction geometry per
batch element as the JAX package's batched group sweep takes it
(sweep_regular.py:398-416, 721-745): path length r, line fraction
f_line, current-plane weight w_cur and the 0/1 centre blend c_prev
(the xz-down quirk, characteristics.jl:794,804), each (B,).

Planes are (B, Nx, Ny).  march_axis 'x' is the yz case (march over x,
lines along y); 'y' is the xz case (march over y, lines along x).  N is
the number of columns along the march, M the points of a line.

The march is the pass-invariant regrouping of _march_step,
I_new = coeff LI(buf) + const, in two kernels (csrc/march_plane.cu):

- march_coeffs: coeff and const of every point of every plane (one exp
  a point), over the whole card, into the scratch (B, N, MP, 2): column
  along the march, point along the line, the pair (coeff, const) last;
  the line padded to MP = line_pad(M) points with zero pairs;
- march_chain: the n_sweeps * N sequential column steps on that scratch,
  one warp a line, rows prefetched into shared memory, no barrier a step.

march_plane is their composition.  Each has its plain version here
(march_coeffs_plain, march_chain_plain, march_plane_plain), with the
kernel's arithmetic in the kernel's order.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  LAUNCHES counts march_plane calls that launched
the kernels; COEFFS_LAUNCHES and CHAIN_LAUNCHES count each kernel's
launches.
"""

from __future__ import annotations

import torch

from ..observability import layer
from .formal import linear_weights

# kernel launches so far (not counting the plain versions)
LAUNCHES = 0
COEFFS_LAUNCHES = 0
CHAIN_LAUNCHES = 0

MAX_LINE = 2048   # csrc/march_plane.cu kMaxLine


def line_pad(M):
    """Padded line length of the scratch: 32 * PPL, PPL the smallest
    power of two with 32 * PPL >= M (the points a lane of the chain's
    warp holds)."""
    ppl = 1
    while 32 * ppl < M:
        ppl *= 2
    return 32 * ppl


def _line_interp(col, s_base, f):
    """(1-f) col[..., y+s_base] + f col[..., y+s_base+1], periodic."""
    lo = torch.roll(col, -s_base, dims=-1) if s_base else col
    return (1.0 - f) * lo + f * torch.roll(col, -(s_base + 1), dims=-1)


def _by_column(A, ax):
    """(B, Nx, Ny) -> (B, N, M), the march axis second."""
    return A if ax == -2 else A.transpose(-1, -2)


def march_coeffs_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line, w_cur,
                       c_prev, *, march_axis, sign, s_base):
    """The plain PyTorch version of march_coeffs: the scratch
    (B, N, line_pad(M), 2) of (coeff, const) per column and point."""
    ax = -2 if march_axis == "x" else -1
    N = alpha_c.shape[ax]
    upwind = (torch.arange(N, device=alpha_c.device) + sign) % N
    g = lambda v: v.reshape(-1, 1, 1)
    r, f, wc, cp = g(r), g(f_line), g(w_cur), g(c_prev)
    wp = 1.0 - wc

    def up(A):
        # the upwind column's line, interpolated: (B, N, M)
        return _line_interp(torch.index_select(_by_column(A, ax), 1, upwind),
                            s_base, f)

    a_c0 = _by_column(cp * alpha_p + (1.0 - cp) * alpha_c, ax)
    s_c0 = _by_column(cp * S_p + (1.0 - cp) * S_c, ax)
    a_up = wp * up(alpha_p) + wc * up(alpha_c)
    dtau = r * (a_c0 + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    s_up = wp * up(S_p) + wc * up(S_c)
    const = ew * (wp * up(I_p)) + aw * s_up + bw * s_c0
    coeff = ew * wc
    B, _, M = coeff.shape
    scratch = coeff.new_zeros((B, N, line_pad(M), 2))
    scratch[:, :, :M, 0] = coeff
    scratch[:, :, :M, 1] = const
    return scratch


def march_chain_plain(scratch, f_line, line, *, march_axis, sign, s_base,
                      n_sweeps):
    """The plain PyTorch version of march_chain: the new I plane
    (B, Nx, Ny) from the scratch of march_coeffs; `line` is M."""
    B, N = scratch.shape[:2]
    coeff = scratch[:, :, :line, 0]
    const = scratch[:, :, :line, 1]
    f = f_line.reshape(-1, 1)
    cols = range(N) if sign > 0 else range(N - 1, -1, -1)
    lines = torch.empty_like(coeff)
    buf = coeff.new_zeros((B, line))
    for _ in range(n_sweeps):
        for c in cols:
            buf = coeff[:, c] * _line_interp(buf, s_base, f) + const[:, c]
            lines[:, c] = buf
    return (lines if march_axis == "x" else lines.transpose(-1, -2)
            ).contiguous()


def march_plane_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line, w_cur,
                      c_prev, *, march_axis, sign, s_base, n_sweeps):
    """The plain PyTorch version of march_plane."""
    scratch = march_coeffs_plain(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line,
                                 w_cur, c_prev, march_axis=march_axis,
                                 sign=sign, s_base=s_base)
    line = alpha_c.shape[-1 if march_axis == "x" else -2]
    return march_chain_plain(scratch, f_line, line, march_axis=march_axis,
                             sign=sign, s_base=s_base, n_sweeps=n_sweeps)


def _check_statics(march_axis, sign, s_base, n_sweeps=1):
    if march_axis not in ("x", "y") or sign not in (1, -1) \
            or s_base not in (0, -1) or n_sweeps < 1:
        raise ValueError(f"bad march statics: axis={march_axis!r} "
                         f"sign={sign} s_base={s_base} n_sweeps={n_sweeps}")


def _check_same(tensors, ref):
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    for t in tensors:
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError("all inputs must share dtype and device")


def _check_geom(geom, B):
    for t in geom:
        if t.shape != (B,):
            raise ValueError(f"per-element geometry must be ({B},),"
                             f" got {tuple(t.shape)}")


def _check_planes(planes, geom):
    ref = planes[0]
    if ref.dim() != 3:
        raise ValueError(f"planes must be (B, Nx, Ny), got {tuple(ref.shape)}")
    _check_same(planes + geom, ref)
    for t in planes:
        if t.shape != ref.shape:
            raise ValueError("planes must share one shape")
    _check_geom(geom, ref.shape[0])


def _on_card(tensors, name):
    """True for CUDA tensors (after checking what the kernel takes),
    False for CPU ones; raises for any other device."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel inputs must be contiguous")
    return True


def _check_line(line):
    if line > MAX_LINE:
        raise ValueError(f"march kernels take lines up to {MAX_LINE} "
                         f"points, got {line}")


def march_coeffs(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line, w_cur, c_prev,
                 *, march_axis, sign, s_base):
    """(coeff, const) of every point: the scratch (B, N, line_pad(M), 2)
    march_chain takes.  Arguments as march_plane's."""
    planes = [alpha_p, alpha_c, S_p, S_c, I_p]
    geom = [r, f_line, w_cur, c_prev]
    _check_planes(planes, geom)
    _check_statics(march_axis, sign, s_base)
    if not _on_card(planes + geom, "march_coeffs"):
        return march_coeffs_plain(*planes, *geom, march_axis=march_axis,
                                  sign=sign, s_base=s_base)
    B, nx, ny = alpha_p.shape
    N, M = (nx, ny) if march_axis == "x" else (ny, nx)
    _check_line(M)
    from ..kernels import build
    mp = line_pad(M)
    scratch = torch.empty((B, N, mp, 2), dtype=alpha_p.dtype,
                          device=alpha_p.device)
    fn = build.launch_fn("vrt_march_coeffs", alpha_p.dtype)
    global COEFFS_LAUNCHES
    with torch.cuda.device(alpha_p.device):
        COEFFS_LAUNCHES += 1
        err = fn(*(t.data_ptr() for t in planes + geom), scratch.data_ptr(),
                 B, nx, ny, mp, int(march_axis == "x"), int(sign),
                 int(s_base), torch.cuda.current_stream().cuda_stream)
    build.check(err, "march_coeffs")
    return scratch


def march_chain(scratch, f_line, line, *, march_axis, sign, s_base,
                n_sweeps):
    """The n_sweeps * N column steps on march_coeffs' scratch; `line` is
    M, the points of a line.  Returns the new I plane (B, Nx, Ny)."""
    if scratch.dim() != 4 or scratch.shape[-1] != 2:
        raise ValueError(f"scratch must be (B, N, MP, 2), got "
                         f"{tuple(scratch.shape)}")
    B, N, mp = scratch.shape[:3]
    if not 1 <= line <= mp or mp != line_pad(line):
        raise ValueError(f"scratch line of {mp} points does not hold a "
                         f"line of {line}")
    _check_same([scratch, f_line], scratch)
    _check_geom([f_line], B)
    _check_statics(march_axis, sign, s_base, n_sweeps)
    statics = dict(march_axis=march_axis, sign=sign, s_base=s_base,
                   n_sweeps=n_sweeps)
    if not _on_card([scratch, f_line], "march_chain"):
        return march_chain_plain(scratch, f_line, line, **statics)
    _check_line(line)
    from ..kernels import build
    nx, ny = (N, line) if march_axis == "x" else (line, N)
    out = torch.empty((B, nx, ny), dtype=scratch.dtype, device=scratch.device)
    fn = build.launch_fn("vrt_march_chain", scratch.dtype)
    global CHAIN_LAUNCHES
    with torch.cuda.device(scratch.device):
        CHAIN_LAUNCHES += 1
        err = fn(scratch.data_ptr(), f_line.data_ptr(), out.data_ptr(), B,
                 nx, ny, mp, int(march_axis == "x"), int(sign), int(s_base),
                 int(n_sweeps), torch.cuda.current_stream().cuda_stream)
    build.check(err, "march_chain")
    return out


@layer("march_plane")
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
    _check_planes(planes, geom)
    _check_statics(march_axis, sign, s_base, n_sweeps)
    statics = dict(march_axis=march_axis, sign=sign, s_base=s_base)
    if not _on_card(planes + geom, "march_plane"):
        return march_plane_plain(*planes, *geom, n_sweeps=n_sweeps,
                                 **statics)
    global LAUNCHES
    LAUNCHES += 1
    scratch = march_coeffs(*planes, *geom, **statics)
    line = alpha_p.shape[-1 if march_axis == "x" else -2]
    return march_chain(scratch, f_line, line, n_sweeps=n_sweeps, **statics)
