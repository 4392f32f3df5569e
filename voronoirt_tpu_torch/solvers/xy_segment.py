"""A whole xy segment of the regular sweep: CUDA kernel wrapper + plain version.

Replaces voronoirt_tpu/solvers/pallas_xy.py (xy_plane_pallas, kernel
_xy_kernel) on the unsplit sweep, where the JAX package runs an xy
segment as one lax.scan of _xy_step (sweep_regular.py:517-528, and
:706-719 on the batched path).  For j, t in enumerate(steps) it computes

  I = xy_plane(alpha[t-dirn], alpha[t], S[t-dirn], S[t], I,
               r[j], fx[j], fy[j], sxs, sys);   out[j] = I

starting from I = I0, with xy_plane's arithmetic in its order, so the
planes are bit-equal to a loop of xy_plane.

Kernel: csrc/xy_segment.cu, one launch a call.  On the production plane
one thread-block cluster a batch element keeps its carried plane and the
previous alpha and S planes on chip across the steps, so HBM sees each
alpha and S plane read once and each I plane written once (three planes
a step against xy_plane's six); larger planes carry through `out` in
global memory.  The sweep cuts a segment into pieces of at most
piece_steps() planes, so `out` stays near PIECE_BYTES.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .xy_plane import xy_plane_plain

# kernel launches so far (not counting the plain version)
LAUNCHES = 0
# bytes of one piece's output planes, (n_steps, B, Nx, Ny): at B = 52 in
# float64 a plane is 27.3 MB, so a piece is 39 planes
PIECE_BYTES = 1 << 30


def piece_steps(B, nx, ny, dtype):
    """Planes a piece of an xy segment may hold: its output stays under
    PIECE_BYTES, and holds at least one."""
    plane = B * nx * ny * torch.empty((), dtype=dtype).element_size()
    return max(1, PIECE_BYTES // max(1, plane))


def xy_segment_plain(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out):
    """The plain PyTorch version: a loop of xy_plane_plain."""
    I = I0
    for j, t in enumerate(steps):
        I = xy_plane_plain(alpha[t - dirn], alpha[t], S[t - dirn], S[t], I,
                           r[j], fx[j], fy[j], sxs, sys)
        out[j] = I
    return out


def _overlap(a, b):
    """Whether the storage spans of two tensors overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def _check(alpha, S, I0, steps, dirn, r, fx, fy, out):
    if alpha.dim() != 4:
        raise ValueError(f"fields must be (nz, B, Nx, Ny), got "
                         f"{tuple(alpha.shape)}")
    if alpha.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {alpha.dtype}")
    for t in (S, I0, r, fx, fy, out):
        if t.dtype != alpha.dtype or t.device != alpha.device:
            raise ValueError("all inputs must share dtype and device")
    nz = alpha.shape[0]
    plane = tuple(alpha.shape[1:])
    n = len(steps)
    if tuple(S.shape) != tuple(alpha.shape):
        raise ValueError("alpha and S must share one shape")
    if tuple(I0.shape) != plane:
        raise ValueError(f"I0 must be {plane}, got {tuple(I0.shape)}")
    if tuple(out.shape) != (n,) + plane:
        raise ValueError(f"out must be {(n,) + plane}, got "
                         f"{tuple(out.shape)}")
    for t in (r, fx, fy):
        if tuple(t.shape) != (n, plane[0]):
            raise ValueError(f"per-step geometry must be {(n, plane[0])}, "
                             f"got {tuple(t.shape)}")
    if dirn not in (1, -1):
        raise ValueError(f"dirn must be 1 or -1, got {dirn}")
    steps = [int(t) for t in steps]
    if not steps:
        return steps
    if steps != [steps[0] + j * dirn for j in range(n)]:
        raise ValueError("steps must advance by dirn")
    ends = (steps[0] - dirn, steps[-1])
    if not (0 <= min(ends) and max(ends) < nz):
        raise ValueError(f"steps {steps[0]}..{steps[-1]} (and the plane "
                         f"before the first) outside the {nz} planes")
    return steps


def xy_segment(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out):
    """Run the xy steps `steps` (t0, t0 + dirn, ...) of one segment from
    the carried plane I0, writing each new plane into out[j]; returns
    out.

    alpha, S: the whole (nz, B, Nx, Ny) fields; I0: (B, Nx, Ny); r, fx,
    fy: (n_steps, B) path length and stencil fractions a step and batch
    element; sxs, sys: the integer stencil base shifts (0 or -1) shared
    by the batch; out: (n_steps, B, Nx, Ny), which must not overlap the
    inputs.
    """
    steps = _check(alpha, S, I0, steps, dirn, r, fx, fy, out)
    if alpha.device.type == "cpu":
        return xy_segment_plain(alpha, S, I0, steps, dirn, r, fx, fy, sxs,
                                sys, out)
    if alpha.device.type != "cuda":
        raise ValueError(f"no xy_segment kernel for device {alpha.device}")
    ins = (alpha, S, I0, r, fx, fy)
    if not all(t.is_contiguous() for t in ins + (out,)):
        raise ValueError("xy_segment kernel inputs must be contiguous")
    if any(_overlap(out, t) for t in ins):
        raise ValueError("xy_segment: out overlaps an input")
    from ..kernels import build
    _, B, nx, ny = alpha.shape
    fn = build.launch_fn("vrt_xy_segment", alpha.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        err = fn(*(t.data_ptr() for t in ins), out.data_ptr(), B, nx, ny,
                 int(sxs), int(sys), steps[0] if steps else 0, int(dirn),
                 len(steps), torch.cuda.current_stream().cuda_stream)
    build.check(err, "xy_segment")
    return out


def layout(nx, ny, dtype):
    """What a launch at an (Nx, Ny) plane is on the current card: a dict
    of its placement of the carried plane ('shared' or 'global'), CTAs a
    cluster, rows a band, shared memory a CTA (bytes) and the clusters
    the card can run at once."""
    from ..kernels import build
    info = (ctypes.c_int * 5)()
    fn = build.launch_fn("vrt_xy_segment_info", dtype)
    err = fn(nx, ny, ctypes.addressof(info))
    build.check(err, "xy_segment layout")
    return {"placement": "shared" if info[0] else "global",
            "cluster": info[1], "rows": info[2], "smem_bytes": info[3],
            "max_active_clusters": info[4]}
