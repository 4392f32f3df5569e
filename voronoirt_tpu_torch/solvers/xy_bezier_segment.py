"""A Bezier xy segment: CUDA kernel wrapper + plain version.

The JAX package runs a Bezier xy segment of the single-direction sweep
as one lax.scan of sweep_regular._xy_step_bezier (plain XLA in its
jitted sweep; no Pallas kernel).  xy_bezier_segment runs the whole
segment in one launch: for j, t = steps[j],

  I = xy_bezier(I, alpha[t], alpha[t-dirn], S[t], S[t-dirn],
                alpha[t2], S[t2], r[j], fx[j], fy[j],
                r[jp], fx[jp], fy[jp], first, sxs, sys);   out[t] = I

with t2 = t - 2 dirn clamped to the grid, jp = max(j - 1, 0) and first
1.0 only at j = 0: what sweep_regular's per-plane loop of X1 makes,
bit for bit.

Kernel: csrc/xy_bezier_segment.cu, one launch a segment.  One
thread-block cluster a batch element keeps the carried plane and the
previous and second-upwind alpha and S planes on chip across the steps,
so HBM sees alpha[t] and S[t] read once and I[t] written once a step
(24 B a point in float64) against the per-plane X1's 64.  The planes go
straight into the sweep's output cube by their index.  A plane whose
band does not fit (fits()) has no launch: the sweep takes the per-plane
X1 there, by that rule.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .xy_bezier import xy_bezier_plain
from .xy_segment import _overlap

# kernel launches so far (not counting the plain version)
LAUNCHES = 0
# the kernel's cluster (CTAs at most), threads a CTA and rows a thread's
# run (csrc/xy_bezier_segment.cu BZ_CLUSTER, BZ_THREADS, BZ_RUN)
CLUSTER, THREADS, RUN = 16, 512, 8


def fits(nx, ny):
    """Whether an (Nx, Ny) plane takes the kernel: a cluster of up to
    CLUSTER CTAs splits Nx into bands of R rows, and every run of RUN
    rows of a band's columns needs a thread of THREADS."""
    C = 1
    while C < CLUSTER and C < nx:
        C *= 2
    R = -(-nx // C)
    return ny * -(-R // RUN) <= THREADS


def xy_bezier_segment_plain(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys,
                            out):
    """The plain PyTorch version: a loop of xy_bezier_plain over the
    segment's steps, each plane written into out[t]; returns the last (a
    view of out)."""
    nz = alpha.shape[0]
    I = I0
    for j, t in enumerate(steps):
        jp = max(j - 1, 0)
        t2 = min(max(t - 2 * dirn, 0), nz - 1)
        I = xy_bezier_plain(I, alpha[t], alpha[t - dirn], S[t], S[t - dirn],
                            alpha[t2], S[t2], r[j], fx[j], fy[j], r[jp],
                            fx[jp], fy[jp], 1.0 if j == 0 else 0.0, sxs, sys)
        out[t] = I
    return out[steps[-1]]


def _check(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out):
    if alpha.dim() != 4:
        raise ValueError(f"fields must be (nz, B, Nx, Ny), got "
                         f"{tuple(alpha.shape)}")
    if alpha.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {alpha.dtype}")
    for t in (S, I0, out):
        if t.dtype != alpha.dtype or t.device != alpha.device:
            raise ValueError("all inputs must share dtype and device")
    if tuple(S.shape) != tuple(alpha.shape) or \
            tuple(out.shape) != tuple(alpha.shape):
        raise ValueError("alpha, S and out must share one shape")
    if tuple(I0.shape) != tuple(alpha.shape[1:]):
        raise ValueError(f"I0 must be {tuple(alpha.shape[1:])}, got "
                         f"{tuple(I0.shape)}")
    if dirn not in (1, -1):
        raise ValueError(f"dirn must be 1 or -1, got {dirn}")
    for s in (sxs, sys):
        if s not in (0, -1) or isinstance(s, bool):
            raise ValueError(f"a stencil base shift is 0 or -1, got {s!r}")
    steps = [int(t) for t in steps]
    n = len(steps)
    if n == 0:
        raise ValueError("a segment has at least one step")
    if steps != [steps[0] + j * dirn for j in range(n)]:
        raise ValueError("steps must advance by dirn")
    nz = alpha.shape[0]
    ends = (steps[0] - dirn, steps[-1])
    if not (0 <= min(ends) and max(ends) < nz):
        raise ValueError(f"steps {steps[0]}..{steps[-1]} (and the plane "
                         f"before the first) outside the {nz} planes")
    for v in (r, fx, fy):
        if len(v) != n:
            raise ValueError(f"per-step geometry of {len(v)} steps for a "
                             f"segment of {n}")
        for x in v:
            if not isinstance(x, numbers.Real) or isinstance(x, bool):
                raise TypeError(f"the geometry is Python floats, got "
                                f"{type(x).__name__}")
    return steps


def xy_bezier_segment(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out):
    """Run a Bezier xy segment from the carried plane I0, writing the
    plane of step j into out[steps[j]]; returns the last plane made (a
    view of out).

    alpha, S: the whole (nz, B, Nx, Ny) fields; I0: (B, Nx, Ny), the
    plane before steps[0] (it may be a plane of out, not one the segment
    writes); steps, r, fx, fy: the segment's z indices (advancing by
    dirn) and per-step geometry (Python floats, shared by the batch);
    sxs, sys: the stencil base shifts (0 or -1); out: (nz, B, Nx, Ny).
    """
    steps = _check(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, out)
    if alpha.device.type == "cpu":
        return xy_bezier_segment_plain(alpha, S, I0, steps, dirn, r, fx, fy,
                                       sxs, sys, out)
    if alpha.device.type != "cuda":
        raise ValueError(f"no xy_bezier_segment kernel for device "
                         f"{alpha.device}")
    _, B, nx, ny = alpha.shape
    if not fits(nx, ny):
        raise ValueError(f"an {nx}x{ny} plane does not fit the segment "
                         f"kernel's band: the sweep steps it plane by plane")
    if not all(t.is_contiguous() for t in (alpha, S, I0, out)):
        raise ValueError("xy_bezier_segment kernel inputs must be "
                         "contiguous")
    if _overlap(out, alpha) or _overlap(out, S):
        raise ValueError("xy_bezier_segment: out overlaps alpha or S")
    written = out[min(steps[0], steps[-1]):max(steps[0], steps[-1]) + 1]
    if _overlap(I0, written):
        raise ValueError("xy_bezier_segment: I0 lies on a plane the segment "
                         "writes")
    from ..kernels import build
    nz = alpha.shape[0]
    # (r, fx, fy) of each step
    geom = torch.tensor(list(zip(r, fx, fy)), dtype=torch.float64,
                        device=alpha.device)
    t0 = steps[0]
    t2 = min(max(t0 - 2 * dirn, 0), nz - 1)
    fn = build.launch_fn("vrt_xy_bezier_segment", alpha.dtype)
    global LAUNCHES
    with torch.cuda.device(out.device):
        LAUNCHES += 1
        err = fn(alpha.data_ptr(), S.data_ptr(), I0.data_ptr(),
                 geom.data_ptr(), out.data_ptr(), B, nx, ny, int(sxs),
                 int(sys), t0, int(dirn), len(steps), t2,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "xy_bezier_segment")
    return out[steps[-1]]


def layout(nx, ny, dtype):
    """What a launch at an (Nx, Ny) plane is on the current card: a dict
    of whether it fits, CTAs a cluster, rows a band, shared memory a CTA
    (bytes), the clusters the card can run at once, and the kernel's
    registers and local memory (bytes) a thread (the most of its four
    shift instances: local memory is spills and stack)."""
    from ..kernels import build
    info = (ctypes.c_int * 7)()
    fn = build.launch_fn("vrt_xy_bezier_segment_info", dtype)
    err = fn(nx, ny, ctypes.addressof(info))
    build.check(err, "xy_bezier_segment layout")
    return {"fits": bool(info[0]), "cluster": info[1], "rows": info[2],
            "smem_bytes": info[3], "max_active_clusters": info[4],
            "registers": info[5], "local_bytes": info[6]}
