"""A mirror group's J emit on the regular grid: CUDA kernel wrappers +
plain versions.

Counterpart of what the JAX package's jitted sweep_group_J
(voronoirt_tpu/solvers/sweep_regular.py:853-887) fuses around the
group's batched sweep:

  group_emit  (G1)  the angle reduction `emit` of sweep_batched_J's scan
                    body (:833-845): for each plane t of a piece,
                    J_up[t] = sum over the originally-up angles e of
                    w[e] * unflip_e(I[t][e B:(e + 1) B]), J_dn[t] over
                    the originally-down ones, e in order;
  group_stack (G2)  the flipped concatenation of S and I0 (:877-881):
                    angle e's copy, flipped by flips[e], in block e of
                    the batch axis;
  group_fold  (G3)  J_up + flip_z(J_dn) (:887), added into the lambda
                    chunk's J in its (lambda, nz, nx, ny) layout.

The plain versions are the port's former eager code in its order of
summation (a sum starts at 0 and adds each weighted block; the two
halves are added, then the sum into J).

Kernels: csrc/group_emit.cu (vrt_group_emit, vrt_group_stack,
vrt_group_fold), one launch a call, each point in the plain version's
arithmetic, so on the card they are bit-equal to the plain versions.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..observability import layer

# kernel launches so far (not counting the plain versions)
EMIT_LAUNCHES = 0       # group_emit
STACK_LAUNCHES = 0      # group_stack
FOLD_LAUNCHES = 0       # group_fold
# the most angles of a launch (GROUP_MAX_ANGLES of csrc/group_emit.cu):
# a mirror group holds at most the 4 xy quadrants of an up and a down
# direction
MAX_ANGLES = 8


def flip_field(A, flip_x, flip_y, flip_z=False):
    """Reverse the trailing (x, y) axes (exact on the periodic domain);
    flip_z reverses the leading axis of a z-leading field."""
    dims = [d for d, on in ((0, flip_z), (-2, flip_x), (-1, flip_y)) if on]
    return torch.flip(A, dims) if dims else A


def _mask(flags):
    return sum(1 << e for e, on in enumerate(flags) if on)


def _launch(name, dtype, *args):
    from ..kernels import build
    err = build.launch_fn(name, dtype)(
        *args, torch.cuda.current_stream().cuda_stream)
    build.check(err, name)


def _on_card(what, *tensors):
    """Whether the call launches the kernel (CUDA tensors) rather than
    the plain version (CPU tensors); raises for another device or mixed
    tensors."""
    dev = tensors[0].device
    if any(t.device != dev or t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError(f"{what}: all tensors must share dtype and device")
    if tensors[0].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {tensors[0].dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    return True


def _angles(what, n):
    if not 1 <= n <= MAX_ANGLES:
        raise ValueError(f"{what}: 1 to {MAX_ANGLES} angles, got {n}")


# ------------------------------------------------------------------ G1

def group_emit_plain(planes, steps, w, down_flags, unflips, J_up, J_dn):
    """The plain version of group_emit: the planes' rows of J_up and
    J_dn zeroed, then each angle's weighted, unflipped block added into
    its class, e in order."""
    B = J_up.shape[1]
    lo = min(steps)
    if steps[0] != lo:          # descending steps: the planes reversed
        planes = planes.flip(0)
    rows = slice(lo, lo + len(steps))
    up, dn = J_up[rows], J_dn[rows]
    up.zero_()
    dn.zero_()
    for e, down in enumerate(down_flags):
        blk = w[e] * flip_field(planes[:, e * B:(e + 1) * B], *unflips[e])
        (dn if down else up).add_(blk)


def _check_emit(planes, steps, w, down_flags, unflips, J_up, J_dn):
    P = len(down_flags)
    _angles("group_emit", P)
    if len(unflips) != P or tuple(w.shape) != (P,):
        raise ValueError(f"group_emit: {P} down flags, {len(unflips)} "
                         f"unflips and weights {tuple(w.shape)}")
    if J_up.dim() != 4 or J_up.shape != J_dn.shape:
        raise ValueError(f"group_emit: J_up {tuple(J_up.shape)} and J_dn "
                         f"{tuple(J_dn.shape)} must be one (nz, B, Nx, Ny)")
    nz, B, nx, ny = J_up.shape
    L = len(steps)
    if tuple(planes.shape) != (L, P * B, nx, ny):
        raise ValueError(f"group_emit: planes must be {(L, P * B, nx, ny)}, "
                         f"got {tuple(planes.shape)}")
    steps = [int(t) for t in steps]
    dirn = 1 if L < 2 or steps[1] > steps[0] else -1
    if L == 0 or steps != [steps[0] + j * dirn for j in range(L)]:
        raise ValueError(f"group_emit: steps must be consecutive, got "
                         f"{steps}")
    if not (0 <= min(steps) and max(steps) < nz):
        raise ValueError(f"group_emit: steps {steps[0]}..{steps[-1]} outside "
                         f"the {nz} planes")
    return steps, dirn


@layer("group_emit")
def group_emit(planes, steps, w, down_flags, unflips, J_up, J_dn):
    """Reduce a piece of swept planes over the group's angles into J.

    planes: (L, P*B, Nx, Ny), the planes made for the consecutive steps
    `steps` (z indices advancing by +1 or -1); w: (P,) quadrature weights
    (a tensor of the planes' dtype and device); down_flags: P bools, the
    originally-down angles; unflips: P (flip_x, flip_y) undoing each
    angle's canonical flip; J_up, J_dn: (nz, B, Nx, Ny), whose rows
    `steps` are written whole (a class with no angle gets 0).
    """
    steps, dirn = _check_emit(planes, steps, w, down_flags, unflips, J_up,
                              J_dn)
    if not _on_card("group_emit", planes, w, J_up, J_dn):
        return group_emit_plain(planes, steps, w, down_flags, unflips, J_up,
                                J_dn)
    if not all(t.is_contiguous() for t in (planes, w, J_up, J_dn)):
        raise ValueError("group_emit kernel inputs must be contiguous")
    _, B, nx, ny = J_up.shape
    global EMIT_LAUNCHES
    with torch.cuda.device(planes.device):
        EMIT_LAUNCHES += 1
        _launch("vrt_group_emit", planes.dtype, planes.data_ptr(),
                w.data_ptr(), J_up.data_ptr(), J_dn.data_ptr(), len(w), B,
                nx, ny, steps[0], dirn, len(steps), _mask(down_flags),
                _mask(f[0] for f in unflips), _mask(f[1] for f in unflips))


# ------------------------------------------------------------------ G2

def group_stack_plain(sources, flips):
    """The plain version of group_stack: the flipped copies concatenated
    along the batch axis."""
    return torch.cat([flip_field(s, *f) for s, f in zip(sources, flips)],
                     dim=sources[0].dim() - 3)


@layer("group_emit")
def group_stack(sources, flips):
    """The group's stack of P flipped fields.

    sources: P tensors of one shape (and, on the card, one set of
    strides with a unit one along y), (nz, B, Nx, Ny) (the S stack: one
    field P times, e.g. the transposed view of a lambda chunk's S) or
    (B, Nx, Ny) (the I0 stack: a boundary plane an angle); flips: P flip
    triples (flip_x, flip_y, flip_z) for 4-d sources, pairs for 3-d
    ones.  Returns the contiguous (nz, P*B, Nx, Ny) or (P*B, Nx, Ny)
    stack, angle e's copy, flipped by flips[e], in block e.
    """
    P = len(sources)
    _angles("group_stack", P)
    s0 = sources[0]
    if s0.dim() not in (3, 4) or len(flips) != P:
        raise ValueError(f"group_stack: {P} sources of {s0.dim()} dims and "
                         f"{len(flips)} flips")
    if any(len(f) != s0.dim() - 1 for f in flips):
        raise ValueError(f"group_stack: {s0.dim()}-d sources take flips of "
                         f"{s0.dim() - 1}, got {flips}")
    if any(s.shape != s0.shape for s in sources):
        raise ValueError("group_stack: the sources must share one shape")
    if not _on_card("group_stack", *sources):
        return group_stack_plain(sources, flips)
    if any(s.stride() != s0.stride() for s in sources):
        raise ValueError("group_stack kernel sources must share strides")
    src = s0 if s0.dim() == 4 else s0[None]
    nz, B, nx, ny = src.shape
    sz, sb, sx, sy = src.stride()
    if sy != 1 and ny > 1:
        raise ValueError("group_stack kernel sources need a unit y stride")
    out = torch.empty((nz, P * B, nx, ny), dtype=s0.dtype, device=s0.device)
    ptrs = (ctypes.c_void_p * P)(*(s.data_ptr() for s in sources))
    fz = [f[2] if len(f) == 3 else False for f in flips]
    global STACK_LAUNCHES
    with torch.cuda.device(out.device):
        STACK_LAUNCHES += 1
        _launch("vrt_group_stack", out.dtype, ctypes.addressof(ptrs),
                out.data_ptr(), P, nz, B, nx, ny, sz, sb, sx,
                _mask(f[0] for f in flips), _mask(f[1] for f in flips),
                _mask(fz))
    return out if s0.dim() == 4 else out[0]


# ------------------------------------------------------------------ G3

def group_fold_plain(Jc, J_up, J_dn):
    """The plain version of group_fold."""
    Jc.add_((J_up + torch.flip(J_dn, [0])).transpose(0, 1))


@layer("group_emit")
def group_fold(Jc, J_up, J_dn):
    """Jc[b, z] += J_up[z, b] + J_dn[nz - 1 - z, b]: a group's two J
    halves (canonical z order, the originally-down angles' z-flipped)
    added into the chunk's J, (B, nz, Nx, Ny) contiguous.  J_up and J_dn
    are (nz, B, Nx, Ny) of one shape and strides, with a unit stride
    along y (on a split grid the interior views of padded tiles).
    Returns Jc."""
    nz, B, nx, ny = J_up.shape
    if (J_up.shape != J_dn.shape or J_up.stride() != J_dn.stride()
            or tuple(Jc.shape) != (B, nz, nx, ny)):
        raise ValueError(f"group_fold: Jc {tuple(Jc.shape)} must be "
                         f"{(B, nz, nx, ny)} and J_up / J_dn one shape and "
                         f"strides, got {tuple(J_up.shape)} and "
                         f"{tuple(J_dn.shape)}")
    if not _on_card("group_fold", Jc, J_up, J_dn):
        group_fold_plain(Jc, J_up, J_dn)
        return Jc
    sz, sb, sx, sy = J_up.stride()
    if not Jc.is_contiguous() or (sy != 1 and ny > 1):
        raise ValueError("group_fold kernel needs a contiguous Jc and a "
                         "unit y stride in J_up / J_dn")
    global FOLD_LAUNCHES
    with torch.cuda.device(Jc.device):
        FOLD_LAUNCHES += 1
        _launch("vrt_group_fold", Jc.dtype, Jc.data_ptr(), J_up.data_ptr(),
                J_dn.data_ptr(), B, nz, nx, ny, sz, sb, sx)
    return Jc
