"""The level steps of a Voronoi sweep stage: CUDA kernel wrapper + plain version.

Replaces the JAX package's compiled level scan (plain XLA, no Pallas
kernel): voronoirt_tpu/solvers/sweep_voronoi.py `_stage_scan` (run by
`_run_stage`), `_run_relax_lap`, `_run_hoisted_lap_d` and
`_run_hoisted_lap`, fed by `_level_src_ew` and `_precompute_lean`.  One
call runs one stage, or one relax lap, on the (n_rows + 1, B) intensity
array I in place: its levels in order, each `passes` times, every level
pass

  formal:  i_new = sum_j w_j (ew_j I[up_j] + src_j),  with (aw, bw, ew) =
           linear_weights(r_j (a_c + a_u_j) / 2), src_j = aw s_u_j + bw s_c
  hoisted: i_new = sum_j A_j I[up_j] + b,  the lean weights A_j = w_j ew_j,
           b = sum_j w_j src_j: given (lean), or formed from the fields
           (hoisted=True)

computed from the rows' upwind intensities as they stood before the pass
(a Jacobi pass) and written into the level's rows.  With `change` (a
2-element tensor) the pass also folds max |i_new - i_old| and max
|i_new| into change[0] and change[1], i_old read before the write.

The stage `sd` is the sweep's `_StageDev` (solvers/sweep_voronoi.py):
rows [sd.start + sd.off[l], sd.start + sd.off[l + 1]) of I are level l;
sd.up_slot / up_site / w / r (R, 2) and sd.row_site (R,) the rows'
upwind slots, upwind sites, blend weights, path lengths and own sites;
sd.steps the device step table (a row a level pass: first row, rows,
scratch buffer), sd.width the widest level, sd.scratch_rows the widest
level some of whose upwind slots lie in its own rows.

Kernel: csrc/voronoi_level.cu (V1), one cooperative launch a stage or
relax lap, a grid barrier between its steps, each step's field work done
before the barrier; a self-referencing step writes one of two scratch
buffers, which the next step reads and copies back into I.  On the card
the hoisted laps form the lean weights from the fields (hoisted=True):
the packed lean pair is the plain version's input only.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  The kernel's index math is 32-bit: a CUDA call
whose I, fields or scratch pair hold MAX_VALUES (2^30) values or more
raises, about 11.8 million sites at 91 wavelengths; a smaller
Config.lambda_chunk (fewer wavelengths a sweep) keeps a larger grid
under it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .formal import linear_weights

# V1 launches so far: one a stage or relax-lap call (not counting the
# plain version)
LAUNCHES = 0
# calls of the plain version on a CUDA tensor, which no sweep makes: only
# a comparison with the kernel calls it there
PLAIN_ON_CARD = 0
# V1 indexes I, the fields and its scratch pair in 32 bits: it refuses
# any of them at this many values or more
MAX_VALUES = 2**30


def level_src_ew(S_T, a_T, up_site, row_site, r2):
    """Field-dependent weights of a block of rows: gathers of the upwind
    and own-site field values straight from the (n, B) site-ordered
    arrays.  up_site/r2: (R, 2); row_site: (R,).  Returns (ew, src),
    (R, 2, B) each."""
    B = S_T.shape[1]
    s_u = S_T.index_select(0, up_site.reshape(-1)).view(
        up_site.shape + (B,))
    a_u = a_T.index_select(0, up_site.reshape(-1)).view(
        up_site.shape + (B,))
    s_c = S_T.index_select(0, row_site)
    a_c = a_T.index_select(0, row_site)
    dtau = r2[..., None] * (a_c[:, None, :] + a_u) * 0.5
    aw, bw, ew = linear_weights(dtau)
    src = aw * s_u + bw * s_c[:, None, :]
    return ew, src


def lean_weights(w2, ew, src):
    """The hoisted laps' lean weights of a block of rows from its blend
    weights w2 (R, 2, 1) and level_src_ew's (ew, src): (A (R, 2, B),
    b (R, B))."""
    return w2 * ew, (w2 * src).sum(1)


def voronoi_stage_plain(I, sd, S_T=None, a_T=None, lean=None, change=None,
                        hoisted=False):
    """The plain PyTorch version: a loop over the levels, each pass
    gathering the level's 2 upwind I rows (SLOT ids: occurrence
    semantics live in I) as i_u (W, 2, B) and writing its rows with one
    contiguous slice copy."""
    global PLAIN_ON_CARD
    if I.is_cuda:
        PLAIN_ON_CARD += 1
    B = I.shape[1]
    off = sd.off.tolist()
    if change is not None:
        dmax, smax = change[0], change[1]
    for l in range(len(off) - 1):
        o0, o1 = off[l], off[l + 1]
        rows = I[sd.start + o0:sd.start + o1]
        fl = sd.up_slot[o0:o1].reshape(-1)
        if lean is None:
            ew, src = level_src_ew(S_T, a_T, sd.up_site[o0:o1],
                                   sd.row_site[o0:o1], sd.r[o0:o1])
            w2 = sd.w[o0:o1][..., None]
            if hoisted:
                A, b = lean_weights(w2, ew, src)
        else:
            A, b = lean[0][o0:o1], lean[1][o0:o1]
        for _ in range(sd.passes):
            i_u = I.index_select(0, fl).view(o1 - o0, 2, B)
            if lean is None and not hoisted:
                i_new = (w2 * (ew * i_u + src)).sum(1)
            else:
                i_new = (A * i_u).sum(1) + b
            if change is not None:
                dmax = torch.maximum(dmax, (i_new - rows).abs().max())
                smax = torch.maximum(smax, i_new.abs().max())
            # the JAX package donates I to this update
            # (dynamic_update_slice); here the rows are written in place
            rows.copy_(i_new)
    if change is not None:
        change[0], change[1] = dmax, smax


def _check(I, sd, S_T, a_T, lean, change, hoisted):
    if I.dim() != 2:
        raise ValueError(f"I must be (n_rows + 1, B), got {tuple(I.shape)}")
    if I.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {I.dtype}")
    if (lean is None) == (S_T is None or a_T is None):
        raise ValueError("give the fields (S_T, a_T) or the lean weights, "
                         "not both")
    if hoisted and lean is not None:
        raise ValueError("hoisted forms the lean weights from the fields")
    B, R = I.shape[1], int(sd.off[-1])
    ins = ((S_T, a_T, sd.w, sd.r) if lean is None else tuple(lean))
    ins += (change,) if change is not None else ()
    for t in ins:
        if t.dtype != I.dtype or t.device != I.device:
            raise ValueError("all inputs must share dtype and device")
    if lean is None:
        if S_T.dim() != 2 or S_T.shape[1] != B or S_T.shape != a_T.shape:
            raise ValueError(f"fields must be (n, {B}), got "
                             f"{tuple(S_T.shape)} and {tuple(a_T.shape)}")
    elif (tuple(lean[0].shape) != (R, 2, B)
          or tuple(lean[1].shape) != (R, B)):
        raise ValueError(f"lean weights must be {(R, 2, B)} and {(R, B)}")
    if change is not None and tuple(change.shape) != (2,):
        raise ValueError("change must hold 2 values")
    # the kernel reads the ids and its step table as int64
    for t in (sd.up_slot, sd.up_site, sd.row_site):
        if t.dtype != torch.int64 or t.device != I.device:
            raise ValueError("the stage's ids must be int64 on I's device")
    n_steps = (len(sd.off) - 1) * sd.passes
    if (sd.steps.dtype != torch.int64 or sd.steps.device != I.device
            or tuple(sd.steps.shape) != (n_steps, 3)
            or not sd.steps.is_contiguous()):
        raise ValueError(f"the stage's step table must be ({n_steps}, 3) "
                         f"contiguous int64 on I's device")
    if sd.start + R > I.shape[0] - 1:
        raise ValueError(f"stage rows {sd.start}..{sd.start + R} outside "
                         f"the {I.shape[0] - 1} rows of I")


def grid_blocks(width, B, resident, threads):
    """V1's blocks for a stage whose widest step has `width` rows: enough
    for one thread an item (row, lambda) of that step, at most the
    `resident` blocks the card holds at once (a cooperative launch needs
    every block resident), at least one."""
    return max(1, min(resident, -(-width * B // threads)))


@functools.cache
def _occupancy(device_index, dtype, hoisted, fold):
    """(blocks an SM holds, SMs, threads a block, cooperative launch
    support) of V1's variant on the card."""
    from ..kernels import build
    info = (ctypes.c_int * 4)()
    fn = build.launch_fn("vrt_voronoi_stage_info", dtype)
    with torch.cuda.device(device_index):
        err = fn(int(hoisted), int(fold), ctypes.addressof(info))
    build.check(err, "voronoi_stage occupancy")
    return tuple(info)


def voronoi_stage(I, sd, S_T=None, a_T=None, lean=None, change=None,
                  hoisted=False):
    """Run one stage (or relax lap) `sd` on I in place: from the fields
    S_T, a_T ((n, B) site-major), in the formal form or, with hoisted,
    the lean weights' form; or from the packed lean weights lean = (A (R,
    2, B), b (R, B)), on the CPU only; with change, fold the lap's change
    into it."""
    _check(I, sd, S_T, a_T, lean, change, hoisted)
    if I.device.type == "cpu":
        return voronoi_stage_plain(I, sd, S_T, a_T, lean, change, hoisted)
    if I.device.type != "cuda":
        raise ValueError(f"no voronoi_stage kernel for device {I.device}")
    if lean is not None:
        raise ValueError("on the card V1 forms the lean weights from the "
                         "fields: pass S_T, a_T and hoisted=True")
    ins = (I, S_T, a_T, sd.up_slot, sd.up_site, sd.row_site, sd.w, sd.r)
    if not all(t.is_contiguous() for t in ins + (change,) if t is not None):
        raise ValueError("voronoi_stage kernel inputs must be contiguous")
    B, fold = I.shape[1], change is not None
    if max(I.numel(), S_T.numel(), 2 * sd.scratch_rows * B) >= MAX_VALUES:
        raise ValueError(f"V1 indexes in 32 bits: I, the fields and its "
                         f"scratch pair must hold fewer than {MAX_VALUES} "
                         f"values each; sweep fewer wavelengths at once "
                         f"(a smaller lambda_chunk)")
    n_steps = sd.steps.shape[0]
    if n_steps == 0:
        return
    from ..kernels import build
    scratch = (torch.empty((2, sd.scratch_rows, B), dtype=I.dtype,
                           device=I.device) if sd.scratch_rows else None)
    bar = torch.empty(1, dtype=torch.int64, device=I.device)
    per_sm, n_sm, threads, coop = _occupancy(
        I.device.index if I.device.index is not None
        else torch.cuda.current_device(), I.dtype, hoisted, fold)
    if not coop:
        raise RuntimeError("voronoi_stage: the card takes no cooperative "
                           "launch")
    blocks = grid_blocks(sd.width, B, per_sm * n_sm, threads)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = build.launch_fn("vrt_voronoi_stage", I.dtype)
    global LAUNCHES
    with torch.cuda.device(I.device):
        LAUNCHES += 1
        err = fn(*(ptr(t) for t in ins), ptr(scratch), ptr(change),
                 sd.steps.data_ptr(), bar.data_ptr(), n_steps,
                 sd.scratch_rows, B, sd.start, int(hoisted), int(fold),
                 blocks, torch.cuda.current_stream().cuda_stream)
    build.check(err, "voronoi_stage")
