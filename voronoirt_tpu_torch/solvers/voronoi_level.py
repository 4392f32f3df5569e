"""The level steps of a Voronoi sweep stage: CUDA kernel wrapper + plain version.

Replaces the JAX package's compiled level scan (plain XLA, no Pallas
kernel): voronoirt_tpu/solvers/sweep_voronoi.py `_stage_scan` (run by
`_run_stage`), `_run_relax_lap`, `_run_hoisted_lap_d` and
`_run_hoisted_lap`, fed by `_level_src_ew`.  One call runs one stage, or
one relax lap, on the (n_rows + 1, B) intensity array I in place: its
levels in order, each `passes` times, every level pass

  formal:  i_new = sum_j w_j (ew_j I[up_j] + src_j),  with (aw, bw, ew) =
           linear_weights(r_j (a_c + a_u_j) / 2), src_j = aw s_u_j + bw s_c
  hoisted: i_new = sum_j A_j I[up_j] + b,  from the lean weights

computed from the rows' upwind intensities as they stood before the pass
(a Jacobi pass) and written into the level's rows.  With `change` (a
2-element tensor) the pass also folds max |i_new - i_old| and max
|i_new| into change[0] and change[1], i_old read before the write.

The stage `sd` is the sweep's `_StageDev` (solvers/sweep_voronoi.py):
rows [sd.start + sd.off[l], sd.start + sd.off[l + 1]) of I are level l;
sd.up_slot / up_site / w / r (R, 2) and sd.row_site (R,) the rows'
upwind slots, upwind sites, blend weights, path lengths and own sites;
sd.self_ref flags the levels some of whose upwind slots lie in their own
rows, sd.scratch_rows the widest such level.

Kernel: csrc/voronoi_level.cu (V1), one launch a level and pass, the
loop over a stage's levels and passes in C: a self-referencing level
writes into a scratch buffer and copies it back, every other level
writes in place.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .formal import linear_weights

# V1 launches so far: one a level and pass (not counting the plain version)
LAUNCHES = 0
# calls of the plain version on a CUDA tensor, which no sweep makes: only
# a comparison with the kernel calls it there
PLAIN_ON_CARD = 0


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


def voronoi_stage_plain(I, sd, S_T=None, a_T=None, lean=None, change=None):
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
        else:
            A, b = lean[0][o0:o1], lean[1][o0:o1]
        for _ in range(sd.passes):
            i_u = I.index_select(0, fl).view(o1 - o0, 2, B)
            if lean is None:
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


def _check(I, sd, S_T, a_T, lean, change):
    if I.dim() != 2:
        raise ValueError(f"I must be (n_rows + 1, B), got {tuple(I.shape)}")
    if I.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {I.dtype}")
    if (lean is None) == (S_T is None or a_T is None):
        raise ValueError("give the fields (S_T, a_T) or the lean weights, "
                         "not both")
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
    # the C entry reads the ids as int64 and the host arrays as int64
    # offsets and int32 flags
    for t in (sd.up_slot, sd.up_site, sd.row_site):
        if t.dtype != torch.int64 or t.device != I.device:
            raise ValueError("the stage's ids must be int64 on I's device")
    if not (sd.off.dtype == np.int64 and sd.self_ref.dtype == np.int32
            and sd.off.flags.c_contiguous and sd.self_ref.flags.c_contiguous
            and len(sd.self_ref) == len(sd.off) - 1):
        raise ValueError("the stage's offsets must be contiguous int64 and "
                         "its flags int32, one a level")
    if sd.start + R > I.shape[0] - 1:
        raise ValueError(f"stage rows {sd.start}..{sd.start + R} outside "
                         f"the {I.shape[0] - 1} rows of I")


def voronoi_stage(I, sd, S_T=None, a_T=None, lean=None, change=None):
    """Run one stage (or relax lap) `sd` on I in place: from the fields
    S_T, a_T ((n, B) site-major) or from the lean weights lean = (A (R,
    2, B), b (R, B)); with change, fold the lap's change into it."""
    _check(I, sd, S_T, a_T, lean, change)
    if I.device.type == "cpu":
        return voronoi_stage_plain(I, sd, S_T, a_T, lean, change)
    if I.device.type != "cuda":
        raise ValueError(f"no voronoi_stage kernel for device {I.device}")
    # the formal form reads the fields and geometry, the hoisted form
    # A and b: the other pointers pass as null
    ins = ((S_T, a_T, sd.up_site, sd.row_site, sd.w, sd.r, None, None)
           if lean is None else (None,) * 6 + tuple(lean))
    if not all(t.is_contiguous() for t in (I, sd.up_slot, change) + ins
               if t is not None):
        raise ValueError("voronoi_stage kernel inputs must be contiguous")
    from ..kernels import build
    B = I.shape[1]
    scratch = (torch.empty((sd.scratch_rows, B), dtype=I.dtype,
                           device=I.device) if sd.scratch_rows else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    S_p, a_p, us_p, rs_p, w_p, r_p, A_p, b_p = (ptr(t) for t in ins)
    fn = build.launch_fn("vrt_voronoi_stage", I.dtype)
    global LAUNCHES
    with torch.cuda.device(I.device):
        LAUNCHES += int(np.count_nonzero(np.diff(sd.off))) * sd.passes
        err = fn(I.data_ptr(), S_p, a_p, sd.up_slot.data_ptr(), us_p, rs_p,
                 w_p, r_p, A_p, b_p, ptr(scratch), ptr(change),
                 sd.off.ctypes.data, sd.self_ref.ctypes.data,
                 len(sd.off) - 1, sd.passes, B, sd.start,
                 int(lean is not None), int(change is not None),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "voronoi_stage")
