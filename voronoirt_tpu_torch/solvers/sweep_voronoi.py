"""Irregular-grid (Voronoi) sweep in slot order.

Port of voronoirt_tpu/solvers/sweep_voronoi.py (reference
src/irregular_ray_tracing.jl Delaunay_upII/_downII): per site, blend the
formal solutions along the two most-upwind Delaunay edges.

Sites are renumbered per direction into schedule order, so every level
of a stage is a contiguous row range of the (rows + 1, B) intensity
array (one extra zero row, the dummy slot that absent upwinds read):

  [ boundary sites | stage-0 level 0 | stage-0 level 1 | ... | orphans ]

Host half: numpy copies of `SlotStage`, `SlotPlan`, `_schedule_stages`
and `build_slot_plan` (the JAX module imports jax at its top).  The copy
is JAX's unpadded form, `build_slot_plan(plan, n_sweeps, bucket=False)`,
and is held equal to it by tests/test_torch_sweep_voronoi.py.  JAX pads
stage shapes (`_bucket`, `share_plan_shapes`, `_pad_to`) only so that
the directions share compiled XLA programs, and its own tests pin the
padded and unpadded sweeps as bitwise equal on every real site
(tests/test_sweep_voronoi.py:385-502).  Also left out: the
`VRT_STAGE_ROWS` stage segmentation (`_split_stage`), the donation
switch and the hoist byte budget, which fit the sweep into a 16 GB TPU.

Device half: each stage (or relax lap) is one call of
`voronoi_level.voronoi_stage`.  On the card that is one cooperative
launch of the V1 kernel (csrc/voronoi_level.cu) on torch's current
stream, which walks the stage's level steps with a grid barrier between
them: each step gathers the level's upwind and own-site S and
extinction, forms the linear formal-solution weights, gathers the two
upwind intensity rows and writes the level's rows.  On the CPU the same
call runs the plain version, a Python loop over the levels of eager
torch operations.  'relax' stages (wavefront plans) repeat, with the
exact per-lap sup-change (folded on the card, read back once a lap) and
the two-lap adaptive exit; when a relax stage repeats, its laps take the
hoisted form (the "lean hoist", JAX's `_precompute_lean`): on the CPU
the lean weights are precomputed once and each lap reads only them and
I; on the card V1 forms them from the fields in each lap, and nothing
is precomputed.  Unlike the JAX sweep, the device layout drops the slot
plan's padding entries (`_device_arrays`): in 'layer' order the
rows of a stage are padded to its widest row, several times the real
slots at production site counts.  Real slots get the same values either
way.

LEVEL_STEPS counts the sequential level steps (one per level and pass,
hoisted laps included), STAGE_CALLS the stage and relax-lap calls (V1's
launches on the card), and LEAN_ON_CARD the lean precomputes on a CUDA
tensor (none on any sweep), each since it was last set to 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..observability import span, wait
from .voronoi_level import lean_weights, level_src_ew, voronoi_stage

LEVEL_STEPS = 0
STAGE_CALLS = 0
LEAN_ON_CARD = 0

# block size (in rows) of the hoisted-weight precompute: it bounds the
# precompute's eager (rows, 2, B) temporaries, about fifteen of them in
# the linear weights (191 MB each at B = 91 in float64), not what is
# hoisted
_LEAN_CHUNK_ROWS = 1 << 17


# ------------------------------------------------------------ slot plan

@dataclasses.dataclass(frozen=True)
class SlotStage:
    """One schedule stage in slot order.

    Rows [base + l*W, base + (l+1)*W) of the slot array are level l.
    up/w/r: (L, W, 2) upwind SLOT ids / blend weights / path lengths.
    passes: Jacobi passes per level (1 for exact topological levels).
    repeats: global repeats of the stage (seam-wrapping relaxation).
    kind: 'exact' | 'relax' | 'gs' | 'layer'; only 'relax' stages repeat.
    """
    base: int
    L: int
    W: int
    up: np.ndarray
    w: np.ndarray
    r: np.ndarray
    passes: int
    repeats: int
    kind: str = "exact"


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """JAX's SlotPlan, plus slot_site: the site id of every slot with
    padding left at n, which the device layout needs to drop it."""
    n_slots: int
    n_bc: int
    slot_gather: np.ndarray   # (n_slots,) site id per slot (clipped pad)
    site_gather: np.ndarray   # (n,) slot id per site
    stages: tuple
    slot_site: np.ndarray     # (n_slots,) site id per slot, n for padding


def _schedule_stages(plan, n_sweeps):
    """(schedule (L, W), passes, kind, repeats, occ) in execution order."""
    if plan.exact_levels is not None or plan.relax_levels is not None:
        out = []
        if plan.exact_levels is not None:
            out.append((plan.exact_levels, 1, "exact", 1, None))
        if plan.relax_levels is not None:
            out.append((plan.relax_levels, 1, "relax",
                        int(plan.relax_repeats), None))
        return out
    if plan.gs_levels is not None:
        # exact Gauss-Seidel row order (grid/voronoi.py
        # _gs_layer_schedule): n_sweeps is already baked into the rows
        return [(plan.gs_levels, 1, "gs", 1, plan.gs_up_occ)]
    return [(plan.layer_sites, n_sweeps, "layer", 1, None)]


def build_slot_plan(plan, n_sweeps=3):
    """Compile the slot renumbering for one direction (host, cached on
    the plan per n_sweeps).

    Every real site appears in exactly one schedule row (bc sites form
    slot block 0); padding entries (site id == n) map to the dummy slot
    n_slots, whose row stays zero.  A `_pad_to` target that the JAX
    package's share_plan_shapes attached to the plan is ignored.
    """
    cache = getattr(plan, "_torch_slot_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_torch_slot_cache", cache)
    if n_sweeps in cache:
        return cache[n_sweeps]

    n = plan.n
    n_bc = len(plan.bc_sites)
    blocks = [np.asarray(plan.bc_sites, dtype=np.int64)]
    base = n_bc
    metas = []
    for sched, passes, kind, repeats, occ in _schedule_stages(plan,
                                                             n_sweeps):
        sched = np.asarray(sched, dtype=np.int64)
        L, W = sched.shape
        blocks.append(sched.reshape(-1))
        metas.append((sched, occ, base, L, W, passes, kind, repeats))
        base += L * W
    slot2site = np.concatenate(blocks)

    # sites absent from every schedule row (the reference's skipped last
    # perm site, unreachable layer-0 sites) still appear as UPWINDS of
    # scheduled sites: give them read-only slots so their S/alpha gather
    # real values while their intensity stays the initial 0 (exactly the
    # reference's behaviour) -- the dummy zero row is only for padding.
    present = np.zeros(n, dtype=bool)
    present[slot2site[slot2site < n]] = True
    orphans = np.nonzero(~present)[0]
    if orphans.size:
        slot2site = np.concatenate([slot2site, orphans])
    n_slots = len(slot2site)

    site2slot = np.full(n + 1, n_slots, dtype=np.int64)  # dummy -> zero row
    real = slot2site < n
    site2slot[slot2site[real]] = np.nonzero(real)[0]

    up_pad = np.concatenate(
        [plan.upwind.astype(np.int64), [[n, n]]], axis=0)   # (n+1, 2)
    w_pad = np.concatenate([plan.weights, [[0.0, 0.0]]], axis=0)
    r_pad = np.concatenate([plan.r, [[0.0, 0.0]]], axis=0)

    stages = []
    for sched, occ, b, L, W, passes, kind, repeats in metas:
        up_slots = site2slot[up_pad[sched]]               # (L, W, 2) slots
        if kind == "gs" and occ is not None:
            # exact-GS stage: a site occurs once per pass; readers whose
            # upwind lives in the same layer target the occurrence of the
            # pass their value must come from; -1 keeps the site-level
            # resolution
            up_slots = np.where(occ >= 0, b + occ, up_slots)
        stages.append(SlotStage(
            base=b, L=L, W=W, up=up_slots.astype(np.int32),
            w=w_pad[sched], r=r_pad[sched],
            passes=passes, repeats=repeats, kind=kind))

    sp = SlotPlan(n_slots=n_slots, n_bc=n_bc,
                  slot_gather=np.minimum(slot2site, n - 1).astype(np.int32),
                  site_gather=site2slot[:n].astype(np.int32),
                  stages=tuple(stages), slot_site=slot2site)
    cache[n_sweeps] = sp
    return sp


# ------------------------------------------------------- device arrays

@dataclasses.dataclass(frozen=True)
class _StageDev:
    """A stage on the device with its padding dropped: rows [start +
    off[l], start + off[l + 1]) of the compact intensity array are level
    l.  off: (L + 1,) int64 host array; self_ref: (L,) int32 host flags,
    1 where an upwind slot of the level lies in its own rows (a Jacobi
    pass there must not write in place); scratch_rows: the widest such
    level's rows, 0 if none; width: the widest level's rows.  steps:
    (L * passes, 3) int64 on the device, V1's step table
    (_step_table).  up_slot/up_site/w/r: (R, 2) upwind slot ids, upwind
    site ids, blend weights and path lengths; row_site: (R,) own-site
    ids."""
    kind: str
    passes: int
    repeats: int
    start: int
    off: np.ndarray
    self_ref: np.ndarray
    scratch_rows: int
    width: int
    steps: torch.Tensor
    up_slot: torch.Tensor
    up_site: torch.Tensor
    row_site: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor


def _self_ref(up_rows, off):
    """(L,) int32: 1 where a level's upwind rows (up_rows (R, 2), rows
    counted from the stage's first) include one of its own rows."""
    level = np.repeat(np.arange(len(off) - 1), np.diff(off))
    inside = ((up_rows >= off[level][:, None])
              & (up_rows < off[level + 1][:, None])).any(1)
    flags = np.zeros(len(off) - 1, dtype=np.int32)
    flags[level[inside]] = 1
    return flags


def _step_table(off, self_ref, passes):
    """(L * passes, 3) int64, a row a step (each level's passes in
    order): the step's first row counted from the stage's first, its
    rows, and the scratch buffer a self-referencing step writes (the
    step's index mod 2, so consecutive steps alternate), -1 where the
    step writes in place."""
    level = np.repeat(np.arange(len(off) - 1), passes)
    step = np.arange(len(level))
    return np.stack([off[level], np.diff(off)[level],
                     np.where(self_ref[level] > 0, step % 2, -1)],
                    1).astype(np.int64)


def _device_arrays(sp, device, dtype):
    """(stages, site_gather, n_rows) on `device`, built once per slot
    plan, device and dtype.

    The slot plan's padding entries (site id n) are dropped: real slots
    keep their order and are renumbered densely, so each level stays one
    contiguous row range of an (n_rows + 1, B) intensity array whose
    last row is the dummy zero row.  Padding only ever read the dummy
    row with weight 0 and wrote zeros into padding slots, so the real
    slots' values are those of the padded layout.  The field gathers
    read the (n, B) site-ordered S and extinction through SITE-id maps,
    so no slot-reordered copies of them exist; an upwind that is the
    dummy slot reads site 0, with weight 0 and path length 0."""
    cache = getattr(sp, "_dev_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(sp, "_dev_cache", cache)
    key = (str(device), dtype)
    if key in cache:
        return cache[key]

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def val(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    n = len(sp.site_gather)
    real = sp.slot_site < n
    n_rows = int(np.count_nonzero(real))
    # old slot id -> dense row; padding and the dummy slot -> dummy row
    dense = np.full(sp.n_slots + 1, n_rows, dtype=np.int64)
    dense[np.nonzero(real)[0]] = np.arange(n_rows)
    # old slot id -> site id, the dummy slot -> site 0
    slot_full = np.concatenate(
        [sp.slot_gather, np.zeros(1, dtype=sp.slot_gather.dtype)])
    stages = []
    for st in sp.stages:
        rows = st.base + np.arange(st.L * st.W, dtype=np.int64)
        keep = real[rows]
        width = keep.reshape(st.L, st.W).sum(1)
        off = np.concatenate([[0], np.cumsum(width)]).astype(np.int64)
        up = st.up.reshape(-1, 2)[keep]
        start = int(np.count_nonzero(real[:st.base]))
        self_ref = _self_ref(dense[up] - start, off)
        stages.append(_StageDev(
            kind=st.kind, passes=st.passes, repeats=st.repeats,
            start=start, off=off, self_ref=self_ref,
            scratch_rows=int(width[self_ref > 0].max(initial=0)),
            width=int(width.max(initial=0)),
            steps=idx(_step_table(off, self_ref, st.passes)),
            up_slot=idx(dense[up]), up_site=idx(slot_full[up]),
            row_site=idx(slot_full[rows[keep]]),
            w=val(st.w.reshape(-1, 2)[keep]),
            r=val(st.r.reshape(-1, 2)[keep])))
    cache[key] = (tuple(stages), idx(dense[sp.site_gather]), n_rows)
    return cache[key]


def device_plan(plan, n_sweeps, device, dtype):
    """The slot plan of one direction and its device arrays, built and
    cached (the first sweep of a direction builds them otherwise)."""
    return _device_arrays(build_slot_plan(plan, n_sweeps), device, dtype)


# ---------------------------------------------------------- device sweep

def _stage(I, sd, S_T=None, a_T=None, lean=None, change=None,
           hoisted=False):
    """One pass over a stage's levels, from the fields or the lean
    weights, I updated in place; counted in LEVEL_STEPS and
    STAGE_CALLS."""
    global LEVEL_STEPS, STAGE_CALLS
    voronoi_stage(I, sd, S_T, a_T, lean, change, hoisted)
    LEVEL_STEPS += (len(sd.off) - 1) * sd.passes
    STAGE_CALLS += 1


def _run_stage(I, sd, S_T, a_T):
    """One pass over a stage's levels (exact / gs / layer, or one plain
    relax lap), I updated in place."""
    _stage(I, sd, S_T, a_T)


def _rel_change(change):
    return change[0] / torch.clamp(change[1], min=1e-30)


def _run_relax_lap(I, sd, S_T, a_T):
    """One relax lap + its EXACT relative sup-change (0-d tensor): each
    level's old rows are read before the update writes them, so the
    change covers every written row (unwritten rows cannot change)."""
    change = torch.zeros(2, dtype=I.dtype, device=I.device)
    _stage(I, sd, S_T, a_T, change=change)
    return _rel_change(change)


def _precompute_lean(sd, S_T, a_T):
    """The packed lean weights (A (R, 2, B), b (R, B)) of a whole stage,
    built in blocks of _LEAN_CHUNK_ROWS rows (they depend on the fields
    only, not on I, so the blocks ignore the levels).  Eager torch on
    either device: it runs once a relax stage and direction, outside the
    level loop, which then reads only A, b and I.  No sweep calls it on
    the card (counted in LEAN_ON_CARD), where V1 forms the weights."""
    global LEAN_ON_CARD
    if S_T.is_cuda:
        LEAN_ON_CARD += 1
    R, B = int(sd.off[-1]), S_T.shape[1]
    A = torch.empty((R, 2, B), dtype=S_T.dtype, device=S_T.device)
    b = torch.empty((R, B), dtype=S_T.dtype, device=S_T.device)
    for c0 in range(0, R, _LEAN_CHUNK_ROWS):
        c = slice(c0, min(c0 + _LEAN_CHUNK_ROWS, R))
        ew, src = level_src_ew(S_T, a_T, sd.up_site[c], sd.row_site[c],
                               sd.r[c])
        A[c], b[c] = lean_weights(sd.w[c][..., None], ew, src)
    return A, b


def _hoist(sd, S_T, a_T):
    """What a repeated relax stage's hoisted laps read, as voronoi_stage's
    keywords: on the card the fields, from which V1 forms the lean
    weights in each lap; elsewhere the lean weights, precomputed once."""
    if S_T.is_cuda:
        return {"S_T": S_T, "a_T": a_T, "hoisted": True}
    return {"lean": _precompute_lean(sd, S_T, a_T)}


def _run_hoisted_lap(I, sd, hoist):
    """One relax lap from the lean weights (hoist: _hoist's keywords)."""
    _stage(I, sd, **hoist)


def _run_hoisted_lap_d(I, sd, hoist):
    """Hoisted relax lap + its exact relative sup-change."""
    change = torch.zeros(2, dtype=I.dtype, device=I.device)
    _stage(I, sd, change=change, **hoist)
    return _rel_change(change)


def _sweep_slots(stages, site_gather, n_rows, relax_tol, S_T, a_T, I0):
    """The slot sweep: stages in order, a relax stage's laps repeated
    up to its repeat count.  With relax_tol > 0, two consecutive laps
    whose relative sup-change is at most relax_tol end the repeats (a
    single stalled-but-unconverged lap must not truncate the schedule);
    each lap reads one scalar back.  S_T/a_T: (n, B) site-ordered
    fields.  Returns I as (n, B)."""
    B = S_T.shape[1]
    with span("engine.sweep_fill", S_T.device):
        I = torch.zeros((n_rows + 1, B), dtype=S_T.dtype,
                        device=S_T.device)
        I[:I0.shape[-1]] = I0.T
    for sd in stages:
        if sd.kind != "relax":
            _run_stage(I, sd, S_T, a_T)
            continue
        hoist = _hoist(sd, S_T, a_T) if sd.repeats > 1 else None
        if not relax_tol:
            for _ in range(sd.repeats):
                if hoist is not None:
                    _run_hoisted_lap(I, sd, hoist)
                else:
                    _run_stage(I, sd, S_T, a_T)
            continue
        streak = 0
        for _ in range(sd.repeats):
            if hoist is not None:
                rel = _run_hoisted_lap_d(I, sd, hoist)
            else:
                rel = _run_relax_lap(I, sd, S_T, a_T)
            with wait():
                streak = streak + 1 if float(rel) <= relax_tol else 0
            if streak >= 2:
                break
    with span("engine.sweep_gather", I.device):
        return I.index_select(0, site_gather)


def sweep_voronoi_t(plan, S_T, a_T, I0, n_sweeps=3, relax_tol=0.0):
    """sweep_voronoi on site-major (n, B) fields; returns I as (n, B).

    The engine's entry point: it transposes S once per wavelength chunk
    and emits each direction's extinction site-major, so no transposes
    happen per direction."""
    stages, site_gather, n_rows = device_plan(plan, n_sweeps, S_T.device,
                                              S_T.dtype)
    return _sweep_slots(stages, site_gather, n_rows, float(relax_tol),
                        S_T, a_T, I0)


def sweep_voronoi(plan, S, alpha, I0, n_sweeps=3, relax_tol=0.0):
    """Formal solution over the irregular grid along plan.k.

    Args:
      plan: VoronoiPlan (static geometry for one direction).
      S, alpha: (B, n) or (n,) source function / extinction tensors.
      I0: (B, n_bc) or (n_bc,) boundary intensity on plan.bc_sites
          (bottom-layer sites for up sweeps: lambda_iteration.jl:99-102).
      relax_tol: early-exit tolerance for seam-wrap relax repeats
          ('wavefront' plans); 0 = fixed repeat count.
    Returns:
      I with the shape of S.
    """
    squeeze = S.dim() == 1
    if squeeze:
        S, alpha, I0 = S[None], alpha[None], I0[None]
    I_T = sweep_voronoi_t(plan, S.T.contiguous(), alpha.T.contiguous(), I0,
                          n_sweeps=n_sweeps, relax_tol=relax_tol)
    return I_T[:, 0] if squeeze else I_T.T
