"""The Voronoi level steps (solvers/voronoi_level.py, kernel V1 in
csrc/voronoi_level.cu) against the JAX package's compiled stage
functions, float64 on the CPU.

Each stage kind runs through the port's plain stage function and through
the sweep's stage functions that dispatch to it, against JAX's
`_run_stage`, `_run_relax_lap`, `_run_hoisted_lap` and
`_run_hoisted_lap_d` on JAX's unpadded slot plan of the same direction,
from the same intensities: 'layer' (three Jacobi passes a level, the
plan's exact Gauss-Seidel schedule dropped), 'gs', and the 'wavefront'
plans' 'exact' and 'relax' stages, the relax laps with and without
their change, and the hoisted laps also with the lean weights formed
from the fields (hoisted=True, V1's form on the card) against JAX's
`_precompute_lean` and hoisted laps.  Tolerances, relative (absolute
where the reference is 0):
1e-12 with the extinction at 1-100, 2e-11 with it down to 0.01, where
the linear weights' middle branch cancels just above its 5e-4 guard and
a one-ulp exp difference between XLA and PyTorch grows (ROADMAP C3; the
same bars as tests/test_torch_sweep_voronoi.py).  The host half (level
offsets, self-reference flags, V1's step table and grid size) is held
against brute force, and a numpy emulation of V1's read rule between
its steps (scratch buffers, copies back a step later, every row of a
step read and written in a random order) against the plain version.
The tests marked cuda hold the kernel against the plain version on the
card, bit for bit, and skip without a card.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voronoirt_tpu import grid as jgrid
from voronoirt_tpu.solvers import sweep_voronoi as jsv
from voronoirt_tpu_torch.grid import build_sites, build_voronoi_plan
from voronoirt_tpu_torch.quadrature import get_quadrature
from voronoirt_tpu_torch.solvers import sweep_voronoi as tsv
from voronoirt_tpu_torch.solvers import voronoi_level as vl

QUAD = get_quadrature("ul7n12")
# (order, direction, keep the gs schedule): direction 2 is steep (|mu|
# 0.888; its wavefront plan is exact-only at this size), 8 grazing (0.205;
# its wavefront plan is relax-only)
CASES = {"layer": ("layer", 8, False), "gs": ("layer", 8, True),
         "exact": ("wavefront", 2, True), "relax": ("wavefront", 8, True)}
TOLS = [(0.0, 1e-12), (-2.0, 2e-11)]


def _fields(n):
    return dict(temperature=np.ones(n), electron_density=np.zeros(n),
                hydrogen_populations=np.zeros(n), velocity_z=np.zeros(n),
                velocity_x=np.zeros(n), velocity_y=np.zeros(n))


@pytest.fixture(scope="module")
def sites():
    """1,000 random sites, (port, JAX), from the same positions."""
    n = 1000
    pos = np.random.default_rng(5).uniform(0, 1, (n, 3))
    return (build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n)),
            jgrid.build_sites(pos.copy(), (0, 1, 0, 1, 0, 1), _fields(n)))


def _plans(sites, kind):
    """The case's plan in each package; 'layer' drops the gs schedule,
    so the stage is the Jacobi-pass layer stage."""
    order, i, keep_gs = CASES[kind]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # 'layer' at grazing angles
        plans = [build(s, QUAD.k[i], bool(QUAD.is_up[i]), order=order)
                 for build, s in zip((build_voronoi_plan,
                                      jgrid.build_voronoi_plan), sites)]
    if not keep_gs:
        plans = [dataclasses.replace(p, gs_levels=None, gs_up_occ=None)
                 for p in plans]
    return plans


def _max_rel(got, want):
    denom = np.where(want == 0.0, 1.0, want)
    return float(np.max(np.where(want == 0.0, np.abs(got),
                                 np.abs(got / denom - 1.0))))


class _Pair:
    """One direction's stage in both packages, from the same inputs: the
    port's compact intensity array and JAX's slot-ordered one, the real
    slots equal."""

    def __init__(self, sites, kind, B, log_alpha_min, seed=0):
        plan_t, plan_j = _plans(sites, kind)
        n = sites[0].n
        self.sp = tsv.build_slot_plan(plan_t, 3)
        self.stages, _, self.n_rows = tsv._device_arrays(
            self.sp, "cpu", torch.float64)
        self.sp_j = jsv.build_slot_plan(plan_j, 3, bucket=False)
        self.xs_j = jsv._device_arrays(self.sp_j)[0]
        (self.k,) = [k for k, sd in enumerate(self.stages)
                     if sd.kind == kind]
        rng = np.random.default_rng(seed + B)
        self.S = rng.uniform(0.1, 1.0, (n, B))
        self.a = 10.0 ** rng.uniform(log_alpha_min, 2.0, (n, B))
        self.real = np.nonzero(self.sp.slot_site < n)[0]
        I_j = np.zeros((self.sp.n_slots + 1, B))
        I_j[self.real] = rng.uniform(0.0, 1.0, (len(self.real), B))
        self.I_j0 = I_j

    @property
    def sd(self):
        return self.stages[self.k]

    def torch_inputs(self, device="cpu", dtype=torch.float64):
        I = torch.zeros((self.n_rows + 1, self.S.shape[1]), dtype=dtype,
                        device=device)
        I[:self.n_rows] = torch.as_tensor(self.I_j0[self.real], dtype=dtype)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        return I, t(self.S), t(self.a)

    def jax(self, fn):
        """JAX's stage function fn ('stage', 'lap', 'hoisted',
        'hoisted_d'; the '_fields' forms are JAX's hoisted laps too) on
        the stage: (I on the real slots, rel or None)."""
        fn = fn.replace("_fields", "")
        st = self.sp_j.stages[self.k]
        xs = self.xs_j[self.k][:6]
        I = jnp.asarray(self.I_j0)
        S, a = jnp.asarray(self.S), jnp.asarray(self.a)
        rel = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # donation on the CPU
            if fn == "stage":
                I = jsv._run_stage(st.W, st.passes, I, xs, S, a)
            elif fn == "lap":
                I, rel = jsv._run_relax_lap(st.W, st.passes, I, xs, S, a)
            else:
                lean = jsv._precompute_lean(st.W, xs, S, a)
                if fn == "hoisted":
                    I = jsv._run_hoisted_lap(st.W, st.passes, I, lean)
                else:
                    I, rel = jsv._run_hoisted_lap_d(st.W, st.passes, I, lean)
        return (np.asarray(I)[self.real],
                None if rel is None else float(rel))


def _folds(fn):
    return fn == "lap" or fn.endswith("_d")


def _run_port(pair, fn, I, S, a, plain):
    """The port's stage function fn on I: through the plain stage
    function itself, or through the sweep's stage functions.  The
    '_fields' hoisted laps form the lean weights from the fields."""
    sd = pair.sd
    change = None
    if _folds(fn):
        change = torch.zeros(2, dtype=I.dtype, device=I.device)
    if fn.startswith("hoisted_fields"):
        hoist = {"S_T": S, "a_T": a, "hoisted": True}
    elif fn.startswith("hoisted"):
        hoist = {"lean": tsv._precompute_lean(sd, S, a)}
    else:
        hoist = {"S_T": S, "a_T": a}
    if plain:
        vl.voronoi_stage_plain(I, sd, change=change, **hoist)
        return None if change is None else float(tsv._rel_change(change))
    rel = {"stage": lambda: tsv._run_stage(I, sd, S, a),
           "lap": lambda: tsv._run_relax_lap(I, sd, S, a),
           "hoisted": lambda: tsv._run_hoisted_lap(I, sd, hoist),
           "hoisted_d": lambda: tsv._run_hoisted_lap_d(I, sd, hoist),
           "hoisted_fields": lambda: tsv._run_hoisted_lap(I, sd, hoist),
           "hoisted_fields_d": lambda: tsv._run_hoisted_lap_d(I, sd, hoist),
           }[fn]()
    return None if rel is None else float(rel)


STAGE_FNS = [("layer", "stage"), ("gs", "stage"), ("exact", "stage"),
             ("relax", "stage"), ("relax", "lap"), ("relax", "hoisted"),
             ("relax", "hoisted_d"), ("relax", "hoisted_fields"),
             ("relax", "hoisted_fields_d")]


@pytest.mark.parametrize("log_alpha_min,rtol", TOLS)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "dispatch"])
@pytest.mark.parametrize("kind,fn", STAGE_FNS)
def test_stage_matches_jax(sites, kind, fn, plain, B, log_alpha_min, rtol):
    """The port's stage functions == JAX's on the same stage and
    intensities: the plain stage function and the sweep's dispatching
    stage functions, every stage kind, the relax laps with and without
    the change (compared too), the lean weights precomputed in both or,
    in the port, formed from the fields within the lap."""
    pair = _Pair(sites, kind, B, log_alpha_min)
    want, rel_j = pair.jax(fn)
    I, S, a = pair.torch_inputs()
    rel_t = _run_port(pair, fn, I, S, a, plain)
    got = I[:pair.n_rows].numpy()
    err = _max_rel(got, want)
    assert err < rtol, f"{kind} {fn}: max rel diff {err:.3e}"
    assert not np.array_equal(got, pair.I_j0[pair.real])   # it wrote
    assert float(I[-1].abs().max()) == 0.0                 # the dummy row
    if rel_j is None:
        assert rel_t is None
    else:
        assert rel_t > 0.0 and abs(rel_t / rel_j - 1.0) < rtol


@pytest.mark.parametrize("relax_tol", [0.0, 1e-7])
@pytest.mark.parametrize("kind", ["layer", "gs", "relax"])
def test_sweep_through_stages_matches_jax(sites, kind, relax_tol):
    """sweep_voronoi_t through the stage functions == the JAX sweep, the
    Jacobi 'layer' stage included, with and without the adaptive relax
    exit; neither the kernel nor the plain version on a card ran."""
    plan_t, plan_j = _plans(sites, kind)
    n, B = sites[0].n, 3
    rng = np.random.default_rng(11)
    S = rng.uniform(0.1, 1.0, (B, n))
    alpha = 10.0 ** rng.uniform(0.0, 2.0, (B, n))
    I0 = rng.uniform(0.0, 1.0, (B, len(plan_t.bc_sites)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jsv.sweep_voronoi(plan_j, S, alpha, I0,
                                            relax_tol=relax_tol))
    launches, plain_on_card = vl.LAUNCHES, vl.PLAIN_ON_CARD
    got = tsv.sweep_voronoi_t(plan_t, torch.from_numpy(S.T.copy()),
                              torch.from_numpy(alpha.T.copy()),
                              torch.from_numpy(I0),
                              relax_tol=relax_tol).numpy().T
    assert _max_rel(got, want) < 1e-12
    assert (vl.LAUNCHES, vl.PLAIN_ON_CARD) == (launches, plain_on_card)


@pytest.mark.parametrize("kind", list(CASES))
def test_host_offsets_and_self_reference(sites, kind):
    """The stage's host arrays: the level offsets (contiguous int64)
    count each level's real slots, the self-reference flags
    equal a brute-force check of every level's upwind rows against its
    own, and the scratch rows are the widest flagged level's.  'layer'
    and 'gs' levels (and relax bins) read their own rows, exact levels
    never."""
    plan_t, _ = _plans(sites, kind)
    sp = tsv.build_slot_plan(plan_t, 3)
    stages, _, n_rows = tsv._device_arrays(sp, "cpu", torch.float64)
    real = sp.slot_site < sites[0].n
    (k,) = [k for k, sd in enumerate(stages) if sd.kind == kind]
    sd, st = stages[k], sp.stages[k]
    assert sd.off.dtype == np.int64 and sd.off.flags["C_CONTIGUOUS"]
    assert sd.self_ref.dtype == np.int32 and sd.self_ref.flags["C_CONTIGUOUS"]
    per_level = real[st.base:st.base + st.L * st.W].reshape(st.L, st.W)
    np.testing.assert_array_equal(
        sd.off, np.concatenate([[0], np.cumsum(per_level.sum(1))]))
    up = sd.up_slot.numpy()
    flags = []
    for l in range(len(sd.off) - 1):
        lo, hi = sd.start + sd.off[l], sd.start + sd.off[l + 1]
        flags.append(int(any(lo <= u < hi
                             for u in up[sd.off[l]:sd.off[l + 1]].ravel())))
    np.testing.assert_array_equal(sd.self_ref, flags)
    width = np.diff(sd.off)
    assert sd.scratch_rows == max([w for w, f in zip(width, flags) if f],
                                  default=0)
    if kind == "exact":
        assert not any(flags) and sd.scratch_rows == 0
    else:
        assert any(flags) and sd.scratch_rows > 0


@pytest.mark.parametrize("kind", list(CASES))
def test_step_table_and_grid(sites, kind):
    """V1's host tables against brute force: the step table (a row a
    level pass, in order: first row, rows, and the scratch buffer, which
    alternates by step, where the level reads its own rows, else -1) on
    the device as the kernel reads it, for the stage's passes and for 3;
    the widest level; and the grid, one thread an item of the widest
    step, capped at the blocks the card holds at once."""
    plan_t, _ = _plans(sites, kind)
    stages, _, _ = tsv._device_arrays(tsv.build_slot_plan(plan_t, 3), "cpu",
                                      torch.float64)
    (sd,) = [sd for sd in stages if sd.kind == kind]
    for passes in (sd.passes, 3):
        want, s = [], 0
        for l in range(len(sd.off) - 1):
            for _ in range(passes):
                buf = s % 2 if sd.self_ref[l] else -1
                want.append([sd.off[l], sd.off[l + 1] - sd.off[l], buf])
                s += 1
        got = tsv._step_table(sd.off, sd.self_ref, passes)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert sd.steps.dtype == torch.int64 and sd.steps.is_contiguous()
    np.testing.assert_array_equal(
        sd.steps.numpy(), tsv._step_table(sd.off, sd.self_ref, sd.passes))
    assert sd.width == max(np.diff(sd.off))
    for B, resident, threads in ((1, 528, 256), (91, 528, 256),
                                 (91, 3, 256), (13, 1056, 128)):
        items = sd.width * B
        want = next(b for b in range(1, resident + 1)
                    if b * threads >= items or b == resident)
        assert vl.grid_blocks(sd.width, B, resident, threads) == want
    assert vl.grid_blocks(0, 91, 528, 256) == 1


def _emulate_v1(I, sd, S, a, passes, seed=0):
    """numpy emulation of V1's read rule over the step table of stage sd
    at `passes` passes a level, in the formal form with the lap's change
    folded: a step reads an upwind or i_old from the previous step's
    scratch buffer where it lies in that step's rows and that step wrote
    there, else from I; a self-referencing step writes its scratch
    buffer, any other I in place; a step copies the previous step's
    scratch rows back into I, and the last step's are copied at the end.
    The rows of a step and its copies back run in a random order, each
    row read and written at once, as the kernel's threads may interleave.
    Returns (I, [max |i_new - i_old|, max |i_new|])."""
    rng = np.random.default_rng(seed)
    I = I.numpy().copy()
    B = I.shape[1]
    scratch = np.full((2, max(sd.scratch_rows, 1), B), np.nan)
    ew, src = (t.numpy() for t in vl.level_src_ew(S, a, sd.up_site,
                                                  sd.row_site, sd.r))
    up, w = sd.up_slot.numpy(), sd.w.numpy()
    dmax = smax = 0.0
    prev = None

    def read(u):
        if prev is not None and prev[2] >= 0:
            rel = u - (sd.start + prev[0])
            if 0 <= rel < prev[1]:
                return scratch[prev[2], rel]
        return I[u]

    def copy_back(i):
        I[sd.start + prev[0] + i] = scratch[prev[2], i]

    for k0, rows, buf in tsv._step_table(sd.off, sd.self_ref, passes):
        tasks = [("row", i) for i in range(rows)]
        if prev is not None and prev[2] >= 0:
            tasks += [("copy", i) for i in range(prev[1])]
        for j in rng.permutation(len(tasks)):
            what, i = tasks[j]
            if what == "copy":
                copy_back(i)
                continue
            k = k0 + i
            i0, i1, old = read(up[k, 0]), read(up[k, 1]), read(sd.start + k)
            new = (w[k, 0] * (ew[k, 0] * i0 + src[k, 0])
                   + w[k, 1] * (ew[k, 1] * i1 + src[k, 1]))
            dmax = max(dmax, float(np.abs(new - old).max()))
            smax = max(smax, float(np.abs(new).max()))
            if buf < 0:
                I[sd.start + k] = new
            else:
                scratch[buf, i] = new
        prev = (k0, rows, buf)
    if prev[2] >= 0:
        for i in range(prev[1]):
            copy_back(i)
    return I, [dmax, smax]


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("kind", ["layer", "gs", "relax"])
def test_v1_read_rule_emulation(sites, kind, passes):
    """V1's read rule between steps (one barrier a step, two scratch
    buffers, copies back a step later), emulated in numpy with every
    step's rows in a random order, equals the plain version bit for bit,
    the folded change too, on the 'layer', 'gs' and 'relax' plans at 3
    passes a level (every 'layer' level, and some 'gs' levels and relax
    bins, read their own rows) and at 1 (three passes of a relax bin
    reach its fixed point in any read order, one does not)."""
    pair = _Pair(sites, kind, 3, 0.0)
    sd = dataclasses.replace(pair.sd, passes=passes)
    assert sd.self_ref.any() and not sd.self_ref.all() or kind == "layer"
    I, S, a = pair.torch_inputs()
    got, change = _emulate_v1(I, sd, S, a, passes)
    want = I.clone()
    ch = torch.zeros(2, dtype=torch.float64)
    vl.voronoi_stage_plain(want, sd, S, a, change=ch)
    np.testing.assert_array_equal(got, want.numpy())
    assert change == ch.tolist()
    assert not np.array_equal(got, I.numpy())


@pytest.mark.parametrize("kind", ["layer", "gs"])
def test_jacobi_pass_reads_old_rows(sites, kind):
    """A self-referencing level's pass reads its own rows as they were
    before it: an in-place update that writes each row as soon as it is
    computed, last row first (as a racing launch may), gives other
    values, so the hazard the kernel's scratch buffer avoids is real on
    these plans (a gs level's own upwinds lie in its later rows)."""
    pair = _Pair(sites, kind, 2, 0.0)
    sd = pair.sd
    I, S, a = pair.torch_inputs()
    I_gs = I.clone()
    vl.voronoi_stage_plain(I, sd, S, a)
    l = int(np.nonzero(sd.self_ref)[0][0])
    # the same stage with the first self-referencing level updated row
    # by row in place, last row first
    off = sd.off.tolist()
    for m in range(len(off) - 1):
        lev = dataclasses.replace(sd, off=np.array(sd.off[m:m + 2]),
                                  self_ref=sd.self_ref[m:m + 1])
        if m != l:
            vl.voronoi_stage_plain(I_gs, lev, S, a)
            continue
        for _ in range(sd.passes):
            for row in reversed(range(off[m], off[m + 1])):
                one = dataclasses.replace(sd, off=np.array([row, row + 1]),
                                          passes=1)
                vl.voronoi_stage_plain(I_gs, one, S, a)
    assert not torch.equal(I, I_gs)


def test_refusals():
    """The wrapper refuses what the kernel does not take, on any device."""
    pair_sd = _StubStage()
    I = torch.zeros((5, 2), dtype=torch.float64)
    S = torch.ones((3, 2), dtype=torch.float64)
    lean = (torch.ones((2, 2, 2), dtype=torch.float64),
            torch.ones((2, 2), dtype=torch.float64))
    with pytest.raises(ValueError):     # both the fields and the lean
        vl.voronoi_stage(I, pair_sd, S, S, lean=lean)
    with pytest.raises(ValueError):     # neither
        vl.voronoi_stage(I, pair_sd)
    with pytest.raises(TypeError):
        vl.voronoi_stage(I.half(), pair_sd, S.half(), S.half())
    with pytest.raises(ValueError):     # mixed dtypes
        vl.voronoi_stage(I, pair_sd, S.float(), S.float())
    with pytest.raises(ValueError):     # fields of another width
        vl.voronoi_stage(I, pair_sd, S[:, :1], S[:, :1])
    with pytest.raises(ValueError):     # lean of another length
        vl.voronoi_stage(I, pair_sd, lean=(lean[0][:1], lean[1][:1]))
    with pytest.raises(ValueError):
        vl.voronoi_stage(I, pair_sd, S, S, change=torch.zeros(3).double())
    with pytest.raises(ValueError):     # rows past the dummy row
        vl.voronoi_stage(I[:3], pair_sd, S, S)
    with pytest.raises(ValueError):     # ids the C entry cannot read
        vl.voronoi_stage(I, dataclasses.replace(
            pair_sd, up_slot=pair_sd.up_slot.int()), S, S)
    with pytest.raises(ValueError):     # a step table V1 cannot read
        vl.voronoi_stage(I, dataclasses.replace(
            pair_sd, steps=pair_sd.steps.int()), S, S)
    with pytest.raises(ValueError):     # the step table of other passes
        vl.voronoi_stage(I, dataclasses.replace(pair_sd, passes=2), S, S)
    with pytest.raises(ValueError):     # the packed pair and hoisted
        vl.voronoi_stage(I, pair_sd, lean=lean, hoisted=True)
    with pytest.raises(ValueError):
        vl.voronoi_stage(I.to("meta"), pair_sd, S.to("meta"),
                         S.to("meta"))
    vl.voronoi_stage(I, pair_sd, S, S)       # the stub itself runs


@dataclasses.dataclass
class _StubStage:
    """Two one-row levels over sites 0-2, reading the dummy row."""
    start: int = 1
    passes: int = 1
    off: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 2], dtype=np.int64))
    self_ref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, dtype=np.int32))
    scratch_rows: int = 0
    width: int = 1
    steps: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor([[0, 1, -1], [1, 1, -1]]))
    up_slot: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.full((2, 2), 4))
    up_site: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((2, 2), dtype=torch.int64))
    row_site: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor([1, 2]))
    w: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((2, 2), dtype=torch.float64))
    r: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((2, 2), dtype=torch.float64))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [1, 13, 91])
@pytest.mark.parametrize("kind,fn", STAGE_FNS)
def test_kernel_matches_plain_on_card(sites, cuda, kind, fn, B, dtype):
    """V1 against the plain version on the card, bit for bit: the
    intensities, and the change where the lap folds it; one launch a
    stage call, the plain version counted apart.  The hoisted laps run
    on the card from the fields, held against the plain version fed
    _precompute_lean ('hoisted') and formed from the fields
    ('hoisted_fields'); the kernel's call precomputes nothing."""
    pair = _Pair(sites, kind, B, -2.0)
    stages, _, _ = tsv._device_arrays(pair.sp, cuda, dtype)
    sd = stages[pair.k]
    I, S, a = pair.torch_inputs(cuda, dtype)
    I_ref = I.clone()
    fold, hoisted = _folds(fn), fn.startswith("hoisted")
    changes = [torch.zeros(2, dtype=dtype, device=cuda) if fold else None
               for _ in range(2)]
    n0, p0, h0 = vl.LAUNCHES, vl.PLAIN_ON_CARD, tsv.LEAN_ON_CARD
    vl.voronoi_stage(I, sd, S, a, change=changes[0], hoisted=hoisted)
    torch.cuda.synchronize()
    assert (vl.LAUNCHES - n0, tsv.LEAN_ON_CARD) == (1, h0)
    if fn in ("hoisted", "hoisted_d"):
        vl.voronoi_stage_plain(I_ref, sd, lean=tsv._precompute_lean(sd, S, a),
                               change=changes[1])
    else:
        vl.voronoi_stage_plain(I_ref, sd, S, a, change=changes[1],
                               hoisted=hoisted)
    assert vl.PLAIN_ON_CARD == p0 + 1
    assert torch.equal(I, I_ref)
    if fold:
        assert torch.equal(changes[0], changes[1])
        assert float(changes[0][1]) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("relax_tol", [0.0, 1e-7])
@pytest.mark.parametrize("kind", ["layer", "gs", "relax"])
def test_sweep_on_card_one_launch_a_stage(sites, cuda, kind, relax_tol):
    """A sweep on the card: one V1 launch a stage or relax-lap call, the
    level steps those of the CPU sweep, no lean precompute and no plain
    loop on the card, the result the CPU sweep's to 1e-10."""
    plan_t, _ = _plans(sites, kind)
    n, B = sites[0].n, 3
    rng = np.random.default_rng(11)
    S = rng.uniform(0.1, 1.0, (B, n))
    alpha = 10.0 ** rng.uniform(0.0, 2.0, (B, n))
    I0 = rng.uniform(0.0, 1.0, (B, len(plan_t.bc_sites)))
    out, counts = {}, {}
    for dev in ("cpu", cuda):
        tsv.LEVEL_STEPS = tsv.STAGE_CALLS = tsv.LEAN_ON_CARD = 0
        vl.LAUNCHES = vl.PLAIN_ON_CARD = 0
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        out[str(dev)] = tsv.sweep_voronoi(plan_t, t(S), t(alpha), t(I0),
                                          relax_tol=relax_tol).cpu()
        counts[str(dev)] = (tsv.LEVEL_STEPS, tsv.STAGE_CALLS, vl.LAUNCHES,
                            vl.PLAIN_ON_CARD, tsv.LEAN_ON_CARD)
    steps, calls, launches, plain, lean = counts["cuda"]
    assert (steps, calls) == counts["cpu"][:2]
    assert (launches, plain, lean) == (calls, 0, 0)
    assert _max_rel(out["cuda"].numpy(), out["cpu"].numpy()) < 1e-10
