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
their change.  Tolerances, relative (absolute where the reference is 0):
1e-12 with the extinction at 1-100, 2e-11 with it down to 0.01, where
the linear weights' middle branch cancels just above its 5e-4 guard and
a one-ulp exp difference between XLA and PyTorch grows (ROADMAP C3; the
same bars as tests/test_torch_sweep_voronoi.py).  The host half (level
offsets, self-reference flags) is held against brute force.  The tests
marked cuda hold the kernel against the plain version on the card, bit
for bit, and skip without a card.
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
        'hoisted_d') on the stage: (I on the real slots, rel or None)."""
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


def _run_port(pair, fn, I, S, a, plain):
    """The port's stage function fn on I: through the plain stage
    function itself, or through the sweep's stage functions."""
    sd = pair.sd
    change = None
    if fn in ("lap", "hoisted_d"):
        change = torch.zeros(2, dtype=I.dtype, device=I.device)
    lean = tsv._precompute_lean(sd, S, a) if fn.startswith("hoisted") \
        else None
    if plain:
        if lean is None:
            vl.voronoi_stage_plain(I, sd, S, a, change=change)
        else:
            vl.voronoi_stage_plain(I, sd, lean=lean, change=change)
        return None if change is None else float(tsv._rel_change(change))
    rel = {"stage": lambda: tsv._run_stage(I, sd, S, a),
           "lap": lambda: tsv._run_relax_lap(I, sd, S, a),
           "hoisted": lambda: tsv._run_hoisted_lap(I, sd, lean),
           "hoisted_d": lambda: tsv._run_hoisted_lap_d(I, sd, lean)}[fn]()
    return None if rel is None else float(rel)


STAGE_FNS = [("layer", "stage"), ("gs", "stage"), ("exact", "stage"),
             ("relax", "stage"), ("relax", "lap"), ("relax", "hoisted"),
             ("relax", "hoisted_d")]


@pytest.mark.parametrize("log_alpha_min,rtol", TOLS)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "dispatch"])
@pytest.mark.parametrize("kind,fn", STAGE_FNS)
def test_stage_matches_jax(sites, kind, fn, plain, B, log_alpha_min, rtol):
    """The port's stage functions == JAX's on the same stage and
    intensities: the plain stage function and the sweep's dispatching
    stage functions, every stage kind, the relax laps with and without
    the change (compared too), the lean weights precomputed in both."""
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
    """The stage's host arrays: the level offsets (contiguous int64, the
    C entry's) count each level's real slots, the self-reference flags
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
    with pytest.raises(ValueError):     # offsets the C entry cannot read
        vl.voronoi_stage(I, dataclasses.replace(
            pair_sd, off=pair_sd.off.astype(np.int32)), S, S)
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
    level and pass, and the plain version counted apart."""
    pair = _Pair(sites, kind, B, -2.0)
    stages, _, _ = tsv._device_arrays(pair.sp, cuda, dtype)
    sd = stages[pair.k]
    I, S, a = pair.torch_inputs(cuda, dtype)
    I_ref = I.clone()
    fold = fn in ("lap", "hoisted_d")
    lean = tsv._precompute_lean(sd, S, a) if fn.startswith("hoisted") \
        else None
    fields = dict(S_T=S, a_T=a) if lean is None else dict(lean=lean)
    changes = [torch.zeros(2, dtype=dtype, device=cuda) if fold else None
               for _ in range(2)]
    n0, p0 = vl.LAUNCHES, vl.PLAIN_ON_CARD
    vl.voronoi_stage(I, sd, **fields, change=changes[0])
    torch.cuda.synchronize()
    assert vl.LAUNCHES - n0 == (len(sd.off) - 1) * sd.passes
    vl.voronoi_stage_plain(I_ref, sd, **fields, change=changes[1])
    assert vl.PLAIN_ON_CARD == p0 + 1
    assert torch.equal(I, I_ref)
    if fold:
        assert torch.equal(changes[0], changes[1])
        assert float(changes[0][1]) > 0.0
