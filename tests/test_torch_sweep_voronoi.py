"""voronoirt_tpu_torch Voronoi sweep against the JAX package, float64 on
the CPU: the slot-plan copy array for array, the sweep in both orders
with and without the adaptive relax exit, and the analytic checks of
tests/test_sweep_voronoi.py through the port.  Each package sweeps its own
sites and plans, built from the same positions."""

import warnings

import numpy as np
import pytest
import torch

from voronoirt_tpu import grid as jgrid
from voronoirt_tpu.solvers import sweep_voronoi as jsv
from voronoirt_tpu_torch.grid import build_sites, build_voronoi_plan
from voronoirt_tpu_torch.quadrature import get_quadrature
from voronoirt_tpu_torch.solvers import sweep_voronoi as tsv
from voronoirt_tpu_torch.solvers.formal import linear_weights

QUAD = get_quadrature("ul7n12")
# ul7n12 directions by |mu| = |k_z| and sense: steep up (mu -0.888),
# steep down (0.888), grazing up (-0.205), grazing down (0.205)
DIRECTIONS = (2, 3, 8, 9)


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


def _fields(n):
    return dict(temperature=np.ones(n), electron_density=np.zeros(n),
                hydrogen_populations=np.zeros(n), velocity_z=np.zeros(n),
                velocity_x=np.zeros(n), velocity_y=np.zeros(n))


def _random_sites(n, seed):
    """The port's sites and the JAX package's, from the same positions."""
    pos = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    return (build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n)),
            jgrid.build_sites(pos.copy(), (0, 1, 0, 1, 0, 1), _fields(n)))


def _plans(site_pair, i, order, compat="reference"):
    """Direction i's plan in each package: (port, JAX)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # 'layer' at grazing angles
        return tuple(build(s, QUAD.k[i], bool(QUAD.is_up[i]), compat=compat,
                           order=order)
                     for build, s in zip((build_voronoi_plan,
                                          jgrid.build_voronoi_plan),
                                         site_pair))


def _plan(site_pair, i, order, compat="reference"):
    """Direction i's plan in the port."""
    return _plans(site_pair[:1], i, order, compat)[0]


@pytest.fixture(scope="module")
def sites():
    """1,000 random sites, (port, JAX).  At this size a wavefront plan is
    exact-only (the steep directions 2, 3, 4, 6) or relax-only (the
    rest); plans holding both stages appear at larger site counts."""
    return _random_sites(1000, 5)


def _max_rel(got, want):
    """Max relative difference, absolute where want == 0."""
    denom = np.where(want == 0.0, 1.0, want)
    return float(np.max(np.where(want == 0.0, np.abs(got),
                                 np.abs(got / denom - 1.0))))


@pytest.mark.parametrize("order,compat", [("layer", "reference"),
                                          ("layer", "fixed"),
                                          ("wavefront", "reference")])
def test_slot_plan_equals_jax(sites, order, compat):
    """build_slot_plan == JAX build_slot_plan(plan, 3, bucket=False),
    array for array, over all 12 ul7n12 directions (up and down, steep
    and grazing); the cases cover the gs stage with its orphan slot
    (the reference's skipped last site), and exact and relax stages."""
    kinds, orphans = set(), 0
    for i in range(QUAD.n_angles):
        plan_t, plan_j = _plans(sites, i, order, compat)
        a = tsv.build_slot_plan(plan_t, 3)
        b = jsv.build_slot_plan(plan_j, 3, bucket=False)
        assert (a.n_slots, a.n_bc) == (b.n_slots, b.n_bc)
        np.testing.assert_array_equal(a.slot_gather, b.slot_gather)
        np.testing.assert_array_equal(a.site_gather, b.site_gather)
        assert len(a.stages) == len(b.stages)
        for sa, sb in zip(a.stages, b.stages):
            assert (sa.base, sa.L, sa.W, sa.passes, sa.repeats, sa.kind) == \
                (sb.base, sb.L, sb.W, sb.passes, sb.repeats, sb.kind)
            for f in ("up", "w", "r"):
                got, want = getattr(sa, f), getattr(sb, f)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            kinds.add(sa.kind)
        orphans += a.n_slots - a.n_bc - sum(s.L * s.W for s in a.stages)
    if order == "layer":
        assert kinds == {"gs"}
        if compat == "reference":
            assert orphans > 0
    else:
        assert kinds == {"exact", "relax"}


def test_slot_plan_ignores_jax_pad_targets(sites):
    """share_plan_shapes attaches _pad_to targets for the JAX sweep; the
    port's plans carry none, and its slot plans stay the unpadded ones."""
    pairs = [_plans(sites, i, "wavefront") for i in range(QUAD.n_angles)]
    plans_j = [pj for _, pj in pairs]
    jsv.share_plan_shapes(plans_j, 3)
    assert all(getattr(p, "_pad_to", None) is not None for p in plans_j)
    for pt, pj in pairs:
        assert getattr(pt, "_pad_to", None) is None
        assert tsv.build_slot_plan(pt, 3).n_slots == \
            jsv.build_slot_plan(pj, 3, bucket=False).n_slots


def _lap_counter(monkeypatch, module, names):
    count = [0]
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, **kwargs):
            count[0] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return count


# Measured worst cases (CPU, float64): 3.6e-15 with the extinction at
# 1-100 (every dtau above 0.03), 5.3e-12 with it at 0.01-100.  The
# second bar is looser because the linear weights' middle branch
# cancels just above its dtau = 5e-4 guard: (1 - e)/dtau - e loses
# log10(1/dtau) digits, so a one-ulp exp difference between XLA and
# PyTorch (ROADMAP C3) becomes ~2e-13 in alpha there and grows along
# the gs stage's three passes.
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("order,relax_tol", [("layer", 0.0),
                                             ("wavefront", 0.0),
                                             ("wavefront", 1e-7)])
@pytest.mark.parametrize("log_alpha_min,rtol", [(0.0, 1e-12),
                                                (-2.0, 2e-11)])
def test_sweep_matches_jax(sites, monkeypatch, order, relax_tol, B,
                           log_alpha_min, rtol):
    """sweep_voronoi == the JAX sweep, per direction, on random S and
    an extinction log-uniform up to 100 (with the lower bound 0.01,
    dtau crosses the small-dtau branch); with relax_tol 1e-7 both
    packages run the same number of relax laps."""
    n = sites[0].n
    rng = np.random.default_rng(100 + B)
    S = rng.uniform(0.1, 1.0, (B, n))
    alpha = 10.0 ** rng.uniform(log_alpha_min, 2.0, (B, n))
    laps_t = _lap_counter(monkeypatch, tsv, ("_run_relax_lap",
                                             "_run_hoisted_lap_d"))
    laps_j = _lap_counter(monkeypatch, jsv, ("_run_relax_lap",
                                             "_run_hoisted_lap_d"))
    worst = 0.0
    for i in DIRECTIONS:
        plan, plan_j = _plans(sites, i, order)
        I0 = rng.uniform(0.0, 1.0, (B, len(plan.bc_sites)))
        want = np.asarray(jsv.sweep_voronoi(plan_j, S, alpha, I0,
                                            relax_tol=relax_tol))
        got = tsv.sweep_voronoi(plan, torch.from_numpy(S),
                                torch.from_numpy(alpha),
                                torch.from_numpy(I0),
                                relax_tol=relax_tol).numpy()
        assert got.shape == want.shape == (B, n)
        worst = max(worst, _max_rel(got, want))
    assert worst < rtol, f"max rel diff {worst:.3e}"
    assert laps_t[0] == laps_j[0]
    if relax_tol:
        assert laps_t[0] > 0


def test_relax_exit_stops_early_and_matches_laps(sites, monkeypatch):
    """With relax_tol the repeats end early on real opacity; every
    lap's relative change stays clear of the threshold on these inputs,
    so the lap count cannot hinge on one-ulp differences."""
    n = sites[0].n
    rng = np.random.default_rng(3)
    S = torch.from_numpy(rng.uniform(0.1, 1.0, (2, n)))
    alpha = torch.from_numpy(10.0 ** rng.uniform(-2.0, 2.0, (2, n)))
    rels = []
    real = tsv._run_hoisted_lap_d

    def record(*args):
        r = real(*args)
        rels.append(float(r))
        return r
    monkeypatch.setattr(tsv, "_run_hoisted_lap_d", record)
    plan = _plan(sites, 8, "wavefront")
    I0 = torch.ones((2, len(plan.bc_sites)), dtype=torch.float64)
    tsv.sweep_voronoi(plan, S, alpha, I0, relax_tol=1e-7)
    assert plan.relax_repeats > len(rels) >= 2
    assert all(abs(np.log10(r / 1e-7)) > 0.5 for r in rels if r > 0)


@pytest.mark.parametrize("order", ["layer", "wavefront"])
def test_device_layout_drops_padding(sites, order):
    """The device layout keeps exactly the real slots of the slot plan,
    in order: each stage's levels are consecutive row ranges, and every
    site reads its intensity from a row that holds it.  A 'layer' plan's
    gs rows are padded to the stage's widest row, so there the dense
    rows are far fewer than the slots."""
    plan = _plan(sites, 8, order)
    sp = tsv.build_slot_plan(plan, 3)
    stages, site_gather, n_rows = tsv._device_arrays(sp, "cpu",
                                                     torch.float64)
    real = sp.slot_site < sites[0].n
    assert n_rows == int(real.sum())
    if order == "layer":
        assert 2 * n_rows < sp.n_slots
    start = sp.n_bc
    for sd in stages:
        assert sd.start == start and sd.off[0] == 0
        assert all(a < b for a, b in zip(sd.off, sd.off[1:]))
        assert sd.up_slot.shape == (sd.off[-1], 2)
        assert int(sd.up_slot.max()) <= n_rows      # the dummy row at most
        start += sd.off[-1]
    assert start <= n_rows      # orphan rows follow the stages
    np.testing.assert_array_equal(sp.slot_site[real][site_gather.numpy()],
                                  np.arange(sites[0].n))


def test_level_steps_count(sites):
    """LEVEL_STEPS counts one step per level and pass: a gs stage runs
    each schedule row once."""
    plan = _plan(sites, 2, "layer")
    sp = tsv.build_slot_plan(plan, 3)
    n = sites[0].n
    tsv.LEVEL_STEPS = 0
    tsv.sweep_voronoi(plan, torch.ones(n, dtype=torch.float64),
                      torch.ones(n, dtype=torch.float64),
                      torch.zeros(len(plan.bc_sites), dtype=torch.float64))
    assert tsv.LEVEL_STEPS == sum(st.L for st in sp.stages) > 0


# ------------------------------------------- tests/test_sweep_voronoi.py:43-98

def _grid_sites(m, jitter=0.0, seed=0):
    """Sites on (or near) regular grid points, cell-centred."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(m) + 0.5) / m
    Z, X, Y = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([Z.ravel(), X.ravel(), Y.ravel()], axis=1)
    if jitter:
        pos += rng.uniform(-jitter, jitter, pos.shape) / m
        pos[:, 0] = np.clip(pos[:, 0], 1e-6, 1 - 1e-6)
        pos[:, 1:] = pos[:, 1:] % 1.0
    return pos


def _skipped_site(sites):
    """The reference's never-updated last permutation site."""
    return int(np.nonzero(sites.layers_up == sites.layers_up.max())[0][-1])


def test_vertical_homogeneous_slab():
    """Sites on grid points reproduce the vertical two-point scheme
    (compare_continuum.jl:327-446 test_with_regular_grid)."""
    m = 8
    pos = _grid_sites(m)
    n = len(pos)
    sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
    iz_of = np.round(pos[:, 0] * m - 0.5).astype(int)
    a0, S0, Iin = 2.5, 1.3, 0.6
    plan = build_voronoi_plan(sites, kvec(180.0, 0.0), up=True)
    I = tsv.sweep_voronoi(plan, torch.full((n,), S0, dtype=torch.float64),
                          torch.full((n,), a0, dtype=torch.float64),
                          torch.full((len(plan.bc_sites),), Iin,
                                     dtype=torch.float64)).numpy()
    aw, bw, ew = (float(v) for v in linear_weights(
        torch.tensor(a0 / m, dtype=torch.float64)))
    expected = [Iin]
    for _ in range(1, m):
        expected.append(ew * expected[-1] + (aw + bw) * S0)
    skipped = _skipped_site(sites)
    assert I[skipped] == 0.0
    for iz in range(m):
        got = I[(iz_of == iz) & (np.arange(n) != skipped)]
        assert np.allclose(got, expected[iz], rtol=1e-10), f"layer {iz}"


def test_oblique_on_jittered_grid_bounded():
    """Jittered grid, oblique ray: finite and inside [min(I0, S),
    max(I0, S)]."""
    m = 7
    pos = _grid_sites(m, jitter=0.2, seed=3)
    n = len(pos)
    sites = build_sites(pos, (0, 1, 0, 1, 0, 1), _fields(n))
    plan = build_voronoi_plan(sites, kvec(150.0, 40.0), up=True)
    I = tsv.sweep_voronoi(plan, torch.full((n,), 2.0, dtype=torch.float64),
                          torch.ones(n, dtype=torch.float64),
                          torch.full((len(plan.bc_sites),), 0.5,
                                     dtype=torch.float64)).numpy()
    assert np.all(np.isfinite(I))
    skipped = _skipped_site(sites)
    assert I[skipped] == 0.0
    live = np.arange(n) != skipped
    assert I[live].min() >= 0.5 - 1e-9 and I[live].max() <= 2.0 + 1e-9
