"""voronoirt_tpu_torch Voronoi engine and sampling densities against the
JAX package, float64 on the CPU: the vor_* NLTE chain goldens through
VoronoiEngine.run(), compute_J and run() on a sampled grid, and each
torch density against its JAX counterpart.  Each package gets its own
atmosphere, sites, plans and Config, built from the same arguments and
numpy arrays."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voronoirt_tpu import atmosphere as jatmos
from voronoirt_tpu import grid as jgrid
from voronoirt_tpu.config import Config as JaxConfig
from voronoirt_tpu.engine.lambda_iter import VoronoiEngine as JaxVoronoiEngine
from voronoirt_tpu.grid import sampling as jsamp
from voronoirt_tpu.physics import lyman_alpha_line as jax_line
from voronoirt_tpu.physics.lte import lte_populations as jax_lte
from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch import grid as tgrid
from voronoirt_tpu_torch.engine import VoronoiEngine
from voronoirt_tpu_torch.grid import sampling as tsamp
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

FIXTURE = "tests/golden/nlte_fixtures.npz"
_C_KEYS = ("01", "10", "02", "20", "12", "21")


def _assert_close(got, want, what, rtol):
    """Max relative difference (absolute where want == 0), as
    tests/test_nlte_parity.py measures it."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    denom = np.where(want == 0.0, 1.0, want)
    rd = np.where(want == 0.0, np.abs(got), np.abs(got / denom - 1.0))
    assert rd.max() < rtol, f"{what}: max rel diff {rd.max():.3e}"


def _line(nlam_bb, nlam_bf, T):
    return lyman_alpha_line(nlam_bb, nlam_bf,
                            torch.from_numpy(np.asarray(T, dtype=np.float64)))


# ------------------------------------------------------------ the fixture

def test_nlte_fixture_three_iterations():
    """The oracle's vor_* chain (tests/test_nlte_parity.py:90-113): 500
    sites, 'layer' order, ul7n12, 3 iterations from the fixture's frozen
    alpha_cont, eps and C; J and S to 1e-8, populations to 1e-7."""
    fx = np.load(FIXTURE)
    sites = tgrid.VoronoiSites(
        **{f: fx[f"vor_sites_{f}"] for f in (
            "positions", "neighbours", "delaunay_lines", "layers_up",
            "layers_down", "temperature", "electron_density",
            "hydrogen_populations", "velocity_z", "velocity_x",
            "velocity_y")},
        bounds=tuple(fx["vor_bounds"]))
    cfg = Config(maxiter=3, eps=1e-30, quadrature="ul7n12", nlam_bb=9,
                 nlam_bf=4, compat="reference")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        eng = VoronoiEngine(sites, _line(9, 4, sites.temperature), cfg)
    _assert_close(eng.eps, fx["vor_eps"], "eps", 1e-12)
    eng.load_state({"a_cont": fx["vor_alpha_cont"], "eps": fx["vor_eps"],
                    **{f"C_{k}": fx[f"vor_C_{k}"] for k in _C_KEYS}})
    res = eng.run()
    assert res.iterations == 3
    _assert_close(res.J, fx["vor_J_2"], "J", 1e-8)
    _assert_close(res.S, fx["vor_S_2"], "S", 1e-8)
    _assert_close(res.populations, fx["vor_pops_2"], "pops", 1e-7)


# ------------------------------------------------------ a sampled grid

@pytest.fixture(scope="module")
def sampled_pair():
    """800 sites sampled with the production density from a small
    synthetic atmosphere: the port's, through its grid layer, and the
    JAX package's from the same positions."""
    atmos = synthetic_atmosphere(nz=10, nx=8, ny=8, seed=7)
    pos = tgrid.sample_sites(atmos, 800, density="invNH_invT", seed=2022)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites_t = tgrid.build_sites(pos, bounds,
                                tgrid.initialise_sites(pos, atmos))
    j_atmos = jatmos.synthetic_atmosphere(nz=10, nx=8, ny=8, seed=7)
    sites_j = jgrid.build_sites(pos.copy(), bounds,
                                jgrid.initialise_sites(pos.copy(), j_atmos))
    return sites_t, sites_j


@pytest.fixture(scope="module")
def sampled(sampled_pair):
    return sampled_pair[0]


def _engines(sites_pair, **cfg_kw):
    """The JAX engine and the port's, each on its own sites, plans and
    Config."""
    sites_t, sites_j = sites_pair
    kw = dict(quadrature="ul7n12", nlam_bb=5, nlam_bf=3, **cfg_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng_j = JaxVoronoiEngine(
            sites_j, jax_line(5, 3, jnp.asarray(sites_j.temperature)),
            JaxConfig(**kw))
        eng_t = VoronoiEngine(sites_t, _line(5, 3, sites_t.temperature),
                              Config(**kw))
    return eng_j, eng_t


# J bar.  The extinction of the two packages agrees to 6e-15 and the
# sweep arithmetic is the same, op for op; what differs is exp: XLA's
# CPU exp is one ulp off PyTorch's (and numpy's) for ~10 % of arguments.
# Just above the 5e-4 guard the linear weight (1 - e)/dtau - e cancels
# about log10(1/dtau) digits, so that ulp becomes up to 8.9e-10 relative
# in the weight (measured over 2e5 dtau), and down-sweep sites next to
# the dark top boundary, where I ~ dtau S, carry it into I: per
# direction the two sweeps differ by up to 5.2e-10 on the same
# extinction.  J, the weighted sum over directions, measured worst
# 1.28e-10 ('layer') on this grid, hence 5e-10 rather than 1e-10.
J_RTOL = 5e-10


@pytest.mark.parametrize("order", ["layer", "wavefront"])
def test_compute_J_matches_jax(sampled_pair, order):
    """compute_J in lambda chunks of 4 (3 chunks of the 11 wavelengths)
    == the JAX engine's to J_RTOL, from B0 and the LTE populations;
    the two engines' plans are equal (tests/test_torch_host_copies.py)."""
    sampled = sampled_pair[0]
    eng_j, eng_t = _engines(sampled_pair, voronoi_order=order,
                            lambda_chunk=4)
    _assert_close(eng_t.B0, np.asarray(eng_j.B0), "B0", 1e-13)
    J_j = np.asarray(eng_j.compute_J(eng_j.B0, eng_j.lte))
    J_t = eng_t.compute_J(eng_t.B0, eng_t.lte)
    assert tuple(J_t.shape) == J_j.shape == (11, sampled.n)
    _assert_close(J_t, J_j, "J", J_RTOL)
    # with the damping cube given, as run() calls it
    J_td = eng_t.compute_J(eng_t.B0, eng_t.lte,
                           eng_t.damping_lam(eng_t.lte))
    _assert_close(J_td, J_j, "J (damping cube)", J_RTOL)


@pytest.mark.parametrize("order", ["layer", "wavefront"])
def test_run_matches_jax(sampled_pair, order):
    """run(): S, populations and the convergence history against the
    JAX engine's after 3 iterations.  A history entry is max |S_new -
    S_old| / |S_new|, a difference of two S that agree to 1e-10 each,
    so it agrees to 2e-10 absolute: relative to an entry of 6e-8 that
    is 3e-3, and no relative bar fits the last entries."""
    eng_j, eng_t = _engines(sampled_pair, voronoi_order=order, maxiter=3,
                            eps=1e-30)
    res_j = eng_j.run()
    res_t = eng_t.run()
    assert res_t.iterations == res_j.iterations == 3
    _assert_close(res_t.S, res_j.S, "S", 1e-10)
    _assert_close(res_t.populations, res_j.populations, "pops", 1e-9)
    np.testing.assert_allclose(res_t.convergence, res_j.convergence,
                               rtol=0, atol=2e-10)


def test_own_plans_and_state(sampled):
    """Without plans= the engine builds its plans itself;
    load_state takes the regular engine's keys; rates_site_chunk is
    refused."""
    cfg = Config(quadrature="ul2n3", nlam_bb=5, nlam_bf=3,
                 voronoi_order="wavefront")
    eng = VoronoiEngine(sampled, _line(5, 3, sampled.temperature), cfg)
    assert len(eng.plans) == 3 and all(p.n == sampled.n for p in eng.plans)
    rng = np.random.default_rng(1)
    state = {"S": rng.uniform(size=tuple(eng.B0.shape)),
             "populations": rng.uniform(size=tuple(eng.lte.shape)),
             "C_21": rng.uniform(size=tuple(eng.T.shape))}
    eng.load_state(state)
    np.testing.assert_array_equal(eng.S_start.numpy(), state["S"])
    np.testing.assert_array_equal(eng.C[(2, 1)].numpy(), state["C_21"])
    with pytest.raises(KeyError):
        eng.load_state({"J": state["S"]})
    eng.cfg = Config(quadrature="ul2n3", rates_site_chunk=100)
    with pytest.raises(NotImplementedError):
        eng.run()


# ------------------------------------------------------------ densities

@pytest.fixture(scope="module")
def atmos_lte():
    """The port's atmosphere, the JAX package's (the same arrays) and
    the JAX LTE populations on it."""
    atmos = synthetic_atmosphere(nz=8, nx=6, ny=6, seed=11)
    j_atmos = jatmos.synthetic_atmosphere(nz=8, nx=6, ny=6, seed=11)
    T = jnp.asarray(j_atmos.temperature)
    line = jax_line(1, 1, T)
    lte = np.asarray(jax_lte(line, T, jnp.asarray(j_atmos.electron_density),
                             jnp.asarray(j_atmos.hydrogen_populations)))
    return atmos, j_atmos, lte


# Each density equals the JAX one to the last few ulps (measured worst
# 1.7e-15 relative); log10 of a quantity near 1 would cancel digits,
# but none of these densities comes near 1 on the synthetic atmosphere.
def test_density_extinction(atmos_lte):
    atmos, j_atmos, lte = atmos_lte
    line = jax_line(1, 1, jnp.asarray(j_atmos.temperature))
    _assert_close(tsamp.density_extinction(atmos, line.lam0, lte),
                  jsamp.density_extinction(j_atmos, line.lam0, lte),
                  "extinction", 1e-12)


def test_density_destruction(atmos_lte):
    atmos, j_atmos, lte = atmos_lte
    line_j = jax_line(1, 1, jnp.asarray(j_atmos.temperature))
    line_t = _line(1, 1, atmos.temperature)
    _assert_close(tsamp.density_destruction(atmos, line_t, lte),
                  jsamp.density_destruction(j_atmos, line_j, lte),
                  "destruction", 1e-12)


def test_density_total_extinction(atmos_lte):
    atmos, j_atmos, lte = atmos_lte
    _assert_close(tsamp.density_total_extinction(atmos),
                  jsamp.density_total_extinction(j_atmos),
                  "total extinction", 1e-12)
    line_j = jax_line(1, 1, jnp.asarray(j_atmos.temperature))
    line_t = _line(1, 1, atmos.temperature)
    _assert_close(tsamp.density_total_extinction(atmos, lte, line_t),
                  jsamp.density_total_extinction(j_atmos, lte, line_j),
                  "total extinction (given lte, line)", 1e-12)


def test_density_avg_extinction(atmos_lte):
    atmos, j_atmos, lte = atmos_lte
    pops = lte * np.random.default_rng(2).uniform(0.5, 1.5, lte.shape)
    line_j = jax_line(5, 3, jnp.asarray(j_atmos.temperature))
    line_t = _line(5, 3, atmos.temperature)
    _assert_close(tsamp.density_avg_extinction(atmos, pops, None, line_t),
                  jsamp.density_avg_extinction(j_atmos, pops, None, line_j),
                  "avg extinction", 1e-12)


@pytest.mark.parametrize("density", ["invNH_invT", "total_extinction"])
def test_sample_sites_matches_jax(atmos_lte, density):
    """Same keys as the JAX DENSITIES; the sampled positions agree."""
    atmos, j_atmos, _ = atmos_lte
    assert list(tsamp.DENSITIES) == list(jsamp.DENSITIES)
    np.testing.assert_allclose(
        tsamp.sample_sites(atmos, 300, density=density, seed=5),
        jsamp.sample_sites(j_atmos, 300, density=density, seed=5),
        rtol=1e-14, atol=0)
