"""The port's own copies of the JAX package's host modules equal their
originals: config, constants, quadrature, atmosphere, the Voronoi grid's
host half (sites, plans, native tessellation, interpolation, the numpy
sampling densities), the disk cache, utils and analysis/plots.py's
brightness_temperature (the one drivers/synthesize.py uses).  Each case
builds one object in each package from the same arguments and numpy
arrays and compares them array for array."""

import dataclasses
import numbers
import warnings

import numpy as np
import pytest

from analysis import plots as j_plots
from voronoirt_tpu import atmosphere as j_atmos
from voronoirt_tpu import config as j_config
from voronoirt_tpu import constants as j_const
from voronoirt_tpu import quadrature as j_quad
from voronoirt_tpu import utils as j_utils
from voronoirt_tpu.grid import cache as j_cache
from voronoirt_tpu.grid import interpolate as j_interp
from voronoirt_tpu.grid import neighbors as j_nb
from voronoirt_tpu.grid import sampling as j_samp
from voronoirt_tpu.grid import voronoi as j_vor
from voronoirt_tpu_torch import atmosphere as t_atmos
from voronoirt_tpu_torch import config as t_config
from voronoirt_tpu_torch import constants as t_const
from voronoirt_tpu_torch import quadrature as t_quad
from voronoirt_tpu_torch import utils as t_utils
from voronoirt_tpu_torch.analysis import plots as t_plots
from voronoirt_tpu_torch.drivers import synthesize as t_synth
from voronoirt_tpu_torch.grid import cache as t_cache
from voronoirt_tpu_torch.grid import interpolate as t_interp
from voronoirt_tpu_torch.grid import neighbors as t_nb
from voronoirt_tpu_torch.grid import sampling as t_samp
from voronoirt_tpu_torch.grid import voronoi as t_vor

CONFIG_FIELDS = [f.name for f in dataclasses.fields(j_config.Config)]
CONSTANTS = sorted(k for k, v in vars(j_const).items()
                   if not k.startswith("_") and isinstance(v, numbers.Number))
QUADRATURES = sorted(j_quad._TABLES)
NUMPY_DENSITIES = ["invNH_invT", "logNH_invT", "logNH_invT_rootv",
                   "temp_gradient"]


def _equal(a, b, what):
    """Field-for-field equality of two values: arrays exactly (NaN
    equal), dataclasses by their fields, dicts and sequences item for
    item, the rest with ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


# ------------------------------------------------------------ config

@pytest.mark.parametrize("name", CONFIG_FIELDS)
def test_config_field_and_default(name):
    j = {f.name: f for f in dataclasses.fields(j_config.Config)}[name]
    t = {f.name: f for f in dataclasses.fields(t_config.Config)}[name]
    assert (t.type, t.default, t.default_factory) == \
        (j.type, j.default, j.default_factory)


def test_config_same_fields_and_methods():
    assert [f.name for f in dataclasses.fields(t_config.Config)] == \
        CONFIG_FIELDS
    kw = dict(dtype="float32", compat="fixed", lambda_chunk=7)
    tc, jc = t_config.Config(**kw), j_config.Config(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.sweep_dtype, tc.fixed()) == (jc.sweep_dtype, jc.fixed())
    assert dataclasses.asdict(t_config.DEFAULT) == \
        dataclasses.asdict(j_config.DEFAULT)


# --------------------------------------------------------- constants

@pytest.mark.parametrize("name", CONSTANTS)
def test_constant(name):
    assert getattr(t_const, name) == getattr(j_const, name)
    assert type(getattr(t_const, name)) is type(getattr(j_const, name))


# -------------------------------------------------------- quadrature

@pytest.mark.parametrize("name", QUADRATURES)
def test_quadrature(name):
    t, j = t_quad.get_quadrature(name), j_quad.get_quadrature(name)
    _equal(t, j, name)
    _equal((t.n_angles, t.k, t.is_up), (j.n_angles, j.k, j.is_up), name)


def test_quadrature_names():
    assert sorted(t_quad._TABLES) == QUADRATURES
    _equal(t_quad.get_quadrature("quadratures/ul7n12.dat"),
           j_quad.get_quadrature("quadratures/ul7n12.dat"), "by path")
    with pytest.raises(KeyError):
        t_quad.get_quadrature("no-such-set")


# -------------------------------------------------------- atmosphere

@pytest.mark.parametrize("shape,seed", [((12, 8, 6), 7), ((20, 10, 14), 1998)])
def test_synthetic_atmosphere(shape, seed):
    nz, nx, ny = shape
    t = t_atmos.synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=seed)
    j = j_atmos.synthetic_atmosphere(nz=nz, nx=nx, ny=ny, seed=seed)
    _equal(t, j, "atmosphere")
    _equal((t.shape, t.dx, t.dy, t.velocity_zxy()),
           (j.shape, j.dx, j.dy, j.velocity_zxy()), "derived")
    tg = t_atmos.atmosphere_with_ghosts(t)
    jg = j_atmos.atmosphere_with_ghosts(j)
    _equal(tg, jg, "with ghosts")


def test_searchlight_atmosphere():
    _equal(t_atmos.searchlight_atmosphere(9),
           j_atmos.searchlight_atmosphere(9), "searchlight")


# --------------------------------------------------------- sampling

@pytest.fixture(scope="module")
def atmos_pair():
    kw = dict(nz=10, nx=8, ny=8, seed=7)
    return t_atmos.synthetic_atmosphere(**kw), \
        j_atmos.synthetic_atmosphere(**kw)


@pytest.mark.parametrize("density", NUMPY_DENSITIES)
def test_numpy_density_and_rejection_sampling(atmos_pair, density):
    ta, ja = atmos_pair
    q_t = t_samp.DENSITIES[density](ta)
    q_j = j_samp.DENSITIES[density](ja)
    _equal(q_t, q_j, density)
    _equal(t_samp.rejection_sampling(400, ta, q_t, seed=11),
           j_samp.rejection_sampling(400, ja, q_j, seed=11), "positions")


def test_initialise_sites(atmos_pair):
    ta, ja = atmos_pair
    pos = t_samp.sample_sites(ta, 300, seed=3)
    _equal(pos, j_samp.sample_sites(ja, 300, seed=3), "positions")
    _equal(t_interp.initialise_sites(pos, ta),
           j_interp.initialise_sites(pos, ja), "fields")
    _equal(t_interp.initialise_sites(pos, ta, log_fields=("temperature",)),
           j_interp.initialise_sites(pos, ja, log_fields=("temperature",)),
           "fields (log)")


# ------------------------------------------------------ Voronoi grid

@pytest.fixture(scope="module")
def sites_pair(atmos_pair):
    """~2,000 sites sampled from the atmosphere, tessellated by the
    native library in each package."""
    ta, ja = atmos_pair
    assert t_nb.build_native() is not None
    assert j_nb._load_lib() is not None
    pos = t_samp.sample_sites(ta, 2000, seed=2022)
    bounds = (ta.z[0], ta.z[-1], ta.x[0], ta.x[-1], ta.y[0], ta.y[-1])
    ts = t_vor.build_sites(pos, bounds, t_interp.initialise_sites(pos, ta))
    js = j_vor.build_sites(pos.copy(), bounds,
                           j_interp.initialise_sites(pos.copy(), ja))
    return ts, js


def test_build_sites(sites_pair):
    ts, js = sites_pair
    _equal(ts, js, "sites")
    assert ts.n == js.n == 2000


@pytest.mark.parametrize("order", ["layer", "wavefront"])
def test_build_voronoi_plan(sites_pair, order):
    ts, js = sites_pair
    q = j_quad.get_quadrature("ul7n12")
    for i in range(q.n_angles):
        kw = dict(compat="reference" if i % 2 else "fixed", order=order)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # 'layer' at grazing angles
            tp = t_vor.build_voronoi_plan(ts, q.k[i], bool(q.is_up[i]), **kw)
            jp = j_vor.build_voronoi_plan(js, q.k[i], bool(q.is_up[i]), **kw)
        _equal(tp, jp, f"plan {i}")


def test_cache_round_trip(sites_pair, tmp_path):
    """The port's cache writes what the JAX package's reads, and back;
    the keys agree."""
    ts, _ = sites_pair
    skey = t_cache.sites_key(ts.positions, ts.bounds)
    assert skey == j_cache.sites_key(ts.positions, ts.bounds) \
        == ts.content_key
    t_cache.save_tessellation(str(tmp_path), skey, ts.neighbours,
                              ts.layers_up, ts.layers_down)
    _equal(j_cache.load_tessellation(str(tmp_path), skey),
           (ts.neighbours, ts.layers_up, ts.layers_down), "tessellation")
    k = np.array([-0.8, 0.36, 0.48])
    pkey = t_cache.plan_key(skey, k, True, 7.0, "reference", "wavefront", 3)
    assert pkey == j_cache.plan_key(skey, k, True, 7.0, "reference",
                                    "wavefront", 3)
    plan = t_vor.build_voronoi_plan(ts, k, True, order="wavefront")
    j_cache.save_plan(str(tmp_path), pkey, plan)
    got = t_cache.load_plan(str(tmp_path), pkey)
    want = j_cache.load_plan(str(tmp_path), pkey)
    assert sorted(got) == sorted(want)
    for name in got:
        _equal(got[name], want[name], name)
        if getattr(plan, name) is not None:
            _equal(got[name], getattr(plan, name), name)
    # a cached tessellation and plan rebuild the same objects
    ts2 = t_vor.build_sites(ts.positions, ts.bounds,
                            {f: getattr(ts, f) for f in (
                                "temperature", "electron_density",
                                "hydrogen_populations", "velocity_z",
                                "velocity_x", "velocity_y")},
                            cache_dir=str(tmp_path))
    _equal(ts2, ts, "sites from the cache")
    plan2 = t_vor.build_voronoi_plan(ts, k, True, order="wavefront",
                                     cache_dir=str(tmp_path))
    _equal(plan2, plan, "plan from the cache")


# ------------------------------------------------------------- utils

@pytest.mark.parametrize("descending", [False, True])
def test_utils_cumtrapz(descending):
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, 2.0, 17))
    if descending:
        x = x[::-1]
    y = rng.uniform(-1.0, 1.0, 17)
    _equal(t_utils.cumtrapz(x, y), j_utils.cumtrapz(x, y), "cumtrapz")
    assert t_utils.cumtrapz(x, y)[0] == 0.0


def test_utils_text_writers(tmp_path):
    rng = np.random.default_rng(6)
    x, y, z = rng.uniform(0.0, 1.0, (3, 40))
    files = {}
    for tag, mod in (("t", t_utils), ("j", j_utils)):
        sites, bounds = tmp_path / f"{tag}_sites.txt", tmp_path / f"{tag}_b.txt"
        mod.write_sites_text(x, y, z, str(sites))
        mod.write_boundaries_text(0.0, 1.0, -2.5, 2.5, 3, 4.0, str(bounds))
        files[tag] = (sites.read_text(), bounds.read_text())
    assert files["t"] == files["j"]
    assert files["t"][0].splitlines()[0].split("\t")[0] == "1"
    with pytest.raises(AssertionError):
        t_utils.write_sites_text(x, y[:-1], z, str(tmp_path / "bad.txt"))


def test_utils_read_neighbours_round_trip(tmp_path):
    """A neighbour file in the CLI's '%i %n' format (1-based ids, walls
    negative) parses into the same fixed-stride matrix in both packages,
    and back into the lists it was written from."""
    rng = np.random.default_rng(7)
    n = 25
    lists = [sorted(rng.choice(np.arange(-6, n + 1)[np.arange(-6, n + 1) != 0],
                               size=rng.integers(4, 12), replace=False))
             for _ in range(n)]
    path = tmp_path / "nb.txt"
    order = rng.permutation(n)
    path.write_text("".join(
        f"{i + 1} " + " ".join(str(v) for v in lists[i]) + "\n\n"
        for i in order))
    got = t_utils.read_neighbours_text(str(path), n)
    _equal(got, j_utils.read_neighbours_text(str(path), n), "neighbours")
    for i in range(n):
        back = [v + 1 if v >= 0 else v for v in got[i, 1:1 + got[i, 0]]]
        assert back == [int(v) for v in lists[i]]


# ------------------------------------------------- brightness temperature

@pytest.mark.parametrize("lam", [121.567e-9, 91.2e-9, 500e-9])
def test_brightness_temperature(lam):
    """The port's one copy of analysis/plots.py brightness_temperature
    (drivers/synthesize.py's too), on intensities over 12 decades and
    zero."""
    assert t_synth.brightness_temperature is t_plots.brightness_temperature
    rng = np.random.default_rng(7)
    I = 10.0 ** rng.uniform(-8.0, 4.0, (6, 5))
    I[0, 0] = 0.0
    _equal(t_plots.brightness_temperature(I, lam),
           j_plots.brightness_temperature(I, lam), "T_b")
