"""The float32 NLTE engines of voronoirt_tpu_torch (Config(dtype=
"float32"), the JAX package's production mode) on the CPU.

* Against the JAX package's float64 engines on the same inputs: the
  standard, lambda-streamed and Bezier loops on the case of
  tests/test_f32_physics.py::test_nlte_iteration_f32_vs_f64 (12x8x8, 5 +
  3 wavelengths, 2 iterations), and the Voronoi engine on the vor_*
  fixture (500 sites, ul7n12, 3 iterations from its frozen state).
  Each meets that test's bar (rtol 5e-3 plus 5e-3 of the float64
  array's largest magnitude, its "scale") and a tight bar about ten
  times what the port measures: J 1e-4 of scale (Voronoi 2e-3), S 1e-4
  of scale, populations 1e-6 of scale.
* Against the JAX package's float32 engine (a subprocess with x64
  off) on the first J pass only, at 1e-4 of scale.
* The run surface in float32: a killed and resumed run, line_nlte --f32
  and recover --f32, synthesize on a float32 run's file, and a float32
  lambda split, y split and site split over 2 gloo ranks.

The ranks import this module to find their function, so it imports
nothing of JAX at its top (as tests/test_torch_lam.py).
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.engine import checkpoint as t_ckpt
from voronoirt_tpu_torch.engine.lambda_iter import _run_iteration
from voronoirt_tpu_torch.parallel import lam, mesh as M
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line, pad_line

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "tests", "golden", "nlte_fixtures.npz")
_C_KEYS = ("01", "10", "02", "20", "12", "21")

# tests/test_f32_physics.py::test_nlte_iteration_f32_vs_f64's bar
GATE = 5e-3
# the tight bars, as a share of the float64 array's scale; measured on
# the port (J, S, populations): standard 1.06e-5, 3.9e-6, 1.0e-7;
# streamed -, 4.0e-6, 1.0e-7; Bezier 2.7e-6, 3.9e-6, 1.0e-7; Voronoi
# 2.5e-4, 2.2e-6, 9.8e-8
TIGHT = {"J": 1e-4, "S": 1e-4, "populations": 1e-6}
TIGHT_VORONOI_J = 2e-3

# the gate's case and the Config of each regular loop
GATE_KW = dict(nlam_bb=5, nlam_bf=3, quadrature="n2", maxiter=2, eps=1e-9)
REGULAR = {
    "standard": {},
    "streamed": dict(quadrature="ul2n3", lambda_chunk=3, stream_rates=True),
    "bezier": dict(formal_interpolation="bezier", rates_site_chunk=100),
}
CASES = tuple(REGULAR) + ("voronoi",)


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype)


def _vor_fixture():
    fx = np.load(FIXTURE)
    fields = {f: fx[f"vor_sites_{f}"] for f in (
        "positions", "neighbours", "delaunay_lines", "layers_up",
        "layers_down", "temperature", "electron_density",
        "hydrogen_populations", "velocity_z", "velocity_x", "velocity_y")}
    state = {"a_cont": fx["vor_alpha_cont"], "eps": fx["vor_eps"],
             **{f"C_{k}": fx[f"vor_C_{k}"] for k in _C_KEYS}}
    return fields, tuple(fx["vor_bounds"]), state


_VOR_KW = dict(maxiter=3, eps=1e-30, quadrature="ul7n12", nlam_bb=9,
               nlam_bf=4, compat="reference")


def _port_run(case, dtype="float32"):
    """The port's engine of the case, run on the CPU."""
    if case == "voronoi":
        fields, bounds, state = _vor_fixture()
        sites = grid.VoronoiSites(**fields, bounds=bounds)
        line = lyman_alpha_line(9, 4, _t(sites.temperature,
                                         getattr(torch, dtype)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # 'layer' at grazing angles
            eng = VoronoiEngine(sites, line, Config(**_VOR_KW, dtype=dtype),
                                device="cpu")
        eng.load_state(state)
        return eng.run()
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
    cfg = Config(**{**GATE_KW, **REGULAR[case]}, dtype=dtype)
    line = lyman_alpha_line(5, 3, _t(atmos.temperature,
                                     getattr(torch, dtype)))
    return RegularEngine(atmos, line, cfg, device="cpu").run()


def _jax_f64_run(case):
    """The JAX package's float64 engine of the case (J, S, populations
    as numpy; J None for the streamed loop)."""
    import jax.numpy as jnp
    from voronoirt_tpu import Config as JConfig
    from voronoirt_tpu import grid as jgrid
    from voronoirt_tpu import synthetic_atmosphere as j_atmos
    from voronoirt_tpu.engine import RegularEngine as JRegular
    from voronoirt_tpu.engine import VoronoiEngine as JVoronoi
    from voronoirt_tpu.physics import lyman_alpha_line as j_line
    if case == "voronoi":
        fields, bounds, state = _vor_fixture()
        sites = jgrid.VoronoiSites(**fields, bounds=bounds)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = JVoronoi(sites, j_line(9, 4, jnp.asarray(sites.temperature)),
                           JConfig(**_VOR_KW))
        # the frozen inputs as tests/test_nlte_parity.py feeds them
        eng.a_cont = jnp.asarray(state["a_cont"])
        eng.eps = jnp.asarray(state["eps"])
        eng.C = {(int(k[0]), int(k[1])): jnp.asarray(state[f"C_{k}"])
                 for k in _C_KEYS}
    else:
        atmos = j_atmos(nz=12, nx=8, ny=8, seed=7)
        eng = JRegular(atmos, j_line(5, 3, jnp.asarray(atmos.temperature)),
                       JConfig(**{**GATE_KW, **REGULAR[case]}))
    res = eng.run()
    return {"J": None if res.J is None else np.asarray(res.J),
            "S": np.asarray(res.S), "populations": np.asarray(res.populations)}


_CACHE = {}


def _pair(case):
    """(port float32 result, JAX float64 arrays) of the case, made once."""
    if case not in _CACHE:
        _CACHE[case] = (_port_run(case), _jax_f64_run(case))
    return _CACHE[case]


def _share_of_scale(got, want):
    """max |got - want| / max |want|, got a float32 tensor."""
    assert got.dtype == torch.float32
    got = got.to(torch.float64).numpy()
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("case", CASES)
def test_f32_engine_meets_the_gate(case):
    """The JAX package's float32 gate, applied to the port's float32
    engine against the JAX float64 engine."""
    res, want = _pair(case)
    for name, a64 in want.items():
        got = getattr(res, name)
        assert (got is None) == (a64 is None), name
        if a64 is None:
            continue
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(
            got.to(torch.float64).numpy(), a64, rtol=GATE,
            atol=GATE * np.max(np.abs(a64)), err_msg=f"f32 vs f64 {name}")


@pytest.mark.parametrize("case", CASES)
def test_f32_engine_meets_the_tight_bar(case):
    res, want = _pair(case)
    for name, a64 in want.items():
        if a64 is None:
            continue
        bar = (TIGHT_VORONOI_J if (case, name) == ("voronoi", "J")
               else TIGHT[name])
        err = _share_of_scale(getattr(res, name), a64)
        assert err <= bar, f"{case} {name}: {err:.3e} of scale > {bar}"


_JAX_F32_FIRST_PASS = r"""
import sys
from voronoirt_tpu.platform import setup
setup(platform="cpu", x64=False)
import numpy as np
import jax.numpy as jnp
from voronoirt_tpu import Config, synthetic_atmosphere
from voronoirt_tpu.engine import RegularEngine
from voronoirt_tpu.physics import lyman_alpha_line

atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="n2", maxiter=1, eps=1e-9)
line = lyman_alpha_line(5, 3, jnp.asarray(atmos.temperature))
res = RegularEngine(atmos, line, cfg).run()
assert res.J.dtype == jnp.float32
np.save(sys.argv[1], np.asarray(res.J))
"""


def test_first_J_pass_matches_jax_f32(tmp_path):
    """The first J pass of the gate's case, the port's float32 against
    the JAX package's float32 (x64 off), to 1e-4 of scale (1.03e-5
    measured).  Only the first pass: it reads B0 and the LTE
    populations, while the second reads the first update's populations,
    where JAX's float32 n1 = n_H - n2 - n3 is 7 % off in ionised cells
    and the port's n1 is not (physics/stateq.py), so the two float32
    engines part there by design; the whole iteration is held to the
    float64 engine instead."""
    out = str(tmp_path / "J.npy")
    proc = subprocess.run([sys.executable, "-c", _JAX_F32_FIRST_PASS, out],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=dict(os.environ, VRT_PLATFORM="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(out).astype(np.float64)
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
    line = lyman_alpha_line(5, 3, _t(atmos.temperature, torch.float32))
    res = RegularEngine(atmos, line, Config(**{**GATE_KW, "maxiter": 1},
                                            dtype="float32"),
                        device="cpu").run()
    assert res.iterations == 1
    assert _share_of_scale(res.J, want) <= 1e-4


# ------------------------------------------------------------ run surface


class _StopAfter:
    """A store that raises after its n-th write_state: a killed run."""

    def __init__(self, inner, n):
        self.inner, self.n, self.count = inner, n, 0

    def write_convergence(self, i, d):
        self.inner.write_convergence(i, d)

    def write_state(self, p, s):
        self.inner.write_state(p, s)
        self.count += 1
        if self.count >= self.n:
            raise KeyboardInterrupt


def test_f32_kill_and_resume_equals_the_whole_run(tmp_path):
    """A float32 run killed after its second state write and resumed
    from its file (float32 datasets) equals the uninterrupted float32
    run, bit for bit: the resume reads back exactly what was written."""
    atmos = synthetic_atmosphere(nz=8, nx=5, ny=5, seed=2)
    cfg = Config(eps=1e-3, maxiter=4, nlam_bb=5, nlam_bf=3,
                 quadrature="n2", dtype="float32")

    def engine():
        T = _t(atmos.temperature, torch.float32)
        return RegularEngine(atmos, lyman_alpha_line(5, 3, T), cfg,
                             device="cpu")

    whole = _run_iteration(engine())
    path = str(tmp_path / "kill.h5")
    eng = engine()
    ckpt = t_ckpt.CheckpointFile(path)
    ckpt.create_regular(eng.line, atmos, cfg.maxiter, cfg.dtype)
    with pytest.raises(KeyboardInterrupt):
        _run_iteration(eng, checkpoint=_StopAfter(ckpt, 2))
    assert ckpt.resume_iteration() >= 1
    P, S, _ = ckpt.read_state()
    assert P.dtype == S.dtype == np.float32
    res = t_ckpt.recover(engine(), path)
    assert res.S.dtype == torch.float32
    assert res.iterations == whole.iterations
    assert torch.equal(res.S, whole.S)
    assert torch.equal(res.populations, whole.populations)


SMALL = ["--eps", "1e-12", "--nlam-bb", "5", "--nlam-bf", "3",
         "--quadrature", "n2", "--atmos", "8", "5", "5", "--device", "cpu"]


@pytest.mark.parametrize("grid_kind", ["regular", "voronoi"])
def test_line_nlte_f32_writes_float32_and_recover_resumes(tmp_path,
                                                          grid_kind):
    """line_nlte --f32 writes float32 source function and populations
    (everything else float64, as a float64 run's file); recover --f32
    resumes the file and ends where an uninterrupted float32 run of the
    driver ends, bit for bit."""
    import h5py
    from voronoirt_tpu_torch.drivers import line_nlte, recover
    extra = (["--grid", "voronoi", "--n-sites", "300", "--no-cache"]
             if grid_kind == "voronoi" else [])
    run, whole = str(tmp_path / "run.h5"), str(tmp_path / "whole.h5")
    line_nlte.main(SMALL + extra + ["--f32", "--maxiter", "2", "--out", run])
    line_nlte.main(SMALL + extra + ["--f32", "--maxiter", "4", "--out",
                                    whole])
    with h5py.File(run) as f:
        assert f["source_function"].dtype == np.float32
        assert f["populations"].dtype == np.float32
        assert f["temperature"].dtype == f["convergence"].dtype == np.float64
        assert np.all(np.isfinite(f["source_function"][...]))
    summary = recover.main([run, "--f32", "--maxiter", "4", "--eps", "1e-12",
                            "--quadrature", "n2", "--no-cache", "--device",
                            "cpu"])
    assert summary["resumed_at"] == 2 and summary["iterations"] == 4
    with h5py.File(run) as f, h5py.File(whole) as g:
        for name in ("source_function", "populations"):
            assert f[name].dtype == np.float32
            np.testing.assert_array_equal(f[name][...], g[name][...])


def _jax_driver(name):
    """A module of the JAX package's drivers/ directory (a script,
    imported by file name as tests/test_torch_drivers.py does)."""
    sys.path.insert(0, os.path.join(REPO, "drivers"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("grid_kind,extra,rtol", [
    ("regular", [], 1e-6), ("voronoi", ["--raster", "8", "6", "6"], 1e-10)])
def test_synthesize_reads_a_float32_run(tmp_path, monkeypatch, capsys,
                                        grid_kind, extra, rtol):
    """The synthesize driver on a line_nlte --f32 file against the JAX
    driver on the same file.  Both read the float32 datasets as they
    are; the port widens them to float64 at once, while the JAX driver
    keeps the float32 populations' own arithmetic (n1 + n2 of the
    damping, the line source's level ratio) in float32 before it meets
    the float64 fields, so on the regular grid the two differ by
    float32 rounding: every .npy to rtol 1e-6 there (1.7e-7 measured).
    JAX's synthesize() on the same populations widened to float64 meets
    the float64 bar of tests/test_torch_drivers.py, rtol 1e-10 (2.7e-11
    measured).  The Voronoi file's populations are resampled onto the
    raster in float64 by both, so its images meet rtol 1e-10 as they
    are."""
    from voronoirt_tpu_torch.drivers import line_nlte, synthesize
    run = str(tmp_path / f"{grid_kind}.h5")
    line_nlte.main(["--grid", grid_kind, "--eps", "5e-2", "--maxiter", "2",
                    "--nlam-bb", "5", "--nlam-bf", "3", "--quadrature", "n2",
                    "--f32", "--out", run, "--device", "cpu"]
                   + (["--n-sites", "800", "--no-cache"]
                      if grid_kind == "voronoi" else []))
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    summary = synthesize.main([run, "--out", out, "--no-plots", "--device",
                               "cpu"] + extra)
    monkeypatch.setattr(sys, "argv", ["synthesize.py", run, "--out", jout,
                                      "--no-plots"] + extra)
    monkeypatch.setenv("VRT_PLATFORM", "cpu")
    j_synth = _jax_driver("synthesize")
    capsys.readouterr()
    j_synth.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for name in os.listdir(jout):
        np.testing.assert_allclose(np.load(os.path.join(out, name)),
                                   np.load(os.path.join(jout, name)),
                                   rtol=rtol, atol=0, err_msg=name)
    for key, value in want.items():
        assert summary[key] == pytest.approx(value, rel=rtol), key
    assert summary["I_centre_mean"] > summary["I_wing_mean"]
    if grid_kind == "regular":
        import h5py
        with h5py.File(run) as f:
            atmos, pops, lam_m = j_synth._load_regular(f)
        assert pops.dtype == np.float32
        I_j, _ = j_synth.synthesize(atmos, pops.astype(np.float64), lam_m,
                                    n_bb=5, n_bf=3)
        np.testing.assert_allclose(np.load(os.path.join(out, "regular.npy")),
                                   np.asarray(I_j), rtol=1e-10, atol=0)


# ---------------------------------------------------------- float32 splits

N_RANKS = 2
# name: (engine, mesh axes, Config overrides): the lambda split's cases
# of tests/test_torch_lam.py and the y / site splits of
# tests/test_torch_mesh.py, in float32, two iterations
SPLITS = {
    "lam": ("regular", ("lam",), dict(quadrature="ul2n3")),
    "streamed_lam": ("regular", ("lam",),
                     dict(quadrature="ul2n3", stream_rates=True,
                          lambda_chunk=4)),
    "y": ("regular", ("y",), dict(quadrature="ul2n3")),
    "site": ("voronoi", ("site",), dict(quadrature="ul2n3")),
}
# the split's bar against the unsplit float32 run, as a share of scale:
# a few float32 ulps, since the lambda split may add the rate integrals
# in another order than the unsplit run (every case measured bit-equal)
SPLIT_BAR = 1e-6


def _split_fields(kind):
    if kind == "regular":
        return synthetic_atmosphere(nz=8, nx=6, ny=6, seed=3)
    atmos = synthetic_atmosphere(nz=10, nx=4, ny=4, seed=7)
    pos = grid.sample_sites(atmos, 128, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))


def _split_engine(name, mesh=None):
    kind, axes, kw = SPLITS[name]
    fields = _split_fields(kind)
    cfg = Config(nlam_bb=5, nlam_bf=3, maxiter=2, eps=0.0, dtype="float32",
                 **kw)
    line = lyman_alpha_line(5, 3, _t(fields.temperature, torch.float32))
    line = pad_line(line, 12)
    make = RegularEngine if kind == "regular" else VoronoiEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make(fields, line, cfg, device="cpu", mesh=mesh)


class _Store:
    """An in-memory checkpoint store: the last state written."""

    def write_convergence(self, i, d):
        pass

    def write_state(self, populations, S):
        self.state = (populations, S)


def _split_ranks(world):
    """Every split case on this rank; S and the populations gathered,
    and what the y split's checkpoint store holds on rank 0."""
    out = {}
    for name, (kind, axes, _) in SPLITS.items():
        mesh = M.make_mesh((N_RANKS,), axes, world=world)
        store = _Store()
        res = _split_engine(name, mesh).run(checkpoint=store)
        S, P = res.S, res.populations
        if mesh.lam is not None:
            S = lam.gather_lambda(S, mesh.lam)
        else:
            spatial = (-2, -1) if kind == "regular" else (-1,)
            S = M.gather_space(S, mesh, dims=spatial)
            P = M.gather_space(P, mesh,
                               dims=(1, 2) if kind == "regular" else (0,))
        out[name] = dict(S=S.numpy(), P=P.numpy(),
                         stored=getattr(store, "state", None))
    return out


def test_f32_splits_match_the_unsplit_run():
    """One spawn of 2 gloo ranks runs the float32 lambda split (standard
    and streamed loop), the y split and the site split; rank 0's S and
    populations, gathered, against the unsplit float32 run at
    SPLIT_BAR of scale, and float32 throughout, in the state rank 0
    wrote to its checkpoint store too."""
    split = lam.spawn(_split_ranks, N_RANKS, device="cpu", timeout=600.0,
                      threads=1)[0]
    for name in SPLITS:
        P, S = split[name]["stored"]
        assert S.dtype == P.dtype == np.float32, name
        np.testing.assert_array_equal(S, split[name]["S"])
        np.testing.assert_array_equal(P, split[name]["P"])
        whole = _split_engine(name).run()
        for key, want in (("S", whole.S), ("P", whole.populations)):
            got, want = split[name][key], want.numpy()
            assert got.dtype == want.dtype == np.float32, (name, key)
            assert got.shape == want.shape, (name, key)
            err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            assert err <= SPLIT_BAR, f"{name} {key}: {err:.3e}"
