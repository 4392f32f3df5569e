"""The port's analysis layer (voronoirt_tpu_torch.analysis) against the
repo's analysis/ scripts on the CPU: every plots.py function on the same
numpy inputs to rtol 1e-12, tests/test_analysis.py's cases re-run on the
port, and line_figures on small line_nlte runs (written by either
package) against the JAX script, float64."""

import importlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_analysis
from analysis import plots as j_plots
from voronoirt_tpu import synthetic_atmosphere as j_synthetic
from voronoirt_tpu.grid import interpolate as j_interp
from voronoirt_tpu.grid import voronoi as j_vor
from voronoirt_tpu_torch import synthetic_atmosphere
from voronoirt_tpu_torch.analysis import line_figures as t_lf
from voronoirt_tpu_torch.analysis import plots as t_plots
from voronoirt_tpu_torch.drivers import line_nlte as t_line_nlte
from voronoirt_tpu_torch.grid import interpolate as t_interp
from voronoirt_tpu_torch.grid import sampling as t_samp
from voronoirt_tpu_torch.grid import voronoi as t_vor

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = ["--atmos", "8", "5", "5", "--nlam-bb", "5", "--nlam-bf", "3",
         "--quadrature", "n2", "--maxiter", "2"]
GRIDS = {"regular": [], "voronoi": ["--grid", "voronoi", "--n-sites", "800",
                                   "--no-cache"]}
FIGURE_ARGS = ["--raster", "8", "5", "5", "--mus", "1.0", "0.6", "0.2"]
# centre_rel_diff_rms, port against JAX: the root mean square of the
# ratio of the two disk-centre line-centre images (measured: equal, on
# either package's files)
RMS_RTOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# ------------------------------------------------------------ plots.py

def _alpha(seed, nz=30, nx=6, ny=5):
    """Random positive extinction with the special columns: one too thin
    to reach tau = 1 (extrapolated), one empty (equal bracketing tau),
    one empty in its middle."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 1.0, nz))
    alpha = 10.0 ** rng.uniform(-0.5, 1.5, (nz, nx, ny))
    alpha[:, 0, 0] = 1e-3
    alpha[:, 1, 1] = 0.0
    alpha[nz // 3:2 * nz // 3, 2, 2] = 0.0
    return z, alpha


def test_tau_unity_height():
    z, alpha = _alpha(0)
    want = j_plots.tau_unity_height(alpha, z)
    got = t_plots.tau_unity_height(alpha, z)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    _close(got, want)
    assert got[1, 1] == z[0]                 # the t1 == t0 branch
    assert got[0, 0] < z[0]                  # extrapolated below the grid
    tensor = t_plots.tau_unity_height(torch.as_tensor(alpha), z)
    assert isinstance(tensor, torch.Tensor)
    _close(tensor.numpy(), want)


# (theta, phi): vertical, oblique, and one whose accumulated offset wraps
# both horizontal axes several times, in both senses
@pytest.mark.parametrize("theta,phi", [(180.0, 0.0), (150.0, 53.0),
                                       (100.0, 37.0), (95.0, 215.0)],
                         ids=["vertical", "oblique", "wraps", "wraps-back"])
def test_tau_unity_height_slanted(theta, phi):
    z, alpha = _alpha(1)
    x, y = np.arange(6) * 0.2, np.arange(5) * 0.25
    th, ph = np.deg2rad(theta), np.deg2rad(phi)
    k = np.array([np.cos(th), np.sin(th) * np.cos(ph),
                  np.sin(th) * np.sin(ph)])
    want = j_plots.tau_unity_height_slanted(alpha, z, x, y, k)
    _close(t_plots.tau_unity_height_slanted(alpha, z, x, y, k), want)
    tensor = t_plots.tau_unity_height_slanted(
        torch.as_tensor(alpha), torch.as_tensor(z), x, y, k)
    assert isinstance(tensor, torch.Tensor)
    _close(tensor.numpy(), want)
    if theta == 95.0:
        # the ray crosses the box more than once in x and in y
        r = (z[-1] - z[0]) / abs(k[0])
        assert r * abs(k[1]) > 2 * 6 * 0.2 and r * abs(k[2]) > 2 * 5 * 0.25


@pytest.mark.parametrize("lam", [121.567e-9, 91.2e-9, 500e-9])
def test_brightness_temperature(lam):
    rng = np.random.default_rng(2)
    I = 10.0 ** rng.uniform(-8.0, 4.0, (6, 5))
    I[0, 0] = 0.0
    _close(t_plots.brightness_temperature(I, lam),
           j_plots.brightness_temperature(I, lam))


def test_profile_convergence_and_source_function(tmp_path):
    rng = np.random.default_rng(3)
    S = rng.uniform(1.0, 2.0, (7, 4, 5, 5))
    _close(t_plots.line_profile(S), j_plots.line_profile(S))
    _close(t_plots.line_profile(S, axis=(2, 3)),
           j_plots.line_profile(S, axis=(2, 3)))
    conv = [0.0, 1.0, 0.1, 0.01, 0.0]
    _close(t_plots.plot_convergence(conv, out_png=str(tmp_path / "c.png"),
                                    label="run"),
           j_plots.plot_convergence(conv))
    z = np.linspace(0.0, 2e6, 4)
    _close(t_plots.plot_source_function(S, z, 3,
                                        out_png=str(tmp_path / "s.png")),
           j_plots.plot_source_function(S, z, 3))
    assert sorted(os.listdir(tmp_path)) == ["c.png", "s.png"]


def test_scaling_beam_and_images(tmp_path):
    rng = np.random.default_rng(4)
    counts, times = [1, 2, 4, 8], rng.uniform(10.0, 100.0, 4)
    _close(t_plots.scaling_plot(counts, times,
                                out_png=str(tmp_path / "scale.png")),
           j_plots.scaling_plot(counts, times))
    for _ in range(5):
        k = rng.normal(size=3)
        assert t_plots.analytic_beam_center(k) == \
            j_plots.analytic_beam_center(k)
    x, y = np.linspace(0.0, 1.0, 9), np.linspace(0.0, 1.0, 7)
    I = rng.uniform(0.0, 1.0, (9, 7))
    k = np.array([-0.8, 0.36, 0.48])
    assert t_plots.plot_searchlight(k, x, y, I, 0.1, "beam",
                                    out_png=str(tmp_path / "b.png")) == \
        j_plots.analytic_beam_center(k)
    assert t_plots.plot_top_intensity(I, x * 1e6, y * 1e6,
                                      out_png=str(tmp_path / "i.png")) is I
    assert sorted(os.listdir(tmp_path)) == ["b.png", "i.png", "scale.png"]


def test_plot_grid_layers(tmp_path):
    ta = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=5)
    ja = j_synthetic(nz=12, nx=8, ny=8, seed=5)
    pos = t_samp.sample_sites(ta, 400, seed=6)
    bounds = (ta.z[0], ta.z[-1], ta.x[0], ta.x[-1], ta.y[0], ta.y[-1])
    ts = t_vor.build_sites(pos, bounds, t_interp.initialise_sites(pos, ta))
    js = j_vor.build_sites(pos.copy(), bounds,
                           j_interp.initialise_sites(pos.copy(), ja))
    got = t_plots.plot_grid_layers(ts, out_png=str(tmp_path / "g.png"))
    want = j_plots.plot_grid_layers(js)
    assert sorted(got) == sorted(want) and got["n_sites"] == 400
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    assert os.listdir(tmp_path) == ["g.png"]


# tests/test_analysis.py's cases, each run with every analysis/plots.py
# function it reaches replaced by the port's
JAX_CASES = [name for name, fn in inspect.getmembers(test_analysis,
                                                     inspect.isfunction)
             if name.startswith("test_")]
PORTED = [name for name, fn in inspect.getmembers(j_plots,
                                                  inspect.isfunction)
          if not name.startswith("_")]


@pytest.mark.parametrize("case", JAX_CASES)
def test_analysis_case_on_the_port(case, monkeypatch, tmp_path):
    for name in PORTED:
        monkeypatch.setattr(j_plots, name, getattr(t_plots, name))
        if hasattr(test_analysis, name):
            monkeypatch.setattr(test_analysis, name, getattr(t_plots, name))
    fn = getattr(test_analysis, case)
    fn(*([tmp_path] if inspect.signature(fn).parameters else []))


# ------------------------------------------------------- line_figures

def _jax_main(mp, module, argv):
    """main() of a JAX package script (drivers.line_nlte,
    analysis.line_figures), on the CPU, with argv as its command line."""
    mp.setattr(sys, "argv", [module.rsplit(".", 1)[-1] + ".py"] + argv)
    mp.setenv("VRT_PLATFORM", "cpu")
    importlib.import_module(module).main()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The small regular and Voronoi line_nlte runs, written by the
    port's line_nlte and by the JAX package's: {writer: (regular,
    voronoi)}."""
    tmp = tmp_path_factory.mktemp("runs")
    out = {"port": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        for grid, extra in GRIDS.items():
            path = str(tmp / f"port_{grid}.h5")
            t_line_nlte.main(SMALL + extra + ["--out", path, "--device",
                                              "cpu"])
            out["port"].append(path)
            path = str(tmp / f"jax_{grid}.h5")
            _jax_main(mp, "drivers.line_nlte",
                      SMALL + extra + ["--out", path])
            out["jax"].append(path)
    return out


def _summary(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_line_figures_matches_jax(runs, tmp_path, capsys, writer):
    """The port's line_figures on a regular and a Voronoi run against
    the JAX script on the same files: the same keys, iterations, mus,
    seconds and figure names; final_diff to 1e-12, every profile to
    rtol 1e-10 (the bar of test_synthesize_matches_jax, ROADMAP C3) and
    centre_rel_diff_rms to RMS_RTOL."""
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    capsys.readouterr()
    got = t_lf.main(runs[writer] + ["--out", out, "--device", "cpu"]
                    + FIGURE_ARGS)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.MonkeyPatch.context() as mp:
        _jax_main(mp, "analysis.line_figures",
                  runs[writer] + ["--out", jout] + FIGURE_ARGS)
    want = _summary(jout)
    assert _summary(out) == got
    assert printed == {k: got[k] for k in ("iterations", "final_diff",
                                           "wall_seconds",
                                           "centre_rel_diff_rms")}
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert len(os.listdir(out)) == 6          # five figures and the summary
    assert sorted(got) == sorted(want)
    for key in ("mus", "iterations", "wall_seconds"):
        assert got[key] == want[key], key
    assert got["iterations"] == {"regular": 2, "voronoi": 2}
    for kind, value in want["final_diff"].items():
        assert got["final_diff"][kind] == pytest.approx(value, rel=1e-12)
    assert sorted(got["profiles"]) == sorted(want["profiles"])
    for key, prof in want["profiles"].items():
        assert len(prof) == 5
        np.testing.assert_allclose(got["profiles"][key], prof, rtol=1e-10,
                                   atol=0, err_msg=key)
    assert got["centre_rel_diff_rms"] == pytest.approx(
        want["centre_rel_diff_rms"], rel=RMS_RTOL)
    assert np.isfinite(got["centre_rel_diff_rms"])


def test_line_figures_from_a_mapping(runs, tmp_path):
    """figures() on runs read from mappings of the datasets equals
    `python -m voronoirt_tpu_torch.analysis.line_figures --no-plots` on
    the files bit for bit; that run writes summary.json and no figure,
    and imports no jax."""
    import h5py
    out = str(tmp_path / "t")
    code = ("import runpy, sys; sys.argv = ['line_figures'] + sys.argv[1:];"
            " runpy.run_module('voronoirt_tpu_torch.analysis.line_figures',"
            " run_name='__main__'); assert 'jax' not in sys.modules")
    proc = subprocess.run(
        [sys.executable, "-c", code] + runs["port"]
        + ["--out", out, "--no-plots", "--device", "cpu"] + FIGURE_ARGS,
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.listdir(out) == ["summary.json"]
    loaded = []
    for path in runs["port"]:
        with h5py.File(path) as f:
            loaded.append(t_lf.load_run({k: f[k][...] for k in f},
                                        raster=(8, 5, 5)))
    summary, cubes = t_lf.figures(loaded, (1.0, 0.6, 0.2), plots=False,
                                  device="cpu")
    assert json.loads(json.dumps(summary)) == _summary(out)
    assert json.loads(proc.stdout.strip().splitlines()[-1])[
        "centre_rel_diff_rms"] == summary["centre_rel_diff_rms"]
    assert sorted(cubes) == sorted((kind, mu) for kind in GRIDS
                                   for mu in (1.0, 0.6, 0.2))
    for I, _ in cubes.values():
        assert I.shape == (11, 5, 5) and np.isfinite(I).all() and I.min() >= 0


def test_line_figures_refuses_voronoi_first(runs, tmp_path):
    """Both scripts refuse the Voronoi run passed first; without a
    device the port runs on the card, and raises where none is
    visible."""
    swapped = runs["port"][::-1] + ["--out", str(tmp_path / "t")]
    with pytest.raises(ValueError, match="regular checkpoint first"):
        t_lf.main(swapped + ["--device", "cpu"] + FIGURE_ARGS)
    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(AssertionError, match="regular checkpoint first"):
        _jax_main(mp, "analysis.line_figures", swapped + FIGURE_ARGS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            t_lf.main(runs["port"] + ["--out", str(tmp_path / "c")])
        loaded = [t_lf.load_run(p, (8, 5, 5)) for p in runs["port"]]
        with pytest.raises(RuntimeError, match="CUDA device"):
            t_lf.figures(loaded, (1.0,), plots=False)
