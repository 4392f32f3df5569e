"""The port's drivers (voronoirt_tpu_torch.drivers) against the JAX
package's drivers/*.py at small sizes: each main([... "--device", "cpu"])
returns the summary it prints, compared with the JAX driver's.  float64
on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch.drivers import continuum as t_continuum
from voronoirt_tpu_torch.drivers import continuum_study as t_study
from voronoirt_tpu_torch.drivers import line_nlte as t_line_nlte
from voronoirt_tpu_torch.drivers import recover as t_recover
from voronoirt_tpu_torch.drivers import searchlight as t_searchlight
from voronoirt_tpu_torch.drivers import synthesize as t_synth
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = ["--eps", "5e-2", "--maxiter", "3", "--nlam-bb", "5", "--nlam-bf",
         "3", "--quadrature", "n2", "--atmos", "8", "5", "5"]


def _jax_driver(name):
    """A module of the JAX package's drivers/ directory (they are
    scripts: imported by file name, as tests/test_drivers.py does)."""
    sys.path.insert(0, os.path.join(REPO, "drivers"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _jax_main(name, argv, monkeypatch, capsys):
    """Run a JAX driver's main() on argv; its printed JSON summary."""
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    monkeypatch.setenv("VRT_PLATFORM", "cpu")
    capsys.readouterr()
    _jax_driver(name).main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _printed(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_searchlight_regular_matches_jax(capsys):
    """All 12 beams cross the cube with their flux kept (rel 1e-4, the
    bar of tests/test_drivers.py) and equal the JAX driver's to 1e-12."""
    res = t_searchlight.main(["--n", "21", "--device", "cpu"])
    assert _printed(capsys) == res
    want = _jax_driver("searchlight").run_regular(n=21)
    assert len(res) == len(want) == 12
    for got, ref in zip(res, want):
        assert sorted(got) == sorted(ref)
        assert got["flux_out"] == pytest.approx(got["flux_in"], rel=1e-4)
        for key in ("theta", "phi", "flux_in", "flux_out"):
            assert got[key] == pytest.approx(ref[key], rel=1e-12)
        assert got["center"] == pytest.approx(ref["center"], rel=1e-12)


def test_searchlight_irregular_matches_jax(tmp_path):
    res = t_searchlight.run_irregular(n_side=6, out_dir=str(tmp_path),
                                      device="cpu")
    want = _jax_driver("searchlight").run_irregular(n_side=6)
    for got, ref in zip(res, want):
        assert sorted(got) == sorted(ref)
        assert got["mean_in"] == ref["mean_in"]
        assert got["mean_out"] == pytest.approx(ref["mean_out"], rel=1e-10,
                                                abs=1e-14)
    img = np.load(tmp_path / "I_70_346_voronoi.npy")
    assert img.shape == (60, 60) and np.isfinite(img).all()


def test_searchlight_helpers_match_jax():
    j = _jax_driver("searchlight")
    for n in (11, 51):
        np.testing.assert_array_equal(t_searchlight.beam_mask(n),
                                      j.beam_mask(n))
    k = t_searchlight.kvec(160.0, 45.0)
    np.testing.assert_array_equal(k, j.kvec(160.0, 45.0))
    assert t_searchlight.analytic_center(k) == j.analytic_center(k)


def test_continuum_driver_matches_jax(tmp_path, capsys):
    """The LTE disk-centre images, regular and resampled from 1500
    sites, against the JAX driver's on the same atmosphere: rtol 1e-10."""
    out = str(tmp_path / "img")
    summary = t_continuum.main(["--atmos", "12", "8", "8", "--n-sites",
                                "1500", "--out", out, "--device", "cpu"])
    assert _printed(capsys) == summary
    assert sorted(summary) == ["regular_mean", "rel_diff", "voronoi_mean"]
    j = _jax_driver("continuum")
    from voronoirt_tpu import synthetic_atmosphere
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=1998)
    img_r = j.run_regular(atmos)
    img_v = j.run_voronoi(atmos, 1500)
    np.testing.assert_allclose(np.load(os.path.join(out, "I_regular.npy")),
                               img_r, rtol=1e-10, atol=0)
    np.testing.assert_allclose(
        np.load(os.path.join(out, "I_voronoi_1500.npy")), img_v, rtol=1e-10,
        atol=0)
    assert summary["regular_mean"] == pytest.approx(float(img_r.mean()),
                                                    rel=1e-10)
    assert summary["rel_diff"] == pytest.approx(
        float(np.mean(np.abs(img_v - img_r) / np.abs(img_r))), rel=1e-8)


@pytest.mark.parametrize("extra", [[], ["--interpolation", "bezier"],
                                   ["--stream", "--lambda-chunk", "4"],
                                   ["--rates-chunk", "3"]],
                         ids=["linear", "bezier", "stream", "slabbed"])
def test_line_nlte_matches_jax(tmp_path, monkeypatch, capsys, extra):
    """line_nlte on the small synthetic atmosphere, every loop the flags
    select: the printed summary and the checkpoint against the JAX
    driver's (final criterion to 1e-6; S 1e-10, populations 1e-8)."""
    import h5py
    out, jout = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    summary = t_line_nlte.main(SMALL + extra + ["--out", out, "--device",
                                                "cpu"])
    assert _printed(capsys) == summary
    want = _jax_main("line_nlte", SMALL + extra + ["--out", jout],
                     monkeypatch, capsys)
    # the port's summary adds its spans (observability.report())
    spans = summary["observability"]
    assert sorted(set(summary) - {"observability"}) == sorted(want)
    assert spans["setup"]["engine.setup"] > 0.0
    assert spans["first_iteration"]["host_s"]["engine.iteration"] > 0.0
    for key in ("grid", "iterations", "converged"):
        assert summary[key] == want[key]
    assert summary["iterations"] >= 1
    assert summary["final_diff"] == pytest.approx(want["final_diff"],
                                                  rel=1e-6)
    with h5py.File(out) as f, h5py.File(jout) as g:
        assert sorted(f) == sorted(g)
        np.testing.assert_allclose(f["source_function"][...],
                                   g["source_function"][...], rtol=1e-10)
        np.testing.assert_allclose(f["populations"][...],
                                   g["populations"][...], rtol=1e-8)
        np.testing.assert_allclose(f["convergence"][...],
                                   g["convergence"][...], rtol=1e-6)
        assert f["time"][0] > 0.0


def test_recover_matches_jax(tmp_path, monkeypatch, capsys):
    """A two-iteration run resumed by the port's recover driver and by
    the JAX one from copies of the same file: the same resume point,
    iteration count and final state."""
    import h5py
    out = str(tmp_path / "run.h5")
    t_line_nlte.main(SMALL[:2] + ["--maxiter", "2"] + SMALL[4:]
                     + ["--eps", "1e-12", "--out", out, "--device", "cpu"])
    jout = str(tmp_path / "jrun.h5")
    shutil.copy(out, jout)
    args = ["--maxiter", "5", "--eps", "1e-12", "--quadrature", "n2"]
    summary = t_recover.main([out] + args + ["--device", "cpu"])
    assert _printed(capsys) == summary
    want = _jax_main("recover", [jout] + args, monkeypatch, capsys)
    assert sorted(summary) == sorted(want)
    for key in ("resumed_at", "iterations", "converged"):
        assert summary[key] == want[key]
    # the file has maxiter + 1 = 3 convergence slots, all written
    assert summary["resumed_at"] == 2 and summary["iterations"] == 5
    with h5py.File(out) as f, h5py.File(jout) as g:
        np.testing.assert_allclose(f["source_function"][...],
                                   g["source_function"][...], rtol=1e-8)
        np.testing.assert_allclose(f["populations"][...],
                                   g["populations"][...], rtol=1e-8)


def test_voronoi_run_and_recover(tmp_path, capsys):
    """--grid voronoi writes the Voronoi schema, and the recover driver
    rebuilds a VoronoiEngine from it and resumes."""
    from voronoirt_tpu_torch import Config
    out = str(tmp_path / "vor.h5")
    summary = t_line_nlte.main(
        SMALL + ["--grid", "voronoi", "--n-sites", "300", "--no-cache",
                 "--maxiter", "2", "--eps", "1e-12", "--out", out,
                 "--device", "cpu"])
    assert summary["grid"] == "voronoi" and summary["iterations"] == 2
    eng, line = t_recover.load_engine_from_checkpoint(
        out, Config(nlam_bb=5, nlam_bf=3, quadrature="n2"), device="cpu")
    assert isinstance(eng, VoronoiEngine) and eng.T.shape == (300,)
    assert line.n_lambda == 11 and eng.device.type == "cpu"
    res = t_recover.main([out, "--maxiter", "4", "--eps", "1e-12",
                          "--quadrature", "n2", "--no-cache", "--device",
                          "cpu"])
    assert res["resumed_at"] == 2 and res["iterations"] == 4


def test_recover_loads_a_regular_engine(tmp_path):
    from voronoirt_tpu_torch import Config
    out = str(tmp_path / "reg.h5")
    t_line_nlte.main(SMALL + ["--out", out, "--device", "cpu"])
    eng, _ = t_recover.load_engine_from_checkpoint(
        out, Config(nlam_bb=5, nlam_bf=3, quadrature="n2"), device="cpu")
    assert isinstance(eng, RegularEngine) and eng.T.shape == (8, 5, 5)


@pytest.mark.parametrize("grid,extra", [
    ("regular", []), ("voronoi", ["--raster", "8", "6", "6"])])
def test_synthesize_matches_jax(tmp_path, monkeypatch, capsys, grid, extra):
    """The synthesize driver on a small line_nlte output (the run of
    tests/test_drivers.py::test_synthesize_driver) against the JAX
    driver on the same file: every .npy to rtol 1e-10, since the linear
    weights cancel digits above their 5e-4 guard where XLA's exp is one
    ulp off PyTorch's (ROADMAP C3; measured 2.4e-11 on the regular
    image); the printed keys equal.  Then that test's bars."""
    run = str(tmp_path / f"{grid}.h5")
    t_line_nlte.main(["--grid", grid, "--eps", "5e-2", "--maxiter", "2",
                      "--nlam-bb", "5", "--nlam-bf", "3", "--quadrature",
                      "n2", "--out", run, "--device", "cpu"]
                     + (["--n-sites", "800", "--no-cache"]
                        if grid == "voronoi" else []))
    capsys.readouterr()
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    summary = t_synth.main([run, "--out", out, "--no-plots", "--device",
                            "cpu"] + extra)
    assert _printed(capsys) == summary
    want = _jax_main("synthesize", [run, "--out", jout, "--no-plots"] + extra,
                     monkeypatch, capsys)
    assert sorted(summary) == sorted(want)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for name in os.listdir(jout):
        np.testing.assert_allclose(np.load(os.path.join(out, name)),
                                   np.load(os.path.join(jout, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    for key, value in want.items():
        assert summary[key] == pytest.approx(value, rel=1e-10), key
    assert summary["kind"] == grid
    I = np.load(os.path.join(out, f"{grid}.npy"))
    lam = np.load(os.path.join(out, f"{grid}_wavelength.npy"))
    assert I.shape[0] == len(lam) == summary["n_lambda"]
    assert np.all(np.isfinite(I)) and I.min() >= 0
    # line centre must be brighter than the far wing for Ly-alpha
    assert summary["I_centre_mean"] > summary["I_wing_mean"]
    assert 3000.0 < summary["Tb_centre_mean"] < 50000.0


def test_synthesize_streams_lambda_blocks(monkeypatch):
    """synthesize() in blocks of one wavelength equals it in blocks of
    LAMBDA_BLOCK, bit for bit: every operation is pointwise in
    wavelength, and the slanted direction marches (yz/xz segments)."""
    from voronoirt_tpu_torch import synthetic_atmosphere
    atmos = synthetic_atmosphere(nz=10, nx=6, ny=6, seed=4)
    T = atmos.temperature
    pops = np.stack([0.6 * atmos.hydrogen_populations,
                     1e-6 * atmos.hydrogen_populations * T / T.max(),
                     0.4 * atmos.hydrogen_populations], axis=-1)
    lam = t_synth.lyman_alpha_line(5, 3, torch.as_tensor(T)).lam
    args = (atmos, pops, lam, 135.0, 30.0)
    kw = dict(n_bb=5, n_bf=3, device="cpu")
    I_all, _ = t_synth.synthesize(*args, **kw)
    monkeypatch.setattr(t_synth, "LAMBDA_BLOCK", 1)
    I_one, _ = t_synth.synthesize(*args, **kw)
    np.testing.assert_array_equal(I_one, I_all)
    assert I_all.shape == (11, 6, 6) and np.isfinite(I_all).all()


def test_continuum_study_matches_jax(tmp_path, monkeypatch, capsys):
    """continuum_study --n-sites 2e3,5e3 --skips 1,2 against the JAX
    driver: the images to rtol 1e-10 (the continuum driver's bar), every
    rel_l1 to 1e-8 absolute (a mean of differences of images that agree
    to 1e-10), the same keys and shapes; then the bars of
    tests/test_drivers.py::test_continuum_study_harness."""
    argv = ["--n-sites", "2e3,5e3", "--skips", "1,2", "--no-plots"]
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    res = t_study.main(argv + ["--out", out, "--device", "cpu"])
    assert _printed(capsys) == res
    want = _jax_main("continuum_study", argv + ["--out", jout], monkeypatch,
                     capsys)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for name in os.listdir(jout):
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(out, name)),
                                       np.load(os.path.join(jout, name)),
                                       rtol=1e-10, atol=0, err_msg=name)
    assert sorted(res) == sorted(want) == ["regular", "voronoi"]
    for kind in want:
        assert sorted(res[kind]) == sorted(want[kind])
        for entry, rec in want[kind].items():
            assert sorted(res[kind][entry]) == sorted(rec)
            assert res[kind][entry]["rel_l1_vs_full"] == pytest.approx(
                rec["rel_l1_vs_full"], abs=1e-8)
            for key in ("skip", "shape", "n_points", "n_sites"):
                assert res[kind][entry].get(key) == rec.get(key)
    with open(os.path.join(out, "study.json")) as f:
        assert json.load(f) == res
    e_lo = res["voronoi"]["2000"]["rel_l1_vs_full"]
    e_hi = res["voronoi"]["5000"]["rel_l1_vs_full"]
    assert np.isfinite(e_lo) and np.isfinite(e_hi)
    assert e_hi < max(1.2 * e_lo, 1.0) and e_hi < 0.5
    assert res["regular"]["half"]["rel_l1_vs_full"] < 0.5


def test_continuum_study_helpers_match_jax():
    from voronoirt_tpu_torch import synthetic_atmosphere
    j = _jax_driver("continuum_study")
    atmos = synthetic_atmosphere(nz=9, nx=7, ny=5, seed=2)
    for skip in (1, 2, 3):
        got, want = (t_study.strided_atmosphere(atmos, skip),
                     j.strided_atmosphere(atmos, skip))
        assert got.shape == want.shape
        for name, v in want.fields().items():
            np.testing.assert_array_equal(got.fields()[name], v)
    a, b = atmos.temperature, atmos.temperature[::-1]
    assert t_study.rel_l1(a, b) == j.rel_l1(a, b)
    k = t_synth._direction(135.0, 30.0)
    np.testing.assert_array_equal(k, _jax_driver("synthesize")._direction(
        135.0, 30.0))


@pytest.mark.parametrize("main,argv", [
    (t_searchlight.main, ["--n", "11"]),
    (t_line_nlte.main, SMALL),
    (t_continuum.main, ["--atmos", "6", "4", "4"]),
    (t_synth.main, ["run.h5", "--out", "synth"]),
    (t_study.main, ["--atmos", "6", "4", "4", "--out", "study"]),
], ids=["searchlight", "line_nlte", "continuum", "synthesize",
        "continuum_study"])
def test_drivers_default_to_the_card(monkeypatch, main, argv):
    """Without --device the drivers run on the CUDA card, and raise
    where none is visible rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(argv)


def test_driver_runs_as_a_module():
    """python -m voronoirt_tpu_torch.drivers.searchlight: the last line
    of its output is the JSON summary, and the run imports no jax."""
    code = ("import runpy, sys; sys.argv = ['searchlight', '--n', '21', "
            "'--device', 'cpu']; "
            "runpy.run_module('voronoirt_tpu_torch.drivers.searchlight', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(res) == 12 and all(
        r["flux_out"] == pytest.approx(r["flux_in"], rel=1e-4) for r in res)
