"""voronoirt_tpu_torch continuum scattering iteration, observability
metrics and source_line against the JAX package.  float64 on the CPU;
the same atmosphere and sites go through both packages."""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voronoirt_tpu as jpkg
from voronoirt_tpu.engine import continuum as j_cont
from voronoirt_tpu.physics import lyman_alpha_line as j_line
from voronoirt_tpu.physics.atom import source_line as j_source_line
from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import continuum as t_cont
from voronoirt_tpu_torch.observability import (PhaseTimer, device_trace,
                                               nan_guard, throughput)
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line, source_line


@pytest.fixture(scope="module")
def atmos():
    return synthetic_atmosphere(nz=10, nx=6, ny=6, seed=5)


@pytest.fixture(scope="module")
def sites(atmos):
    pos = grid.sample_sites(atmos, 600, seed=9)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))


def _lines(temperature):
    T = np.asarray(temperature)
    return (j_line(1, 1, jnp.asarray(T)),
            lyman_alpha_line(1, 1, torch.from_numpy(T)))


def test_continuum_setup_matches_jax(atmos):
    jl, tl = _lines(atmos.temperature)
    want = j_cont.continuum_setup(
        jl, jnp.asarray(atmos.temperature),
        jnp.asarray(atmos.electron_density),
        jnp.asarray(atmos.hydrogen_populations))
    got = t_cont.continuum_setup(tl, atmos.temperature,
                                 atmos.electron_density,
                                 atmos.hydrogen_populations, device="cpu")
    for g, w, name in zip(got, want, ("alpha_tot", "eps", "B")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=0, err_msg=name)


def test_continuum_defaults_to_the_card(atmos, monkeypatch):
    """With no device given the continuum functions go to the CUDA card
    and raise where none is visible."""
    _, tl = _lines(atmos.temperature)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_cont.lambda_continuum_regular(atmos, tl, Config(maxiter=1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_cont.continuum_setup(tl, atmos.temperature, atmos.electron_density,
                               atmos.hydrogen_populations)


@pytest.mark.parametrize("quadrature", ["ul2n3", "ul7n12"])
def test_continuum_regular_matches_jax(atmos, quadrature):
    """S, J and the convergence history of the 500 nm scattering
    iteration (a batch of ONE wavelength through every sweep) against
    the JAX package's: rtol 1e-10 (the linear weights' cancellation,
    ROADMAP C3, through up to 30 iterations); the history to 1e-8."""
    kw = dict(eps=1e-2, maxiter=30, quadrature=quadrature)
    jl, tl = _lines(atmos.temperature)
    S_j, J_j, hist_j = j_cont.lambda_continuum_regular(atmos, jl,
                                                       jpkg.Config(**kw))
    S_t, J_t, hist_t = t_cont.lambda_continuum_regular(atmos, tl,
                                                       Config(**kw),
                                                       device="cpu")
    assert len(hist_t) == len(hist_j) and hist_t[-1] < kw["eps"]
    assert S_t.shape == S_j.shape == atmos.shape
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=1e-10, atol=0)
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-10, atol=0)
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-8)


def test_continuum_voronoi_matches_jax(sites):
    """The same on the irregular grid (the JAX package pads its slot
    plans to shared shapes, the port does not): rtol 5e-10, the bar the
    Voronoi sweeps are held to next to a dark boundary (ROADMAP C3)."""
    kw = dict(eps=2e-2, maxiter=30, quadrature="ul2n3")
    jl, tl = _lines(sites.temperature)
    S_j, J_j, hist_j = j_cont.lambda_continuum_voronoi(sites, jl,
                                                       jpkg.Config(**kw))
    S_t, J_t, hist_t = t_cont.lambda_continuum_voronoi(sites, tl,
                                                       Config(**kw),
                                                       device="cpu")
    assert len(hist_t) == len(hist_j) and hist_t[-1] < kw["eps"]
    assert S_t.shape == (sites.n,)
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=5e-10, atol=0)
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=5e-10, atol=0)
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-8)


def test_continuum_mask_falls_back_to_every_cell(atmos):
    """With no cell above eps_mask the criterion covers every cell, as
    in the JAX package."""
    kw = dict(eps=1e-2, maxiter=3, quadrature="ul2n3")
    jl, tl = _lines(atmos.temperature)
    _, _, hist_j = j_cont.lambda_continuum_regular(
        atmos, jl, jpkg.Config(**kw), eps_mask=2.0)
    _, _, hist_t = t_cont.lambda_continuum_regular(
        atmos, tl, Config(**kw), eps_mask=2.0, device="cpu")
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-8)


def test_source_line_matches_jax(atmos):
    rng = np.random.default_rng(4)
    pops = rng.uniform(1e10, 1e16, atmos.shape + (3,))
    pops[..., 1] *= 1e-6
    jl, tl = _lines(atmos.temperature)
    want = np.asarray(j_source_line(jl, jnp.asarray(pops)))
    got = source_line(tl, torch.from_numpy(pops)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


# -------------------------------------------------------- observability

def test_phase_timer_report_and_dump(tmp_path):
    timer = PhaseTimer(device="cpu")
    for _ in range(2):
        with timer.phase("sweep"):
            torch.ones(8).sum()
    timer.add("rates", 0.25)
    rep = timer.report()
    assert rep["sweep"]["count"] == 2 and rep["sweep"]["total_s"] >= 0.0
    assert rep["sweep"]["mean_s"] == rep["sweep"]["total_s"] / 2
    assert rep["rates"] == {"total_s": 0.25, "count": 1, "mean_s": 0.25}
    assert rep["_wall_s"] >= rep["sweep"]["total_s"]
    timer.dump(str(tmp_path / "t.json"))
    assert set(json.load(open(tmp_path / "t.json"))) == {"sweep", "rates",
                                                         "_wall_s"}


def test_phase_timer_counts_a_failed_phase():
    timer = PhaseTimer()
    with pytest.raises(KeyError):
        with timer.phase("bad"):
            raise KeyError("x")
    assert timer.counts["bad"] == 1


def test_throughput_matches_jax():
    from voronoirt_tpu.observability.metrics import throughput as j_tp
    args = (215 * 256 * 256, 12, 91, 2, 38.5)
    assert throughput(*args) == j_tp(*args)


@pytest.mark.parametrize("make", [np.asarray, torch.as_tensor],
                         ids=["numpy", "tensor"])
def test_nan_guard(make):
    nan_guard("fine", make([1.0, 2.0]), make([[0.0]]))
    with pytest.raises(FloatingPointError, match="S: array 1 has 2"):
        nan_guard("S", make([1.0]), make([np.nan, 1.0, np.inf]))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64).exp().sum()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]
    assert any("exp" in e.key for e in prof.key_averages())
