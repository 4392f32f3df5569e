"""voronoirt_tpu_torch Bezier formal solution against the JAX package:
the single-direction sweep, compute_J and a whole run with
formal_interpolation='bezier'.  float64 on the CPU; the same numpy arrays
go through both packages."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voronoirt_tpu as jpkg
from voronoirt_tpu.engine import RegularEngine as JRegularEngine
from voronoirt_tpu.physics import lyman_alpha_line as j_line
from voronoirt_tpu.solvers import sweep_regular as jsr
from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.solvers import sweep_regular as tsr


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


def _fields(seed, nz=14, nx=8, ny=9, B=3):
    rng = np.random.default_rng(seed)
    # a stretched z axis: steep directions stay xy, oblique ones change
    # case from plane to plane
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 0.3, nz - 1))])
    S = rng.uniform(0.1, 1.0, (nz, B, nx, ny))
    alpha = 10.0 ** rng.uniform(-2.0, 1.5, (nz, B, nx, ny))
    I0 = rng.uniform(0.5, 1.0, (B, nx, ny))
    return z, 1.0 / nx, 1.0 / ny, S, alpha, I0


# (theta, phi, up, the cases its segments must show)
DIRECTIONS = [
    pytest.param(160.0, 30.0, True, {"xy"}, id="xy-only-up"),
    pytest.param(110.0, 200.0, True, {"xy", "yz"}, id="mixed-xy-yz-up"),
    pytest.param(20.0, 100.0, False, {"xy"}, id="xy-only-down"),
    pytest.param(70.0, 300.0, False, {"xy", "xz"}, id="mixed-xy-xz-down"),
]


@pytest.mark.parametrize("theta,phi,up,cases", DIRECTIONS)
def test_bezier_sweep_matches_jax(theta, phi, up, cases):
    """Bezier `sweep` against the JAX package's, rtol 2e-12: the Bezier
    weights agree between XLA and PyTorch to ~2e-13 absolute near their
    dtau = 0.05 branch (one-ulp exp differences, cancelling J2/dt^2)."""
    z, dx, dy, S, alpha, I0 = _fields(0)
    k = kvec(theta, phi)
    plan = tsr.build_plan(k, z, dx, dy, up)
    assert {s.case for s in plan.segments} == cases
    want = np.asarray(jsr.sweep(
        jsr.build_plan(k, z, dx, dy, up), jnp.asarray(S), jnp.asarray(alpha),
        jnp.asarray(I0), n_sweeps=3, interpolation="bezier"))
    t = torch.from_numpy
    got = tsr.sweep(plan, t(S), t(alpha), t(I0), n_sweeps=3,
                    interpolation="bezier").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-12, atol=0)
    # and it is not the linear solution under another name
    lin = tsr.sweep(plan, t(S), t(alpha), t(I0), n_sweeps=3).numpy()
    assert np.max(np.abs(got / lin - 1.0)) > 1e-3


def test_bezier_marching_segments_stay_linear():
    """A direction with no xy segment gives the linear solution bit for
    bit: the marching segments have no Bezier form."""
    z = np.linspace(0.0, 1.0, 10)
    _, dx, dy, S, alpha, I0 = _fields(1, nz=10)
    plan = tsr.build_plan(kvec(94.0, 20.0), z, dx, dy, True)
    assert {s.case for s in plan.segments} == {"yz"}
    t = torch.from_numpy
    a = tsr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier")
    b = tsr.sweep(plan, t(S), t(alpha), t(I0))
    assert torch.equal(a, b)


def test_unknown_interpolation_is_refused():
    z, dx, dy, S, alpha, I0 = _fields(2)
    plan = tsr.build_plan(kvec(160.0, 30.0), z, dx, dy, True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="interpolation"):
        tsr.sweep(plan, t(S), t(alpha), t(I0), interpolation="cubic")


def test_column_accuracy_beats_linear():
    """The accuracy property of tests/test_sweep_regular.py's
    test_column_accuracy_beats_linear on the port: on a smooth column
    the Bezier error is below a third of the linear one."""
    nz = 33
    z = np.linspace(0.0, 1.0, nz)
    a0 = 3.0
    S = np.tile((1.0 + np.sin(3 * z))[:, None, None], (1, 4, 4))
    alpha = np.full((nz, 4, 4), a0)
    I0 = np.zeros((4, 4))
    Iex = ((1 - np.exp(-a0 * z))
           + a0 * (a0 * np.sin(3 * z) - 3 * np.cos(3 * z)
                   + 3 * np.exp(-a0 * z)) / (a0 * a0 + 9.0))
    k = np.array([-1.0, 0.0, 0.0])
    errs = {}
    for interp in ("linear", "bezier"):
        I = tsr.short_characteristics(
            k, torch.from_numpy(S), torch.from_numpy(alpha),
            torch.from_numpy(I0), z, 1.0, 1.0, up=True,
            interpolation=interp).numpy()
        errs[interp] = np.abs(I[:, 0, 0] - Iex).max()
    assert errs["bezier"] < errs["linear"] / 3.0


def _engines(atmos, **kw):
    T = np.asarray(atmos.temperature)
    jeng = JRegularEngine(atmos, j_line(kw["nlam_bb"], kw["nlam_bf"],
                                        jnp.asarray(T)), jpkg.Config(**kw))
    teng = RegularEngine(atmos, lyman_alpha_line(
        kw["nlam_bb"], kw["nlam_bf"], torch.from_numpy(T)), Config(**kw))
    return jeng, teng


@pytest.mark.parametrize("chunk", [None, 4])
def test_bezier_compute_J_matches_jax(chunk):
    """compute_J with formal_interpolation='bezier' (the per-angle path)
    against the JAX engine's, rtol 5e-11: measured 4.5e-12, the Bezier
    weights' cancellation near dtau = 0.05 (see
    test_bezier_sweep_matches_jax) summed over 12 directions."""
    atmos = synthetic_atmosphere(nz=10, nx=6, ny=6, seed=3)
    jeng, teng = _engines(atmos, nlam_bb=5, nlam_bf=3, quadrature="ul7n12",
                          lambda_chunk=chunk, formal_interpolation="bezier")
    want = np.asarray(jeng.compute_J(jeng.B0, jeng.lte))
    got = teng.compute_J(teng.B0, teng.lte).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-11, atol=0)
    # Bezier J differs from the linear (grouped) J
    _, lin = _engines(atmos, nlam_bb=5, nlam_bf=3, quadrature="ul7n12",
                      lambda_chunk=chunk)
    J_lin = lin.compute_J(lin.B0, lin.lte).numpy()
    assert np.max(np.abs(got / J_lin - 1.0)) > 1e-4


def test_bezier_run_matches_jax():
    """Two Bezier Lambda iterations through run() against the JAX
    engine's: S to 1e-10, populations to 1e-8 (the rates cancel digits,
    as in test_torch_engine.py), the convergence history to 1e-9."""
    atmos = synthetic_atmosphere(nz=10, nx=6, ny=6, seed=3)
    jeng, teng = _engines(atmos, nlam_bb=5, nlam_bf=3, quadrature="ul2n3",
                          formal_interpolation="bezier", maxiter=2, eps=1e-9)
    want, got = jeng.run(), teng.run()
    assert got.iterations == want.iterations == 2
    np.testing.assert_allclose(got.S.numpy(), want.S, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.populations.numpy(), want.populations,
                               rtol=1e-8, atol=0)
    np.testing.assert_allclose(got.convergence, want.convergence, rtol=1e-9)


def test_streamed_loop_refuses_bezier():
    """stream_rates sweeps in batched groups, which are linear only: the
    streamed loop and iterate_streamed raise for Bezier (the JAX package
    asserts the same)."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    _, teng = _engines(atmos, nlam_bb=5, nlam_bf=3, quadrature="ul2n3",
                       formal_interpolation="bezier", stream_rates=True)
    with pytest.raises(NotImplementedError, match="linear"):
        teng.run()
    with pytest.raises(NotImplementedError, match="linear"):
        teng.iterate_streamed(teng.B0.clone(), teng.lte)


def test_unknown_formal_interpolation_is_refused():
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    T = torch.from_numpy(np.asarray(atmos.temperature))
    with pytest.raises(ValueError, match="formal_interpolation"):
        RegularEngine(atmos, lyman_alpha_line(5, 3, T),
                      Config(nlam_bb=5, nlam_bf=3,
                             formal_interpolation="cubic"))
