"""voronoirt_tpu_torch angle distribution (parallel/angles.py) and the
slabbed rates against the port's serial path and the JAX engines.
float64 on the CPU, where every slot of the device list is the one CPU
device."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import voronoirt_tpu as jpkg
from voronoirt_tpu import parallel as j_parallel
from voronoirt_tpu.engine import (RegularEngine as JRegularEngine,
                                  VoronoiEngine as JVoronoiEngine)
from voronoirt_tpu.physics import lyman_alpha_line as j_line
from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.engine.lambda_iter import (
    _rates_and_populations, _rates_and_populations_slabbed, _update_S)
from voronoirt_tpu_torch.parallel import angles, distribute_angles
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.physics.rates import calculate_R
from voronoirt_tpu_torch.physics.stateq import get_revised_populations

CPU3 = ["cpu"] * 3


def _regular(atmos, **kw):
    T = torch.from_numpy(np.asarray(atmos.temperature))
    return RegularEngine(atmos, lyman_alpha_line(5, 3, T),
                         Config(nlam_bb=5, nlam_bf=3, **kw))


def _j_regular(atmos, **kw):
    T = jnp.asarray(atmos.temperature)
    return JRegularEngine(atmos, j_line(5, 3, T),
                          jpkg.Config(nlam_bb=5, nlam_bf=3, **kw))


@pytest.fixture(scope="module")
def sites():
    atmos = synthetic_atmosphere(nz=8, nx=6, ny=6, seed=13)
    pos = grid.sample_sites(atmos, 500, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))


def _one_iteration(eng):
    damping_lam = eng.damping_lam(eng.lte)
    J = eng.compute_J(eng.B0, eng.lte, damping_lam)
    S = _update_S(eng.line, eng.eps, J, eng.B0)
    P = _rates_and_populations(eng.line, J, eng._gamma_cell(eng.lte),
                               eng.lte, eng.C, eng.T, eng.nH,
                               eng.cfg.compat)
    return J.numpy(), S.numpy(), P.numpy()


@pytest.mark.parametrize("interp", ["linear", "bezier"])
def test_regular_distribution_matches_serial(interp):
    """Angles dealt over three slots give the serial J up to the order
    of the sum (rtol 1e-12, the bar of tests/test_parallel.py); the
    serial linear path is the grouped one, so that case also crosses the
    z-flip canonicalisation (ROADMAP C3, ~1e-12)."""
    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    kw = dict(quadrature="ul2n3", formal_interpolation=interp)
    J0, S0, P0 = _one_iteration(_regular(atmos, **kw))
    eng = distribute_angles(_regular(atmos, **kw), CPU3)
    assert eng.angle_devices == (torch.device("cpu"),) * 3
    assert [angles.angle_device(eng, i) for i in range(4)] == [0, 1, 2, 0]
    J1, S1, P1 = _one_iteration(eng)
    np.testing.assert_allclose(J1, J0, rtol=1e-12, atol=0)
    np.testing.assert_allclose(S1, S0, rtol=1e-12, atol=0)
    np.testing.assert_allclose(P1, P0, rtol=1e-10, atol=0)


def test_regular_distribution_matches_jax():
    """The port's distributed compute_J (damping=None, so the cube is
    materialised for the broadcast) against the JAX engine's over three
    of its CPU devices, rtol 5e-10: measured 5.2e-11 in 14 of 5632
    values, the linear weights' cancellation just above their 5e-4
    guard under one-ulp exp differences between XLA and PyTorch (the
    bar tests/test_torch_voronoi_engine.py holds compute_J to)."""
    atmos = synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)
    jeng = j_parallel.distribute_angles(
        _j_regular(atmos, quadrature="ul2n3", lambda_chunk=4),
        jax.devices()[:3])
    want = np.asarray(jeng.compute_J(jeng.B0, jeng.lte))
    eng = distribute_angles(
        _regular(atmos, quadrature="ul2n3", lambda_chunk=4), CPU3)
    got = eng.compute_J(eng.B0, eng.lte).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-10, atol=0)


def test_slots_not_devices_key_the_partials():
    """A device list naming one device three times keeps three partial
    sums, and .to() onto a tensor's own device copies nothing."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    eng = distribute_angles(_regular(atmos, quadrature="ul2n3"), CPU3)
    assert len(eng._angle_static) == 3
    assert all(st["v"] is eng.v and st["a_cont"] is eng.a_cont
               for st in eng._angle_static)
    x = torch.ones(3)
    state = angles.broadcast_state(eng.angle_devices, S=x, damping=None)
    assert len(state) == 3 and all(s["S"] is x and s["damping"] is None
                                   for s in state)
    partials = {}
    for slot in (0, 1, 2, 0):
        angles.partial_accumulate(partials, slot, torch.full((2,), 1.0 + slot))
    assert sorted(partials) == [0, 1, 2]
    total = angles.reduce_partials(partials, angles.target_device(x))
    assert total.tolist() == [7.0, 7.0]
    with pytest.raises(ValueError):
        distribute_angles(eng, [])


def test_streamed_loop_refuses_distribution():
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    eng = distribute_angles(
        _regular(atmos, quadrature="ul2n3", stream_rates=True), CPU3)
    with pytest.raises(ValueError, match="angle distribution"):
        eng.run()


def test_voronoi_distribution_matches_serial_and_jax(sites):
    """Voronoi compute_J, chunked and distributed together (as
    tests/test_parallel.py composes them): against the port's serial
    path at rtol 1e-12, and against the JAX engine distributed over
    three of its CPU devices at 5e-10, the bar
    tests/test_torch_voronoi_engine.py holds compute_J to (the linear
    weights cancel above their 5e-4 guard)."""
    kw = dict(nlam_bb=5, nlam_bf=3, quadrature="n2", lambda_chunk=4)
    T = np.asarray(sites.temperature)

    def port():
        return VoronoiEngine(sites, lyman_alpha_line(5, 3,
                                                     torch.from_numpy(T)),
                             Config(**kw))

    serial = port()
    J0 = serial.compute_J(serial.B0, serial.lte,
                          serial.damping_lam(serial.lte)).numpy()
    eng = distribute_angles(port(), CPU3)
    assert all(st["T"] is eng.T for st in eng._angle_static)
    J1 = eng.compute_J(eng.B0, eng.lte, eng.damping_lam(eng.lte)).numpy()
    np.testing.assert_allclose(J1, J0, rtol=1e-12, atol=0)
    # damping_lam=None materialises the cube for the broadcast
    J2 = eng.compute_J(eng.B0, eng.lte).numpy()
    np.testing.assert_allclose(J2, J0, rtol=1e-12, atol=0)

    jeng = JVoronoiEngine(sites, j_line(5, 3, jnp.asarray(T)),
                          jpkg.Config(**kw), plans=serial.plans)
    j_parallel.distribute_angles(jeng, jax.devices()[:3])
    want = np.asarray(jeng.compute_J(jeng.B0, jeng.lte))
    np.testing.assert_allclose(J1, want, rtol=5e-10, atol=0)


# ------------------------------------------------------- slabbed rates

def _slab_inputs(eng):
    rng = np.random.default_rng(11)
    J = eng.B0 * torch.from_numpy(rng.uniform(0.5, 1.5, tuple(eng.B0.shape)))
    return J, eng._gamma_cell(eng.lte)


@pytest.mark.parametrize("chunk", [1, 3, 8, 100])
def test_slabbed_populations_match_unslabbed(chunk):
    """Slabs of z-planes against the whole-array rates (calculate_R
    from the damping cube).  Pointwise in space, but eager slices may
    round a vectorised exp's tail differently: held to rtol 1e-13."""
    atmos = synthetic_atmosphere(nz=8, nx=5, ny=5, seed=2)
    eng = _regular(atmos, quadrature="n2")
    J, g_cell = _slab_inputs(eng)
    want = get_revised_populations(
        calculate_R(eng.line, J, eng.damping_lam(eng.lte), eng.lte, eng.T,
                    compat="reference"), eng.C, eng.nH)
    got = _rates_and_populations_slabbed(eng.line, J, g_cell, eng.lte, eng.C,
                                         eng.T, eng.nH, "reference", chunk)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=0)


def test_slabbed_populations_match_jax(sites):
    """The slabbed update on Voronoi sites against the JAX package's
    _rates_and_populations_slabbed from the same J, gamma and frozen
    state: rtol 1e-9 (the rates cancel digits; the unslabbed bar of
    tests/test_torch_physics.py)."""
    from voronoirt_tpu.engine import lambda_iter as jli
    T = np.asarray(sites.temperature)
    kw = dict(nlam_bb=5, nlam_bf=3, quadrature="n2")
    eng = VoronoiEngine(sites, lyman_alpha_line(5, 3, torch.from_numpy(T)),
                        Config(**kw))
    jeng = JVoronoiEngine(sites, j_line(5, 3, jnp.asarray(T)),
                          jpkg.Config(**kw), plans=eng.plans)
    J, g_cell = _slab_inputs(eng)
    got = _rates_and_populations_slabbed(eng.line, J, g_cell, eng.lte, eng.C,
                                         eng.T, eng.nH, "reference", 128)
    want = jli._rates_and_populations_slabbed(
        jeng.line, jnp.asarray(J.numpy()), jnp.asarray(g_cell.numpy()),
        jeng.lte, jeng.C, jeng.T, jeng.nH, "reference", 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=0)


def test_slabbed_run_matches_jax():
    """run() with cfg.rates_site_chunk (damping per chunk inside
    compute_J, rates in slabs of z-planes) against the JAX engine's and
    against the port's unslabbed run."""
    atmos = synthetic_atmosphere(nz=8, nx=5, ny=5, seed=2)
    kw = dict(quadrature="n2", maxiter=2, eps=1e-9, lambda_chunk=4)
    want = _j_regular(atmos, rates_site_chunk=3, **kw).run()
    got = _regular(atmos, rates_site_chunk=3, **kw).run()
    plain = _regular(atmos, **kw).run()
    assert got.iterations == want.iterations == 2
    np.testing.assert_allclose(got.S.numpy(), want.S, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got.populations.numpy(), want.populations,
                               rtol=1e-8, atol=0)
    np.testing.assert_allclose(got.S.numpy(), plain.S.numpy(), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(got.populations.numpy(),
                               plain.populations.numpy(), rtol=1e-12, atol=0)
