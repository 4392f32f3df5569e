"""voronoirt_tpu_torch regular Lambda-iteration engine: the NLTE chain
goldens, the entry() step against the JAX package's, and the streamed
iteration against the full one.  float64 on the CPU."""

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Atmosphere, Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine
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


def _engine(atmos, nlam_bb, nlam_bf, **cfg_kw):
    cfg = Config(nlam_bb=nlam_bb, nlam_bf=nlam_bf, **cfg_kw)
    line = lyman_alpha_line(nlam_bb, nlam_bf,
                            torch.from_numpy(np.asarray(atmos.temperature)))
    return RegularEngine(atmos, line, cfg)


def test_nlte_fixture_three_iterations():
    """The oracle's reg_* chain (tests/test_nlte_parity.py:60-87): J and
    S to 1e-8, populations to 1e-7 after 3 iterations, from the
    fixture's frozen alpha_cont, eps and C loaded with load_state."""
    fx = np.load(FIXTURE)
    atmos = Atmosphere(**{f: fx[f"reg_atmos_{f}"] for f in (
        "z", "x", "y", "temperature", "electron_density",
        "hydrogen_populations", "velocity_z", "velocity_x", "velocity_y")})
    eng = _engine(atmos, 9, 4, maxiter=3, eps=1e-30, quadrature="ul7n12",
                  compat="reference")
    _assert_close(eng.eps, fx["reg_eps"], "eps", 1e-12)
    for key in _C_KEYS:
        # the ionisation rates (to or from level 2) cancel digits in
        # Johnson's xi(y) - xi(z), where one-ulp exp differences between
        # libraries grow to ~6e-12 (see tests/test_torch_physics.py)
        _assert_close(eng.C[(int(key[0]), int(key[1]))], fx[f"reg_C_{key}"],
                      f"C{key}", 1e-10 if "2" in key else 1e-12)
    eng.load_state({"a_cont": fx["reg_alpha_cont"], "eps": fx["reg_eps"],
                    **{f"C_{k}": fx[f"reg_C_{k}"] for k in _C_KEYS}})
    res = eng.run()
    assert res.iterations == 3
    _assert_close(res.J, fx["reg_J_2"], "J", 1e-8)
    _assert_close(res.S, fx["reg_S_2"], "S", 1e-8)
    _assert_close(res.populations, fx["reg_pops_2"], "pops", 1e-7)


def test_entry_step_matches_jax():
    """The port's entry() step against __graft_entry__.entry()'s, from
    the JAX step's own inputs: S to rtol 1e-10, populations to 1e-8."""
    import __graft_entry__
    from voronoirt_tpu_torch.entry import entry

    step_j, args_j = __graft_entry__.entry()
    S_j, P_j = (np.asarray(a) for a in step_j(*args_j))
    step_t, args_t = entry(device="cpu")
    assert [tuple(a.shape) for a in args_t] == [a.shape for a in args_j]
    S_t, P_t = step_t(*(torch.from_numpy(np.asarray(a)) for a in args_j))
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=1e-10, atol=0)
    np.testing.assert_allclose(P_t.numpy(), P_j, rtol=1e-8, atol=0)


def test_entry_defaults_to_the_card(monkeypatch):
    """entry() and small_problem() run on the CUDA card unless given a
    device, and so do the public functions that make tensors from no
    tensor; with no card visible they raise rather than fall back to
    the CPU."""
    from voronoirt_tpu_torch.entry import entry, small_problem
    from voronoirt_tpu_torch.physics.planck import B_lambda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, small_problem,
                 lambda: lyman_alpha_line(5, 3, np.full((2, 2), 6e3)),
                 lambda: B_lambda(1.2e-7, 6e3)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    cfg, atmos, line, eng = small_problem(nz=4, nx=2, ny=2, device="cpu")
    assert eng.device.type == line.dlamD.device.type == "cpu"


def test_load_state_round_trip():
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    eng = _engine(atmos, 5, 3, quadrature="ul2n3")
    rng = np.random.default_rng(1)
    state = {"S": rng.uniform(size=tuple(eng.B0.shape)),
             "populations": rng.uniform(size=tuple(eng.lte.shape)),
             "C_21": rng.uniform(size=tuple(eng.T.shape))}
    eng.load_state(state)
    np.testing.assert_array_equal(eng.S_start.numpy(), state["S"])
    np.testing.assert_array_equal(eng.populations_start.numpy(),
                                  state["populations"])
    np.testing.assert_array_equal(eng.C[(2, 1)].numpy(), state["C_21"])
    with pytest.raises(KeyError):
        eng.load_state({"J": state["S"]})


def test_streamed_run_matches_standard():
    """stream_rates=True reproduces the standard loop (the bar of
    tests/test_rates_stream.py): rates differ only by float addition
    order."""
    atmos = synthetic_atmosphere(nz=12, nx=8, ny=8, seed=7)
    kw = dict(quadrature="ul2n3", maxiter=3, eps=1e-9, lambda_chunk=5)
    res_std = _engine(atmos, 7, 4, stream_rates=False, **kw).run()
    res_str = _engine(atmos, 7, 4, stream_rates=True, **kw).run()
    assert res_str.iterations == res_std.iterations == 3
    np.testing.assert_allclose(res_str.S.numpy(), res_std.S.numpy(),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(res_str.populations.numpy(),
                               res_std.populations.numpy(), rtol=1e-9)
    np.testing.assert_allclose(res_str.convergence[1:],
                               res_std.convergence[1:], rtol=1e-6)


def test_per_angle_J_equals_grouped():
    """group_max_angles=1 leaves every group a singleton, so compute_J
    sweeps each angle alone; it must equal the grouped J.  Not to the
    last bits: grouping z-flips the down sweeps onto the axis
    z[0] + (z[-1] - z[::-1]), whose steps round differently from the
    original dz at the 1e-16 level on this 2 Mm axis."""
    atmos = synthetic_atmosphere(nz=10, nx=6, ny=6, seed=3)
    J = {}
    for cap in (None, 1):
        eng = _engine(atmos, 5, 3, quadrature="ul7n12", lambda_chunk=4,
                      group_max_angles=cap)
        assert any(len(g) > 1 for g in eng.plan_groups) == (cap is None)
        J[cap] = eng.compute_J(eng.B0, eng.lte).numpy()
    np.testing.assert_allclose(J[1], J[None], rtol=1e-11, atol=0)


def test_one_working_dtype():
    """A transport dtype other than the working dtype is refused (the
    float32 linear weights cancel near their 5e-4 guard, ROADMAP C3)."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    with pytest.raises(NotImplementedError):
        _engine(atmos, 5, 3, quadrature="ul2n3", transport_dtype="float32")


def test_linear_formal_solution_only():
    """The grouped sweeps are the linear formal solution only:
    formal_interpolation='bezier' sends compute_J through the per-angle
    sweeps instead, never through the linear ones in its place; with the
    Bezier xy step its J differs from the linear one (held against the
    JAX package in tests/test_torch_bezier.py)."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    eng = _engine(atmos, 5, 3, quadrature="ul2n3",
                  formal_interpolation="bezier")
    calls = []
    grouped = eng._J_chunk_grouped
    eng._J_chunk_grouped = lambda *a, **k: calls.append(1) or grouped(*a, **k)
    J_bez = eng.compute_J(eng.B0, eng.lte)
    assert not calls
    lin = _engine(atmos, 5, 3, quadrature="ul2n3")
    J_lin = lin.compute_J(lin.B0, lin.lte)
    assert J_bez.shape == J_lin.shape and J_bez.is_contiguous()
    assert float((J_bez / J_lin - 1.0).abs().max()) > 1e-4
