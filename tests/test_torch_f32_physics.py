"""float32 physics of voronoirt_tpu_torch against its float64 physics.

The twin of tests/test_f32_physics.py's physics gates, with its bars and
parameter grid: Planck (B_lambda, B_nu) to 2e-4, the continuum opacity
to 5e-3 (absorption) and 1e-4 (scattering), the LTE populations to 5e-3
per level where the float64 value is representable in float32.  The
float64 side is also held to the JAX package's float64 functions.

The 3-level statistical equilibrium in float32 over the same grid: the
port closes it without subtraction (physics/stateq.py), so each level
keeps float32's few-ulp accuracy where the JAX package's n1 = n_H - n2
- n3 and its Cramer numerators cancel (ROADMAP C4).  Both NLTE engines
run float32 end to end (tests/test_torch_f32_engine.py holds them to
the JAX package's float64 engines); a transport_dtype unequal to dtype
is refused.
"""

import warnings

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.physics.broadening import damping, gamma_constant
from voronoirt_tpu_torch.physics.lte import lte_populations
from voronoirt_tpu_torch.physics.opacity import (alpha_absorption,
                                                 alpha_scattering)
from voronoirt_tpu_torch.physics.planck import B_lambda, B_nu
from voronoirt_tpu_torch.physics.rates import calculate_C, calculate_R
from voronoirt_tpu_torch.physics.stateq import get_revised_populations


def _param_grid():
    T = np.geomspace(2500.0, 5e4, 7)
    n_e = np.geomspace(1e14, 1e23, 7)
    TT, NN = np.meshgrid(T, n_e, indexing="ij")
    return TT.ravel(), NN.ravel()


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype)


def _close(a32, a64, rtol, name):
    a32 = a32.to(torch.float64).numpy()
    a64 = a64.numpy()
    assert np.all(np.isfinite(a32)), f"{name}: non-finite float32 values"
    scale = np.max(np.abs(a64))
    np.testing.assert_allclose(a32, a64, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def test_planck_f32_matches_f64():
    from voronoirt_tpu.physics import planck as jplanck
    T, _ = _param_grid()
    lam = np.geomspace(22.8e-9, 364.7e-9, 11)
    L, TT = np.meshgrid(lam, T, indexing="ij")
    b64 = B_lambda(_t(L), _t(TT))
    b32 = B_lambda(_t(L, torch.float32), _t(TT, torch.float32))
    assert b32.dtype == torch.float32
    _close(b32, b64, 2e-4, "B_lambda")
    np.testing.assert_allclose(b64.numpy(), np.asarray(
        jplanck.B_lambda(L, TT)), rtol=1e-12, atol=0)
    nu = 3e8 / L
    n64 = B_nu(_t(nu), _t(TT))
    n32 = B_nu(_t(nu, torch.float32), _t(TT, torch.float32))
    _close(n32, n64, 2e-4, "B_nu")
    np.testing.assert_allclose(n64.numpy(), np.asarray(
        jplanck.B_nu(nu, TT)), rtol=1e-12, atol=0)


@pytest.mark.parametrize("lam", [22.8e-9, 121.568e-9, 364.7e-9, 500e-9])
def test_opacity_f32_matches_f64(lam):
    from voronoirt_tpu.physics import opacity as jopacity
    T, n_e = _param_grid()
    n_h1 = n_e * 10.0          # representative neutral/proton mix
    n_p = n_e * 0.1
    host = (np.float64(lam), T, n_e, n_h1, n_p)
    args64 = tuple(_t(a) for a in host)
    args32 = tuple(_t(a, torch.float32) for a in host)
    _close(alpha_absorption(*args32), alpha_absorption(*args64), 5e-3,
           f"alpha_absorption@{lam}")
    _close(alpha_scattering(args32[0], args32[2], args32[3]),
           alpha_scattering(args64[0], args64[2], args64[3]), 1e-4,
           f"alpha_scattering@{lam}")
    np.testing.assert_allclose(
        alpha_absorption(*args64).numpy(),
        np.asarray(jopacity.alpha_absorption(*host)), rtol=1e-10, atol=0)


def test_lte_f32():
    from voronoirt_tpu.physics import lyman_alpha_line as jax_line
    from voronoirt_tpu.physics.lte import lte_populations as jax_lte
    T, n_e = _param_grid()
    n_H = n_e * 3.0
    line = lyman_alpha_line(5, 3, _t(T))
    p64 = lte_populations(line, _t(T), _t(n_e), _t(n_H))
    line32 = lyman_alpha_line(5, 3, _t(T, torch.float32))
    p32 = lte_populations(line32, _t(T, torch.float32),
                          _t(n_e, torch.float32), _t(n_H, torch.float32))
    assert p32.dtype == torch.float32
    # per-level relative agreement where the f64 population is
    # representable in float32 at all (level fractions span e^-large)
    p32 = p32.to(torch.float64).numpy()
    p64 = p64.numpy()
    mask = p64 > 1e-30 * p64.max()
    rel = np.abs(p32 - p64)[mask] / p64[mask]
    assert np.all(np.isfinite(p32))
    assert rel.max() < 5e-3
    want = np.asarray(jax_lte(jax_line(5, 3, T), T, n_e, n_H))
    np.testing.assert_allclose(p64, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("dilution", [1.0, 1e-3])
def test_stateq_f32(dilution):
    """The float32 population solve against the float64 one on the same
    rates (made in float64 from the production grid's LTE populations
    and a radiation field of `dilution` x B_lambda, then rounded to
    float32): every level to 2e-6 relative (2.5e-7 measured) and the
    sum to n_H to 1e-6.  The JAX package's subtraction forms miss this
    by orders on the same inputs: in float32 their n1 is off by up to
    43x (dilution 1) and 1.6x (1e-3), and their n2 by more than 1e-3 in
    12 of the 49 cells, hot and thin ones where n2 is 3e-14 to 3e-8 of
    n_H, and 0 in 6 of those."""
    T, n_e = _param_grid()
    n_H = n_e * 3.0
    line = lyman_alpha_line(51, 20, _t(T))
    lte = lte_populations(line, _t(T), _t(n_e), _t(n_H))
    lam = line.lam_tensor()[:, None]
    J = dilution * B_lambda(lam, _t(T)[None])
    g = gamma_constant(line, _t(T), lte[..., 0] + lte[..., 1], _t(n_e),
                       4.702e8)
    R = calculate_R(line, J, damping(g[None], lam, line.dlamD[None]), lte,
                    _t(T))
    C = calculate_C(_t(n_e), _t(T), lte)
    p64 = get_revised_populations(R, C, _t(n_H))
    to32 = lambda d: {k: v.to(torch.float32) for k, v in d.items()}
    p32 = get_revised_populations(to32(R), to32(C), _t(n_H, torch.float32))
    assert p32.dtype == torch.float32
    p32, p64 = p32.to(torch.float64).numpy(), p64.numpy()
    assert np.all(p64 > 0.0) and np.all(np.isfinite(p32))
    np.testing.assert_allclose(p32, p64, rtol=2e-6, atol=0)
    np.testing.assert_allclose(p32.sum(-1), n_H, rtol=1e-6, atol=0)


def test_nlte_engines_accept_float32():
    """Config(dtype='float32') runs both NLTE engines, whose S and
    populations come back float32 (tests/test_torch_f32_engine.py holds
    the values)."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3", dtype="float32",
                 maxiter=1)
    line = lyman_alpha_line(5, 3, _t(atmos.temperature, torch.float32))
    res = RegularEngine(atmos, line, cfg, device="cpu").run()
    assert res.S.dtype == res.populations.dtype == torch.float32
    from voronoirt_tpu_torch import grid
    pos = grid.sample_sites(atmos, 96, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    line = lyman_alpha_line(5, 3, _t(sites.temperature, torch.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        res = VoronoiEngine(sites, line, cfg, device="cpu").run()
    assert res.S.dtype == res.populations.dtype == torch.float32
    assert res.J.dtype == torch.float32


@pytest.mark.parametrize("dtype,transport", [("float32", "float64"),
                                             ("float64", "float32")])
def test_engines_refuse_a_second_transport_dtype(dtype, transport):
    """A transport_dtype unequal to dtype is refused: the JAX package
    declares the field and never reads it."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3", dtype=dtype,
                 transport_dtype=transport)
    line = lyman_alpha_line(5, 3, _t(atmos.temperature))
    with pytest.raises(NotImplementedError, match="never reads it"):
        RegularEngine(atmos, line, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="never reads it"):
        VoronoiEngine(None, line, cfg, plans=[], device="cpu")
