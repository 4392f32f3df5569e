"""float32 physics of voronoirt_tpu_torch against its float64 physics.

The twin of tests/test_f32_physics.py's physics gates, with its bars and
parameter grid: Planck (B_lambda, B_nu) to 2e-4, the continuum opacity
to 5e-3 (absorption) and 1e-4 (scattering), the LTE populations to 5e-3
per level where the float64 value is representable in float32.  The
float64 side is also held to the JAX package's float64 functions.

The NLTE engines refuse float32 (engine/lambda_iter.py, ROADMAP C2/C4):
n1 = n_H - n2 - n3 cancels in ionised cells, and there float32 rounding
of n2 + n3 becomes a 7-22 % error in n1 after one iteration and then
line-core J; test_nlte_engines_refuse_float32 holds the refusal.
"""

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.physics.lte import lte_populations
from voronoirt_tpu_torch.physics.opacity import (alpha_absorption,
                                                 alpha_scattering)
from voronoirt_tpu_torch.physics.planck import B_lambda, B_nu


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


def test_nlte_engines_refuse_float32():
    """Config(dtype='float32') is refused by both NLTE engines, and the
    message names the cancelling line."""
    atmos = synthetic_atmosphere(nz=6, nx=4, ny=4, seed=7)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3", dtype="float32")
    line = lyman_alpha_line(5, 3, _t(atmos.temperature, torch.float32))
    with pytest.raises(NotImplementedError, match="n1 = atom_density"):
        RegularEngine(atmos, line, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="stateq.py"):
        VoronoiEngine(None, line, cfg, plans=[], device="cpu")
