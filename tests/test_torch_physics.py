"""voronoirt_tpu_torch physics against the JAX package, float64.

One parametrised case per ported function: the same numpy inputs, made
from a seed, go through the JAX function (CPU, x64) and its port, to
rtol 1e-12 (the populations of test_stateq against exact arithmetic
instead, where the JAX package's subtractions round).  Plus the
continuum-recipe golden and the Ly-alpha line.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voronoirt_tpu.physics import atom as j_atom
from voronoirt_tpu.physics import broadening as j_broad
from voronoirt_tpu.physics import collisions as j_coll
from voronoirt_tpu.physics import lte as j_lte
from voronoirt_tpu.physics import opacity as j_op
from voronoirt_tpu.physics import planck as j_planck
from voronoirt_tpu.physics import rates as j_rates
from voronoirt_tpu.physics import stateq as j_stateq
from voronoirt_tpu.physics import voigt as j_voigt
from voronoirt_tpu_torch.physics import atom as t_atom
from voronoirt_tpu_torch.physics import broadening as t_broad
from voronoirt_tpu_torch.physics import collisions as t_coll
from voronoirt_tpu_torch.physics import lte as t_lte
from voronoirt_tpu_torch.physics import opacity as t_op
from voronoirt_tpu_torch.physics import planck as t_planck
from voronoirt_tpu_torch.physics import rates as t_rates
from voronoirt_tpu_torch.physics import stateq as t_stateq
from voronoirt_tpu_torch.physics import voigt as t_voigt

RTOL = 1e-12
# Johnson's ionisation bracket takes xi(y) - xi(z), xi = E0 - 2 E1 + E2
# ~ exp(-t)/t * O(1/t^2): at t ~ 30 it cancels three to four digits, and
# XLA's CPU exp differs from PyTorch's by one ulp in ~15% of arguments,
# so the two packages agree there to ~6e-12, not 1e-12
RTOL_COLL_ION = 1e-10
N = 96


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        T=rng.uniform(3000.0, 15000.0, N),
        ne=10.0 ** rng.uniform(15.0, 20.0, N),
        nH=10.0 ** rng.uniform(17.0, 23.0, N),
        n_h1=10.0 ** rng.uniform(16.0, 23.0, N),
        n_p=10.0 ** rng.uniform(14.0, 20.0, N),
        lam=10.0 ** rng.uniform(-7.7, -5.0, N),
        v=rng.uniform(-8e3, 8e3, (N, 3)))


def _close(got, want, rtol=RTOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol)
        return
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0)


def _lines(nlam_bb=9, nlam_bf=4):
    T = _inputs()["T"]
    return (j_atom.lyman_alpha_line(nlam_bb, nlam_bf, jnp.asarray(T)),
            t_atom.lyman_alpha_line(nlam_bb, nlam_bf, torch.from_numpy(T)))


def _lte_pair():
    d = _inputs()
    jl, tl = _lines()
    pj = j_lte.lte_populations(jl, *(jnp.asarray(d[k])
                                     for k in ("T", "ne", "nH")))
    pt = t_lte.lte_populations(tl, *(torch.from_numpy(d[k])
                                     for k in ("T", "ne", "nH")))
    return d, jl, tl, pj, pt


# Each case: (JAX callable, port callable, argument names from _inputs);
# the callables take the named arrays (jnp or torch) positionally.
def _pointwise_cases():
    lam0 = 121.567e-9
    return {
        "planck_B_lambda": (j_planck.B_lambda, t_planck.B_lambda,
                            ("lam", "T")),
        "planck_B_nu": (lambda lam, T: j_planck.B_nu(2.99792458e8 / lam, T),
                        lambda lam, T: t_planck.B_nu(2.99792458e8 / lam, T),
                        ("lam", "T")),
        "voigt_H": (lambda lam, T: j_voigt.voigt_H(lam * 1e6, (T - 9e3) / 200),
                    lambda lam, T: t_voigt.voigt_H(lam * 1e6, (T - 9e3) / 200),
                    ("lam", "T")),
        "voigt_profile": (
            lambda lam, T: j_voigt.voigt_profile(lam * 1e5, T / 1e3 - 9.0,
                                                 lam),
            lambda lam, T: t_voigt.voigt_profile(lam * 1e5, T / 1e3 - 9.0,
                                                 lam),
            ("lam", "T")),
        "damping": (lambda T, ne: j_broad.damping(ne * 1e-9, 121e-9, T * 1e-15),
                    lambda T, ne: t_broad.damping(ne * 1e-9, 121e-9, T * 1e-15),
                    ("T", "ne")),
        "expint_E1_E2": (
            lambda T: (j_coll.expint_E1(T / 3000.0 - 0.9),
                       j_coll.expint_E2(T / 3000.0 - 0.9)),
            lambda T: (t_coll.expint_E1(T / 3000.0 - 0.9),
                       t_coll.expint_E2(T / 3000.0 - 0.9)),
            ("T",)),
        "coll_exc_1_2": (lambda ne, T: j_coll.coll_exc_hydrogen_johnson(
                             1, 2, ne, T),
                         lambda ne, T: t_coll.coll_exc_hydrogen_johnson(
                             1, 2, ne, T), ("ne", "T")),
        "coll_ion_1": (lambda ne, T: j_coll.coll_ion_hydrogen_johnson(1, ne, T),
                       lambda ne, T: t_coll.coll_ion_hydrogen_johnson(1, ne, T),
                       ("ne", "T")),
        "coll_ion_2": (lambda ne, T: j_coll.coll_ion_hydrogen_johnson(2, ne, T),
                       lambda ne, T: t_coll.coll_ion_hydrogen_johnson(2, ne, T),
                       ("ne", "T")),
        "opacity_hminus_ff": (j_op.hminus_ff, t_op.hminus_ff,
                              ("lam", "T", "n_h1", "ne")),
        "opacity_hminus_bf": (j_op.hminus_bf, t_op.hminus_bf,
                              ("lam", "T", "n_h1", "ne")),
        "opacity_hydrogenic_ff": (
            lambda lam, T, ne, n_p: j_op.hydrogenic_ff(2.99792458e8 / lam, T,
                                                       ne, n_p),
            lambda lam, T, ne, n_p: t_op.hydrogenic_ff(2.99792458e8 / lam, T,
                                                       ne, n_p),
            ("lam", "T", "ne", "n_p")),
        "opacity_h2plus_ff": (j_op.h2plus_ff, t_op.h2plus_ff,
                              ("lam", "T", "n_h1", "n_p")),
        "opacity_h2plus_bf": (j_op.h2plus_bf, t_op.h2plus_bf,
                              ("lam", "T", "n_h1", "n_p")),
        "opacity_thomson": (j_op.thomson, t_op.thomson, ("ne",)),
        "opacity_rayleigh_h": (j_op.rayleigh_h, t_op.rayleigh_h,
                               ("lam", "n_h1")),
        "opacity_alpha_absorption_lam0": (
            lambda T, ne, n_h1, n_p: j_op.alpha_absorption(lam0, T, ne, n_h1,
                                                           n_p),
            lambda T, ne, n_h1, n_p: t_op.alpha_absorption(lam0, T, ne, n_h1,
                                                           n_p),
            ("T", "ne", "n_h1", "n_p")),
        "opacity_alpha_scattering": (j_op.alpha_scattering,
                                     t_op.alpha_scattering,
                                     ("lam", "ne", "n_h1")),
    }


@pytest.mark.parametrize("case", sorted(_pointwise_cases()))
def test_pointwise(case):
    jfn, tfn, names = _pointwise_cases()[case]
    d = _inputs()
    want = jfn(*(jnp.asarray(d[k]) for k in names))
    got = tfn(*(torch.from_numpy(d[k]) for k in names))
    _close(got, want, RTOL_COLL_ION if case.startswith("coll_ion") else RTOL)


def test_voigt_all_regions():
    """A grid over (a, v) that visits all four Humlicek regions."""
    a = np.concatenate([[0.0, 1e-6], np.logspace(-4, 1.5, 30)])
    v = np.linspace(-40.0, 40.0, 161)
    A, V = np.meshgrid(a, v, indexing="ij")
    _close(t_voigt.voigt_H(torch.from_numpy(A), torch.from_numpy(V)),
           j_voigt.voigt_H(jnp.asarray(A), jnp.asarray(V)))


def test_lyman_alpha_line_equal():
    jl, tl = _lines(51, 20)
    np.testing.assert_array_equal(tl.lam, np.asarray(jl.lam))
    assert tl.lam_idx == jl.lam_idx
    for f in ("Aji", "Bji", "Bij", "lam0", "chi_i", "chi_j", "chi_inf"):
        assert getattr(tl, f) == getattr(jl, f), f
    _close(tl.dlamD, jl.dlamD)


@pytest.mark.parametrize("builder", ["line", "boundfree", "einstein"])
def test_host_builders_equal(builder):
    if builder == "line":
        for n in (1, 2, 4, 9, 51, 100):
            np.testing.assert_array_equal(
                t_atom.sample_lambda_line(n, 121.6e-9),
                j_atom.sample_lambda_line(n, 121.6e-9))
    elif builder == "boundfree":
        for n in (1, 4, 20):
            np.testing.assert_array_equal(
                t_atom.sample_lambda_boundfree(n, 22.8e-9, 0.0, 2.18e-18),
                j_atom.sample_lambda_boundfree(n, 22.8e-9, 0.0, 2.18e-18))
    else:
        for lam0 in (121.6e-9, 656.3e-9):
            A_t = t_atom.calc_Aji(lam0, 0.25, 0.4162)
            assert A_t == j_atom.calc_Aji(lam0, 0.25, 0.4162)
            assert t_atom.calc_Bji(lam0, A_t) == j_atom.calc_Bji(lam0, A_t)


def test_gamma_constant():
    d = _inputs()
    jl, tl = _lines()
    _close(t_broad.gamma_constant(tl, *(torch.from_numpy(d[k]) for k in
                                        ("T", "n_h1", "ne"))),
           j_broad.gamma_constant(jl, *(jnp.asarray(d[k]) for k in
                                        ("T", "n_h1", "ne"))))


def test_lte_populations():
    _, _, _, pj, pt = _lte_pair()
    _close(pt, pj)


@pytest.mark.parametrize("fn", ["line_of_sight_velocity", "compute_profile",
                                "alpha_line", "destruction"])
def test_atom(fn):
    d, jl, tl, pj, pt = _lte_pair()
    k = np.array([-0.6, 0.48, 0.64])
    vj = j_atom.line_of_sight_velocity(jnp.asarray(d["v"]), -k)
    vt = t_atom.line_of_sight_velocity(torch.from_numpy(d["v"]), -k)
    if fn == "line_of_sight_velocity":
        _close(vt, vj)
        return
    lam = np.asarray(jl.lam)
    damp = np.tile(10.0 ** np.linspace(-4, 0.5, len(lam))[:, None], (1, N))
    prof_j = j_atom.compute_profile(jl, lam, jnp.asarray(damp), vj)
    prof_t = t_atom.compute_profile(tl, lam, torch.from_numpy(damp), vt)
    if fn == "compute_profile":
        _close(prof_t, prof_j)
    elif fn == "alpha_line":
        _close(t_atom.alpha_line(tl, prof_t, pt[..., 1], pt[..., 0]),
               j_atom.alpha_line(jl, prof_j, pj[..., 1], pj[..., 0]))
    else:
        _close(t_atom.destruction(pt, torch.from_numpy(d["ne"]),
                                  torch.from_numpy(d["T"]), tl),
               j_atom.destruction(pj, jnp.asarray(d["ne"]),
                                  jnp.asarray(d["T"]), jl))


def _rates_inputs():
    d, jl, tl, pj, pt = _lte_pair()
    rng = np.random.default_rng(3)
    J = 10.0 ** rng.uniform(-8, -5, (len(jl.lam), N))
    g = np.asarray(j_broad.gamma_constant(jl, jnp.asarray(d["T"]),
                                          pj[..., 0] + pj[..., 1],
                                          jnp.asarray(d["ne"])))
    return d, jl, tl, pj, pt, J, g


@pytest.mark.parametrize("compat", ["reference", "fixed"])
@pytest.mark.parametrize("fn", ["calculate_R", "calculate_R_chunk",
                                "calculate_C", "sigma_ic_rows"])
def test_rates(fn, compat):
    d, jl, tl, pj, pt, J, g = _rates_inputs()
    T_j, T_t = jnp.asarray(d["T"]), torch.from_numpy(d["T"])
    if fn == "calculate_R":
        lam = np.asarray(jl.lam)[:, None]
        damp_j = j_broad.damping(jnp.asarray(g)[None], lam, jl.dlamD[None])
        damp_t = t_broad.damping(torch.from_numpy(g)[None],
                                 torch.from_numpy(lam), tl.dlamD[None])
        _close(t_rates.calculate_R(tl, torch.from_numpy(J), damp_t, pt, T_t,
                                   compat=compat),
               j_rates.calculate_R(jl, jnp.asarray(J), damp_j, pj, T_j,
                                   compat=compat))
    elif fn == "calculate_R_chunk":
        # the middle chunk of three, with its one-row overlap
        r0, stop = 4, 11
        _close(t_rates.calculate_R_chunk(tl, None, torch.from_numpy(J[r0:stop]),
                                         r0, torch.from_numpy(g), pt, T_t,
                                         compat=compat),
               j_rates.calculate_R_chunk(jl, None, jnp.asarray(J[r0:stop]),
                                         r0, jnp.asarray(g), pj, T_j,
                                         compat=compat))
    elif fn == "calculate_C":
        ne_j, ne_t = jnp.asarray(d["ne"]), torch.from_numpy(d["ne"])
        _close(t_rates.calculate_C(ne_t, T_t, pt),
               j_rates.calculate_C(ne_j, T_j, pj), RTOL_COLL_ION)
    else:
        lam_w = np.asarray(jl.lam)[14:17]
        for level in (0, 1):
            _close(t_rates._sigma_ic_rows(level, tl, torch.from_numpy(lam_w),
                                          float(jl.lam[16]), compat),
                   j_rates._sigma_ic_rows(level, jl, lam_w,
                                          float(jl.lam[16]), compat))


def _exact_populations(R, C, nH):
    """The 3-level balance in exact rational arithmetic on the given
    float64 rates: Cramer's rule on the JAX package's 2x2 system for
    (n2, n3) and n1 = n_H - n2 - n3, with P = R + C, rounded once to
    float64.  Returns (n, 3)."""
    F = lambda a: [Fraction(float(x)) for x in np.asarray(a)]
    P = {k: [r + c for r, c in zip(F(R[k]), F(C[k]))] for k in R}
    out = []
    for i, n in enumerate(F(nH)):
        p = {k: v[i] for k, v in P.items()}
        a00 = p[(0, 1)] + p[(1, 0)] + p[(1, 2)]
        a01 = p[(0, 1)] - p[(2, 1)]
        a10 = p[(0, 2)] - p[(1, 2)]
        a11 = p[(0, 2)] + p[(2, 0)] + p[(2, 1)]
        det = a00 * a11 - a01 * a10
        n2 = n * (a11 * p[(0, 1)] - a01 * p[(0, 2)]) / det
        n3 = n * (a00 * p[(0, 2)] - a10 * p[(0, 1)]) / det
        out.append([float(n - n2 - n3), float(n2), float(n3)])
    return np.array(out)


def test_stateq():
    """The port closes the balance without the JAX package's
    subtractions (physics/stateq.py): n1 = n_H - n2 - n3 and the Cramer
    numerators cancel where a level is small, so JAX's float64 n1 is
    off by up to 4e-10 relative and its n2 by up to 6e-12 on these
    inputs.  Each level is held against an exact evaluation of the same
    rates to 1e-14 relative (4.4e-16 measured), and against JAX's at
    JAX's own rounding, 8 eps n_H (2.1 eps n_H measured)."""
    d, jl, tl, pj, pt, J, g = _rates_inputs()
    lam = np.asarray(jl.lam)[:, None]
    damp = np.asarray(j_broad.damping(jnp.asarray(g)[None], lam,
                                      jl.dlamD[None]))
    T_j, T_t = jnp.asarray(d["T"]), torch.from_numpy(d["T"])
    R = j_rates.calculate_R(jl, jnp.asarray(J), jnp.asarray(damp), pj, T_j)
    C = j_rates.calculate_C(jnp.asarray(d["ne"]), T_j, pj)
    as_t = lambda dct: {k: torch.from_numpy(np.array(v))
                        for k, v in dct.items()}
    got = t_stateq.get_revised_populations(
        as_t(R), as_t(C), torch.from_numpy(d["nH"])).numpy()
    want = np.asarray(j_stateq.get_revised_populations(
        R, C, jnp.asarray(d["nH"])))
    exact = _exact_populations(R, C, d["nH"])
    assert np.all(exact > 0.0)
    np.testing.assert_allclose(got, exact, rtol=1e-14, atol=0)
    eps = np.finfo(np.float64).eps
    assert np.all(np.abs(got - want) <= 8 * eps * d["nH"][:, None])


def test_alpha_cont_golden():
    """The continuum recipes against the recipe golden, at the golden's
    own tolerance (tests/test_physics.py::test_alpha_cont_golden)."""
    fx = np.load("tests/golden/alpha_cont_golden.npz")
    T, n_e = torch.from_numpy(fx["T"]), torch.from_numpy(fx["n_e"])
    n_h1, n_p = torch.from_numpy(fx["n_h1"]), torch.from_numpy(fx["n_p"])
    for i, lam in enumerate(fx["lambdas"]):
        np.testing.assert_allclose(
            t_op.alpha_absorption(float(lam), T, n_e, n_h1, n_p).numpy(),
            fx[f"alpha_abs_{i}"], rtol=1e-10)
        np.testing.assert_allclose(
            t_op.alpha_scattering(float(lam), n_e, n_h1).numpy(),
            fx[f"alpha_sca_{i}"], rtol=1e-10)
