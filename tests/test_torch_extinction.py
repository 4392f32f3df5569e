"""The extinction (physics/extinction.py) against the JAX package.

alpha_tot makes a lambda chunk's line-plus-continuum extinction for one
direction in the sweep's layout, and voigt_rows the rates' bound-bound
profile; on the card each is one launch of csrc/extinction.cu, on the
CPU each takes its plain version.  Here the same seeded numpy inputs go
through the JAX package's compiled extinction programs
(engine/lambda_iter.py _alpha_tot_g_t, _alpha_tot_g_T and _alpha_tot
with the damping rows given) and its sigma_ij_bb, and through the
port's wrappers on the CPU, at a regular grid's and a Voronoi grid's
shapes, float64 at rtol 1e-12 (the one-ulp exp difference of ROADMAP
C3 stays far below it) and float32 at rtol 2e-5.  Points on each
Humlicek region boundary, the launch counters, the wrappers' refusals,
doppler_profile (which had no counterpart in the port) and its export
from the physics package are checked too.  The kernels themselves are held against the plain versions on the card, bit
for bit, by the tests marked cuda (and by chip_smoke.py phase 2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voronoirt_tpu import physics as j_physics
from voronoirt_tpu.engine import lambda_iter as jli
from voronoirt_tpu.physics import atom as j_atom
from voronoirt_tpu.physics import rates as j_rates
from voronoirt_tpu.physics import voigt as j_voigt
from voronoirt_tpu_torch import physics as t_physics
from voronoirt_tpu_torch.physics import atom as t_atom
from voronoirt_tpu_torch.physics import extinction as ex
from voronoirt_tpu_torch.physics import rates as t_rates
from voronoirt_tpu_torch.physics import voigt as t_voigt

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=2e-5, atol=0.0)}
# cell shapes: a regular grid's (nz, nx, ny) and a Voronoi grid's (n,)
CELLS = {"regular": (4, 5, 3), "voronoi": (37,)}
# the JAX program of each layout, per-cell gamma and damping rows given
JAX_LAYOUT = {"regular": lambda a: jnp.swapaxes(a, 0, 1),
              "voronoi": lambda a: a.T}
JAX_G = {"regular": jli._alpha_tot_g_t, "voronoi": jli._alpha_tot_g_T}


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **TOL[dtype])


def _case(cells, dtype, seed=3, nlam=(5, 3)):
    """Both packages' Ly-alpha line on one temperature field, and the
    per-cell inputs of one direction (the temperature among them), as
    numpy in `dtype`."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(4e3, 2e4, cells).astype(dtype)
    jline = j_atom.lyman_alpha_line(*nlam, jnp.asarray(T))
    # the Doppler widths shared, so both compute the same v: at a region
    # boundary one ulp of dlamD moves a point into the other region
    lines = (jline, dataclasses.replace(
        t_atom.lyman_alpha_line(*nlam, torch.from_numpy(T)),
        dlamD=_t(np.asarray(jline.dlamD))))
    n_l = 10.0 ** rng.uniform(14, 18, cells)
    pops = np.stack([n_l, n_l * 10.0 ** rng.uniform(-9, -6, cells),
                     10.0 ** rng.uniform(14, 18, cells)], -1)
    fields = dict(
        v_los=rng.uniform(-3e4, 3e4, cells),
        populations=pops,
        a_cont=10.0 ** rng.uniform(-9, -5, cells),
        g_cell=10.0 ** rng.uniform(8, 11, cells), T=T)
    return rng, lines, {k: v.astype(dtype) for k, v in fields.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _counters():
    ex.LAUNCHES = ex.VOIGT_LAUNCHES = 0
    yield
    # the CPU takes the plain versions: no kernel launch is counted
    assert ex.LAUNCHES == 0 and ex.VOIGT_LAUNCHES == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("damping", ["g_cell", "rows"])
@pytest.mark.parametrize("grid", ["regular", "voronoi"])
@pytest.mark.parametrize("rows", [slice(0, 4), slice(4, 5), slice(2, 11)])
def test_alpha_tot_vs_jax(grid, damping, dtype, rows):
    """alpha_tot on the CPU (the plain version, and the wrapper that
    dispatches to it) against the JAX program of the same layout, over
    chunks of line-core, far-wing and bound-free wavelengths and a
    chunk of one."""
    cells = CELLS[grid]
    _, (jline, tline), f = _case(cells, dtype)
    lam = jline.lam[rows].astype(dtype)
    a_c = f["a_cont"]
    if damping == "g_cell":
        want = JAX_G[grid](jline, jnp.asarray(lam), f["g_cell"], f["v_los"],
                           f["populations"], a_c)
        kw = dict(g_cell=_t(f["g_cell"]))
    else:
        damp = np.asarray(jli._damping_chunk(jline, f["g_cell"], lam))
        want = JAX_LAYOUT[grid](jli._alpha_tot(
            jline, jnp.asarray(lam), damp, f["v_los"], f["populations"],
            a_c))
        kw = dict(damp=_t(damp))
    args = (tline, _t(lam), _t(f["v_los"]), _t(f["populations"]), _t(a_c))
    assert want.shape == ex.out_shape(cells, lam.shape[0])
    _close(ex.alpha_tot_plain(*args, **kw), want, dtype)
    got = ex.alpha_tot(*args, **kw)
    assert got.dtype == args[1].dtype and got.is_contiguous()
    _close(got, want, dtype)
    # without the continuum: the line's alone
    line_only = ex.alpha_tot(*args[:4], **kw)
    _close(line_only + _t(a_c).unsqueeze(1), want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cells", [(4, 5, 3), (37,), (2, 3)])
def test_voigt_rows_vs_jax(cells, dtype):
    """sigma_ij_bb's profile (voigt_rows) against the JAX package's
    sigma_ij_bb over the whole bound-bound window."""
    _, (jline, tline), f = _case(cells, dtype, nlam=(11, 3))
    i0, i1 = jline.lam_idx[:2]
    lam = jline.lam[i0:i1].astype(dtype)
    damp = np.asarray(jli._damping_chunk(jline, f["g_cell"], lam))
    want = j_rates.sigma_ij_bb(jline, lam, damp)
    _close(t_rates.sigma_ij_bb(tline, lam, _t(damp)), want, dtype)
    const = j_atom.hc / (4.0 * np.pi * jline.lam0) * jline.Bij
    _close(ex.voigt_rows_plain(tline, _t(lam), _t(damp)) * const, want,
           dtype)


def _boundary_damping(v, dtype, ulps=3):
    """Damping rows that put s = |v| + a on each region boundary (15 and
    5.5) and a on the line a = 0.195 |v| - 0.176, each nudged by -ulps
    .. ulps units in the last place, one row a target and nudge; a
    target below 0 is taken as its absolute value."""
    av = np.abs(v)
    rows = []
    for a in (dtype(15.0) - av, dtype(5.5) - av,
              dtype(0.195) * av - dtype(0.176)):
        a = np.abs(a)
        for k in range(-ulps, ulps + 1):
            b = a
            for _ in range(abs(k)):
                b = np.nextafter(b, dtype(np.inf if k > 0 else 0.0))
            rows.append(b)
    return np.stack(rows).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_region_boundaries_vs_jax(dtype):
    """Points within a few ulps of each Humlicek region boundary, where
    the selected region flips, one wavelength at a time: the port's
    voigt_rows against the JAX package's sigma_ij_bb, and alpha_tot
    (damping rows given, no line-of-sight velocity) against the JAX
    package's voigt_profile and alpha_line, evaluated op by op at the
    same v.  (XLA's fusion of _alpha_tot rounds some of these points an
    ulp apart, which moves them across a boundary; the kernel is held at
    them against the port's plain version, bit for bit, on the card.)"""
    _, (jline, tline), f = _case((64,), dtype)
    f["v_los"] = np.zeros_like(f["v_los"])
    dD = np.asarray(jline.dlamD)
    pops = f["populations"]
    const = j_atom.hc / (4.0 * np.pi * jline.lam0) * jline.Bij
    for off in (1.0, 4.0, 9.0, 14.0):
        lam = np.full(1, jline.lam0 + off * float(np.median(dD)),
                      dtype=dtype)
        # v as both packages compute it: (lam - lam0) / dlamD
        v = ((lam[0] - dtype(jline.lam0)) / dD).astype(dtype)
        for d in _boundary_damping(v, dtype)[:, None, :]:
            _close(ex.voigt_rows(tline, _t(lam), _t(d)) * const,
                   j_rates.sigma_ij_bb(jline, lam, d), dtype)
            phi = j_voigt.voigt_profile(d, v[None], dD[None])
            want = (j_atom.alpha_line(jline, phi, pops[..., 1],
                                      pops[..., 0]) + f["a_cont"]).T
            _close(ex.alpha_tot(tline, _t(lam), _t(f["v_los"]), _t(pops),
                                _t(f["a_cont"]), damp=_t(d)), want, dtype)


def _ok_args():
    _, (_, tline), f = _case((3, 4, 2), np.float64)
    lam = _t(tline.lam[:3])
    return tline, lam, _t(f["v_los"]), _t(f["populations"]), \
        _t(f["a_cont"]), _t(f["g_cell"])


def _bad_alpha_tot(case):
    line, lam, v, pops, a_c, g = _ok_args()
    damp = torch.ones((3,) + tuple(v.shape), dtype=v.dtype)
    return {
        "both damping": lambda: ex.alpha_tot(line, lam, v, pops, a_c,
                                             g_cell=g, damp=damp),
        "no damping": lambda: ex.alpha_tot(line, lam, v, pops, a_c),
        "lam 2-d": lambda: ex.alpha_tot(line, lam[None], v, pops, a_c,
                                        g_cell=g),
        "populations of another grid": lambda: ex.alpha_tot(
            line, lam, v, pops[:2], a_c, g_cell=g),
        "one level": lambda: ex.alpha_tot(line, lam, v, pops[..., :1], a_c,
                                          g_cell=g),
        "a_cont of another grid": lambda: ex.alpha_tot(
            line, lam, v, pops, a_c[:, :2], g_cell=g),
        "g_cell of another grid": lambda: ex.alpha_tot(
            line, lam, v, pops, a_c, g_cell=g[:1]),
        "damping rows of another chunk": lambda: ex.alpha_tot(
            line, lam, v, pops, a_c, damp=damp[:2]),
        "dlamD of another grid": lambda: ex.alpha_tot(
            line, lam, v[:2], pops[:2], a_c[:2], g_cell=g[:2]),
        "mixed dtypes": lambda: ex.alpha_tot(line, lam, v.float(), pops,
                                             a_c, g_cell=g),
        "another device": lambda: ex.alpha_tot(
            line, lam.to("meta"), v.to("meta"), pops.to("meta"),
            a_c.to("meta"), g_cell=g.to("meta")),
        "voigt_rows rows of another chunk": lambda: ex.voigt_rows(
            line, lam, damp[:2]),
        "voigt_rows mixed dtypes": lambda: ex.voigt_rows(line, lam.float(),
                                                         damp),
    }[case]


@pytest.mark.parametrize("case", [
    "both damping", "no damping", "lam 2-d", "populations of another grid",
    "one level", "a_cont of another grid", "g_cell of another grid",
    "damping rows of another chunk", "dlamD of another grid",
    "mixed dtypes", "another device", "voigt_rows rows of another chunk",
    "voigt_rows mixed dtypes"])
def test_wrappers_refuse(case):
    """Mismatched shapes, dtypes and devices, and a damping given twice
    or not at all, raise before any kernel or plain version runs."""
    with pytest.raises(ValueError):
        _bad_alpha_tot(case)()


def test_wrappers_refuse_dtype():
    line, lam, v, pops, a_c, g = _ok_args()
    with pytest.raises(TypeError):
        ex.alpha_tot(line, lam.half(), v.half(), pops.half(), a_c.half(),
                     g_cell=g.half())
    with pytest.raises(TypeError):
        ex.voigt_rows(line, lam.half(), torch.ones((3, 3, 4, 2)).half())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_doppler_profile_vs_jax(dtype):
    rng = np.random.default_rng(5)
    dlamD = rng.uniform(1e-12, 1e-11, 64).astype(dtype)
    # out to 8 Doppler widths: exp(-64) is still a normal float32
    dlam = (dlamD * rng.uniform(-8.0, 8.0, 64)).astype(dtype)
    want = j_voigt.doppler_profile(jnp.asarray(dlam), jnp.asarray(dlamD))
    got = t_voigt.doppler_profile(_t(dlam), _t(dlamD))
    assert got.dtype == _t(dlam).dtype
    _close(got, want, dtype)
    assert t_physics.doppler_profile is t_voigt.doppler_profile


def test_physics_exports_doppler_profile():
    """doppler_profile is exported from the physics package, as the JAX
    package exports it."""
    assert callable(j_physics.doppler_profile)
    assert t_physics.doppler_profile is t_voigt.doppler_profile


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cells", [(5, 37, 29), (301,)])
def test_kernels_match_plain_on_card(cuda, dtype, cells):
    """Both kernels against their plain versions on the card, bit for
    bit (the kernels round as PyTorch's CUDA kernels do), with the
    per-cell gamma and with damping rows, with and without the
    continuum, at chunks of 13 wavelengths and of one, and at the
    region boundaries."""
    _, _, f = _case(cells, dtype)
    d = {k: _t(v).to(cuda) for k, v in f.items()}
    line = t_atom.lyman_alpha_line(51, 20, d["T"])
    lam = line.lam_tensor()
    for rows in (slice(20, 33), slice(25, 26), slice(51, 71)):
        lam_r = lam[rows]
        damp = (d["g_cell"][None] * lam_r.reshape(
            (-1,) + (1,) * len(cells)) ** 2 * 1e-12).contiguous()
        for kw in (dict(g_cell=d["g_cell"]), dict(damp=damp)):
            for a_c in (d["a_cont"], None):
                args = (line, lam_r, d["v_los"], d["populations"], a_c)
                got = ex.alpha_tot(*args, **kw)
                want = ex.alpha_tot_plain(*args, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
        assert torch.equal(ex.voigt_rows(line, lam_r, damp),
                           ex.voigt_rows_plain(line, lam_r, damp))
    dD = line.dlamD.cpu().numpy()
    for off in (1.0, 4.0, 9.0, 14.0):
        lam1 = torch.full((1,), line.lam0 + off * float(np.median(dD)),
                          dtype=lam.dtype, device=cuda)
        v = ((lam1.cpu().numpy()[0] - dtype(line.lam0)) / dD).astype(dtype)
        for row in _boundary_damping(v, dtype):
            damp = torch.from_numpy(row[None]).to(cuda)
            assert torch.equal(ex.voigt_rows(line, lam1, damp),
                               ex.voigt_rows_plain(line, lam1, damp))
            zero = torch.zeros_like(d["v_los"])
            args = (line, lam1, zero, d["populations"], d["a_cont"])
            assert torch.equal(ex.alpha_tot(*args, damp=damp),
                               ex.alpha_tot_plain(*args, damp=damp))
    ex.LAUNCHES = ex.VOIGT_LAUNCHES = 0
