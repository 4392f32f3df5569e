"""The streamed iteration's rate accumulation (R1, physics/rates.py
calculate_R_chunk) and S update (S1, engine/s_update.py) against the
JAX package.

On the card each is one launch of csrc/rates.cu a lambda chunk; on the
CPU its plain version.  Here, from seeded numpy inputs at small sizes (a
line of 11 + 2 x 5 wavelengths, whose windows are bound-bound rows 0-10
and bound-free rows 11-15 and 16-20, over 64 cells):

  (a) the engine's _rates_accum chunk after chunk, the previous chunk's
      last J row leading each chunk, against the JAX package's
      _rates_accum, at chunk sizes 1, 3, 5 and 7 (7 straddles both
      bound-free edges, 5 both and the pair across the bb / bf0 edge,
      which no window holds), both compat modes, float64 at rtol 1e-12
      (tests/test_torch_physics.py's RTOL) and float32 at
      _f32_pair_rtol (1.5 % for this line) and ATOL_F32;
  (b) the sum of every chunk against the port's calculate_R, within
      rounding (tests/test_rates_stream.py's 5e-13);
  (c) R1's loop emulated in torch from the wrapper's own row table
      (_r1_rows) against the plain version, chunk after chunk: the
      windows, rows, lead row and pair order R1 reads;
  (d) the S update against the JAX package's _s_update_stream (handed a
      copy of S, which it donates), S and the maximum, float64 at rtol
      1e-12 and float32 at RTOL_F32; a NaN in J gives a NaN maximum;
  (e) dispatch: CPU inputs launch nothing; mismatched dtype, device or
      shape raise;
  (f) marked cuda (skipped without a card): R1 and S1 against their
      plain versions on the card, bit for bit, R1 also at each of
      R1_CASES (a one-pair chunk, a 14-row chunk with its lead, 91 rows,
      odd cell counts whose rows start 8 bytes off 16 in float64, a
      ragged tail tile, three tiles, a slab whose rows lie a stride
      apart; rates added into and new), each case checked on the CPU
      to build what it names;
  (g) the standard loop's rates and statistical equilibrium
      (_rates_and_populations, one R1 launch over all rows from the
      per-cell gamma) against the JAX package's and against the port's
      calculate_R path.

The JAX package is imported inside the tests that use it, so the cuda
tests run where only the port is installed.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch.engine import lambda_iter as t_li
from voronoirt_tpu_torch.engine import s_update as s1
from voronoirt_tpu_torch.physics import rates as t_rates
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.physics.broadening import damping, gamma_constant
from voronoirt_tpu_torch.physics.extinction import voigt_rows_plain
from voronoirt_tpu_torch.physics.lte import lte_populations

RTOL = 1e-12
# float32 S update: the port and the JAX package round B's exp, log and
# expm1 with other libraries (XLA's CPU functions against PyTorch's), a
# few float32 ulps (6e-8) apart
RTOL_F32 = 1e-5
# float32 rates: the JAX package takes the wavelengths in float64 (its
# pair widths, and with them the rates, promote to float64), the port
# rounds them to float32 first, so a pair's width differs by up to two
# ulps of lam over the width (_f32_pair_rtol); and where the Boltzmann
# factor of a cold cell at the bound-free edge underflows float32 (below
# 1e-45) the JAX package keeps it: those rates lie below 1e-6 of the
# rate's largest, the atol
ATOL_F32 = 1e-6
NLAM = (11, 5)
N = 64
CHUNKS = (1, 3, 5, 7)


def _fields(dtype=np.float64, seed=3, n=N, nlam=NLAM):
    """Seeded per-cell fields and J rows: T, n_e, n_H (n,), J (the
    line's rows, n)."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(4000.0, 12000.0, n)
    ne = 10.0 ** rng.uniform(16, 18, n)
    nH = 10.0 ** rng.uniform(18, 20, n)
    J = 10.0 ** rng.uniform(-8, -5, (sum(nlam) + nlam[1], n))
    return tuple(a.astype(dtype) for a in (T, ne, nH, J))


def _torch_side(T, ne, nH, nlam=NLAM):
    T, ne, nH = (torch.from_numpy(a) for a in (T, ne, nH))
    line = lyman_alpha_line(*nlam, T)
    lte = lte_populations(line, T, ne, nH)
    g = gamma_constant(line, T, lte[..., 0] + lte[..., 1], ne)
    return line, lte, g, T


def _jax_side(T, ne, nH):
    import jax.numpy as jnp
    from voronoirt_tpu.physics import lyman_alpha_line as j_line
    from voronoirt_tpu.physics.broadening import gamma_constant as j_gamma
    from voronoirt_tpu.physics.lte import lte_populations as j_lte
    T, ne, nH = (jnp.asarray(a) for a in (T, ne, nH))
    line = j_line(*NLAM, T)
    lte = j_lte(line, T, ne, nH)
    g = j_gamma(line, T, lte[..., 0] + lte[..., 1], ne)
    return line, lte, g, T


def _chunks(n, chunk):
    """(r0, J rows slice) of each chunk of the streamed loop: r0 is the
    carried row's (one before the chunk) after the first chunk."""
    return [(s if s == 0 else s - 1, slice(s, min(s + chunk, n)))
            for s in range(0, n, chunk)]


def _stream_torch(line, lte, g, T, J, chunk, compat, rates=t_li._rates_accum):
    acc = carry = None
    out = []
    for r0, sl in _chunks(J.shape[0], chunk):
        acc = rates(line, acc, carry, J[sl], r0, g, lte, T, compat)
        carry = J[sl][-1:].clone()
        out.append({k: v.clone() for k, v in acc.items()})
    return out


def _close(got, want, rtol, atol=0.0):
    """Each rate within rtol, or atol of its largest magnitude."""
    assert set(got) == set(want)
    for k in want:
        b = np.asarray(want[k], dtype=np.float64)
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64), b,
                                   rtol=rtol, atol=atol * np.abs(b).max(),
                                   err_msg=str(k))


def _f32_pair_rtol(line):
    """Twice the largest float32 ulp of lam over a pair's width."""
    lam = np.asarray(line.lam)
    return 2.0 * float((np.spacing(lam.astype(np.float32))[:-1]
                        / np.abs(np.diff(lam))).max())


# ------------------------------------------------------ (a), (b): R1

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("compat", ["reference", "fixed"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_rates_accum_vs_jax(chunk, compat, dtype):
    """The streamed rates chunk after chunk, with the carried row,
    against the JAX package's _rates_accum."""
    import jax.numpy as jnp
    from voronoirt_tpu.engine.lambda_iter import _rates_accum as j_accum
    T, ne, nH, J = _fields(dtype)
    tl, tlte, tg, tT = _torch_side(T, ne, nH)
    jl, jlte, jg, jT = _jax_side(T, ne, nH)
    n = tl.n_lambda
    got = _stream_torch(tl, tlte, tg, tT, torch.from_numpy(J[:n]), chunk,
                        compat)
    acc = carry = None
    for (r0, sl), want in zip(_chunks(n, chunk), got):
        Jc = jnp.asarray(J[sl])
        acc = j_accum(jl, acc, carry, Jc, r0, jg, jlte, jT, compat)
        carry = Jc[-1:]
        if dtype == np.float64:
            _close(want, acc, RTOL)
        else:
            _close(want, acc, _f32_pair_rtol(tl), ATOL_F32)


@pytest.mark.parametrize("compat", ["reference", "fixed"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunks_sum_to_calculate_R(chunk, compat):
    """Every chunk's rates summed against the port's calculate_R on the
    whole J, within float addition order."""
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    J = torch.from_numpy(J[:line.n_lambda])
    lam = line.lam_tensor().reshape(-1, 1)
    want = t_rates.calculate_R(line, J, damping(g[None], lam,
                                                line.dlamD[None]),
                               lte, T, compat=compat)
    got = _stream_torch(line, lte, g, T, J, chunk, compat)[-1]
    _close(got, want, 5e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("compat", ["reference", "fixed"])
def test_rates_and_populations_vs_jax(compat, dtype):
    """The standard loop's rates and statistical equilibrium (the
    unslabbed Voronoi iteration's and entry()'s): the port's one R1
    launch over all rows from the per-cell gamma against the JAX
    package's _rates_and_populations, calculate_R from the damping
    cube, on the same J and collisional rates.  The rates R1 integrates
    (calculate_R_chunk over every row from row 0) against JAX's
    calculate_R at RTOL float64 (7e-15 measured), at _f32_pair_rtol and
    ATOL_F32 float32.  The populations: float32 at _f32_pair_rtol;
    float64 at rtol 2e-11 (measured: 5.9e-12 'reference', 2.0e-12
    'fixed', on level 0, ~6e-13 n_H; calculate_R's populations from the
    damping cube differ from JAX's alike, and JAX's statistical
    equilibrium on the port's own rates by 7.0e-12: the solve's rounding,
    not the rates')."""
    import jax.numpy as jnp
    from voronoirt_tpu.engine.lambda_iter import \
        _rates_and_populations as j_rates
    from voronoirt_tpu.physics.broadening import damping as j_damping
    from voronoirt_tpu.physics.rates import calculate_R as j_calculate_R
    T, ne, nH, J = _fields(dtype)
    tl, tlte, tg, tT = _torch_side(T, ne, nH)
    jl, jlte, jg, jT = _jax_side(T, ne, nH)
    J = J[:tl.n_lambda]
    C = t_rates.calculate_C(torch.from_numpy(ne), tT, tlte)
    n0 = t_rates.LAUNCHES
    got = t_li._rates_and_populations(tl, torch.from_numpy(J), tg, tlte, C,
                                      tT, torch.from_numpy(nH), compat)
    assert t_rates.LAUNCHES == n0       # the CPU takes the plain version
    lam = jnp.asarray(np.asarray(jl.lam)).reshape(-1, 1)
    damp = j_damping(jg[None], lam, jl.dlamD[None])
    want = j_rates(jl, jnp.asarray(J), damp, jlte,
                   {k: jnp.asarray(v.numpy()) for k, v in C.items()}, jT,
                   jnp.asarray(nH), compat)
    assert got.shape == want.shape and got.dtype == torch.from_numpy(T).dtype
    R = t_rates.calculate_R_chunk(tl, None, torch.from_numpy(J), 0, tg,
                                  tlte, tT, compat)
    R_jax = j_calculate_R(jl, jnp.asarray(J), damp, jlte, jT, compat=compat)
    if dtype == np.float64:
        _close(R, R_jax, RTOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-11, atol=0)
    else:
        _close(R, R_jax, _f32_pair_rtol(tl), ATOL_F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=_f32_pair_rtol(tl), atol=0)


def test_rates_and_populations_equal_calculate_R():
    """The standard loop's rates through R1's plain version against
    calculate_R's from the damping cube (the port's path until R1 took
    it): the same populations within rounding (5e-13, the chunks' bar)."""
    from voronoirt_tpu_torch.physics.stateq import get_revised_populations
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    J = torch.from_numpy(J[:line.n_lambda])
    nH = torch.from_numpy(nH)
    C = t_rates.calculate_C(torch.from_numpy(ne), T, lte)
    lam = line.lam_tensor().reshape(-1, 1)
    R = t_rates.calculate_R(line, J, damping(g[None], lam, line.dlamD[None]),
                            lte, T)
    want = get_revised_populations(R, C, nH)
    got = t_li._rates_and_populations(line, J, g, lte, C, T, nH, "reference")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-13, atol=0)


# ----------------------------------------------- (c): R1's loop emulated

def _r1_emulated(line, acc, J_blk, r0, g_cell, lte, T, compat, lead):
    """R1's per-cell loop (csrc/rates.cu rates_chunk_kernel) over all
    cells at once, in its order of operations, from the wrapper's row
    table; the profile through the plain version's Voigt (E2's)."""
    rows = ([lead[0]] if lead is not None else []) + list(J_blk)
    wins, lam, dlam, sig, planck = t_rates._r1_rows(line, r0, len(rows), T,
                                                    compat)
    out = dict(acc) if acc is not None else {}
    const = t_rates._sigma_bb_const(line)
    for kind, lo, hi in wins:
        i, j = {"bf0": (0, 2), "bf1": (1, 2), "bb": (0, 1)}[kind]
        nr = lte[..., i] / lte[..., j]
        s_ij = s_ji = f_ij = f_ji = None
        for r in range(lo, hi + 1):
            lb = lam[r:r + 1]
            if kind == "bb":
                a = damping(g_cell, lb, line.dlamD)
                s = const * voigt_rows_plain(line, lb, a[None])[0]
            else:
                s = sig[r]
            G = nr * torch.exp((lb * T).reciprocal() * -(t_rates.hc
                                                          / t_rates.k_B))
            e_ij = (lb * s) * (rows[r] * t_rates.IUNIT_SI)
            e_ji = (((s * lb) * t_rates.IUNIT_SI) * G) * (planck[r] + rows[r])
            if r > lo:
                c_ij, c_ji = (f_ij + e_ij) * dlam[r - 1], (f_ji + e_ji) \
                    * dlam[r - 1]
                s_ij = c_ij if r == lo + 1 else s_ij + c_ij
                s_ji = c_ji if r == lo + 1 else s_ji + c_ji
            f_ij, f_ji = e_ij, e_ji
        if compat == "fixed":
            s_ij, s_ji = s_ij * 0.5, s_ji * 0.5
        r_ij = 2.0 * np.pi / t_rates.hc * s_ij
        if compat == "reference":
            r_ij = r_ij / 1000.0
        r_ji = 2.0 * np.pi / t_rates.hc * s_ji
        for key, v in zip(t_rates._RATE_KEYS[kind], (r_ij, r_ji)):
            out[key] = out[key] + v if key in out else v
    return out


@pytest.mark.parametrize("compat", ["reference", "fixed"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_kernel_loop_equals_plain(chunk, compat):
    """R1's loop, emulated from the wrapper's row table, against the
    plain version chunk after chunk, bit for bit: the windows, their
    rows, the lead row and the pairs' order are what the plain version
    integrates."""
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    J = torch.from_numpy(J[:line.n_lambda])

    def emulated(line, acc, carry, Jc, r0, g, lte, T, compat):
        return _r1_emulated(line, acc, Jc, r0, g, lte, T, compat, carry)

    got = _stream_torch(line, lte, g, T, J, chunk, compat, emulated)
    want = _stream_torch(line, lte, g, T, J, chunk, compat)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_window_table():
    """The row table of the chunk [10, 16) with its lead row 9: bb's
    last pair (9, 10), no window for the pair (10, 11) across the
    bb / bf0 edge, bf0's rows 11-15, no bf1 row; the bf sigma on bf0's
    rows only."""
    T, ne, nH, _ = _fields()
    line, _, _, T = _torch_side(T, ne, nH)
    assert line.lam_idx == (0, 11, 16, 21)
    wins, lam, dlam, sig, planck = t_rates._r1_rows(line, 9, 7, T,
                                                    "reference")
    assert wins == [("bf0", 2, 6), ("bb", 0, 1)]
    assert torch.equal(lam, torch.from_numpy(np.asarray(line.lam[9:16])))
    assert torch.equal(dlam, torch.diff(lam))
    assert bool((sig[2:] > 0).all()) and bool((sig[:2] == 0).all())
    assert planck.shape == (7,)
    assert t_rates._r1_rows(line, 10, 2, T, "reference")[0] == []


def test_row_table_made_once_a_line():
    """The row table is made once a line, compat, dtype and device: a
    slab's line (the same line with a slice of dlamD, as the standard
    loop's slabs make) and any block of rows read views of the same
    table; another compat or dtype, or other wavelengths, make their
    own."""
    T, ne, nH, _ = _fields()
    line, _, _, T = _torch_side(T, ne, nH)
    lam = t_rates._r1_rows(line, 0, 21, T, "reference")[1]
    slab = dataclasses.replace(line, dlamD=line.dlamD[:8])
    lam_slab = t_rates._r1_rows(slab, 9, 7, T, "reference")[1]
    assert lam_slab.data_ptr() == lam[9:].data_ptr()
    others = [t_rates._r1_rows(line, 0, 21, T, "fixed")[1],
              t_rates._r1_rows(line, 0, 21, T.float(), "reference")[1],
              t_rates._r1_rows(dataclasses.replace(line, lam=line.lam * 2),
                               0, 21, T, "reference")[1]]
    assert all(t.data_ptr() != lam.data_ptr() for t in others)
    assert torch.equal(others[2], 2 * lam)


# -------------------------------------------------------- (d): S1

def _s_inputs(dtype, seed=5, nb=4, start=3, nz=6):
    rng = np.random.default_rng(seed)
    T = rng.uniform(4000.0, 12000.0, (nz, 5, 4)).astype(dtype)
    eps = 10.0 ** rng.uniform(-6, -1, T.shape).astype(dtype)
    S = 10.0 ** rng.uniform(-9, -4, (start + nb + 2,) + T.shape)
    J = 10.0 ** rng.uniform(-9, -4, (nb,) + T.shape)
    lam = np.linspace(100e-9, 125e-9, nb)
    return S.astype(dtype), J.astype(dtype), eps, T, lam.astype(dtype), start


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_s_update_vs_jax(dtype):
    """The streamed S update against the JAX package's, S and the
    chunk's maximum; rows outside the chunk untouched."""
    import jax.numpy as jnp
    from voronoirt_tpu.engine.lambda_iter import _s_update_stream as j_s
    S, J, eps, T, lam, start = _s_inputs(dtype)
    S_t = torch.from_numpy(S.copy())
    S_t, m_t = t_li._s_update_stream(None, S_t, *(torch.from_numpy(a) for a
                                                  in (J, eps, T, lam)),
                                     start)
    S_j, m_j = j_s(None, jnp.asarray(S.copy()), *(jnp.asarray(a) for a in
                                                  (J, eps, T, lam)), start)
    rtol = RTOL if dtype == np.float64 else RTOL_F32
    assert m_t.dim() == 0 and m_t.dtype == S_t.dtype
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(float(m_t), float(m_j), rtol=rtol)
    rest = np.r_[0:start, start + J.shape[0]:S.shape[0]]
    assert np.array_equal(S_t.numpy()[rest], S[rest])


@pytest.mark.parametrize("where", ["J", "S_old"])
def test_s_update_nan_gives_nan(where):
    """A NaN in J or in S_old makes the chunk's maximum NaN, as
    torch.max and the JAX package's jnp.max do, and the run loop's
    np.isnan test sees it."""
    S, J, eps, T, lam, start = _s_inputs(np.float64)
    if where == "J":
        J[1, 2, 3, 1] = np.nan
    else:
        S[start + 2, 0, 0, 0] = np.nan
    _, m = s1.s_update_stream(*(torch.from_numpy(a) for a in
                                (S, J, eps, T, lam)), start)
    assert np.isnan(float(m))


# -------------------------------------------------- (e): dispatch

def test_cpu_launches_nothing():
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    n0, s0 = t_rates.LAUNCHES, s1.LAUNCHES
    _stream_torch(line, lte, g, T, torch.from_numpy(J[:line.n_lambda]), 5,
                  "reference")
    S, Jc, eps, Tc, lam, start = _s_inputs(np.float64)
    s1.s_update_stream(*(torch.from_numpy(a) for a in (S, Jc, eps, Tc, lam)),
                       start)
    assert (t_rates.LAUNCHES, s1.LAUNCHES) == (n0, s0)


def _rates_case(bad):
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    J = torch.from_numpy(J[:6])
    args = dict(line=line, acc=None, J_blk=J, r0=0, g_cell=g, lte_pops=lte,
                temperature=T, compat="reference", lead=None)
    if bad == "dtype":
        args["g_cell"] = g.float()
    elif bad == "device":
        args["lte_pops"] = lte.to("meta")
    elif bad == "J shape":
        args["J_blk"] = J[:, :-1]
    elif bad == "lead shape":
        args["lead"] = J[:2]
    elif bad == "rows":
        args["r0"] = line.n_lambda - 3
    elif bad == "acc shape":
        args["acc"] = {(0, 1): g[:-1]}
    elif bad == "compat":
        args["compat"] = "other"
    return args


@pytest.mark.parametrize("bad", ["dtype", "device", "J shape", "lead shape",
                                 "rows", "acc shape", "compat"])
def test_rates_refuse(bad):
    with pytest.raises((ValueError, TypeError)):
        t_rates.calculate_R_chunk(**_rates_case(bad))


@pytest.mark.parametrize("bad", ["dtype", "device", "J shape", "eps shape",
                                 "lam shape", "rows"])
def test_s_update_refuses(bad):
    S, J, eps, T, lam, start = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in _s_inputs(np.float64))
    if bad == "dtype":
        eps = eps.float()
    elif bad == "device":
        J = J.to("meta")
    elif bad == "J shape":
        J = J[..., :-1]
    elif bad == "eps shape":
        eps = eps[:-1]
    elif bad == "lam shape":
        lam = lam[:-1]
    else:
        start = S.shape[0] - 1
    with pytest.raises((ValueError, TypeError)):
        s1.s_update_stream(S, J, eps, T, lam, start)


def test_kernel_refuses_strided_cells():
    """R1 takes J rows any stride apart, but each row's cells
    contiguous: a cut along the last axis is refused before a launch."""
    T, ne, nH, J = _fields()
    line, lte, g, T = _torch_side(T, ne, nH)
    J2 = torch.from_numpy(J[:6]).reshape(6, 8, 8)
    assert t_rates._cells_contiguous(torch.from_numpy(J)[:, 8:40])
    assert t_rates._cells_contiguous(J2[:, 2:5])
    assert not t_rates._cells_contiguous(J2[:, :, 1:5])
    with pytest.raises(ValueError, match="contiguous"):
        t_rates._launch_r1(line, None, torch.from_numpy(J[:6])[:, ::2], 0,
                           g[::2].contiguous(), lte[::2].contiguous(),
                           T[::2].contiguous(), "reference", None)


# ------------------------------------------------------ (f): the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the production line (51 + 2 x 20 rows: bb rows 0-50, bf0 51-70, bf1
# 71-90) and R1's cases: (name, cells, J rows (first, stop) in the line,
# with the row before them leading, and the windows whose rates the
# running rates hold before the launch); J's cells a slab of a wider
# grid where the cells are (a, b, width): rows a stride apart
PROD_NLAM = (51, 20)
R1_CASES = {
    "one pair": (N, (4, 5), ()),
    "14 rows with lead": (1024, (13, 26), ("bb",)),
    "91 rows": (1024, (0, 91), ()),
    "odd cells": (5365, (0, 91), ()),
    "odd cells, chunk": (5365, (46, 59), ("bb",)),
    "ragged tile": (1000, (65, 78), ("bf0",)),
    "three tiles": (581, (13, 26), ("bb",)),
    "slab": ((2, 6, 40), (26, 39), ("bb",)),
}
# R1's tile: a block of cells, one a thread (csrc/rates.cu R1_THREADS)
R1_TILE = int(re.search(
    r"#define R1_THREADS (\d+)",
    (Path(t_rates.__file__).parents[1] / "csrc" / "rates.cu").read_text()
).group(1))


def _r1_case(name, dtype, device):
    """(line, acc, J_blk, r0, g, lte, T, lead) of an R1_CASES case on
    `device`: the lead row and acc's rates from seeded rows."""
    cells, (a, b), held = R1_CASES[name]
    nlam = NLAM if name == "one pair" else PROD_NLAM
    slab = isinstance(cells, tuple)
    n = 8 * cells[2] if slab else cells
    T, ne, nH, J = _fields(dtype, seed=11, n=n, nlam=nlam)
    line, lte, g, T = _torch_side(T, ne, nH, nlam)
    J = torch.from_numpy(J)
    if slab:
        # the cells [c0, c1) x width of an (8, width) grid
        c0, c1, width = cells
        cut = (slice(None), slice(c0, c1))
        J = J.reshape(J.shape[0], 8, width)[cut]
        line = dataclasses.replace(
            line, dlamD=line.dlamD.reshape(8, width)[c0:c1].contiguous())
        g, T = (x.reshape(8, width)[c0:c1].contiguous() for x in (g, T))
        lte = lte.reshape(8, width, -1)[c0:c1].contiguous()
    to = {"device": device}
    line = dataclasses.replace(line, dlamD=line.dlamD.to(**to))
    J, g, lte, T = (x.to(**to) for x in (J, g, lte, T))
    r0 = a - 1 if a > 0 else 0
    lead = J[a - 1:a].contiguous() if a > 0 else None
    acc = None
    if held:
        keys = {k for kind in held for k in t_rates._RATE_KEYS[kind]}
        full = t_rates.calculate_R_chunk_plain(line, None, J, 0, g, lte, T)
        acc = {k: v for k, v in full.items() if k in keys}
    return line, acc, J[a:b], r0, g, lte, T, lead


@pytest.mark.parametrize("name", sorted(R1_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_r1_cases_cover(name, dtype):
    """Each case of the card's R1 holds exercises what it names: its
    windows, all the line's rows, rows whose first value is not on 16
    bytes, a short tail tile, rows a stride apart, rates added into and
    new; and on the CPU the wrapper launches nothing and gives the plain
    version's rates."""
    line, acc, J, r0, g, lte, T, lead = _r1_case(name, dtype, "cpu")
    n_rows = J.shape[0] + (lead is not None)
    wins = t_rates._r1_rows(line, r0, n_rows, T, "reference")[0]
    kinds = [w[0] for w in wins]
    es = J.element_size()
    n = T.numel()
    if name == "one pair":
        assert wins == [("bb", 0, 1)]
    if name in ("91 rows", "odd cells"):
        assert sorted(kinds) == ["bb", "bf0", "bf1"]
        assert n_rows == line.n_lambda
    if name.startswith("odd cells"):
        assert n % 2 and (J.stride(0) * es) % 16
    if name in ("ragged tile", "three tiles"):
        assert n % R1_TILE
    if name == "three tiles":
        assert -(-n // R1_TILE) == 3
    if name == "slab":
        assert J.stride(0) > J[0].numel()
    held = set(acc or {})
    if name in ("14 rows with lead", "odd cells, chunk", "ragged tile",
                "three tiles", "slab"):
        # a production chunk: its 13 rows after the previous one's last
        assert lead is not None and n_rows == 14
        # the rates of one window added into, those of another new
        keys = [k for w in kinds for k in t_rates._RATE_KEYS[w]]
        assert any(k in held for k in keys)
        if name in ("ragged tile", "odd cells, chunk"):
            assert any(k not in held for k in keys)
    n0 = t_rates.LAUNCHES
    got = t_rates.calculate_R_chunk(line, acc, J, r0, g, lte, T, lead=lead)
    want = t_rates.calculate_R_chunk_plain(line, acc, J, r0, g, lte, T,
                                           lead=lead)
    assert t_rates.LAUNCHES == n0
    assert set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(R1_CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_r1_cases_match_plain_on_card(cuda, dtype, name):
    """R1 at each case against its plain version on the card, bit for
    bit, one launch a call; the running rates it adds into unchanged
    but for the launch's own."""
    line, acc, J, r0, g, lte, T, lead = _r1_case(name, dtype, cuda)
    before = None if acc is None else {k: v.clone() for k, v in acc.items()}
    want = t_rates.calculate_R_chunk_plain(line, acc, J, r0, g, lte, T,
                                           lead=lead)
    n0 = t_rates.LAUNCHES
    got = t_rates.calculate_R_chunk(line, acc, J, r0, g, lte, T, lead=lead)
    torch.cuda.synchronize()
    assert t_rates.LAUNCHES == n0 + 1
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the rates added into are acc's own tensors, updated in place
    for k in before or {}:
        assert got[k] is acc[k] and not torch.equal(acc[k], before[k])


@pytest.mark.cuda
@pytest.mark.parametrize("compat", ["reference", "fixed"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernels_match_plain_on_card(cuda, dtype, compat):
    """R1 chunk after chunk (chunk sizes 1, 5 and 7, with the lead row;
    a slab of z-planes cut from J, rows strided), the edge pair, and S1
    (a NaN in J too) against their plain versions on the card, bit for
    bit; one launch a call."""
    T, ne, nH, J = _fields(dtype)
    line, lte, g, T = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                       for x in _torch_side(T, ne, nH))
    line = dataclasses.replace(line, dlamD=line.dlamD.to(cuda))
    J = torch.from_numpy(J[:line.n_lambda]).to(cuda)
    for chunk in (1, 5, 7):
        n0, want_n = t_rates.LAUNCHES, 0
        acc_k = acc_p = carry = None
        for r0, sl in _chunks(J.shape[0], chunk):
            # a launch where the block holds a pair (not the first chunk
            # of one row)
            want_n += bool(t_rates._chunk_windows(line, r0,
                                                  sl.stop - r0))
            acc_k = t_rates.calculate_R_chunk(line, acc_k, J[sl], r0, g, lte,
                                              T, compat, lead=carry)
            acc_p = t_rates.calculate_R_chunk_plain(line, acc_p, J[sl], r0, g,
                                                    lte, T, compat,
                                                    lead=carry)
            torch.cuda.synchronize()
            assert set(acc_k) == set(acc_p)
            assert all(torch.equal(acc_k[k], acc_p[k]) for k in acc_p)
            carry = J[sl][-1:].clone()
        assert t_rates.LAUNCHES - n0 == want_n
    # a slab of the cells of a (21, 8, 8) J, rows 64 values apart
    J3 = J.reshape(J.shape[0], 8, 8)
    cut = slice(2, 6)
    sub = (dataclasses.replace(
        line, dlamD=line.dlamD.reshape(8, 8)[cut].contiguous()),)
    fields = [x.reshape((8, 8) + x.shape[1:])[cut].contiguous()
              for x in (g, lte, T)]
    for r0, lead in ((12, J3[12:13, cut]), (4, None)):
        rows = J3[r0 + (lead is not None):r0 + 8, cut]
        got = t_rates.calculate_R_chunk(*sub, None, rows, r0, *fields,
                                        compat, lead=lead)
        want = t_rates.calculate_R_chunk_plain(*sub, None, rows, r0, *fields,
                                               compat, lead=lead)
        assert all(torch.equal(got[k], want[k]) for k in want)
    S, Jc, eps, Tc, lam, start = (torch.from_numpy(a).to(cuda) if isinstance(
        a, np.ndarray) else a for a in _s_inputs(dtype))
    for nan in (False, True):
        if nan:
            Jc[1, 2, 3, 1] = float("nan")
        S_k, m_k = s1.s_update_stream(S.clone(), Jc, eps, Tc, lam, start)
        S_p, m_p = s1.s_update_stream_plain(S.clone(), Jc, eps, Tc, lam,
                                            start)
        torch.cuda.synchronize()
        assert torch.equal(S_k, S_p) if not nan else torch.equal(
            S_k.nan_to_num(), S_p.nan_to_num())
        assert torch.equal(m_k, m_p) or (bool(m_k.isnan()) and
                                         bool(m_p.isnan()))
        assert bool(m_k.isnan()) == nan
