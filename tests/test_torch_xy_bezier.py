"""The Bezier xy plane step (solvers/xy_bezier.py, X1) against the JAX
package.

xy_bezier runs one z-plane of the regular sweep's xy case with the
quadratic-Bezier source integration, one launch of csrc/xy_bezier.cu on
the card; on the CPU it takes its plain version, xy_bezier_plain.  Here,
from seeded numpy inputs at small shapes:

  (a) xy_bezier (the plain version, on CPU tensors) against the JAX
      package's sweep_regular._xy_step_bezier over both stencil base
      shifts in x and y, first 0 and 1, and fractions at 0, 1 and
      between; float64 at rtol 2e-12 (the Bezier weights cancel digits
      near dtau = 0.05, where XLA's exp is one ulp off PyTorch's), with
      dtau across 0.05 and 50; float32 at TOL["float32"] (chip_smoke.py's
      and tests/test_torch_xy_segment.py's bar), dtau across 50 and kept
      above 0.2, clear of the float32 cancellation at 0.05, where a
      one-ulp exp difference grows to ~3e-5 of the plane (ROADMAP C3);
  (b) a CPU tensor takes the plain version and launches nothing, and
      the Bezier sweep calls the wrapper once an xy plane where the
      plane does not fit the segment kernel's band (a fitting plane
      goes through solvers/xy_bezier_segment.py, one call a piece:
      tests/test_torch_xy_bezier_segment.py);
  (c) the wrapper refuses a wrong shape, dtype, device or layout;
  (d) the kernel's C entry points and their ctypes signature, from the
      source text (no build);
  (e) marked cuda (skipped without a card): X1 against the plain version
      on the card, float64 and float32, bit for bit, at (13, 256, 256),
      (1, 256, 256), (5, 37, 29) and a tile padded with 2-cell halos.

The JAX package is imported inside the tests that use it, so the cuda
test runs where only the port is installed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch.kernels import build
from voronoirt_tpu_torch.solvers import sweep_regular as sr
from voronoirt_tpu_torch.solvers import xy_bezier as xb

TOL = {np.float64: dict(rtol=2e-12, atol=0.0),
       np.float32: dict(rtol=2e-5, atol=1e-6)}
SHIFTS = [(0, 0), (-1, 0), (0, -1), (-1, -1)]
# (fx, fy, fx_prev, fy_prev): all zero, all one, between, mixed
FRACTIONS = [(0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0),
             (0.3, 0.8, 0.55, 0.1), (0.0, 1.0, 0.45, 1.0)]
# r and r_prev of the step
PATHS = (1.0, 0.7)


def _planes(seed, B, nx, ny, dtype):
    """I_p, alpha_c, alpha_p, S_c, S_p, alpha_pp, S_pp as numpy arrays.
    float64: alpha over 10^-2.5 .. 10^2.2, so dtau = r (alpha_c + a_up) / 2
    crosses the Bezier weights' 0.05 and 50 branches; float32: alpha
    from 10^-0.3, so dtau stays above 0.2 (it still crosses 50)."""
    rng = np.random.default_rng(seed)
    lo = -2.5 if dtype == np.float64 else -0.3
    shape = (B, nx, ny)

    def alpha():
        return (10.0 ** rng.uniform(lo, 2.2, shape)).astype(dtype)

    def source():
        return rng.uniform(0.1, 1.0, shape).astype(dtype)

    I_p = rng.uniform(0.0, 1.0, shape).astype(dtype)
    a_c, a_p = alpha(), alpha()
    S_c, S_p = source(), source()
    return I_p, a_c, a_p, S_c, S_p, alpha(), source()


class _Plan:
    def __init__(self, sxs, sys):
        self.sxs, self.sys = sxs, sys


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("first", [0.0, 1.0])
@pytest.mark.parametrize("sxs,sys", SHIFTS)
def test_plain_matches_jax(dtype, first, sxs, sys):
    import jax.numpy as jnp

    from voronoirt_tpu.solvers import sweep_regular as jsr

    planes = _planes(17 + 4 * sxs + 2 * sys, 3, 7, 6, dtype)
    r, r_prev = PATHS
    dtaus = []
    for fx, fy, fx_p, fy_p in FRACTIONS:
        geom = (r, fx, fy, r_prev, fx_p, fy_p, first)
        want, _ = jsr._xy_step_bezier(
            _Plan(sxs, sys), jnp.asarray(planes[0]),
            tuple(jnp.asarray(p) for p in planes[1:]) + geom)
        got = xb.xy_bezier(*(torch.from_numpy(p) for p in planes), *geom,
                           sxs, sys)
        assert got.dtype == torch.from_numpy(planes[0]).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype])
        a_up = xb.stencil_xy(torch.from_numpy(planes[2]), sxs, sys, fx, fy)
        dtaus.append(r * (torch.from_numpy(planes[1]) + a_up) * 0.5)
    dtau = torch.cat([d.flatten() for d in dtaus])
    assert float(dtau.max()) > 50.0
    if dtype == np.float64:
        assert float(dtau.min()) < 0.05
    else:
        assert float(dtau.min()) > 0.2
    assert xb.LAUNCHES == 0


def test_cpu_takes_plain_and_the_sweep_calls_it_a_plane(monkeypatch):
    planes = [torch.from_numpy(p) for p in _planes(3, 2, 5, 4, np.float64)]
    geom = (0.9, 0.25, 0.5, 0.8, 0.75, 0.0, 0.0)
    assert torch.equal(xb.xy_bezier(*planes, *geom, -1, 0),
                       xb.xy_bezier_plain(*planes, *geom, -1, 0))
    # the plan-level step is the wrapper with the plan's shifts
    assert torch.equal(sr._xy_step_bezier(_Plan(0, -1), *planes, *geom),
                       xb.xy_bezier_plain(*planes, *geom, 0, -1))

    calls = []

    def counting(*args):
        calls.append(args[-2:])
        return xb.xy_bezier(*args)

    monkeypatch.setattr(sr, "xy_bezier", counting)
    rng = np.random.default_rng(4)
    # 520 columns: more runs of a band than the segment kernel's threads
    nz, B, nx, ny = 9, 2, 3, 520
    assert not sr.bezier_fits(nx, ny)
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 0.3, nz - 1))])
    k = np.array([np.cos(np.deg2rad(150.0)), 0.3, -0.2])
    k /= np.linalg.norm(k)
    # the cell sizes of a 6 x 5 plane, so most steps are xy steps
    plan = sr.build_plan(k, z, 1.0 / 6, 1.0 / 5, True)
    n_xy = sum(len(s.steps) for s in plan.segments if s.case == "xy")
    assert n_xy > 0
    t = torch.from_numpy
    sr.sweep(plan, t(rng.uniform(0.1, 1.0, (nz, B, nx, ny))),
             t(10.0 ** rng.uniform(-1, 1, (nz, B, nx, ny))),
             t(rng.uniform(0.5, 1.0, (B, nx, ny))), interpolation="bezier")
    assert len(calls) == n_xy
    assert set(calls) == {(plan.sxs, plan.sys)}
    assert xb.LAUNCHES == 0


def _refused(case):
    planes = [torch.from_numpy(p) for p in _planes(5, 2, 5, 4, np.float64)]
    geom = [0.9, 0.25, 0.5, 0.8, 0.75, 0.0, 0.0]
    shifts = [0, -1]
    if case == "rank":
        planes[0] = planes[0][0]
    elif case == "shape":
        planes[3] = planes[3][:, :-1].contiguous()
    elif case == "dtype":
        planes = [p.to(torch.float16) for p in planes]
    elif case == "mixed dtype":
        planes[5] = planes[5].float()
    elif case == "device":
        planes = [p.to("meta") for p in planes]
    elif case == "mixed device":
        planes[6] = planes[6].to("meta")
    elif case == "layout":
        planes[2] = planes[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "tensor geometry":
        geom[0] = torch.tensor(0.9, dtype=torch.float64)
    elif case == "shift":
        shifts[1] = 1
    return lambda: xb.xy_bezier(*planes, *geom, *shifts)


REFUSALS = {"rank": ValueError, "shape": ValueError, "dtype": TypeError,
            "mixed dtype": ValueError, "device": ValueError,
            "mixed device": ValueError, "layout": ValueError,
            "tensor geometry": TypeError, "shift": ValueError}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    with pytest.raises(REFUSALS[case]):
        _refused(case)()


def test_kernel_entry_points_from_source():
    """vrt_xy_bezier_f64 / _f32 are extern "C" in csrc/xy_bezier.cu with
    the arguments _SIGNATURES gives them: eight pointers (the seven
    planes and the output), five ints, seven doubles, the stream."""
    from voronoirt_tpu_torch.kernels.build import _D, _I, _P, _SIGNATURES
    assert _SIGNATURES["vrt_xy_bezier"] == [_P] * 8 + [_I] * 5 + [_D] * 7 \
        + [_P]
    src = (Path(build.SRC_DIR) / "xy_bezier.cu").read_text()
    kinds = {"double*": _P, "float*": _P, "void*": _P, "int": _I,
             "double": _D}
    for suffix, ptr in (("_f64", "double*"), ("_f32", "float*")):
        m = re.search(r'extern "C" int vrt_xy_bezier' + suffix
                      + r"\(([^)]*)\)", src)
        assert m, suffix
        args = [re.sub(r"\s+", " ", a).strip()
                for a in m.group(1).split(",")]
        types = [a.replace("const ", "").rsplit(" ", 1)[0].replace(" *", "*")
                 for a in args]
        assert [kinds[t] for t in types] == _SIGNATURES["vrt_xy_bezier"]
        assert types[:8] == [ptr] * 8


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (B, Nx, Ny): the Bezier iteration's plane (a lambda chunk), the
# continuum's batch of one, a ragged plane, a tile of a split grid
# padded with 2-cell halos
CARD_SHAPES = [(13, 256, 256), (1, 256, 256), (5, 37, 29), (13, 132, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, dtype, shape):
    """X1 against xy_bezier_plain on the same CUDA tensors, bit for
    bit, over the shift pairs, first 0 and 1 and the fraction sets; one
    launch a call."""
    planes = [torch.from_numpy(p).to(cuda)
              for p in _planes(sum(shape), *shape, dtype)]
    n0 = xb.LAUNCHES
    n = 0
    for sxs, sys in SHIFTS:
        for first in (0.0, 1.0):
            for fx, fy, fx_p, fy_p in FRACTIONS:
                geom = (*PATHS[:1], fx, fy, PATHS[1], fx_p, fy_p, first)
                got = xb.xy_bezier(*planes, *geom, sxs, sys)
                want = xb.xy_bezier_plain(*planes, *geom, sxs, sys)
                torch.cuda.synchronize()
                n += 1
                assert torch.equal(got, want), (sxs, sys, first, fx, fy)
    assert xb.LAUNCHES - n0 == n
