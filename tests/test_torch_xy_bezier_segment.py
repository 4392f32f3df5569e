"""A Bezier xy segment (solvers/xy_bezier_segment.py) against a loop of
the Bezier xy step and against the JAX package.

xy_bezier_segment runs a Bezier xy segment in one launch of
csrc/xy_bezier_segment.cu on the card, each plane written into the
sweep's output cube at its index; on the CPU it takes its plain
version.  Here, from seeded numpy inputs at small shapes:

  (a) xy_bezier_segment (the plain version, on CPU tensors) against a
      loop of xy_bezier_plain written out here (the second-upwind plane
      clamped at the boundary, the step before's geometry, first at the
      segment's first step), bit for bit, float64 and float32, every
      shift pair, up and down, a segment that starts at the boundary
      plane and one that starts after a march segment, at every length
      from one step to the whole segment;
  (b) whole Bezier sweeps through that route against the JAX package's
      sweep(..., interpolation=
      "bezier"): float64 at rtol 2e-12, float32 at rtol 2e-5 / atol 1e-6
      (tests/test_torch_xy_bezier.py's bars);
  (c) routing: the unsplit sweep calls xy_bezier_segment once a segment
      and X1 (xy_bezier) never; a split grid (a one-rank halo) calls X1
      once a plane and the segment wrapper never; so does an unsplit
      plane that does not fit the kernel's band;
  (d) the wrapper refuses a bad segment, shape, dtype, shift or
      geometry;
  (e) the kernel's C entry points and their ctypes signatures, from the
      source text (no build);
  (f) marked cuda (skipped without a card): the kernel against its
      plain version on the same CUDA tensors, bit for bit, float64 and
      float32, at (13, 256, 256), (1, 256, 256), (5, 37, 29) and two
      edge planes, every shift pair, both directions, both starts, a
      segment of one step and a longer one.

The JAX package is imported inside the tests that use it, so the cuda
test runs where only the port is installed.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch.kernels import build
from voronoirt_tpu_torch.solvers import sweep_regular as sr
from voronoirt_tpu_torch.solvers import xy_bezier as xb
from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs

TOL = {np.float64: dict(rtol=2e-12, atol=0.0),
       np.float32: dict(rtol=2e-5, atol=1e-6)}
SHIFTS = [(0, 0), (-1, 0), (0, -1), (-1, -1)]
DTYPES = [np.float64, np.float32]


def _fields(seed, nz, B, nx, ny, dtype, lo32=-0.3):
    """alpha, S, I0 as numpy arrays: alpha over 10^-2.5 .. 10^2.2 in
    float64 (dtau crosses the Bezier weights' 0.05 and 50 branches),
    from 10^lo32 in float32."""
    rng = np.random.default_rng(seed)
    lo = -2.5 if dtype == np.float64 else lo32
    alpha = (10.0 ** rng.uniform(lo, 2.2, (nz, B, nx, ny))).astype(dtype)
    S = rng.uniform(0.1, 1.0, (nz, B, nx, ny)).astype(dtype)
    I0 = rng.uniform(0.0, 1.0, (B, nx, ny)).astype(dtype)
    return rng, alpha, S, I0


def _segment(rng, nz, L, dirn, start):
    """A segment of L steps: from the boundary plane (t = 1 up, nz - 2
    down: the second-upwind index clamps) or after a march segment (3
    planes in), with per-step Python-float geometry holding exact 0 and
    1 fractions."""
    off = 1 if start == "boundary" else 4
    t0 = off if dirn == 1 else nz - 1 - off
    steps = tuple(t0 + j * dirn for j in range(L))
    r = tuple(float(v) for v in 10.0 ** rng.uniform(-0.5, 0.5, L))
    fx = [float(v) for v in rng.uniform(0, 1, L)]
    fy = [float(v) for v in rng.uniform(0, 1, L)]
    fx[0], fy[-1] = 0.0, 1.0
    return steps, r, tuple(fx), tuple(fy)


def _loop(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys):
    """The Bezier xy steps of a segment, plane by plane through
    xy_bezier_plain: {t: plane}."""
    nz = alpha.shape[0]
    I, planes = I0, {}
    for j, t in enumerate(steps):
        jp = max(j - 1, 0)
        t2 = min(max(t - 2 * dirn, 0), nz - 1)
        I = xb.xy_bezier_plain(I, alpha[t], alpha[t - dirn], S[t],
                               S[t - dirn], alpha[t2], S[t2], r[j], fx[j],
                               fy[j], r[jp], fx[jp], fy[jp],
                               1.0 if j == 0 else 0.0, sxs, sys)
        planes[t] = I
    return planes


def _run(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys):
    """xy_bezier_segment into a NaN-filled cube."""
    out = torch.full(alpha.shape, float("nan"), dtype=alpha.dtype,
                     device=alpha.device)
    last = xbs.xy_bezier_segment(alpha, S, I0, steps, dirn, r, fx, fy, sxs,
                                 sys, out)
    assert last.data_ptr() == out[steps[-1]].data_ptr()
    return out


def _same(out, planes):
    """out holds planes bit for bit at their indices and NaN elsewhere."""
    for t in range(out.shape[0]):
        if t in planes:
            assert torch.equal(out[t], planes[t]), t
        else:
            assert torch.isnan(out[t]).all(), t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("start", ["boundary", "after-march"])
@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("sxs,sys", SHIFTS)
def test_plain_equals_a_loop_of_the_step(dtype, start, dirn, sxs, sys):
    nz, L = 12, 7
    rng, *arrays = _fields(3 + sxs + 2 * sys, nz, 2, 7, 6, dtype)
    alpha, S, I0 = (torch.from_numpy(a) for a in arrays)
    steps, r, fx, fy = _segment(rng, nz, L, dirn, start)
    # every length: a shorter segment is the loop's first steps
    for n in range(1, L + 1):
        planes = _loop(alpha, S, I0, steps[:n], dirn, r[:n], fx[:n], fy[:n],
                       sxs, sys)
        _same(_run(alpha, S, I0, steps[:n], dirn, r[:n], fx[:n], fy[:n],
                   sxs, sys), planes)
    assert xbs.LAUNCHES == 0


def _kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t),
                     np.sin(p) * np.sin(t)])


# (theta, phi, up, the cases its segments must show): xy alone, and xy
# segments that start after a march segment
DIRECTIONS = [
    pytest.param(160.0, 30.0, True, {"xy"}, id="xy-only-up"),
    pytest.param(110.0, 200.0, True, {"xy", "yz"}, id="mixed-xy-yz-up"),
    pytest.param(20.0, 100.0, False, {"xy"}, id="xy-only-down"),
    pytest.param(70.0, 300.0, False, {"xy", "xz"}, id="mixed-xy-xz-down"),
]


# z steps: steep directions stay xy throughout; the oblique ones march
# where the steps are long and take an xy segment of six planes where
# they are short, so it starts after a march segment
DZ = [0.3] * 4 + [0.03] * 6 + [0.3] * 3


def _sweep_inputs(dtype, B=3, nx=8, ny=9):
    """z, dx, dy, S, alpha, I0.  In float32 alpha starts at 10^0.8, so
    dtau (r >= 0.032) stays above 0.2, clear of the float32 cancellation
    of the Bezier weights near dtau = 0.05, where one-ulp differences
    grow to ~3e-5 of the plane (ROADMAP C3, as in
    tests/test_torch_xy_bezier.py); it still crosses 50."""
    _, alpha, S, I0 = _fields(0, len(DZ) + 1, B, nx, ny, dtype, lo32=0.8)
    z = np.concatenate([[0.0], np.cumsum(DZ)])
    return z, 1.0 / nx, 1.0 / ny, S, alpha, I0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta,phi,up,cases", DIRECTIONS)
def test_bezier_sweep_matches_jax(monkeypatch, dtype, theta, phi, up,
                                  cases):
    """The whole Bezier sweep, its xy segments through xy_bezier_segment,
    against the JAX package's (whose Bezier scan runs in float64: the
    float32 inputs go to it as float64)."""
    import jax.numpy as jnp

    from voronoirt_tpu.solvers import sweep_regular as jsr

    calls = _count(monkeypatch)
    z, dx, dy, S, alpha, I0 = _sweep_inputs(dtype)
    k = _kvec(theta, phi)
    plan = sr.build_plan(k, z, dx, dy, up)
    assert {s.case for s in plan.segments} == cases
    n_xy = sum(s.case == "xy" for s in plan.segments)
    assert max(len(s.steps) for s in plan.segments if s.case == "xy") > 3
    j64 = lambda a: jnp.asarray(a.astype(np.float64))  # noqa: E731
    want = np.asarray(jsr.sweep(
        jsr.build_plan(k, z, dx, dy, up), j64(S), j64(alpha), j64(I0),
        n_sweeps=3, interpolation="bezier"))
    t = torch.from_numpy
    n0 = xbs.LAUNCHES
    got = sr.sweep(plan, t(S), t(alpha), t(I0), n_sweeps=3,
                   interpolation="bezier")
    assert got.dtype == t(S).dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    assert xbs.LAUNCHES == n0
    assert len(calls["segment"]) == n_xy and calls["plane"] == 0


def _count(monkeypatch):
    calls = {"segment": [], "plane": 0}

    def segment(*args):
        calls["segment"].append(tuple(args[3]))
        return xbs.xy_bezier_segment(*args)

    def plane(*args):
        calls["plane"] += 1
        return xb.xy_bezier(*args)

    monkeypatch.setattr(sr, "xy_bezier_segment", segment)
    monkeypatch.setattr(sr, "xy_bezier", plane)
    return calls


def test_unsplit_sweep_calls_the_segment_once_a_segment(monkeypatch):
    calls = _count(monkeypatch)
    z, dx, dy, S, alpha, I0 = _sweep_inputs(np.float64)
    plan = sr.build_plan(_kvec(110.0, 200.0), z, dx, dy, True)
    want = [tuple(s.steps) for s in plan.segments if s.case == "xy"]
    lengths = [len(w) for w in want]
    assert want and max(lengths) > 1
    t = torch.from_numpy
    out = sr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier")
    assert calls["segment"] == want
    assert calls["plane"] == 0
    # the same cube as a sweep whose xy steps go plane by plane
    monkeypatch.setattr(sr, "bezier_fits", lambda nx, ny: False)
    planes = sr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier")
    assert torch.equal(out, planes)
    assert calls["plane"] == sum(lengths)
    assert len(calls["segment"]) == len(want)


def test_split_and_unfitting_sweeps_call_x1_a_plane(monkeypatch):
    """A split grid (here a one-rank halo: refill, gather and slab the
    identity) and an unsplit plane that does not fit the kernel's band
    step plane by plane through X1; both give the unsplit cube."""
    calls = _count(monkeypatch)
    z, dx, dy, S, alpha, I0 = _sweep_inputs(np.float64)
    plan = sr.build_plan(_kvec(110.0, 200.0), z, dx, dy, True)
    n_xy = sum(len(s.steps) for s in plan.segments if s.case == "xy")
    t = torch.from_numpy
    whole = sr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier")
    n_segments = len(calls["segment"])
    assert n_segments > 0 and calls["plane"] == 0
    ident = lambda P: P  # noqa: E731
    halo = types.SimpleNamespace(width=2, refill=ident, gather=ident,
                                 slab=ident)
    split = sr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier",
                     halo=halo)
    assert torch.equal(split, whole)
    assert calls["plane"] == n_xy and len(calls["segment"]) == n_segments

    # 520 columns: more runs of a band than the kernel has threads
    nz, B, nx, ny = 6, 1, 3, 520
    assert not xbs.fits(nx, ny) and xbs.fits(nx, 512)
    rng, alpha, S, I0 = _fields(5, nz, B, nx, ny, np.float64)
    plan = sr.build_plan(_kvec(160.0, 30.0), np.linspace(0, 0.5, nz),
                         1.0 / 6, 1.0 / 5, True)
    n_wide = sum(len(s.steps) for s in plan.segments if s.case == "xy")
    assert n_wide > 0
    sr.sweep(plan, t(S), t(alpha), t(I0), interpolation="bezier")
    assert calls["plane"] == n_xy + n_wide
    assert len(calls["segment"]) == n_segments


def test_fits_rule():
    """fits() is the kernel's rule (csrc/xy_bezier_segment.cu
    bz_layout): the production plane and every plane phase 2 holds fit,
    wider ones do not."""
    for nx, ny in ((256, 256), (37, 29), (6, 1), (1, 7), (260, 132),
                   (3, 512), (128, 512)):
        assert xbs.fits(nx, ny), (nx, ny)
    for nx, ny in ((3, 513), (256, 257), (260, 256), (512, 512)):
        assert not xbs.fits(nx, ny), (nx, ny)


def _refused(case):
    rng, *arrays = _fields(9, 8, 2, 5, 4, np.float64)
    alpha, S, I0 = (torch.from_numpy(a) for a in arrays)
    steps, r, fx, fy = _segment(rng, 8, 4, 1, "boundary")
    out = torch.empty_like(alpha)
    dirn, shifts = 1, [0, -1]
    if case == "empty segment":
        steps, r, fx, fy = (), (), (), ()
    elif case == "steps past the grid":
        steps = (5, 6, 7, 8)
    elif case == "steps":
        steps = (1, 2, 4, 5)
    elif case == "plane before the grid":
        steps = (0, 1, 2, 3)
    elif case == "shape":
        S = S[:, :, :-1].contiguous()
    elif case == "I0 shape":
        I0 = I0[0]
    elif case == "dtype":
        alpha, S, I0, out = (a.to(torch.float16) for a in (alpha, S, I0, out))
    elif case == "mixed dtype":
        out = out.float()
    elif case == "device":
        alpha, S, I0, out = (a.to("meta") for a in (alpha, S, I0, out))
    elif case == "shift":
        shifts[0] = 1
    elif case == "dirn":
        dirn = 2
    elif case == "tensor geometry":
        r = (torch.tensor(1.0),) + r[1:]
    elif case == "geometry length":
        fx = fx[:-1]
    return lambda: xbs.xy_bezier_segment(alpha, S, I0, steps, dirn, r, fx, fy,
                                         *shifts, out)


REFUSALS = {"empty segment": ValueError, "steps past the grid": ValueError,
            "steps": ValueError, "plane before the grid": ValueError,
            "shape": ValueError, "I0 shape": ValueError, "dtype": TypeError,
            "mixed dtype": ValueError, "device": ValueError,
            "shift": ValueError, "dirn": ValueError,
            "tensor geometry": TypeError, "geometry length": ValueError}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(case):
    with pytest.raises(REFUSALS[case]):
        _refused(case)()


def test_kernel_entry_points_from_source():
    """vrt_xy_bezier_segment_f64 / _f32 and their _info are extern "C"
    in csrc/xy_bezier_segment.cu with the arguments _SIGNATURES gives
    them: five pointers (alpha, S, I0, the geometry rows in double, the
    output cube), nine ints, the stream; the info two ints and a
    pointer."""
    from voronoirt_tpu_torch.kernels.build import _I, _P, _SIGNATURES
    assert _SIGNATURES["vrt_xy_bezier_segment"] == [_P] * 5 + [_I] * 9 \
        + [_P]
    assert _SIGNATURES["vrt_xy_bezier_segment_info"] == [_I] * 2 + [_P]
    src = (Path(build.SRC_DIR) / "xy_bezier_segment.cu").read_text()
    kinds = {"double*": _P, "float*": _P, "void*": _P, "int*": _P,
             "int": _I}
    for name in ("vrt_xy_bezier_segment", "vrt_xy_bezier_segment_info"):
        for suffix, ptr in (("_f64", "double*"), ("_f32", "float*")):
            m = re.search(r'extern "C" int ' + name + suffix + r"\(([^)]*)\)",
                          src)
            assert m, name + suffix
            args = [re.sub(r"\s+", " ", a).strip()
                    for a in m.group(1).split(",")]
            types_ = [a.replace("const ", "").rsplit(" ", 1)[0]
                      .replace(" *", "*") for a in args]
            assert [kinds[t] for t in types_] == _SIGNATURES[name]
            if name == "vrt_xy_bezier_segment":
                assert types_[:5] == [ptr] * 3 + ["double*", ptr]
    # the Python rule names the kernel's constants
    for const, v in (("BZ_CLUSTER", xbs.CLUSTER), ("BZ_THREADS", xbs.THREADS),
                     ("BZ_RUN", xbs.RUN)):
        assert re.search(rf"constexpr int {const} = {v};", src), const


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (nz, B, Nx, Ny): the Bezier iteration's plane (a lambda chunk), the
# continuum's batch of one, a ragged plane, a single column (the y wrap
# onto itself) and a single row (one CTA, the x wrap onto itself)
CARD_SHAPES = [(12, 13, 256, 256), (12, 1, 256, 256), (12, 5, 37, 29),
               (12, 3, 6, 1), (12, 2, 1, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, dtype, shape):
    """The kernel against xy_bezier_segment_plain on the same CUDA
    tensors, bit for bit: every shift pair, both directions, both
    starts, a segment of one step and one of L; one launch a
    segment."""
    nz = shape[0]
    L = 7
    rng, *arrays = _fields(sum(shape), *shape, dtype)
    alpha, S, I0 = (torch.from_numpy(a).to(cuda) for a in arrays)
    n0, n = xbs.LAUNCHES, 0
    for sxs, sys in SHIFTS:
        for dirn in (1, -1):
            for start in ("boundary", "after-march"):
                seg = _segment(rng, nz, L, dirn, start)
                for n_steps in (1, L):
                    steps, r, fx, fy = (v[:n_steps] for v in seg)
                    got = _run(alpha, S, I0, steps, dirn, r, fx, fy, sxs,
                               sys)
                    want = torch.full_like(got, float("nan"))
                    xbs.xy_bezier_segment_plain(alpha, S, I0, steps, dirn, r,
                                                fx, fy, sxs, sys, want)
                    torch.cuda.synchronize()
                    n += 1
                    assert torch.equal(got.nan_to_num(-1.0),
                                       want.nan_to_num(-1.0)), \
                        (sxs, sys, dirn, start, n_steps)
    assert xbs.LAUNCHES - n0 == n
