"""The xy segment (solvers/xy_segment.py) against the JAX package.

xy_segment runs a whole xy segment of the regular sweep, or a piece of
one, in one kernel launch on the card; on the CPU it takes its plain
version, a loop of xy_plane_plain.  Here the same seeded numpy inputs
go through the JAX package's two xy paths -- a lax.scan of
sweep_regular._xy_step over the segment (per-element geometry, as the
batched group sweep feeds it) and a loop of the Pallas kernel
xy_plane_pallas in interpret mode (geometry shared by the batch) -- and
through xy_segment, over every stencil-shift pair and both directions,
float64 at 1e-12 and float32 at TOL["float32"].  Cutting a segment into
pieces gives bit-equal planes, and the unsplit sweep calls the wrapper
once a piece.  The kernel itself is held against the plain version and
the per-plane kernel on the card by the test marked cuda (and by
chip_smoke.py phase 2).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voronoirt_tpu.solvers import sweep_regular as jsr
from voronoirt_tpu.solvers.pallas_xy import xy_plane_pallas
from voronoirt_tpu_torch.solvers import sweep_regular as sr
from voronoirt_tpu_torch.solvers import xy_plane as xp
from voronoirt_tpu_torch.solvers import xy_segment as xs

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=2e-5, atol=1e-6)}
SHIFTS = [(0, 0), (-1, 0), (0, -1), (-1, -1)]


def _fields(seed, nz, B, nx, ny, dtype):
    """alpha, S, I0.  In float64 alpha spans 7 decades, so dtau crosses
    every weight branch.  In float32 alpha stays above 0.3, so dtau
    (r >= 0.1) stays above 0.03, clear of the linear weights' float32
    cancellation just above their 5e-4 guard, where one-ulp exp
    differences between XLA and PyTorch grow to ~5e-5 (ROADMAP C3); the
    large-dtau branch is still crossed."""
    rng = np.random.default_rng(seed)
    lo = -5.0 if dtype == np.float64 else -0.5
    alpha = (10.0 ** rng.uniform(lo, 2, (nz, B, nx, ny))).astype(dtype)
    S = rng.uniform(0.1, 1.0, (nz, B, nx, ny)).astype(dtype)
    I0 = rng.uniform(0.0, 1.0, (B, nx, ny)).astype(dtype)
    return rng, alpha, S, I0


def _steps(nz, dirn, n=None):
    steps = list(range(1, nz)) if dirn == 1 else list(range(nz - 2, -1, -1))
    return steps if n is None else steps[:n]


def _geometry(rng, n, B, dtype):
    """Per-step, per-element r, fx, fy, with exact 0 and 1 fractions."""
    r = (10.0 ** rng.uniform(-1, 1, (n, B))).astype(dtype)
    fx, fy = (rng.uniform(0, 1, (n, B)).astype(dtype) for _ in range(2))
    fx[0, 0], fy[0, -1], fx[-1, -1] = 0.0, 1.0, 1.0
    return r, fx, fy


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plan(sxs, sys):
    return jsr.RegularPlan(k=(0, 0, 0), up=True, sign_x=1, sign_y=1, sxs=sxs,
                           sys=sys, r_x=0.0, r_y=0.0, fy_line=0.0,
                           fx_line=0.0, segments=())


def _run(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys, **kw):
    n = len(steps)
    a, s, i0, rt, fxt, fyt = _t(alpha, S, I0, r, fx, fy)
    out = torch.empty((n,) + tuple(i0.shape), dtype=a.dtype)
    return xs.xy_segment(a, s, i0, steps, dirn, rt, fxt, fyt, sxs, sys, out,
                         **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("sxs,sys", SHIFTS)
def test_segment_matches_jax_scan(sxs, sys, dirn, dtype):
    """A lax.scan of _xy_step over the segment, per-element geometry of
    shape (B, 1, 1) a step, on a ragged plane."""
    nz, B, nx, ny = 9, 3, 7, 5
    rng, alpha, S, I0 = _fields(10 + sxs + 2 * sys, nz, B, nx, ny, dtype)
    steps = _steps(nz, dirn)
    n = len(steps)
    r, fx, fy = _geometry(rng, n, B, dtype)
    idx = np.asarray(steps)
    g = lambda a: jnp.asarray(a[:, :, None, None])
    inputs = (jnp.asarray(alpha[idx]), jnp.asarray(alpha[idx - dirn]),
              jnp.asarray(S[idx]), jnp.asarray(S[idx - dirn]), g(r), g(fx),
              g(fy), jnp.zeros(n, dtype))
    _, want = jax.lax.scan(partial(jsr._xy_step, _plan(sxs, sys)),
                           jnp.asarray(I0), inputs)
    got = _run(alpha, S, I0, steps, dirn, r, fx, fy, sxs, sys)
    assert got.dtype == torch.from_numpy(alpha).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("sxs,sys", SHIFTS)
def test_segment_matches_pallas_loop(sxs, sys, dirn, dtype):
    """A loop of xy_plane_pallas (interpret mode) over the segment, the
    geometry shared by the batch (the kernel's scalars); its 3x3 tap
    form rounds otherwise than the separable lerp."""
    nz, B, nx, ny = 6, 4, 8, 8
    rng, alpha, S, I0 = _fields(20 + sxs + 2 * sys, nz, B, nx, ny, dtype)
    steps = _steps(nz, dirn)
    n = len(steps)
    r1, fx1, fy1 = _geometry(rng, n, 1, dtype)
    I = jnp.asarray(I0)
    want = []
    for j, t in enumerate(steps):
        I = xy_plane_pallas(jnp.asarray(alpha[t - dirn]),
                            jnp.asarray(alpha[t]), jnp.asarray(S[t - dirn]),
                            jnp.asarray(S[t]), I, float(r1[j, 0]),
                            sxs + float(fx1[j, 0]), sys + float(fy1[j, 0]),
                            b_block=2, interpret=True)
        want.append(np.asarray(I))
    rep = lambda a: np.repeat(a, B, axis=1)
    got = _run(alpha, S, I0, steps, dirn, rep(r1), rep(fx1), rep(fy1), sxs,
               sys)
    np.testing.assert_allclose(got.numpy(), np.stack(want), **TOL[dtype])


@pytest.mark.parametrize("dirn", [1, -1])
def test_plain_is_the_per_plane_loop(dirn):
    """xy_segment on the CPU equals a loop of xy_plane bit for bit,
    and returns the `out` it was given."""
    nz, B, nx, ny = 8, 2, 6, 9
    rng, alpha, S, I0 = _fields(30, nz, B, nx, ny, np.float64)
    steps = _steps(nz, dirn, 5)
    r, fx, fy = _geometry(rng, len(steps), B, np.float64)
    got = _run(alpha, S, I0, steps, dirn, r, fx, fy, -1, 0)
    a, s, I, rt, fxt, fyt = _t(alpha, S, I0, r, fx, fy)
    for j, t in enumerate(steps):
        I = xp.xy_plane(a[t - dirn], a[t], s[t - dirn], s[t], I, rt[j],
                        fxt[j], fyt[j], -1, 0)
        assert torch.equal(got[j], I)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("max_steps", [1, 3, None])
def test_pieces_are_bit_equal(max_steps, dirn, dtype):
    """A segment cut into pieces of max_steps planes (None: whole), each
    piece starting from the last plane of the one before, gives the
    whole segment's planes bit for bit."""
    nz, B, nx, ny = 12, 3, 5, 7
    rng, alpha, S, I0 = _fields(40, nz, B, nx, ny, dtype)
    steps = _steps(nz, dirn)
    n = len(steps)
    r, fx, fy = _geometry(rng, n, B, dtype)
    whole = _run(alpha, S, I0, steps, dirn, r, fx, fy, 0, -1)
    k = max_steps or n
    carry, pieces = I0, []
    for j0 in range(0, n, k):
        sl = slice(j0, j0 + k)
        p = _run(alpha, S, carry, steps[sl], dirn, r[sl], fx[sl], fy[sl], 0,
                 -1)
        pieces.append(p)
        carry = p[-1].numpy()
    assert len(pieces) == -(-n // k)
    assert torch.equal(torch.cat(pieces), whole)


def _xy_group(nz=10, nx=6, ny=5):
    """A plan group whose every step is the xy case (a steep direction
    on a uniform z axis)."""
    z = np.linspace(0.0, 0.5, nz)
    k = np.array([-0.9, 0.3, 0.2])
    k /= np.linalg.norm(k)
    ks = [k, k * np.array([1, -1, 1]), -k * np.array([1, 1, -1])]
    groups = sr.group_plans(ks, [True, True, False], z, 1.0 / nx, 1.0 / ny)
    assert len(groups) == 1
    assert [s.case for s in groups[0][0][1].segments] == ["xy"]
    return z, groups[0]


def _count_calls(monkeypatch):
    calls = []
    fn = sr.xy_segment

    def counting(*args, **kwargs):
        calls.append(len(args[3]))
        return fn(*args, **kwargs)

    monkeypatch.setattr(sr, "xy_segment", counting)
    return calls


@pytest.mark.parametrize("max_steps", [1, 3, None])
def test_sweep_group_calls_one_a_piece(monkeypatch, max_steps):
    """sweep_group_J makes one xy_segment call a piece of at most
    piece_steps() planes, and its J is bit-equal whatever the pieces."""
    nz, nx, ny, B = 10, 6, 5, 2
    z, group = _xy_group(nz, nx, ny)
    rng = np.random.default_rng(50)
    P = len(group)
    S = torch.from_numpy(rng.uniform(0.1, 1.0, (nz, B, nx, ny)))
    alist = [torch.from_numpy(10.0 ** rng.uniform(-2, 2, (nz, B, nx, ny)))
             for _ in range(P)]
    I0 = [torch.from_numpy(rng.uniform(0, 1, (B, nx, ny))) for _ in range(P)]
    plans = [g[1] for g in group]
    flips = [g[2] for g in group]
    w = np.full(P, 1.0 / P)
    want = sr.sweep_group_J(plans, S, alist, I0, w, flips=flips)
    plane = P * B * nx * ny * 8
    if max_steps is not None:
        monkeypatch.setattr(xs, "PIECE_BYTES", max_steps * plane + plane // 2)
    calls = _count_calls(monkeypatch)
    got = sr.sweep_group_J(plans, S, alist, I0, w, flips=flips)
    n = nz - 1
    k = max_steps or n
    assert calls == [min(k, n - j0) for j0 in range(0, n, k)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("up", [True, False])
def test_sweep_calls_one_a_piece(monkeypatch, up):
    """`sweep`, up and down, makes one xy_segment call a piece, and its
    intensities equal a loop of xy_plane over the same steps bit for
    bit."""
    nz, nx, ny, B = 10, 6, 5, 3
    z = np.linspace(0.0, 0.5, nz)
    k = np.array([-0.9 if up else 0.9, 0.3, -0.2])
    plan = sr.build_plan(k / np.linalg.norm(k), z, 1.0 / nx, 1.0 / ny, up)
    assert [s.case for s in plan.segments] == ["xy"]
    rng = np.random.default_rng(60)
    S, alpha = (torch.from_numpy(rng.uniform(lo, hi, (nz, B, nx, ny)))
                for lo, hi in ((0.1, 1.0), (0.5, 20.0)))
    I0 = torch.from_numpy(rng.uniform(0, 1, (B, nx, ny)))
    monkeypatch.setattr(xs, "PIECE_BYTES", 4 * B * nx * ny * 8)
    calls = _count_calls(monkeypatch)
    got = sr.sweep(plan, S, alpha, I0)
    assert calls == [4, 4, 1]
    seg, dirn = plan.segments[0], 1 if up else -1
    I = I0
    t_first = 0 if up else nz - 1
    assert torch.equal(got[t_first], I0)
    for j, t in enumerate(seg.steps):
        g = [torch.full((B,), v, dtype=torch.float64)
             for v in (seg.r[j], seg.fx[j], seg.fy[j])]
        I = xp.xy_plane(alpha[t - dirn], alpha[t], S[t - dirn], S[t], I,
                        *g, plan.sxs, plan.sys)
        assert torch.equal(got[t], I)


def test_piece_steps(monkeypatch):
    """The piece bound: ~1 GiB of planes, at least one."""
    f64 = torch.float64
    assert xs.piece_steps(52, 256, 256, f64) == 39
    assert xs.piece_steps(52, 256, 256, torch.float32) == 78
    assert xs.piece_steps(1, 256, 256, f64) == 2048
    assert -(-214 // xs.piece_steps(52, 256, 256, f64)) == 6
    monkeypatch.setattr(xs, "PIECE_BYTES", 1)
    assert xs.piece_steps(52, 256, 256, f64) == 1


def test_cpu_tensors_take_the_plain_version():
    nz, B, nx, ny = 5, 2, 4, 4
    rng, alpha, S, I0 = _fields(70, nz, B, nx, ny, np.float64)
    r, fx, fy = _geometry(rng, 3, B, np.float64)
    before = xs.LAUNCHES, xp.LAUNCHES
    _run(alpha, S, I0, [1, 2, 3], 1, r, fx, fy, 0, 0)
    assert (xs.LAUNCHES, xp.LAUNCHES) == before


def test_wrapper_checks_its_inputs():
    nz, B, nx, ny = 5, 2, 4, 4
    rng, alpha, S, I0 = _fields(80, nz, B, nx, ny, np.float64)
    r, fx, fy = _geometry(rng, 3, B, np.float64)
    a, s, i0, rt, fxt, fyt = _t(alpha, S, I0, r, fx, fy)
    out = torch.empty(3, B, nx, ny, dtype=torch.float64)
    ok = (a, s, i0, [1, 2, 3], 1, rt, fxt, fyt, 0, 0, out)

    def bad(i, v, exc=ValueError):
        args = list(ok)
        args[i] = v
        with pytest.raises(exc):
            xs.xy_segment(*args)

    bad(3, [1, 3, 4])                        # steps that skip a plane
    bad(3, [4, 5, 6])                        # past the last plane
    bad(3, [0, 1, 2])                        # no plane before the first
    bad(4, 2)                                # dirn
    bad(0, a.float())                        # mixed dtypes
    bad(1, s[:4])                            # S of another shape
    bad(2, i0[:1])                           # I0 of another batch
    bad(5, rt[:2])                           # geometry of another length
    bad(10, out[:2])                         # out of another length
    with pytest.raises(TypeError):
        xs.xy_segment(*(t.half() if torch.is_tensor(t) else t for t in ok))
    meta = [t.to("meta") if torch.is_tensor(t) else t for t in ok]
    with pytest.raises(ValueError):
        xs.xy_segment(*meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,nx,ny", [(5, 37, 29), (2, 260, 260)])
def test_kernel_matches_plain_on_card(cuda, dtype, B, nx, ny):
    """The kernel against the plain version and a loop of the per-plane
    kernel on the card, bit for bit, over every shift pair and both
    directions, on a ragged plane (the carried plane in shared memory)
    and on one whose band does not fit there (in global memory)."""
    gen = torch.Generator().manual_seed(90)
    nz = 9
    mk = lambda *s, lo=0.0, hi=1.0: (lo + (hi - lo) * torch.rand(
        *s, generator=gen, dtype=torch.float64)).to(cuda, dtype)
    alpha = 10.0 ** mk(nz, B, nx, ny, lo=-5.0, hi=2.0)
    S, I0 = mk(nz, B, nx, ny, lo=0.1), mk(B, nx, ny)
    for sxs, sys in SHIFTS:
        for dirn in (1, -1):
            steps = _steps(nz, dirn)
            n = len(steps)
            r, fx, fy = mk(n, B, lo=0.1, hi=3.0), mk(n, B), mk(n, B)
            want = xs.xy_segment_plain(alpha, S, I0, steps, dirn, r, fx, fy,
                                       sxs, sys, torch.empty(n, B, nx, ny,
                                                             dtype=dtype,
                                                             device=cuda))
            got = xs.xy_segment(alpha, S, I0, steps, dirn, r, fx, fy, sxs,
                                sys, torch.empty_like(want))
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            I = I0
            for j, t in enumerate(steps):
                I = xp.xy_plane(alpha[t - dirn], alpha[t], S[t - dirn], S[t],
                                I, r[j], fx[j], fy[j], sxs, sys)
                assert torch.equal(got[j], I)
