"""The sweep kernels' plain versions against the JAX package.

voronoirt_tpu_torch.solvers.xy_plane / march_plane hold the CUDA
kernels (csrc/) and their plain PyTorch versions.  Here, on the CPU, the
plain versions are held against the Pallas kernels they replace (run in
interpret mode, float32, the tier of tests/test_pallas_march.py) and
against the JAX XLA steps with per-element geometry (float64, 1e-12);
the march's split into march_coeffs and march_chain is held bit for bit
to the march-order formulation it replaced.  The kernels themselves are
held against the plain versions on the card by the tests marked cuda
(and by chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voronoirt_tpu.solvers import sweep_regular as jsr
from voronoirt_tpu.solvers.pallas_march import march_plane_pallas
from voronoirt_tpu.solvers.pallas_xy import xy_plane_pallas
from voronoirt_tpu_torch.solvers import march_plane as mp
from voronoirt_tpu_torch.solvers import xy_plane as xp
from voronoirt_tpu_torch.solvers.formal import linear_weights

F32 = dict(rtol=2e-5, atol=1e-6)
F64 = dict(rtol=1e-12, atol=0)


def _planes(rng, B, nx, ny, dtype, lo=0.1, hi=2.0):
    return [rng.uniform(lo, hi, (B, nx, ny)).astype(dtype) for _ in range(5)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plan(sign_x=1, sign_y=1, sxs=0, sys=0, r_x=0.0, r_y=0.0, fy_line=0.0,
          fx_line=0.0):
    return jsr.RegularPlan(k=(0, 0, 0), up=True, sign_x=sign_x,
                           sign_y=sign_y, sxs=sxs, sys=sys, r_x=r_x, r_y=r_y,
                           fy_line=fy_line, fx_line=fx_line, segments=())


@pytest.mark.parametrize("sxs,sys,fx,fy", [(0, 0, 0.3, 0.8), (-1, 0, 0.9, 0.2),
                                           (0, -1, 0.0, 1.0),
                                           (-1, -1, 0.5, 0.5)])
def test_xy_plain_matches_pallas(sxs, sys, fx, fy):
    rng = np.random.default_rng(1)
    B = 4
    a_p, a_c, s_p, s_c, i_p = _planes(rng, B, 8, 8, np.float32)
    want = np.asarray(xy_plane_pallas(*map(jnp.asarray, (a_p, a_c, s_p, s_c,
                                                          i_p)),
                                      1.3, sxs + fx, sys + fy, b_block=2,
                                      interpret=True))
    geom = [torch.full((B,), v, dtype=torch.float32) for v in (1.3, fx, fy)]
    got = xp.xy_plane(*_t(a_p, a_c, s_p, s_c, i_p), *geom, sxs, sys)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("sxs,sys", [(0, 0), (-1, 0), (0, -1), (-1, -1)])
def test_xy_plain_matches_xla_per_element(sxs, sys):
    """Per-element r, fx, fy, as the JAX batched group sweep feeds
    _xy_step ((B, 1, 1) geometry), over a ragged plane, float64; dtau
    spans every weight branch."""
    rng = np.random.default_rng(2)
    B, nx, ny = 6, 7, 5
    a_p, a_c = (10.0 ** rng.uniform(-5, 2, (B, nx, ny)) for _ in range(2))
    s_p, s_c, i_p = (rng.uniform(0.1, 1.0, (B, nx, ny)) for _ in range(3))
    r = 10.0 ** rng.uniform(-1, 1, B)
    fx, fy = rng.uniform(0, 1, B), rng.uniform(0, 1, B)
    fx[0], fy[1] = 0.0, 1.0
    _, want = jsr._xy_step(_plan(sxs=sxs, sys=sys),
                           jnp.asarray(i_p),
                           (jnp.asarray(a_c), jnp.asarray(a_p),
                            jnp.asarray(s_c), jnp.asarray(s_p),
                            jnp.asarray(r[:, None, None]),
                            jnp.asarray(fx[:, None, None]),
                            jnp.asarray(fy[:, None, None]), 0.0))
    got = xp.xy_plane(*_t(a_p, a_c, s_p, s_c, i_p, r, fx, fy), sxs, sys)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


@pytest.mark.parametrize("sign,s_base,f_line,centre_prev",
                         [(1, 0, 0.3, False), (-1, -1, 0.7, False),
                          (1, -1, 0.0, True), (-1, 0, 1.0, False)])
def test_march_plain_matches_pallas(sign, s_base, f_line, centre_prev):
    """The tests/test_pallas_march.py parametrisations (yz case)."""
    rng = np.random.default_rng(0)
    B, nx, ny = 4, 8, 8
    r, w_cur = 1.7, 0.35
    a_p = rng.uniform(0.0, 2.0, (B, nx, ny)).astype(np.float32)
    a_c = rng.uniform(0.0, 2.0, (B, nx, ny)).astype(np.float32)
    s_p = rng.uniform(0.1, 1.0, (B, nx, ny)).astype(np.float32)
    s_c = rng.uniform(0.1, 1.0, (B, nx, ny)).astype(np.float32)
    i_p = rng.uniform(0.0, 1.0, (B, nx, ny)).astype(np.float32)
    t = lambda A: np.transpose(A, (1, 0, 2))
    want = np.asarray(march_plane_pallas(
        *(jnp.asarray(t(a)) for a in (a_p, a_c, s_p, s_c, i_p)), w_cur,
        sign=sign, s_base=s_base, f_line=f_line, r=r, n_sweeps=3,
        centre_prev=centre_prev, b_block=2, interpret=True))
    geom = [torch.full((B,), v, dtype=torch.float32)
            for v in (r, f_line, w_cur, float(centre_prev))]
    got = mp.march_plane(*_t(a_p, a_c, s_p, s_c, i_p), *geom,
                         march_axis="x", sign=sign, s_base=s_base,
                         n_sweeps=3)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (1, 0, 2)),
                               **F32)


@pytest.mark.parametrize("case", ["yz", "xz"])
@pytest.mark.parametrize("sign,s_base", [(1, 0), (1, -1), (-1, 0), (-1, -1)])
def test_march_plain_matches_xla_per_element(case, sign, s_base):
    """Per-element r, f_line, w_cur and a mixed 0/1 c_prev, as the JAX
    batched group sweep passes them to _march_plane (geom), float64 over
    a ragged plane."""
    rng = np.random.default_rng(3)
    B, nx, ny = 6, 7, 5
    a_p, a_c = (10.0 ** rng.uniform(-5, 2, (B, nx, ny)) for _ in range(2))
    s_p, s_c, i_p = (rng.uniform(0.1, 1.0, (B, nx, ny)) for _ in range(3))
    r = 10.0 ** rng.uniform(-1, 1, B)
    f_line, w_cur = rng.uniform(0, 1, B), rng.uniform(0, 1, B)
    f_line[0] = 0.0
    c_prev = (np.arange(B) % 2).astype(np.float64)
    if case == "yz":
        plan = _plan(sign_x=sign, sys=s_base)
    else:
        plan = _plan(sign_y=sign, sxs=s_base)
    geom = {"f_line": jnp.asarray(f_line[:, None]),
            "r": jnp.asarray(r[:, None]),
            "c_prev": jnp.asarray(c_prev[:, None, None])}
    want = jsr._march_plane(plan, case, 3, jnp.asarray(w_cur[:, None]),
                            jnp.asarray(i_p), jnp.asarray(a_c),
                            jnp.asarray(a_p), jnp.asarray(s_c),
                            jnp.asarray(s_p), "cur", geom=geom)
    got = mp.march_plane(*_t(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur,
                             c_prev),
                         march_axis="x" if case == "yz" else "y", sign=sign,
                         s_base=s_base, n_sweeps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def _march_plane_by_march_order(alpha_p, alpha_c, S_p, S_c, I_p, r, f_line,
                                w_cur, c_prev, *, march_axis, sign, s_base,
                                n_sweeps):
    """The march as one function, columns gathered in march order, as
    sweep_regular._march_step computes it (the plain version before the
    split into march_coeffs and march_chain)."""
    ax = -2 if march_axis == "x" else -1
    N = alpha_c.shape[ax]
    order = np.arange(N) if sign > 0 else np.arange(N - 1, -1, -1)
    upwind = torch.as_tensor((order + sign) % N)
    inv = torch.as_tensor(np.argsort(order))
    order = torch.as_tensor(order)

    def take(A, idx):
        # (B, Nx, Ny) -> (N, B, M), march axis leading
        return torch.movedim(torch.index_select(A, ax, idx), ax, 0)

    def LI(A):
        return mp._line_interp(A, s_base, f_line.reshape(-1, 1))

    cp = c_prev.reshape(-1, 1, 1)
    wc = w_cur.reshape(-1, 1)
    wp = 1.0 - wc
    alpha_c0 = take(cp * alpha_p + (1.0 - cp) * alpha_c, order)
    S_c0 = take(cp * S_p + (1.0 - cp) * S_c, order)
    a_up = wp * LI(take(alpha_p, upwind)) + wc * LI(take(alpha_c, upwind))
    dtau = r.reshape(-1, 1) * (alpha_c0 + a_up) * 0.5
    aw, bw, ew = linear_weights(dtau)
    s_up = wp * LI(take(S_p, upwind)) + wc * LI(take(S_c, upwind))
    const = ew * (wp * LI(take(I_p, upwind))) + aw * s_up + bw * S_c0
    coeff = ew * wc
    lines = torch.empty_like(const)
    buf = torch.zeros_like(alpha_c0[0])
    for _ in range(n_sweeps):
        for j in range(N):
            buf = coeff[j] * LI(buf) + const[j]
            lines[j] = buf
    lines = torch.index_select(lines, 0, inv)
    return torch.movedim(lines, 0, ax).contiguous()


def _march_inputs(rng, B, nx, ny):
    """Planes and per-element geometry, float64 tensors; extinction
    over 7 decades, so dtau crosses every weight branch."""
    a_p, a_c = (10.0 ** rng.uniform(-5, 2, (B, nx, ny)) for _ in range(2))
    s_p, s_c, i_p = (rng.uniform(0.1, 1.0, (B, nx, ny)) for _ in range(3))
    r = 10.0 ** rng.uniform(-1, 1, B)
    f_line, w_cur = rng.uniform(0, 1, B), rng.uniform(0, 1, B)
    f_line[0], f_line[1] = 0.0, 1.0
    c_prev = (np.arange(B) % 2).astype(np.float64)
    return _t(a_p, a_c, s_p, s_c, i_p, r, f_line, w_cur, c_prev)


@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 40, 33)])
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("sign,s_base", [(1, 0), (1, -1), (-1, 0), (-1, -1)])
def test_split_march_equals_march_order(shape, axis, sign, s_base):
    """march_coeffs_plain then march_chain_plain == the march-order
    formulation, bit for bit, float64, over both axes, signs and stencil
    shifts, on lines shorter and longer than a warp."""
    args = _march_inputs(np.random.default_rng(5), *shape)
    st = dict(march_axis=axis, sign=sign, s_base=s_base)
    scratch = mp.march_coeffs_plain(*args, **st)
    line = shape[2] if axis == "x" else shape[1]
    got = mp.march_chain_plain(scratch, args[6], line, n_sweeps=3, **st)
    want = _march_plane_by_march_order(*args, n_sweeps=3, **st)
    assert torch.equal(got, want)
    assert torch.equal(mp.march_plane(*args, n_sweeps=3, **st), want)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_scratch_layout(axis):
    """The scratch is (B, N, MP, 2), as csrc/march_plane.cu documents:
    batch element, column along the march, point along the line padded
    to MP = 32 * PPL with zero pairs, then (coeff, const); coeff is
    exp(-dtau) w_cur at every point."""
    B, nx, ny = 3, 40, 33
    args = _march_inputs(np.random.default_rng(6), B, nx, ny)
    st = dict(march_axis=axis, sign=-1, s_base=0)
    scratch = mp.march_coeffs(*args, **st)
    N, M = (nx, ny) if axis == "x" else (ny, nx)
    assert mp.line_pad(M) == 64
    assert [mp.line_pad(m) for m in (1, 32, 33, 256, 257, 2048)] == \
        [32, 32, 64, 256, 512, 2048]
    assert tuple(scratch.shape) == (B, N, 64, 2)
    assert torch.all(scratch[:, :, M:] == 0)
    coeff = scratch[:, :, :M, 0]
    assert torch.all((coeff >= 0) & (coeff <= args[7].reshape(-1, 1, 1)))
    # column c of the scratch is the march's column c, whatever the sign
    one = mp.march_chain(scratch, args[6], M, n_sweeps=1, **st)
    col = one[:, -1] if axis == "x" else one[:, :, -1]
    buf = torch.zeros(B, M, dtype=torch.float64)
    f = args[6].reshape(-1, 1)
    want = scratch[:, -1, :M, 0] * mp._line_interp(buf, 0, f) \
        + scratch[:, -1, :M, 1]
    assert torch.equal(col, want)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(4)
    planes = _t(*_planes(rng, 2, 4, 4, np.float64))
    geom = [torch.full((2,), 0.5, dtype=torch.float64) for _ in range(4)]
    counts = lambda: (xp.LAUNCHES, mp.LAUNCHES, mp.COEFFS_LAUNCHES,
                      mp.CHAIN_LAUNCHES)
    before = counts()
    xp.xy_plane(*planes, *geom[:3], 0, -1)
    mp.march_plane(*planes, *geom, march_axis="y", sign=-1, s_base=0,
                   n_sweeps=3)
    scratch = mp.march_coeffs(*planes, *geom, march_axis="x", sign=1,
                              s_base=-1)
    mp.march_chain(scratch, geom[1], 4, march_axis="x", sign=1, s_base=-1,
                   n_sweeps=2)
    assert counts() == before


def test_wrappers_check_their_inputs():
    planes = [torch.ones(2, 4, 4, dtype=torch.float64) for _ in range(5)]
    geom = [torch.ones(2, dtype=torch.float64) for _ in range(4)]
    with pytest.raises(ValueError):
        xp.xy_plane(*planes, torch.ones(3, dtype=torch.float64), *geom[1:3],
                    0, 0)
    with pytest.raises(ValueError):
        mp.march_plane(*planes[:4], planes[4].float(), *geom,
                       march_axis="x", sign=1, s_base=0, n_sweeps=3)
    with pytest.raises(ValueError):
        mp.march_plane(*planes, *geom, march_axis="z", sign=1, s_base=0,
                       n_sweeps=3)
    scratch = mp.march_coeffs(*planes, *geom, march_axis="x", sign=1,
                              s_base=0)
    with pytest.raises(ValueError):     # a line the scratch does not hold
        mp.march_chain(scratch, geom[1], 40, march_axis="x", sign=1,
                       s_base=0, n_sweeps=3)
    with pytest.raises(ValueError):
        mp.march_chain(scratch[..., 0], geom[1], 4, march_axis="x", sign=1,
                       s_base=0, n_sweeps=3)
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError):
        xp.xy_plane(*meta, *(g.to("meta") for g in geom[:3]), 0, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64),
                                       (torch.float32, F32)])
def test_kernels_match_plain_on_card(cuda, dtype, tol):
    gen = torch.Generator().manual_seed(9)
    B, nx, ny = 5, 37, 29
    mk = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64).to(
        cuda, dtype)
    planes = [mk(B, nx, ny) + 0.1 for _ in range(5)]
    r, f1, f2, w = (mk(B) for _ in range(4))
    c_prev = (torch.arange(B, device=cuda) % 2).to(dtype)
    for sxs in (0, -1):
        for sys in (0, -1):
            torch.testing.assert_close(
                xp.xy_plane(*planes, r, f1, f2, sxs, sys),
                xp.xy_plane_plain(*planes, r, f1, f2, sxs, sys), **tol)
    for axis in ("x", "y"):
        for sign in (1, -1):
            for s_base in (0, -1):
                st = dict(march_axis=axis, sign=sign, s_base=s_base)
                scratch = mp.march_coeffs(*planes, r, f1, w, c_prev, **st)
                torch.testing.assert_close(
                    scratch,
                    mp.march_coeffs_plain(*planes, r, f1, w, c_prev, **st),
                    **tol)
                line = ny if axis == "x" else nx
                torch.testing.assert_close(
                    mp.march_chain(scratch, f1, line, n_sweeps=3, **st),
                    mp.march_chain_plain(scratch, f1, line, n_sweeps=3,
                                         **st), **tol)
                torch.testing.assert_close(
                    mp.march_plane(*planes, r, f1, w, c_prev, n_sweeps=3,
                                   **st),
                    mp.march_plane_plain(*planes, r, f1, w, c_prev,
                                         n_sweeps=3, **st), **tol)
    torch.cuda.synchronize()
