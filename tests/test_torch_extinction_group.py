"""A mirror group's extinction stack (physics/extinction.py
alpha_tot_group) against the per-angle extinction and the JAX package.

alpha_tot_group makes the extinction of every angle of a mirror group
(solvers/sweep_regular.py group_plans) for a lambda chunk in one call,
from the velocity field, each angle's block flipped into the group's
canonical quadrant of the stack (nz, P B, nx, ny) that
sweep_group_J_stack sweeps; on the card it is one launch of
csrc/extinction.cu, on the CPU its plain version.  Here, from seeded
numpy inputs: the plain version equals the flipped concatenation of the
per-angle alpha_tot_plain bit for bit (ul7n12's groups, one angle and
four, per-cell gamma and damping rows, with and without the continuum,
float64 and float32); the stack against the JAX package's
_alpha_tot_g_t / _alpha_tot per angle, flipped with numpy, at float64
rtol 1e-12 and float32 rtol 2e-5; the regular engine's grouped J chunk,
which now takes this path, against the JAX engine's compute_J; and the
wrapper's refusals.  The kernel itself is held against the plain version
on the card by the test marked cuda (and by chip_smoke.py phase 2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voronoirt_tpu as jpkg
from voronoirt_tpu.engine import RegularEngine as JRegularEngine
from voronoirt_tpu.engine import lambda_iter as jli
from voronoirt_tpu.physics import atom as j_atom
from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine
from voronoirt_tpu_torch.engine import lambda_iter as tli
from voronoirt_tpu_torch.physics import atom as t_atom
from voronoirt_tpu_torch.physics import extinction as ex
from voronoirt_tpu_torch.quadrature import get_quadrature
from voronoirt_tpu_torch.solvers import sweep_regular as sr
from voronoirt_tpu_torch.solvers.sweep_regular import flip_field, group_plans

TOL = {np.float64: dict(rtol=1e-12, atol=0.0),
       np.float32: dict(rtol=2e-5, atol=0.0)}
CELLS = (4, 5, 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _groups(cells=CELLS):
    """ul7n12's mirror groups on a grid of `cells`, as (ks, flips):
    groups of 4 and 2 angles at nz = 4."""
    atmos = synthetic_atmosphere(*cells)
    quad = get_quadrature("ul7n12")
    return [([quad.k[i] for i, _, _ in g], [f for _, _, f in g])
            for g in group_plans(quad.k, quad.is_up, np.asarray(atmos.z),
                                 atmos.dx, atmos.dy, max_group=4)]


def _case(dtype, cells=CELLS, seed=11, nlam=(5, 3)):
    """Both packages' Ly-alpha line on one temperature field (the
    Doppler widths shared, so both compute the same v) and the per-cell
    inputs of a group, velocity (cells, 3) among them, as numpy."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(4e3, 2e4, cells).astype(dtype)
    jline = j_atom.lyman_alpha_line(*nlam, jnp.asarray(T))
    tline = dataclasses.replace(
        t_atom.lyman_alpha_line(*nlam, torch.from_numpy(T)),
        dlamD=_t(np.asarray(jline.dlamD)))
    n_l = 10.0 ** rng.uniform(14, 18, cells)
    pops = np.stack([n_l, n_l * 10.0 ** rng.uniform(-9, -6, cells),
                     10.0 ** rng.uniform(14, 18, cells)], -1)
    fields = dict(velocity=rng.uniform(-3e4, 3e4, cells + (3,)),
                  populations=pops, a_cont=10.0 ** rng.uniform(-9, -5, cells),
                  g_cell=10.0 ** rng.uniform(8, 11, cells))
    return jline, tline, {k: v.astype(dtype) for k, v in fields.items()}


def _damping(tline, f, lam, how):
    """The damping keyword of one call: the per-cell gamma, or the
    chunk's rows made from it as the engine makes them."""
    g = _t(f["g_cell"])
    if how == "g_cell":
        return dict(g_cell=g)
    return dict(damp=tli.damping(g[None], lam.reshape(-1, 1, 1, 1),
                                 tline.dlamD[None]).contiguous())


@pytest.fixture(autouse=True)
def _counters():
    ex.LAUNCHES = ex.GROUP_LAUNCHES = 0
    yield
    # the CPU takes the plain versions: no kernel launch is counted
    assert ex.LAUNCHES == 0 and ex.GROUP_LAUNCHES == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("damping", ["g_cell", "rows"])
@pytest.mark.parametrize("cont", [True, False])
@pytest.mark.parametrize("group", ["one angle", "first", "second"])
def test_group_equals_flipped_per_angle(group, cont, damping, dtype):
    """alpha_tot_group (the wrapper, here its plain version) equals the
    per-angle alpha_tot_plain of v . (-k) flipped by flip_field and
    concatenated along the batch axis, bit for bit: one angle (the first
    group's first, with its flips), a group of four and one of two."""
    groups = _groups()
    ks, flips = {"one angle": (groups[0][0][:1], groups[0][1][:1]),
                 "first": groups[0], "second": groups[1]}[group]
    assert len(ks) == {"one angle": 1, "first": 4, "second": 2}[group]
    _, tline, f = _case(dtype)
    lam = _t(tline.lam[1:6].astype(dtype))
    vel, pops = _t(f["velocity"]), _t(f["populations"])
    a_c = _t(f["a_cont"]) if cont else None
    kw = _damping(tline, f, lam, damping)
    want = torch.cat([flip_field(ex.alpha_tot_plain(
        tline, lam, t_atom.line_of_sight_velocity(vel, -np.asarray(k)),
        pops, a_c, **kw), *fl) for k, fl in zip(ks, flips)], dim=1)
    plain = ex.alpha_tot_group_plain(tline, lam, vel, ks, flips, pops, a_c,
                                     **kw)
    got = ex.alpha_tot_group(tline, lam, vel, ks, flips, pops, a_c, **kw)
    assert got.shape == (CELLS[0], len(ks) * 5) + CELLS[1:]
    assert got.dtype == lam.dtype and got.is_contiguous()
    assert torch.equal(plain, want) and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("damping", ["g_cell", "rows"])
@pytest.mark.parametrize("rows", [slice(0, 4), slice(2, 11)])
def test_group_vs_jax(rows, damping, dtype):
    """The stack against the JAX package's per-angle extinction program
    (_alpha_tot_g_t, or _alpha_tot with the damping rows), each angle's
    result flipped with numpy, at the extinction's bars."""
    jline, tline, f = _case(dtype)
    lam = jline.lam[rows].astype(dtype)
    for ks, flips in _groups():
        blocks = []
        for k, (fx, fy, fz) in zip(ks, flips):
            # in the working dtype, as the port takes it
            v_los = np.asarray(j_atom.line_of_sight_velocity(
                jnp.asarray(f["velocity"]), -np.asarray(k))).astype(dtype)
            if damping == "g_cell":
                a = jli._alpha_tot_g_t(jline, jnp.asarray(lam), f["g_cell"],
                                       v_los, f["populations"], f["a_cont"])
            else:
                damp = jli._damping_chunk(jline, f["g_cell"], lam)
                a = jnp.swapaxes(jli._alpha_tot(
                    jline, jnp.asarray(lam), damp, v_los, f["populations"],
                    f["a_cont"]), 0, 1)
            a = np.asarray(a)
            axes = [ax for ax, on in ((0, fz), (2, fx), (3, fy)) if on]
            blocks.append(np.flip(a, axes) if axes else a)
        want = np.concatenate(blocks, axis=1)
        kw = (dict(g_cell=_t(f["g_cell"])) if damping == "g_cell" else dict(
            damp=_t(np.asarray(jli._damping_chunk(jline, f["g_cell"], lam)))))
        got = ex.alpha_tot_group(tline, _t(lam), _t(f["velocity"]), ks,
                                 flips, _t(f["populations"]),
                                 _t(f["a_cont"]), **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stack_sweep_equals_list_sweep(dtype):
    """sweep_group_J_stack on alpha_tot_group's stack equals
    sweep_group_J on the per-angle extinctions, which it flips and
    concatenates itself, bit for bit, for each ul7n12 group."""
    atmos = synthetic_atmosphere(*CELLS)
    quad = get_quadrature("ul7n12")
    _, tline, f = _case(dtype)
    lam = _t(tline.lam[2:6].astype(dtype))
    rng = np.random.default_rng(5)
    S = _t(rng.uniform(0.1, 1.0, (CELLS[0], 4) + CELLS[1:]).astype(dtype))
    vel, pops = _t(f["velocity"]), _t(f["populations"])
    kw = dict(g_cell=_t(f["g_cell"]))
    for g in group_plans(quad.k, quad.is_up, np.asarray(atmos.z), atmos.dx,
                         atmos.dy, max_group=4):
        ks = [quad.k[i] for i, _, _ in g]
        flips = tuple(fl for _, _, fl in g)
        plans = tuple(p for _, p, _ in g)
        I0 = [_t(rng.uniform(0.0, 1.0, (4,) + CELLS[1:]).astype(dtype))
              for _ in g]
        w = [float(quad.weights[i]) for i, _, _ in g]
        a_list = [ex.alpha_tot(tline, lam, t_atom.line_of_sight_velocity(
            vel, -np.asarray(k)), pops, _t(f["a_cont"]), **kw) for k in ks]
        want = sr.sweep_group_J(plans, S, a_list, I0, w, flips=flips)
        got = sr.sweep_group_J_stack(plans, S, ex.alpha_tot_group(
            tline, lam, vel, ks, flips, pops, _t(f["a_cont"]), **kw), I0, w,
            flips=flips)
        assert torch.equal(got, want)


def _engines(quadrature):
    atmos = synthetic_atmosphere(nz=6, nx=5, ny=4, seed=3)
    T = np.asarray(atmos.temperature)
    jeng = JRegularEngine(atmos, j_atom.lyman_alpha_line(5, 3, jnp.asarray(T)),
                          jpkg.Config(nlam_bb=5, nlam_bf=3,
                                      quadrature=quadrature, lambda_chunk=4))
    teng = RegularEngine(atmos, t_atom.lyman_alpha_line(5, 3, _t(T)),
                         Config(nlam_bb=5, nlam_bf=3, quadrature=quadrature,
                                lambda_chunk=4))
    return jeng, teng


def test_J_chunk_grouped_vs_jax(monkeypatch):
    """The regular engine's compute_J, whose grouped chunks now make
    each group's stack with one alpha_tot_group call and sweep it
    through sweep_group_J_stack, against the JAX engine's compute_J at
    rtol 1e-8, the bar tests/test_torch_engine.py holds J to; one
    alpha_tot_group call a group of two or more and lambda chunk, and
    alpha_tot only for the singleton groups."""
    jeng, teng = _engines("ul7n12")
    calls = {"alpha_tot_group": 0, "alpha_tot": 0}
    for name in calls:
        fn = getattr(tli, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tli, name, counted)
    want = np.asarray(jeng.compute_J(jeng.B0, jeng.lte))
    got = teng.compute_J(teng.B0, teng.lte).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0)
    sizes = [len(g) for g in teng.plan_groups]
    n_chunks = 3        # 11 wavelengths in chunks of 4
    assert calls == {"alpha_tot_group": n_chunks * sum(s > 1 for s in sizes),
                     "alpha_tot": n_chunks * sum(s == 1 for s in sizes)}
    assert calls["alpha_tot_group"] > 0


def _ok_args():
    _, tline, f = _case(np.float64)
    lam = _t(tline.lam[:3])
    ks, flips = _groups()[0]
    return (tline, lam, _t(f["velocity"]), ks, flips, _t(f["populations"]),
            _t(f["a_cont"]), _t(f["g_cell"]))


def _bad_group(case):
    line, lam, vel, ks, flips, pops, a_c, g = _ok_args()
    call = ex.alpha_tot_group
    return {
        "fewer flips than ks": lambda: call(line, lam, vel, ks, flips[:3],
                                            pops, a_c, g_cell=g),
        "no angle": lambda: call(line, lam, vel, [], [], pops, a_c,
                                 g_cell=g),
        "more angles than a launch takes": lambda: call(
            line, lam, vel, ks * 3, flips * 3, pops, a_c, g_cell=g),
        "a flip pair": lambda: call(line, lam, vel, ks,
                                    [fl[:2] for fl in flips], pops, a_c,
                                    g_cell=g),
        "a k of two components": lambda: call(
            line, lam, vel, [k[:2] for k in ks], flips, pops, a_c, g_cell=g),
        "velocity without components": lambda: call(
            line, lam, vel[..., 0], ks, flips, pops, a_c, g_cell=g),
        "velocity of two components": lambda: call(
            line, lam, vel[..., :2], ks, flips, pops, a_c, g_cell=g),
        "velocity of another grid": lambda: call(
            line, lam, vel[:2], ks, flips, pops, a_c, g_cell=g),
        "site-major velocity": lambda: call(
            line, lam, vel.reshape(-1, 3), ks, flips, pops, a_c, g_cell=g),
        "non-contiguous velocity": lambda: call(
            line, lam, vel.transpose(0, 1).contiguous().transpose(0, 1), ks,
            flips, pops, a_c, g_cell=g),
        "non-contiguous populations": lambda: call(
            line, lam, vel, ks, flips,
            pops.transpose(0, 1).contiguous().transpose(0, 1), a_c,
            g_cell=g),
        "both damping": lambda: call(line, lam, vel, ks, flips, pops, a_c,
                                     g_cell=g, damp=torch.ones((3,) + tuple(
                                         g.shape), dtype=g.dtype)),
        "mixed dtypes": lambda: call(line, lam, vel.float(), ks, flips, pops,
                                     a_c, g_cell=g),
        "mixed devices": lambda: call(line, lam, vel.to("meta"), ks, flips,
                                      pops, a_c, g_cell=g),
        "another device": lambda: call(
            dataclasses.replace(line, dlamD=line.dlamD.to("meta")),
            lam.to("meta"), vel.to("meta"), ks, flips, pops.to("meta"),
            a_c.to("meta"), g_cell=g.to("meta")),
    }[case]


@pytest.mark.parametrize("case", [
    "fewer flips than ks", "no angle", "more angles than a launch takes",
    "a flip pair", "a k of two components", "velocity without components",
    "velocity of two components", "velocity of another grid",
    "site-major velocity", "non-contiguous velocity",
    "non-contiguous populations", "both damping", "mixed dtypes",
    "mixed devices", "another device"])
def test_group_refuses(case):
    """Mismatched angle lists, a velocity of the wrong shape, inputs that
    are not contiguous, mixed dtypes and devices, and a device with no
    kernel raise before any kernel or plain version runs."""
    with pytest.raises(ValueError):
        _bad_group(case)()


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cells", [(5, 37, 29), (6, 64, 32)])
def test_group_kernel_matches_plain_on_card(cuda, dtype, cells):
    """The kernel against its plain version on the card, bit for bit,
    for every ul7n12 group of the grid and one angle, with the per-cell
    gamma and with damping rows, with and without the continuum, at a
    chunk of 13 wavelengths and of one."""
    _, tline, f = _case(dtype, cells)
    d = {k: _t(v).to(cuda) for k, v in f.items()}
    line = dataclasses.replace(tline, dlamD=tline.dlamD.to(cuda))
    lam = line.lam_tensor().to(cuda, d["velocity"].dtype)
    groups = _groups(cells)
    groups.append((groups[0][0][:1], groups[0][1][:1]))
    for rows in (slice(0, 11), slice(5, 6)):
        lam_r = lam[rows]
        damp = tli.damping(d["g_cell"][None], lam_r.reshape(-1, 1, 1, 1),
                           line.dlamD[None]).contiguous()
        for ks, flips in groups:
            for kw in (dict(g_cell=d["g_cell"]), dict(damp=damp)):
                for a_c in (d["a_cont"], None):
                    args = (line, lam_r, d["velocity"], ks, flips,
                            d["populations"], a_c)
                    got = ex.alpha_tot_group(*args, **kw)
                    want = ex.alpha_tot_group_plain(*args, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want)
    ex.LAUNCHES = ex.GROUP_LAUNCHES = 0
