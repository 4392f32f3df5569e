"""A mirror group's J emit (solvers/group_emit.py: G1 group_emit, G2
group_stack, G3 group_fold) against the port's former eager code and the
JAX package.

G1 reduces a piece of swept planes over the group's angles into the J
halves, G2 makes the group's flipped S and I0 stacks, G3 adds J_up +
flip_z(J_dn) into the lambda chunk's J; on the card each is one launch
of csrc/group_emit.cu, on the CPU its plain version.  Here, from seeded
numpy inputs in float64, at small sizes (a few z-planes, 8-16 x 8-16
planes, groups of 2 and 4 angles with mixed x / y / z flips):

  (a) sweep_batched_J and sweep_group_J / sweep_group_J_stack against
      the JAX package's sweep_batched_J / sweep_group_J at rtol 1e-12
      (tests/test_torch_sweep.py's bar);
  (b) the regular engine's _J_chunk_grouped and one iterate_streamed
      against the JAX engine's, J at rtol 1e-8 (the bar
      tests/test_torch_engine.py holds J to), S and the populations at
      the same;
  (c) emission a piece against emission a plane, bit for bit;
  (d) the plain G1-G3 against the eager code they replace (a flip, a
      multiply and an add_ an angle a plane into zeroed J halves; the
      torch.cat of flip_field copies; J_up.add_(flip(J_dn)) then
      Jc.add_(transpose)), bit for bit;
  (e) the plain path's calls a sweep: one group_emit a K2 plane and an
      xy piece and one for the boundary, each plane emitted once;
  (f) the wrappers' refusals, and, marked cuda (skipped without a card),
      each kernel against its plain version in float64 and float32, bit
      for bit.

The JAX package is imported inside the tests that use it, so the cuda
tests run where only the port is installed.
"""

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine
from voronoirt_tpu_torch.physics import atom as t_atom
from voronoirt_tpu_torch.solvers import group_emit as ge
from voronoirt_tpu_torch.solvers import sweep_regular as sr
from voronoirt_tpu_torch.solvers import xy_segment as xs

RTOL = 1e-12            # tests/test_torch_sweep.py's bar against JAX
RTOL_ENGINE = 1e-8      # tests/test_torch_engine.py's bar on J


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


# (theta up, theta down), phi: groups whose canonical plans run xy
# segments only (steep), a yz march (grazing in x) and an xz march
GROUP_ANGLES = {"xy": ((100.0, 80.0), 30.0),
                "yz": ((94.0, 86.0), 20.0),
                "xz": ((95.0, 85.0), 75.0)}


def _group(case, max_group=None, nz=10, nx=12, ny=8):
    """A mirror group of `case`: the up and down directions at phi and
    phi + 180, merged into one canonical plan (flips mixed in x, y and
    z); max_group=2 splits it into pairs.  Returns (z, dx, dy, ks, ups,
    groups)."""
    (th_up, th_dn), phi = GROUP_ANGLES[case]
    z = np.linspace(0.0, 1.0, nz)
    dx, dy = 1.0 / nx, 1.0 / ny
    ks = [kvec(th_up, phi), kvec(th_dn, phi), kvec(th_up, phi + 180.0),
          kvec(th_dn, phi + 180.0)]
    ups = [True, False, True, False]
    groups = [g for g in sr.group_plans(ks, ups, z, dx, dy,
                                        max_group=max_group) if len(g) > 1]
    assert groups
    return z, dx, dy, ks, ups, groups


def _fields(nz, nx, ny, B, P, seed):
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.1, 1.0, (nz, B, nx, ny))
    a_list = [10.0 ** rng.uniform(-2, 1, (nz, B, nx, ny)) for _ in range(P)]
    I0_up = rng.uniform(0.5, 1.0, (B, nx, ny))
    w = rng.uniform(0.05, 0.1, P)
    return S, a_list, I0_up, np.zeros((B, nx, ny)), w


def _np_flip(A, fx, fy, fz=False):
    axes = [a for a, on in ((0, fz), (-2, fx), (-1, fy)) if on]
    return np.flip(A, axes) if axes else A


def _group_inputs(g, nz, nx, ny, B=3, seed=7):
    plans = tuple(p for (_, p, _) in g)
    flips = tuple(f for (_, _, f) in g)
    S, a_list, I0_up, I0_dn, w = _fields(nz, nx, ny, B, len(g), seed)
    I0_list = [I0_dn if f[2] else I0_up for f in flips]
    return plans, flips, S, a_list, I0_list, w


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- (a) vs JAX

@pytest.mark.parametrize("case", list(GROUP_ANGLES))
def test_sweep_batched_J_matches_jax(case):
    """sweep_batched_J's J halves (G1 a piece or a plane) against the
    JAX package's on the same flipped stacks."""
    import jax.numpy as jnp
    from voronoirt_tpu.solvers import sweep_regular as jsr
    nz, nx, ny = 10, 12, 8
    z, dx, dy, ks, ups, groups = _group(case, nz=nz, nx=nx, ny=ny)
    j_groups = [g for g in jsr.group_plans(ks, ups, z, dx, dy) if len(g) > 1]
    for g, jg in zip(groups, j_groups):
        plans, flips, S, a_list, I0_list, w = _group_inputs(g, nz, nx, ny)
        S_b = np.concatenate([_np_flip(S, *f) for f in flips], axis=1)
        a_b = np.concatenate([_np_flip(a, *f) for a, f in
                              zip(a_list, flips)], axis=1)
        I0_b = np.concatenate([_np_flip(i, f[0], f[1]) for i, f in
                               zip(I0_list, flips)], axis=0)
        kw = dict(n_sweeps=3, down_flags=tuple(f[2] for f in flips),
                  unflips=tuple(f[:2] for f in flips))
        want = jsr.sweep_batched_J(tuple(p for (_, p, _) in jg),
                                   jnp.asarray(S_b), jnp.asarray(a_b),
                                   jnp.asarray(I0_b), jnp.asarray(w), **kw)
        got = sr.sweep_batched_J(plans, _t(S_b), _t(a_b), _t(I0_b), w, **kw)
        for half, (a, b) in zip(("J_up", "J_dn"), zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=0, err_msg=half)


@pytest.mark.parametrize("max_group", [None, 2])
@pytest.mark.parametrize("case", list(GROUP_ANGLES))
def test_sweep_group_J_matches_jax(case, max_group):
    """sweep_group_J, sweep_group_J_stack and sweep_group_J_stack into a
    chunk's J (G2 stacks, G3 fold) against the JAX package's
    sweep_group_J, groups of 4 and of 2 angles."""
    import jax.numpy as jnp
    from voronoirt_tpu.solvers import sweep_regular as jsr
    nz, nx, ny = 9, 8, 16
    z, dx, dy, ks, ups, groups = _group(case, max_group, nz, nx, ny)
    j_groups = [g for g in jsr.group_plans(ks, ups, z, dx, dy,
                                           max_group=max_group)
                if len(g) > 1]
    assert [len(g) for g in groups] == [len(g) for g in j_groups]
    for g, jg in zip(groups, j_groups):
        plans, flips, S, a_list, I0_list, w = _group_inputs(g, nz, nx, ny)
        want = np.asarray(jsr.sweep_group_J(
            tuple(p for (_, p, _) in jg), jnp.asarray(S),
            tuple(map(jnp.asarray, a_list)), tuple(map(jnp.asarray, I0_list)),
            jnp.asarray(w), n_sweeps=3, flips=flips))
        args = (plans, _t(S))
        kw = dict(I0_list=[_t(i) for i in I0_list], w=w, n_sweeps=3,
                  flips=flips)
        got = sr.sweep_group_J(*args, [_t(a) for a in a_list], **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
        a_b = torch.cat([sr.flip_field(_t(a), *f) for a, f in
                         zip(a_list, flips)], dim=1)
        got_stack = sr.sweep_group_J_stack(*args, a_b.clone(), **kw)
        assert torch.equal(got_stack, got)
        Jc0 = _t(np.random.default_rng(3).uniform(0, 1, (3, nz, nx, ny)))
        Jc = sr.sweep_group_J_stack(*args, a_b, out=Jc0.clone(), **kw)
        assert torch.equal(Jc, Jc0 + got.transpose(0, 1))
        np.testing.assert_allclose(Jc.numpy(), Jc0.numpy()
                                   + want.transpose(1, 0, 2, 3), rtol=RTOL,
                                   atol=0)


def test_sweep_group_J_on_a_transposed_S():
    """The S stack is made from the transposed view of a lambda chunk's
    S, as the engine passes it, equal to the contiguous S's."""
    nz, nx, ny = 9, 8, 16
    *_, groups = _group("yz", None, nz, nx, ny)
    plans, flips, S, a_list, I0_list, w = _group_inputs(groups[0], nz, nx,
                                                        ny)
    S_c = _t(S.transpose(1, 0, 2, 3))
    kw = dict(I0_list=[_t(i) for i in I0_list], w=w, flips=flips)
    a = [_t(x) for x in a_list]
    got = sr.sweep_group_J(plans, S_c.transpose(0, 1), a, **kw)
    want = sr.sweep_group_J(plans, _t(S), a, **kw)
    assert torch.equal(got, want)


# ------------------------------------------------------ (b) the engine

def _engines(quadrature="ul7n12", nlam=(5, 3), chunk=4):
    import jax.numpy as jnp
    import voronoirt_tpu as jpkg
    from voronoirt_tpu.engine import RegularEngine as JRegularEngine
    from voronoirt_tpu.physics import atom as j_atom
    atmos = synthetic_atmosphere(nz=7, nx=8, ny=6, seed=5)
    T = np.asarray(atmos.temperature)
    jeng = JRegularEngine(atmos, j_atom.lyman_alpha_line(*nlam,
                                                         jnp.asarray(T)),
                          jpkg.Config(nlam_bb=nlam[0], nlam_bf=nlam[1],
                                      quadrature=quadrature,
                                      lambda_chunk=chunk, stream_rates=True))
    teng = RegularEngine(atmos, t_atom.lyman_alpha_line(*nlam, _t(T)),
                         Config(nlam_bb=nlam[0], nlam_bf=nlam[1],
                                quadrature=quadrature, lambda_chunk=chunk,
                                stream_rates=True))
    return jeng, teng


def test_J_chunk_grouped_vs_jax(monkeypatch):
    """One lambda chunk of J through the engine's grouped path (G2
    stacks, G1 emits, G3 folds into the chunk's J, one group_fold a
    group of two or more) against the JAX engine's _J_chunk_grouped."""
    from voronoirt_tpu.engine import lambda_iter as jli
    jeng, teng = _engines()
    folds = []
    fold = sr.group_fold
    monkeypatch.setattr(sr, "group_fold",
                        lambda *a: folds.append(1) or fold(*a))
    sl = slice(4, 8)
    lam = np.asarray(jeng.line.lam)
    # both engines on the same S and populations (the JAX engine's)
    S, pops = np.asarray(jeng.B0), np.asarray(jeng.lte)
    g_j = jli._gamma_cell(jeng.line, jeng.T, jeng.lte[..., 0]
                          + jeng.lte[..., 1], jeng.ne,
                          jeng.cfg.gamma_natural)
    want = np.asarray(jeng._J_chunk_grouped(jeng.B0[sl], jeng.lte, None,
                                            lam[sl], g_cell=g_j))
    got = teng._J_chunk_grouped(_t(S[sl]), _t(pops), None,
                                teng.block_lam()[sl],
                                g_cell=teng._gamma_cell(_t(pops)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_ENGINE, atol=0)
    assert len(folds) == sum(len(g) > 1 for g in teng.plan_groups) > 0


def test_iterate_streamed_vs_jax():
    """One lambda-streamed iteration (three chunks of up to 4
    wavelengths, each through the grouped J) against the JAX engine's."""
    import jax.numpy as jnp
    jeng, teng = _engines()
    S, pops = np.asarray(jeng.B0), np.asarray(jeng.lte)
    S_j, pops_j, diff_j = jeng.iterate_streamed(jnp.array(S),
                                                jnp.asarray(pops))
    S_t, pops_t, diff_t = teng.iterate_streamed(_t(S), _t(pops))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j),
                               rtol=RTOL_ENGINE, atol=0)
    np.testing.assert_allclose(pops_t.numpy(), np.asarray(pops_j),
                               rtol=RTOL_ENGINE, atol=0)
    np.testing.assert_allclose(float(diff_t), float(diff_j),
                               rtol=RTOL_ENGINE)


# ------------------------------------- (c) a piece against plane by plane

def _emit_plane_by_plane(monkeypatch):
    """Patch sweep_regular's group_emit so that every call emits its
    planes one at a time."""
    emit = ge.group_emit

    def by_plane(planes, steps, *rest):
        for j, t in enumerate(steps):
            emit(planes[j:j + 1], (t,), *rest)

    monkeypatch.setattr(sr, "group_emit", by_plane)


@pytest.mark.parametrize("max_steps", [2, None])
@pytest.mark.parametrize("case", list(GROUP_ANGLES))
def test_piece_equals_plane_by_plane(monkeypatch, case, max_steps):
    """The J halves of a group sweep emitted a piece at a time (pieces
    of max_steps planes, or whole segments) equal those emitted a plane
    at a time, bit for bit."""
    nz, nx, ny = 10, 12, 8
    *_, groups = _group(case, nz=nz, nx=nx, ny=ny)
    plans, flips, S, a_list, I0_list, w = _group_inputs(groups[0], nz, nx,
                                                        ny)
    P, B = len(plans), S.shape[1]
    if max_steps is not None:
        plane = P * B * nx * ny * 8
        monkeypatch.setattr(xs, "PIECE_BYTES", max_steps * plane + 1)
    S_b = torch.cat([sr.flip_field(_t(S), *f) for f in flips], dim=1)
    a_b = torch.cat([sr.flip_field(_t(a), *f) for a, f in
                     zip(a_list, flips)], dim=1)
    I0_b = torch.cat([sr.flip_field(_t(i), *f[:2]) for i, f in
                      zip(I0_list, flips)], dim=0)
    kw = dict(down_flags=tuple(f[2] for f in flips),
              unflips=tuple(f[:2] for f in flips))
    want = sr.sweep_batched_J(plans, S_b, a_b, I0_b, w, **kw)
    _emit_plane_by_plane(monkeypatch)
    got = sr.sweep_batched_J(plans, S_b, a_b, I0_b, w, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------ (d) the plain versions

def _eager_emit(I_plane, t, w, down_flags, unflips, J_up, J_dn):
    """The port's former per-plane emit, into zeroed J halves."""
    B = J_up.shape[1]
    for e in range(len(down_flags)):
        blk = w[e] * sr.flip_field(I_plane[e * B:(e + 1) * B], *unflips[e])
        (J_dn if down_flags[e] else J_up)[t].add_(blk)


# (down flags, unflips): groups of 2, 3 and 4 angles, every class
# mixed, all up, all down
EMIT_GROUPS = [
    ((False, True), ((True, False), (False, True))),
    ((False, False, True), ((False, False), (True, True), (True, False))),
    ((False, True, False, True),
     ((False, False), (True, False), (False, True), (True, True))),
    ((False, False), ((True, True), (False, False))),
    ((True, True, True), ((False, True), (True, False), (True, True))),
]


@pytest.mark.parametrize("dirn", [1, -1])
@pytest.mark.parametrize("flags", EMIT_GROUPS)
def test_plain_emit_equals_eager(flags, dirn):
    """group_emit's plain version on a piece of 4 planes, and on one
    plane, equals the per-plane eager emit bit for bit; a class with no
    angle gets 0, and rows outside the piece are left alone."""
    down, unflips = flags
    P, B, nz, nx, ny = len(down), 3, 8, 9, 7
    rng = np.random.default_rng(P + dirn)
    w = _t(rng.uniform(0.05, 0.3, P))
    planes = _t(rng.uniform(0, 2, (4, P * B, nx, ny)))
    steps = [2 + j for j in range(4)] if dirn == 1 else [6 - j for j in
                                                          range(4)]
    want_up, want_dn = (torch.zeros((nz, B, nx, ny), dtype=torch.float64)
                        for _ in range(2))
    for j, t in enumerate(steps):
        _eager_emit(planes[j], t, w, down, unflips, want_up, want_dn)
    J_up, J_dn = (torch.full((nz, B, nx, ny), -1.0, dtype=torch.float64)
                  for _ in range(2))
    ge.group_emit(planes, steps, w, down, unflips, J_up, J_dn)
    ge.group_emit(planes[:1], [0], w, down, unflips, J_up, J_dn)
    _eager_emit(planes[0], 0, w, down, unflips, want_up, want_dn)
    written = sorted(steps + [0])
    for got, want in ((J_up, want_up), (J_dn, want_dn)):
        assert torch.equal(got[written], want[written])
        others = [t for t in range(nz) if t not in written]
        assert bool((got[others] == -1.0).all())
    if all(down):
        assert not bool(J_up[written].any())
    if not any(down):
        assert not bool(J_dn[written].any())


@pytest.mark.parametrize("flips", [
    ((False, False, False), (True, False, True), (False, True, False),
     (True, True, True)),
    ((True, False, False), (False, True, True))])
def test_plain_stack_equals_cat(flips):
    """group_stack's plain version equals the torch.cat of flip_field
    copies bit for bit: the S stack from one field (a transposed view,
    as the engine passes it) and the I0 stack from a plane an angle."""
    P, B, nz, nx, ny = len(flips), 3, 5, 8, 6
    rng = np.random.default_rng(P)
    S_c = _t(rng.uniform(0, 1, (B, nz, nx, ny)))
    S_t = S_c.transpose(0, 1)
    want = torch.cat([sr.flip_field(S_t, *f) for f in flips], dim=1)
    got = ge.group_stack([S_t] * P, flips)
    assert got.is_contiguous() and torch.equal(got, want)
    I0 = [_t(rng.uniform(0, 1, (B, nx, ny))) for _ in range(P)]
    want = torch.cat([sr.flip_field(i, *f[:2]) for i, f in zip(I0, flips)],
                     dim=0)
    assert torch.equal(ge.group_stack(I0, [f[:2] for f in flips]), want)


@pytest.mark.parametrize("padded", [False, True])
def test_plain_fold_equals_eager(padded):
    """group_fold's plain version equals J_up.add_(flip(J_dn)) then
    Jc.add_(J.transpose(0, 1)) bit for bit, on whole halves and on the
    interior views of padded tiles (a split grid's)."""
    B, nz, nx, ny, h = 3, 6, 8, 7, 2
    rng = np.random.default_rng(9)
    J_up, J_dn = (_t(rng.uniform(0, 1, (nz, B, nx + 2 * h, ny + 2 * h)))
                  for _ in range(2))
    strip = (lambda A: A[..., h:-h, h:-h]) if padded else (lambda A: A)
    Jc0 = _t(rng.uniform(0, 1, (B, nz) + tuple(strip(J_up).shape[2:])))
    J = J_up.clone()
    J.add_(torch.flip(J_dn, [0]))
    want = Jc0.clone()
    want.add_(strip(J).transpose(0, 1))
    got = Jc0.clone()
    assert ge.group_fold(got, strip(J_up), strip(J_dn)) is got
    assert torch.equal(got, want)


# ------------------------------------------- (e) calls and planes emitted

def _count_emits(monkeypatch):
    calls = []
    emit = ge.group_emit

    def counting(planes, steps, *rest):
        calls.append(list(steps))
        return emit(planes, steps, *rest)

    monkeypatch.setattr(sr, "group_emit", counting)
    return calls


@pytest.mark.parametrize("max_steps", [3, None])
@pytest.mark.parametrize("case", list(GROUP_ANGLES))
def test_emit_calls_a_sweep(monkeypatch, case, max_steps):
    """sweep_group_J makes one group_emit call a K2 plane, one a piece
    of an xy segment and one for the boundary plane, and emits every
    plane of the grid exactly once (so J_up and J_dn may be allocated
    empty)."""
    nz, nx, ny = 10, 12, 8
    *_, groups = _group(case, nz=nz, nx=nx, ny=ny)
    plans, flips, S, a_list, I0_list, w = _group_inputs(groups[0], nz, nx,
                                                        ny)
    P, B = len(plans), S.shape[1]
    if max_steps is not None:
        monkeypatch.setattr(xs, "PIECE_BYTES",
                            max_steps * P * B * nx * ny * 8 + 1)
    k = xs.piece_steps(P * B, nx, ny, torch.float64)
    segs = plans[0].segments
    march = sum(len(s.steps) for s in segs if s.case != "xy")
    pieces = sum(-(-len(s.steps) // k) for s in segs if s.case == "xy")
    calls = _count_emits(monkeypatch)
    sr.sweep_group_J(plans, _t(S), [_t(a) for a in a_list],
                     [_t(i) for i in I0_list], w, flips=flips)
    assert len(calls) == march + pieces + 1
    assert calls[0] == [0]          # the boundary plane (canonical: up)
    assert sorted(t for c in calls for t in c) == list(range(nz))
    assert max(len(c) for c in calls) <= k


def test_boundary_and_march_planes_one_a_call(monkeypatch):
    """On a grid whose group runs yz marches only, every call emits one
    plane, the boundary first."""
    nz, nx, ny = 10, 12, 8
    *_, groups = _group("yz", nz=nz, nx=nx, ny=ny)
    plans, flips, S, a_list, I0_list, w = _group_inputs(groups[0], nz, nx,
                                                        ny)
    assert {s.case for s in plans[0].segments} == {"yz"}
    calls = _count_emits(monkeypatch)
    sr.sweep_group_J(plans, _t(S), [_t(a) for a in a_list],
                     [_t(i) for i in I0_list], w, flips=flips)
    assert calls == [[t] for t in range(nz)]


# --------------------------------------------------------- (f) refusals

def _emit_args(P=2, B=2, nz=5, nx=4, ny=3):
    rng = np.random.default_rng(1)
    return dict(planes=_t(rng.uniform(0, 1, (2, P * B, nx, ny))),
                steps=[1, 2], w=_t(rng.uniform(0, 1, P)),
                down_flags=(False, True), unflips=((False, False),) * P,
                J_up=torch.zeros((nz, B, nx, ny), dtype=torch.float64),
                J_dn=torch.zeros((nz, B, nx, ny), dtype=torch.float64))


def _bad(case):
    a = _emit_args()
    S = torch.zeros((5, 2, 4, 3), dtype=torch.float64)
    J = torch.zeros((5, 2, 4, 3), dtype=torch.float64)
    return {
        "steps not consecutive": lambda: ge.group_emit(
            **dict(a, steps=[1, 3])),
        "steps outside the grid": lambda: ge.group_emit(
            **dict(a, steps=[4, 5])),
        "planes of another batch": lambda: ge.group_emit(
            **dict(a, planes=a["planes"][:, :3])),
        "fewer weights than angles": lambda: ge.group_emit(
            **dict(a, w=a["w"][:1])),
        "halves of two shapes": lambda: ge.group_emit(
            **dict(a, J_dn=a["J_dn"][:4])),
        "an emit of float16": lambda: ge.group_emit(
            **{k: (v.half() if isinstance(v, torch.Tensor) else v)
               for k, v in a.items()}),
        "too many angles": lambda: ge.group_stack(
            [S] * (ge.MAX_ANGLES + 1), [(False,) * 3] * (ge.MAX_ANGLES + 1)),
        "flip pairs for 4-d sources": lambda: ge.group_stack(
            [S, S], [(False, False)] * 2),
        "sources of two shapes": lambda: ge.group_stack(
            [S, S[:4]], [(False,) * 3] * 2),
        "mixed dtypes": lambda: ge.group_stack(
            [S, S.float()], [(False,) * 3] * 2),
        "a fold into another layout": lambda: ge.group_fold(J, J, J),
        "halves of two strides": lambda: ge.group_fold(
            J.transpose(0, 1).contiguous(), J, J.transpose(0, 1)
            .contiguous().transpose(0, 1)),
    }[case]


@pytest.mark.parametrize("case", [
    "steps not consecutive", "steps outside the grid",
    "planes of another batch", "fewer weights than angles",
    "halves of two shapes", "an emit of float16", "too many angles",
    "flip pairs for 4-d sources", "sources of two shapes", "mixed dtypes",
    "a fold into another layout", "halves of two strides"])
def test_refuses(case):
    with pytest.raises((ValueError, TypeError)):
        _bad(case)()


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (P, B, nx, ny): the production group's plane, a ragged tile, B = 1
CARD_SHAPES = [(4, 13, 64, 64), (4, 5, 37, 29), (2, 1, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, dtype, shape):
    """G1 on pieces of 1 and 7 planes up and down, G2 (the S stack from
    a transposed view, the I0 stack) and G3 (whole halves and interior
    views) against their plain versions on the card, bit for bit."""
    P, B, nx, ny = shape
    nz = 9
    g = torch.Generator(device=cuda).manual_seed(P * B)

    def u(*s):
        return torch.rand(*s, generator=g, device=cuda, dtype=dtype)

    down = tuple(bool(e % 2) for e in range(P))
    unflips = tuple((bool(e & 1), bool(e & 2)) for e in range(P))
    w = u(P)
    for steps in ([3], list(range(1, 8)), list(range(7, 0, -1))):
        planes = u(len(steps), P * B, nx, ny)
        got = [torch.full((nz, B, nx, ny), -1.0, dtype=dtype, device=cuda)
               for _ in range(2)]
        want = [x.clone() for x in got]
        ge.group_emit(planes, steps, w, down, unflips, *got)
        ge.group_emit_plain(planes, steps, w, down, unflips, *want)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    flips = tuple((bool(e & 1), bool(e & 2), bool(e % 3 == 0))
                  for e in range(P))
    S_t = u(B, nz, nx, ny).transpose(0, 1)
    assert torch.equal(ge.group_stack([S_t] * P, flips),
                       ge.group_stack_plain([S_t] * P, flips))
    I0 = [u(B, nx, ny) for _ in range(P)]
    pairs = [f[:2] for f in flips]
    assert torch.equal(ge.group_stack(I0, pairs),
                       ge.group_stack_plain(I0, pairs))
    J_up, J_dn = u(nz, B, nx + 4, ny + 4), u(nz, B, nx + 4, ny + 4)
    for cut in (slice(None), slice(2, -2)):
        uu, dd = J_up[..., cut, cut], J_dn[..., cut, cut]
        Jc = u(B, nz, *uu.shape[2:])
        want = Jc.clone()
        ge.group_fold(Jc, uu, dd)
        ge.group_fold_plain(want, uu, dd)
        torch.cuda.synchronize()
        assert torch.equal(Jc, want)
    ge.EMIT_LAUNCHES = ge.STACK_LAUNCHES = ge.FOLD_LAUNCHES = 0
