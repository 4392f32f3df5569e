"""The mesh of voronoirt_tpu_torch (parallel/mesh.py: the "x" / "y" axes of
the regular grid, the "site" axis of the Voronoi grid, make_hybrid_mesh,
and checkpoints of split runs) on the CPU, float64, over gloo: the twin
of tests/test_parallel.py.

One spawn a rank count (2, 4 and 8 ranks) runs every case of that
count.  Rank 0's results, gathered over the mesh, are held against the
port unsplit and against the JAX package on a make_mesh of the same
shape (conftest's 8 virtual CPU devices) at test_parallel.py's bars: J
and S rtol 1e-10, populations rtol 1e-8.  The halo exchange and plane
gather are held against torch.roll of the whole plane; a split run
killed after its second state write and resumed equals the whole run
at 1e-8 (tests/test_checkpoint.py's bar), and its files cross to and
from the unsplit port and JAX.

The ranks import this module to find their functions, so it imports
nothing of JAX at its top (as tests/test_torch_lam.py).
"""

import dataclasses
import os
import shutil
import types
import warnings

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.engine import checkpoint as t_ckpt
from voronoirt_tpu_torch.engine import lambda_iter
from voronoirt_tpu_torch.parallel import distribute_angles, lam, mesh as M
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line, pad_line

# name: (engine, mesh shape, axis names, Config overrides); every
# regular case on test_parallel.py's 8x8x8 atmosphere (seed 3), 5 + 2x3
# wavelengths (padded to 12 where "lam" splits), the Voronoi cases on
# the 128 sites of tests/test_torch_lam.py
CASES = {
    "y2": ("regular", (2,), ("y",), dict(quadrature="ul2n3")),
    "streamed_y2": ("regular", (2,), ("y",),
                    dict(quadrature="ul7n12", stream_rates=True,
                         lambda_chunk=4)),
    "bezier_y2": ("regular", (2,), ("y",),
                  dict(quadrature="ul7n12", formal_interpolation="bezier",
                       lambda_chunk=6)),
    "site2": ("voronoi", (2,), ("site",), dict(quadrature="ul2n3")),
    "lam2_y2": ("regular", (2, 2), ("lam", "y"), dict(quadrature="ul2n3")),
    "x2_y2": ("regular", (2, 2), ("x", "y"),
              dict(quadrature="ul7n12", lambda_chunk=5)),
    "bezier_x2_y2": ("regular", (2, 2), ("x", "y"),
                     dict(quadrature="ul2n3",
                          formal_interpolation="bezier")),
    "lam2_site2": ("voronoi", (2, 2), ("lam", "site"),
                   dict(quadrature="ul2n3")),
    "hybrid": ("regular", (2, 2, 2), ("x", "lam", "y"),
               dict(quadrature="ul2n3")),
}
# the cases the JAX package runs on a mesh too (its standard iteration;
# the Bezier sweep stays with the port's own unsplit run)
JAX_CASES = ("y2", "streamed_y2", "site2", "lam2_y2", "x2_y2",
             "lam2_site2", "hybrid")
CKPT = dict(eps=1e-3, maxiter=4, nlam_bb=5, nlam_bf=3, quadrature="n2",
            checkpoint_every=1)


def _atmos():
    return synthetic_atmosphere(nz=8, nx=8, ny=8, seed=3)


def _ckpt_atmos():
    return synthetic_atmosphere(nz=8, nx=6, ny=6, seed=2)


def _sites():
    atmos = synthetic_atmosphere(nz=10, nx=4, ny=4, seed=7)
    pos = grid.sample_sites(atmos, 128, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))


def _n_lam(names, shape):
    """The line's padded length: 11 wavelengths, 12 where "lam" splits."""
    return 12 if "lam" in names and shape[names.index("lam")] > 1 else 11


def _engine(name, fields, mesh=None, world=None):
    """The case's port engine on the CPU (on `mesh` when given)."""
    kind, shape, names, kw = CASES[name]
    cfg = Config(nlam_bb=5, nlam_bf=3, maxiter=1, eps=0.0, **kw)
    line = lyman_alpha_line(5, 3, torch.as_tensor(fields.temperature,
                                                  dtype=torch.float64))
    line = pad_line(line, _n_lam(names, shape))
    make = RegularEngine if kind == "regular" else VoronoiEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        return make(fields, line, cfg, device="cpu", mesh=mesh)


def _mesh(name, world):
    _, shape, names, _ = CASES[name]
    if name == "hybrid":
        return M.make_hybrid_mesh(shape, names, dcn_axes=("x",), world=world)
    return M.make_mesh(shape, names, world=world)


def _whole(t, mesh, kind, lam_dim=True, spatial=None):
    """t gathered over the mesh's lambda axis (when lam_dim) and its
    spatial axes, as numpy."""
    if lam_dim and mesh.lam is not None:
        t = lam.gather_lambda(t, mesh.lam)
    if spatial is None:
        spatial = (-2, -1) if kind == "regular" else (-1,)
    return M.gather_space(t, mesh, dims=spatial).numpy()


def _run_case(name, world, sites):
    kind = CASES[name][0]
    fields = _atmos() if kind == "regular" else sites
    mesh = _mesh(name, world)
    res = _engine(name, fields, mesh).run()
    pops = (1, 2) if kind == "regular" else (0,)
    out = dict(S=_whole(res.S, mesh, kind),
               P=_whole(res.populations, mesh, kind, False, pops),
               J=None if res.J is None else _whole(res.J, mesh, kind),
               convergence=res.convergence, tally=mesh.tally,
               ranks=mesh.ranks.tolist(), coords=mesh.coords)
    if name == "hybrid" or name == "y2":
        # shard_regular on an engine built whole gives the same
        eng = M.shard_regular(_engine(name, fields), _mesh(name, world))
        res = eng.run()
        out["shard"] = _whole(res.S, eng.mesh, kind)
    if name == "site2":
        eng = M.shard_voronoi(_engine(name, fields), _mesh(name, world))
        out["shard"] = _whole(eng.run().S, eng.mesh, kind)
    return out


# ------------------------------------------------------- halo and gather


def _frame(W, fx, fy):
    """Each element of W (B, Nx, Ny) in its own mirror frame."""
    return torch.stack([torch.flip(w, [d for d, f in ((0, a), (1, b)) if f])
                        for w, a, b in zip(W, fx, fy)])


def _want_tile(F, mesh, h, fx, fy):
    """Each element's padded tile by torch.roll of its whole plane: the
    tile at the rank's position, mirrored where the element is flipped."""
    out = []
    for f, a, b in zip(F, fx, fy):
        shifts, size = [], []
        for n_ax, flip, N in (("x", a, F.shape[1]), ("y", b, F.shape[2])):
            p = mesh.size(n_ax)
            hh = h if p > 1 else 0
            i = mesh.coords.get(n_ax, 0)
            q = p - 1 - i if flip else i
            shifts.append(-(q * (N // p) - hh))
            size.append(N // p + 2 * hh)
        out.append(torch.roll(f, shifts, dims=(0, 1))[:size[0], :size[1]])
    return torch.stack(out)


def _halo_checks(world):
    """The halo exchange, plane gather and tile cut on an (x, y) = (2, 2)
    mesh against torch.roll, halo 1 and 2, elements flipped and not."""
    mesh = M.make_mesh((2, 2), ("x", "y"), world=world)
    gen = torch.Generator().manual_seed(5)
    W = torch.rand((6, 8, 10), generator=gen, dtype=torch.float64)
    fx = [False, True, False, True, False, True]
    fy = [False, False, True, True, True, False]
    F = _frame(W, fx, fy)
    errs = {}
    for h in (1, 2):
        halo = mesh.halo(h).with_flips(torch.tensor(fx), torch.tensor(fy))
        want = _want_tile(F, mesh, h, fx, fy)
        tile = halo.strip(want).clone()
        garbage = want.clone()
        garbage[:, :h] = garbage[:, -h:] = garbage[:, :, :h] = \
            garbage[:, :, -h:] = -1.0
        errs[h] = dict(slab=float((halo.slab(F) - want).abs().max()),
                       pad=float((halo.pad(tile) - want).abs().max()),
                       refill=float((halo.refill(garbage) - want).abs().max()),
                       gather=float((halo.gather(want) - F).abs().max()))
        # no flips at all: the plain periodic tile
        plain = mesh.halo(h)
        want0 = _want_tile(W, mesh, h, [False] * 6, [False] * 6)
        errs[h]["plain"] = float((plain.pad(plain.strip(want0).clone())
                                  - want0).abs().max())
    return errs


# ------------------------------------------------------------ checkpoints


class _Killed(Exception):
    pass


def _ckpt_engine(atmos, mesh=None, n_lam=11, **kw):
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64)
    line = pad_line(lyman_alpha_line(5, 3, T), n_lam)
    return RegularEngine(atmos, line, Config(**{**CKPT, **kw}),
                         device="cpu", mesh=mesh)


def _kill_and_resume(world, shape, names, path, n_lam, **kw):
    """A split run killed (every rank) after its second state write,
    then resumed from the file on the same mesh; the resumed S and
    populations, gathered."""
    atmos = _ckpt_atmos()
    mesh = M.make_mesh(shape, names, world=world)
    write = lambda_iter._write_state
    n = {"writes": 0}

    def killing(*args):
        write(*args)
        n["writes"] += 1
        if n["writes"] == 2:
            raise _Killed

    lambda_iter._write_state = killing
    try:
        _ckpt_engine(atmos, mesh, n_lam, **kw).run(
            checkpoint=t_ckpt.CheckpointFile(path))
    except _Killed:
        pass
    finally:
        lambda_iter._write_state = write
    resume_at = t_ckpt.CheckpointFile(path).resume_iteration()
    mesh = M.make_mesh(shape, names, world=world)
    res = t_ckpt.recover(_ckpt_engine(atmos, mesh, n_lam, **kw), path)
    return dict(S=_whole(res.S, mesh, "regular"),
                P=_whole(res.populations, mesh, "regular", False, (1, 2)),
                iterations=res.iterations, resume_at=resume_at)


def _write_whole_run(world, shape, names, path, n_lam, **kw):
    """A split run of 2 iterations writing its state to `path`."""
    mesh = M.make_mesh(shape, names, world=world)
    res = _ckpt_engine(_ckpt_atmos(), mesh, n_lam, maxiter=2, **kw).run(
        checkpoint=t_ckpt.CheckpointFile(path))
    return dict(S=_whole(res.S, mesh, "regular"),
                P=_whole(res.populations, mesh, "regular", False, (1, 2)))


def _resume_from(world, shape, names, path, n_lam):
    mesh = M.make_mesh(shape, names, world=world)
    res = t_ckpt.recover(_ckpt_engine(_ckpt_atmos(), mesh, n_lam), path)
    return dict(S=_whole(res.S, mesh, "regular"),
                P=_whole(res.populations, mesh, "regular", False, (1, 2)),
                iterations=res.iterations)


# ------------------------------------------------------------- the ranks


def _refusals(world, sites):
    """What a 2-rank world refuses: extents the mesh does not divide, a
    mesh with angle slots (either way round) or beside a lambda group,
    a mesh of another size than the world, a regular engine on 'site'."""
    got = {}

    def refused(key, fn, exc=ValueError):
        try:
            fn()
        except exc:
            got[key] = True
        else:
            got[key] = False

    odd = synthetic_atmosphere(nz=6, nx=4, ny=5, seed=3)
    T = torch.as_tensor(odd.temperature, dtype=torch.float64)
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3")
    y2 = M.make_mesh((2,), ("y",), world=world)
    refused("ny", lambda: RegularEngine(odd, lyman_alpha_line(5, 3, T), cfg,
                                        device="cpu", mesh=y2))
    refused("lam", lambda: _engine("y2", _atmos(), M.make_mesh(
        (2,), ("lam",), world=world)))
    refused("sites", lambda: VoronoiEngine(
        types.SimpleNamespace(n=127), lyman_alpha_line(5, 3, T), cfg,
        plans=[], device="cpu", mesh=M.make_mesh((2,), ("site",),
                                                 world=world)))
    refused("angles_after", lambda: distribute_angles(
        _engine("y2", _atmos(), y2), ["cpu", "cpu"]))
    refused("angles_before", lambda: M.shard_regular(
        distribute_angles(_engine("y2", _atmos()), ["cpu", "cpu"]), y2))
    refused("both", lambda: RegularEngine(
        _atmos(), lyman_alpha_line(5, 3, torch.as_tensor(
            _atmos().temperature)), cfg, device="cpu", mesh=y2,
        lam_group=world))
    refused("size", lambda: M.make_mesh((4,), ("y",), world=world))
    refused("site_on_regular", lambda: _engine("y2", _atmos(), M.make_mesh(
        (2,), ("site",), world=world)))
    return got


def _ranks(world, names, sites, tmp):
    out = {name: _run_case(name, world, sites) for name in names}
    if world.size == 2:
        out["refusals"] = _refusals(world, sites)
        out["kill"] = _kill_and_resume(world, (2,), ("y",),
                                       os.path.join(tmp, "kill_y2.h5"), 11)
        out["written"] = _write_whole_run(world, (2,), ("y",),
                                          os.path.join(tmp, "split.h5"), 11)
        out["streamed"] = _write_whole_run(
            world, (2,), ("y",), os.path.join(tmp, "streamed.h5"), 11,
            stream_rates=True, lambda_chunk=4)
        # the files the unsplit port and JAX wrote, copied: a resume
        # writes into its file
        out["from_port"] = _resume_from(world, (2,), ("y",),
                                        os.path.join(tmp, "port_r.h5"), 11)
        out["from_jax"] = _resume_from(world, (2,), ("y",),
                                       os.path.join(tmp, "jax_r.h5"), 11)
    if world.size == 4:
        out["halo"] = _halo_checks(world)
        out["kill"] = _kill_and_resume(world, (2, 2), ("lam", "y"),
                                       os.path.join(tmp, "kill_l2y2.h5"), 12)
    return out


# -------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def sites():
    return _sites()


def _case_names(n):
    return [k for k, (_, shape, _, _) in CASES.items()
            if int(np.prod(shape)) == n]


def _make_file(path, n_lam, package):
    """An empty checkpoint file of the checkpoint cases' problem, made
    by the port's or the JAX package's CheckpointFile."""
    atmos = _ckpt_atmos()
    line = _ckpt_engine(atmos, n_lam=n_lam).line
    if package == "jax":
        from voronoirt_tpu.engine import checkpoint as j_ckpt
        j_ckpt.CheckpointFile(path).create_regular(line, atmos,
                                                   CKPT["maxiter"])
    else:
        t_ckpt.CheckpointFile(path).create_regular(line, atmos,
                                                   CKPT["maxiter"])


def _jax_written(path):
    """A whole 2-iteration JAX run writing `path`."""
    import jax.numpy as jnp
    import voronoirt_tpu as jpkg
    from voronoirt_tpu.engine import RegularEngine as JRegular
    from voronoirt_tpu.engine import checkpoint as j_ckpt
    from voronoirt_tpu.physics import lyman_alpha_line as j_line
    atmos = _ckpt_atmos()
    eng = JRegular(atmos, j_line(5, 3, jnp.asarray(atmos.temperature)),
                   jpkg.Config(**{**CKPT, "maxiter": 2}))
    ckpt = j_ckpt.CheckpointFile(path)
    ckpt.create_regular(eng.line, atmos, CKPT["maxiter"])
    eng.run(checkpoint=ckpt)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The checkpoint files the 2- and 4-rank worlds write and read."""
    tmp = str(tmp_path_factory.mktemp("mesh_ckpt"))
    for name, n_lam in (("kill_y2", 11), ("split", 11), ("streamed", 11),
                        ("kill_l2y2", 12)):
        _make_file(os.path.join(tmp, name + ".h5"), n_lam, "port")
    port = os.path.join(tmp, "port.h5")
    _make_file(port, 11, "port")
    _ckpt_engine(_ckpt_atmos(), maxiter=2).run(
        checkpoint=t_ckpt.CheckpointFile(port))
    _jax_written(os.path.join(tmp, "jax.h5"))
    for name in ("port", "jax"):
        shutil.copy(os.path.join(tmp, f"{name}.h5"),
                    os.path.join(tmp, f"{name}_r.h5"))
    return tmp


@pytest.fixture(scope="module")
def split(sites, files):
    """{rank count: [each rank's results]}: one spawn of gloo ranks a
    count, every case of that count in it."""
    return {n: lam.spawn(_ranks, n, args=(_case_names(n), sites, files),
                         device="cpu", timeout=900.0, threads=1)
            for n in (2, 4, 8)}


@pytest.fixture(scope="module")
def unsplit(sites):
    out = {}
    for name, (kind, _, _, _) in CASES.items():
        res = _engine(name, _atmos() if kind == "regular" else sites).run()
        out[name] = dict(S=res.S.numpy(), P=res.populations.numpy(),
                         J=None if res.J is None else res.J.numpy(),
                         convergence=res.convergence)
    return out


def _count(name):
    return int(np.prod(CASES[name][1]))


def _assert_close(got, want, what, rtol):
    """Max relative difference (absolute where want is 0: the Voronoi J
    of a site no ray reaches)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    zero = want == 0.0
    rd = np.where(zero, np.abs(got), np.abs(got / np.where(zero, 1.0, want)
                                            - 1.0))
    assert rd.max() <= rtol, f"{what}: max rel diff {rd.max():.3e}"


def _jax_one_iteration(name, sites):
    """J, S and populations of one standard JAX iteration of the case on
    a make_mesh (make_hybrid_mesh) of its shape; test_parallel.py's
    helper."""
    import jax.numpy as jnp
    from voronoirt_tpu import synthetic_atmosphere as jax_atmos
    from voronoirt_tpu import grid as jgrid
    from voronoirt_tpu.config import Config as JaxConfig
    from voronoirt_tpu.engine import RegularEngine as JaxRegular
    from voronoirt_tpu.engine import VoronoiEngine as JaxVoronoi
    from voronoirt_tpu.engine.lambda_iter import (_rates_and_populations,
                                                  _update_S)
    from voronoirt_tpu.parallel import (make_hybrid_mesh, make_mesh,
                                        shard_regular, shard_voronoi)
    from voronoirt_tpu.physics import lyman_alpha_line as jax_line
    from voronoirt_tpu.physics.atom import pad_line as jax_pad

    kind, shape, names, kw = CASES[name]
    kw = {k: v for k, v in kw.items() if k != "stream_rates"}
    cfg = JaxConfig(nlam_bb=5, nlam_bf=3, **kw)
    if kind == "regular":
        fields = jax_atmos(nz=8, nx=8, ny=8, seed=3)
    else:
        fields = jgrid.VoronoiSites(**{
            f.name: getattr(sites, f.name)
            for f in dataclasses.fields(sites)})
    line = jax_pad(jax_line(5, 3, jnp.asarray(fields.temperature)),
                   _n_lam(names, shape))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = (JaxRegular if kind == "regular" else JaxVoronoi)(
            fields, line, cfg)
    mesh = (make_hybrid_mesh(shape, names, dcn_axes=("x",))
            if name == "hybrid" else make_mesh(shape, names))
    (shard_regular if kind == "regular" else shard_voronoi)(eng, mesh)
    damping_lam = eng.damping_lam(eng.lte)
    J = eng.compute_J(eng.B0, eng.lte, damping_lam)
    S = _update_S(line, eng.eps, J, eng.B0)
    P = _rates_and_populations(line, J, damping_lam, eng.lte, eng.C, eng.T,
                               eng.nH, cfg.compat)
    return np.asarray(J), np.asarray(S), np.asarray(P), mesh


# ------------------------------------------------------------ the cases


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_unsplit_port(split, unsplit, name):
    """Every rank's gathered result equals the port's unsplit run: J and
    S rtol 1e-10, populations 1e-8 (a cell's arithmetic does not depend
    on which rank holds it: in practice the two agree to 2.2e-16), the
    criterion history to 1e-9."""
    want = unsplit[name]
    for got in (out[name] for out in split[_count(name)]):
        _assert_close(got["S"], want["S"], f"{name} S", 1e-10)
        _assert_close(got["P"], want["P"], f"{name} populations", 1e-8)
        if want["J"] is not None:
            _assert_close(got["J"], want["J"], f"{name} J", 1e-10)
        _assert_close(got["convergence"], want["convergence"],
                      f"{name} convergence", 1e-9)


@pytest.mark.parametrize("name", JAX_CASES)
def test_split_matches_jax_on_the_same_mesh(split, sites, name):
    """Against the JAX engine's standard iteration on a mesh of the same
    shape: J and S 1e-10, populations 1e-8 (the streamed case too, as in
    tests/test_torch_lam.py)."""
    J, S, P, _ = _jax_one_iteration(name, sites)
    got = split[_count(name)][0][name]
    _assert_close(got["S"], S, f"{name} S", 1e-10)
    _assert_close(got["P"], P, f"{name} populations", 1e-8)
    if got["J"] is not None:
        _assert_close(got["J"], J, f"{name} J", 1e-10)


def test_hybrid_mesh_rank_order_matches_jax(split, sites):
    """make_hybrid_mesh((2, 2, 2), ("x", "lam", "y"), dcn_axes=("x",)):
    x (the emulated host axis) varies slowest, and the ranks lie where
    the JAX mesh puts its devices."""
    _, _, _, jmesh = _jax_one_iteration("hybrid", sites)
    got = np.asarray(split[8][0]["hybrid"]["ranks"])
    np.testing.assert_array_equal(got, np.arange(8).reshape(2, 2, 2))
    np.testing.assert_array_equal(
        got, np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices)))
    for rank, out in enumerate(split[8]):
        c = out["hybrid"]["coords"]
        assert rank == 4 * c["x"] + 2 * c["lam"] + c["y"]


def test_shard_equals_the_constructor(split):
    """shard_regular / shard_voronoi on an engine built whole give what
    mesh= at construction gives, to the last bit or two (the frozen
    set-up runs over the whole grid there, over the tile here, and the
    CPU's vectorised exp rounds a lane's tail differently)."""
    for n, name in ((2, "y2"), (2, "site2"), (8, "hybrid")):
        np.testing.assert_allclose(split[n][0][name]["shard"],
                                   split[n][0][name]["S"], rtol=1e-15,
                                   atol=0)


def test_collectives_counted(split):
    """The regular split exchanges halos and gathers march planes; the
    site split only gathers."""
    for n, name in ((2, "y2"), (4, "x2_y2"), (2, "site2")):
        tally = split[n][0][name]["tally"]
        assert tally["gather"]["calls"] > 0 and tally["gather"]["bytes"] > 0
        assert (tally["halo"]["calls"] > 0) == (name != "site2")


@pytest.mark.parametrize("h", [1, 2])
def test_halo_and_gather_against_roll(split, h):
    """On an (x, y) = (2, 2) mesh, every rank: the cut of a whole plane,
    the padded tile from the exchange (x first, then y: corners too), a
    refill over garbage halos, and the gathered plane, each element in
    its mirror frame, all equal torch.roll of the whole plane exactly."""
    for out in split[4]:
        for what, err in out["halo"][h].items():
            assert err == 0.0, (h, what, err)


def test_refusals(split):
    """No fallback: an extent the mesh does not divide (ny = 5 over 2,
    11 wavelengths over 2, 127 sites over 2), angle slots with a mesh
    either way round, a mesh beside lam_group, a mesh of 4 in a world of
    2, and a regular engine on 'site' raise on every rank."""
    for out in split[2]:
        assert out["refusals"] == dict.fromkeys(
            ("ny", "lam", "sites", "angles_after", "angles_before", "both",
             "size", "site_on_regular"), True)


# ----------------------------------------------------------- checkpoints


@pytest.mark.parametrize("n", [2, 4], ids=["y2", "lam2_y2"])
def test_killed_split_run_resumes_to_the_whole_run(split, n):
    """A run split over y (and lambda) killed after its second state
    write and resumed from its file equals the uninterrupted whole run
    (1e-8, tests/test_checkpoint.py's bar)."""
    n_lam = 12 if n == 4 else 11
    full = _ckpt_engine(_ckpt_atmos(), n_lam=n_lam).run()
    for out in split[n]:
        got = out["kill"]
        assert got["resume_at"] >= 1
        assert got["iterations"] == full.iterations
        np.testing.assert_allclose(got["S"], full.S.numpy(), rtol=1e-8)
        np.testing.assert_allclose(got["P"], full.populations.numpy(),
                                   rtol=1e-8)


def test_split_files_cross_to_port_and_jax(split, files):
    """The file a split run wrote holds the whole state (read by the JAX
    package's CheckpointFile); the unsplit port and JAX resume from it
    alike (1e-8)."""
    from voronoirt_tpu.engine import checkpoint as j_ckpt
    import jax.numpy as jnp
    import voronoirt_tpu as jpkg
    from voronoirt_tpu.engine import RegularEngine as JRegular
    from voronoirt_tpu.physics import lyman_alpha_line as j_line
    path = os.path.join(files, "split.h5")
    pops, S, conv = j_ckpt.CheckpointFile(path).read_state()
    np.testing.assert_array_equal(S, split[2][0]["written"]["S"])
    np.testing.assert_array_equal(pops, split[2][0]["written"]["P"])
    assert j_ckpt.CheckpointFile(path).resume_iteration() == 3
    # a resume writes into its file: each package resumes from a copy
    jpath = os.path.join(files, "split_j.h5")
    shutil.copy(path, jpath)
    atmos = _ckpt_atmos()
    res = t_ckpt.recover(_ckpt_engine(atmos), path)
    jres = j_ckpt.recover(JRegular(
        atmos, j_line(5, 3, jnp.asarray(atmos.temperature)),
        jpkg.Config(**CKPT)), jpath)
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.S.numpy(), jres.S, rtol=1e-8)
    np.testing.assert_allclose(res.populations.numpy(), jres.populations,
                               rtol=1e-8)


def test_streamed_split_run_writes_the_whole_state(split, files):
    """The streamed loop split over y writes, through rank 0, the state
    and criterion the unsplit streamed run writes (S 1e-13)."""
    path = os.path.join(files, "streamed.h5")
    pops, S, conv = t_ckpt.CheckpointFile(path).read_state()
    np.testing.assert_array_equal(S, split[2][0]["streamed"]["S"])
    np.testing.assert_array_equal(pops, split[2][0]["streamed"]["P"])
    want = _ckpt_engine(_ckpt_atmos(), maxiter=2, stream_rates=True,
                        lambda_chunk=4).run()
    np.testing.assert_allclose(S, want.S.numpy(), rtol=1e-13, atol=0)
    np.testing.assert_allclose(conv[1:4], want.convergence, rtol=1e-9)
    assert conv[0] == 0.0 and conv[4] == 0.0


@pytest.mark.parametrize("source", ["port", "jax"])
def test_split_run_resumes_from_unsplit_files(split, files, source):
    """A split run resumes from a file the unsplit port or JAX wrote,
    and equals the unsplit port resumed from the same file (1e-8)."""
    path = os.path.join(files, f"{source}.h5")
    want = t_ckpt.recover(_ckpt_engine(_ckpt_atmos()), path)
    for out in split[2]:
        got = out[f"from_{source}"]
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["S"], want.S.numpy(), rtol=1e-8)
        np.testing.assert_allclose(got["P"], want.populations.numpy(),
                                   rtol=1e-8)


def test_dryrun_multichip_4_cpu():
    """dryrun_multichip(4) factors the ranks as JAX factors its devices:
    lam 2 x y 2 for the regular engine, lam 2 x site 2 for the Voronoi
    one, each equal to the unsplit run; then the angle slots."""
    from voronoirt_tpu_torch.entry import dryrun_multichip
    lines = dryrun_multichip(4, device="cpu")
    assert len(lines) == 3
    assert lines[0].startswith("dryrun_multichip regular OK on 4 ranks "
                               "(mesh lam=2 x y=2")
    assert lines[1].startswith("dryrun_multichip voronoi OK on 4 ranks "
                               "(mesh lam=2 x site=2, 256 sites")
    assert lines[2].startswith("dryrun_multichip voronoi angle-MPMD OK")
