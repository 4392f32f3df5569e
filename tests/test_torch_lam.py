"""The lambda split of voronoirt_tpu_torch (parallel/lam.py and the
engines' lam_group) on the CPU, float64: one spawn of 2 gloo ranks runs
every case, and rank 0's results (S gathered over the ranks) are held
against the port's unsharded engines (S 1e-13, populations 1e-12), and
against the JAX engines unsharded and on a ("lam",) mesh of 2 of
conftest's 8 virtual CPU devices (S 1e-10, populations 1e-8: the bars of
tests/test_parallel.py and __graft_entry__.dryrun_multichip; ROADMAP C3
for why the packages differ by more than the port's own bars).

The ranks import this module to find their function, so it imports
nothing of JAX at its top: the JAX package is imported inside the tests
(conftest has configured it), and the ranks stay free of it.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.engine.checkpoint import recover
from voronoirt_tpu_torch.parallel import distribute_angles, lam
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line, pad_line

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_RANKS = 2
# every case: the engine, the atmosphere's seed, (nlam_bb, nlam_bf) and
# the Config.  5 + 2x3 = 11 wavelengths pad to 12: the block edge (5, 6)
# lies in the first bf window (rows 5-7); 9 + 2x3 = 15 pad to 16: the
# edge (7, 8) lies in the bb window (rows 0-8)
CASES = {
    "regular": ("regular", (5, 3), dict(quadrature="ul2n3", maxiter=1)),
    "streamed": ("regular", (9, 3), dict(quadrature="ul2n3", maxiter=1,
                                         stream_rates=True, lambda_chunk=4)),
    "history": ("regular", (9, 3), dict(quadrature="ul2n3", maxiter=3,
                                        eps=1e-30, rates_site_chunk=3)),
    "voronoi": ("voronoi", (5, 3), dict(quadrature="ul2n3", maxiter=1)),
}
JAX_CASES = ("regular", "streamed", "voronoi")


def _atmos():
    return synthetic_atmosphere(nz=8, nx=6, ny=6, seed=3)


def _sites():
    """The Voronoi grid of __graft_entry__.dryrun_multichip at 2 devices:
    128 sites (seed 21) in the 10x4x4 atmosphere of seed 7."""
    atmos = synthetic_atmosphere(nz=10, nx=4, ny=4, seed=7)
    pos = grid.sample_sites(atmos, 128, seed=21)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    return grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))


def _engine(name, fields, lam_group=None, **cfg_over):
    """The case's port engine on the CPU, its line padded to a multiple
    of N_RANKS wavelengths."""
    kind, (nbb, nbf), kw = CASES[name]
    cfg = Config(nlam_bb=nbb, nlam_bf=nbf, **{"eps": 0.0, **kw, **cfg_over})
    line = lyman_alpha_line(nbb, nbf, torch.as_tensor(fields.temperature,
                                                      dtype=torch.float64))
    line = pad_line(line, -(-line.n_lambda // N_RANKS) * N_RANKS)
    make = RegularEngine if kind == "regular" else VoronoiEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 'layer' at grazing angles
        return make(fields, line, cfg, device="cpu", lam_group=lam_group)


def _ranks(group, sites, S_nan):
    """Every case on this rank's lambda block; S gathered over the ranks.
    The 'voronoi' case goes through shard_voronoi, and 'regular' once
    more through shard_regular, on engines built whole."""
    atmos = _atmos()
    out = {}
    for name, (kind, _, _) in CASES.items():
        fields = atmos if kind == "regular" else sites
        if name == "voronoi":
            eng = lam.shard_voronoi(_engine(name, fields), group)
        else:
            eng = _engine(name, fields, lam_group=group)
        b0_rows = eng.B0.shape[0]
        res = eng.run()
        out[name] = dict(S=lam.gather_lambda(res.S, group).numpy(),
                         P=res.populations.numpy(),
                         convergence=res.convergence, b0_rows=b0_rows,
                         block=(eng.lam_block.start, eng.lam_block.stop))
    res = lam.shard_regular(_engine("regular", atmos), group).run()
    out["shard_regular"] = dict(S=lam.gather_lambda(res.S, group).numpy(),
                                P=res.populations.numpy())
    # a NaN in rank 1's block of the starting S
    eng = _engine("regular", atmos, lam_group=group)
    eng.load_state({"S": S_nan})
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = eng.run()
    out["nan"] = dict(printed=printed.getvalue(),
                      convergence=res.convergence)
    out["collectives"] = (group.calls, group.seconds, group.backend)
    return out


def _fail_on_rank_1(group):
    lam.global_max(group, torch.zeros((), dtype=torch.float64))
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return group.rank


def _assert_close(got, want, what, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    rd = np.abs(got / want - 1.0)
    assert rd.max() <= rtol, f"{what}: max rel diff {rd.max():.3e}"


@pytest.fixture(scope="module")
def sites():
    return _sites()


@pytest.fixture(scope="module")
def S_nan():
    S = _engine("regular", _atmos()).B0.numpy().copy()
    S[8, 2, 1, 1] = np.nan                 # row 8: rank 1's block
    return S


@pytest.fixture(scope="module")
def sharded(sites, S_nan):
    """Every case on 2 spawned gloo ranks: [rank 0's, rank 1's] results."""
    return lam.spawn(_ranks, N_RANKS, args=(sites, S_nan), device="cpu",
                     timeout=600.0, threads=1)


@pytest.fixture(scope="module")
def unsharded(sites):
    out = {}
    for name, (kind, _, _) in CASES.items():
        res = _engine(name, _atmos() if kind == "regular" else sites).run()
        out[name] = dict(S=res.S.numpy(), P=res.populations.numpy(),
                         convergence=res.convergence)
    return out


def _jax_one_iteration(name, sites=None, mesh=False):
    """S and populations after one standard JAX iteration of the case
    (its line padded as the port's), unsharded or on a ("lam",) mesh of
    N_RANKS virtual CPU devices; the helper of tests/test_parallel.py."""
    import jax.numpy as jnp
    from voronoirt_tpu import synthetic_atmosphere as jax_atmos
    from voronoirt_tpu import grid as jgrid
    from voronoirt_tpu.config import Config as JaxConfig
    from voronoirt_tpu.engine import RegularEngine as JaxRegular
    from voronoirt_tpu.engine import VoronoiEngine as JaxVoronoi
    from voronoirt_tpu.engine.lambda_iter import (_rates_and_populations,
                                                  _update_S)
    from voronoirt_tpu.parallel import make_mesh, shard_regular, \
        shard_voronoi
    from voronoirt_tpu.physics import lyman_alpha_line as jax_line
    from voronoirt_tpu.physics.atom import pad_line as jax_pad

    kind, (nbb, nbf), kw = CASES[name]
    cfg = JaxConfig(nlam_bb=nbb, nlam_bf=nbf, quadrature=kw["quadrature"])
    if kind == "regular":
        fields = jax_atmos(nz=8, nx=6, ny=6, seed=3)
    else:
        fields = jgrid.VoronoiSites(**{
            f.name: getattr(sites, f.name)
            for f in dataclasses.fields(sites)})
    line = jax_line(nbb, nbf, jnp.asarray(fields.temperature))
    line = jax_pad(line, -(-line.n_lambda // N_RANKS) * N_RANKS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = (JaxRegular if kind == "regular" else JaxVoronoi)(
            fields, line, cfg)
    if mesh:
        place = shard_regular if kind == "regular" else shard_voronoi
        place(eng, make_mesh((N_RANKS,), ("lam",)))
    damping_lam = eng.damping_lam(eng.lte)
    J = eng.compute_J(eng.B0, eng.lte, damping_lam)
    S = _update_S(line, eng.eps, J, eng.B0)
    P = _rates_and_populations(line, J, damping_lam, eng.lte, eng.C, eng.T,
                               eng.nH, cfg.compat)
    return np.asarray(S), np.asarray(P)


# ------------------------------------------------------------ the cases


def test_pad_line_matches_jax():
    from voronoirt_tpu.physics import lyman_alpha_line as jax_line
    from voronoirt_tpu.physics.atom import pad_line as jax_pad
    T = _atmos().temperature
    t_line = lyman_alpha_line(5, 3, torch.as_tensor(T))
    j_line = jax_line(5, 3, np.asarray(T))
    for n in (11, 12, 16):
        got, want = pad_line(t_line, n), jax_pad(j_line, n)
        np.testing.assert_array_equal(got.lam, want.lam)
        assert got.lam_idx == want.lam_idx == t_line.lam_idx
    assert pad_line(t_line, 11) is t_line
    assert list(pad_line(t_line, 13).lam[10:]) == [t_line.lam[-1]] * 3
    with pytest.raises(ValueError, match="shrink"):
        pad_line(t_line, 10)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_unsharded_port(sharded, unsharded, name):
    """The lambda-split iteration equals the port's unsharded one: S to
    1e-13 (each wavelength's arithmetic does not depend on which batch
    carries it) and populations to 1e-12 (the rate sums add the same
    pairs in another order); after 3 iterations (the 'history' case,
    rates in slabs) the criterion history to 1e-9 relative: |1 -
    S_old/S_new| differences values near 1e-2..1e-5 that agree to
    ~1e-13."""
    got, want = sharded[0][name], unsharded[name]
    _assert_close(got["S"], want["S"], f"{name} S", 1e-13)
    _assert_close(got["P"], want["P"], f"{name} populations", 1e-12)
    assert len(got["convergence"]) == len(want["convergence"])
    _assert_close(got["convergence"], want["convergence"],
                  f"{name} convergence", 1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_their_block_and_the_same_populations(sharded, name):
    """Each rank built B0 for its block only, owns rows [r n/2, (r+1)
    n/2), and ends with the same populations and history as the other."""
    n = sharded[0][name]["S"].shape[0]
    for rank, out in enumerate(sharded):
        assert out[name]["b0_rows"] == n // N_RANKS
        assert out[name]["block"] == (rank * n // N_RANKS,
                                      (rank + 1) * n // N_RANKS)
        np.testing.assert_array_equal(out[name]["P"], sharded[0][name]["P"])
        assert out[name]["convergence"] == sharded[0][name]["convergence"]
        np.testing.assert_array_equal(out[name]["S"], sharded[0][name]["S"])


def test_shard_regular_equals_the_constructor(sharded):
    """shard_regular on an engine built whole gives what lam_group= at
    construction gives, bit for bit."""
    for key in ("S", "P"):
        np.testing.assert_array_equal(sharded[0]["shard_regular"][key],
                                      sharded[0]["regular"][key])


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("mesh", [False, True], ids=["jax", "jax_lam_mesh"])
def test_sharded_matches_jax(sharded, sites, name, mesh):
    """Against the JAX engine's standard iteration, unsharded and on a
    ("lam",) mesh: S 1e-10, populations 1e-8 (the streamed case too: the
    JAX package's own streamed-vs-full bar is S 1e-10,
    tests/test_rates_stream.py)."""
    S, P = _jax_one_iteration(name, sites, mesh=mesh)
    _assert_close(sharded[0][name]["S"], S, f"{name} S", 1e-10)
    _assert_close(sharded[0][name]["P"], P, f"{name} populations", 1e-8)


def test_nan_criterion_reaches_every_rank(sharded, S_nan, capsys):
    """A NaN in one rank's block stops every rank's loop with 'NaN
    convergence', as it stops the unsharded one."""
    eng = _engine("regular", _atmos())
    eng.load_state({"S": S_nan})
    res = eng.run()
    want = capsys.readouterr().out
    assert "NaN convergence at iteration 0" in want
    for out in sharded:
        assert out["nan"]["printed"] == want
        assert np.isnan(out["nan"]["convergence"]).tolist() == \
            np.isnan(res.convergence).tolist() == [True]


def test_collectives_counted(sharded):
    for out in sharded:
        calls, seconds, backend = out["collectives"]
        assert backend == "gloo" and calls > 0 and seconds >= 0.0


# ------------------------------------------------------------ refusals


def _group(rank=0, size=N_RANKS):
    """A rank's LamGroup with no process group behind it: enough for
    whatever raises before the first collective."""
    return lam.LamGroup(rank, size, "cpu", "gloo")


def test_refuses_an_indivisible_line():
    atmos = _atmos()
    line = lyman_alpha_line(5, 3, torch.as_tensor(atmos.temperature))
    cfg = Config(nlam_bb=5, nlam_bf=3, quadrature="ul2n3")
    with pytest.raises(ValueError, match="pad_line"):
        RegularEngine(atmos, line, cfg, device="cpu", lam_group=_group())
    with pytest.raises(ValueError, match="pad_line"):
        lam.shard_regular(RegularEngine(atmos, line, cfg, device="cpu"),
                          _group())


def test_refuses_a_group_with_angle_devices(sites):
    eng = _engine("regular", _atmos(), lam_group=_group())
    with pytest.raises(ValueError, match="not both"):
        distribute_angles(eng, ["cpu", "cpu"])
    eng = distribute_angles(_engine("voronoi", sites), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        lam.shard_voronoi(eng, _group())
    with pytest.raises(ValueError, match="already"):
        lam.shard_regular(_engine("regular", _atmos(), lam_group=_group()),
                          _group())


def test_refuses_nccl_beyond_the_visible_cards(tmp_path):
    init = "file://" + str(tmp_path / "rendezvous")
    with pytest.raises(RuntimeError, match="visible cards"):
        lam.join_group(0, N_RANKS, init, backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="visible cards"):
        lam.spawn(_fail_on_rank_1, N_RANKS, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="CUDA"):
        lam.spawn(_fail_on_rank_1, N_RANKS, device="cpu", backend="nccl")


@pytest.mark.parametrize("name", ["regular", "streamed"])
def test_refuses_checkpoints(name):
    """Checkpoints of a lambda-split run are not ported (write_state needs
    the whole S): run(checkpoint=...) and recover raise before any
    collective."""
    store = object()
    eng = _engine(name, _atmos(), lam_group=_group(rank=1))
    with pytest.raises(NotImplementedError, match="lambda group"):
        eng.run(checkpoint=store)

    class Store:
        def read_state(self):
            return eng.lte.numpy(), None, np.zeros(3)

        def resume_iteration(self):
            return 1

    with pytest.raises(NotImplementedError, match="lambda group"):
        recover(eng, Store())


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        lam.spawn(_fail_on_rank_1, N_RANKS, device="cpu", timeout=300.0,
                  threads=1)


def test_spawn_and_dryrun_default_to_the_card(monkeypatch):
    from voronoirt_tpu_torch.entry import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lam.spawn(_fail_on_rank_1, N_RANKS)
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun_multichip(N_RANKS)


# ------------------------------------------------------------ dry run


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_cpu(n):
    """dryrun_multichip(n) on the CPU: both engines lambda-split over n
    gloo ranks equal the unsharded ones, and the angle distribution
    does too; JAX's three report lines.  With 3 ranks the middle one
    both receives a row and sends one."""
    from voronoirt_tpu_torch.entry import dryrun_multichip
    lines = dryrun_multichip(n, device="cpu")
    assert len(lines) == 3
    assert lines[0].startswith(f"dryrun_multichip regular OK on {n} ranks")
    assert lines[1].startswith(f"dryrun_multichip voronoi OK on {n} ranks")
    assert f"{64 * n} sites" in lines[1]
    assert lines[2].startswith("dryrun_multichip voronoi angle-MPMD OK")


def test_dryrun_runs_as_a_module():
    """python -m voronoirt_tpu_torch.entry dryrun 2 --device cpu prints
    the three OK lines (its ranks check that they imported no jax)."""
    proc = subprocess.run([sys.executable, "-m", "voronoirt_tpu_torch.entry",
                           "dryrun", "2", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok = [s for s in proc.stdout.splitlines() if " OK on " in s]
    assert len(ok) == 3, proc.stdout[-3000:]
