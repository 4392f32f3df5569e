"""voronoirt_tpu_torch checkpoint store and resume against the JAX
package's: the schema, files crossing between the packages, and
crash/resume equality.  float64 on the CPU."""

import h5py
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voronoirt_tpu as jpkg
from voronoirt_tpu.engine import RegularEngine as JRegularEngine
from voronoirt_tpu.engine import checkpoint as j_ckpt
from voronoirt_tpu.engine.lambda_iter import _run_iteration as j_run_iteration
from voronoirt_tpu.physics import lyman_alpha_line as j_line
from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.engine import checkpoint as t_ckpt
from voronoirt_tpu_torch.engine.lambda_iter import _run_iteration
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line

KW = dict(eps=1e-3, maxiter=4, nlam_bb=5, nlam_bf=3, quadrature="n2")


@pytest.fixture(scope="module")
def atmos():
    return synthetic_atmosphere(nz=8, nx=5, ny=5, seed=2)


def _engine(atmos, **kw):
    T = torch.from_numpy(np.asarray(atmos.temperature))
    return RegularEngine(atmos, lyman_alpha_line(5, 3, T),
                         Config(**{**KW, **kw}))


def _j_engine(atmos, **kw):
    T = jnp.asarray(atmos.temperature)
    return JRegularEngine(atmos, j_line(5, 3, T),
                          jpkg.Config(**{**KW, **kw}))


class StopAfter:
    """A store that raises after its n-th write_state: a killed run."""

    def __init__(self, inner, n):
        self.inner, self.n, self.count = inner, n, 0

    def write_convergence(self, i, d):
        self.inner.write_convergence(i, d)

    def write_state(self, p, s):
        self.inner.write_state(p, s)
        self.count += 1
        if self.count >= self.n:
            raise KeyboardInterrupt


def _datasets(path):
    with h5py.File(path) as f:
        return {k: (f[k].shape, f[k].dtype.kind) for k in f}


def test_regular_schema_equals_jax(atmos, tmp_path):
    """Dataset names, shapes and units of tests/test_checkpoint.py's
    schema check, and the whole file against one the JAX package
    creates."""
    eng = _engine(atmos)
    path, jpath = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    t_ckpt.CheckpointFile(path).create_regular(eng.line, atmos, KW["maxiter"])
    j_ckpt.CheckpointFile(jpath).create_regular(_j_engine(atmos).line, atmos,
                                                KW["maxiter"])
    assert _datasets(path) == _datasets(jpath)
    with h5py.File(path) as f, h5py.File(jpath) as g:
        assert f["source_function"].shape == (eng.line.n_lambda,) + atmos.shape
        assert f["populations"].shape == atmos.shape + (3,)
        assert f["convergence"].shape == (KW["maxiter"] + 1,)
        assert int(f["n_bb"][0]) == 5 and int(f["n_bf"][0]) == 3
        assert np.isclose(f["line_center"][0], 121.568, rtol=1e-3)
        assert np.allclose(f["wavelength"][:], eng.line.lam * 1e9)
        for name in f:
            np.testing.assert_array_equal(f[name][...], g[name][...],
                                          err_msg=name)


def test_voronoi_schema_equals_jax(atmos, tmp_path):
    from voronoirt_tpu.engine import VoronoiEngine as JVoronoiEngine
    pos = grid.sample_sites(atmos, 200, seed=3)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    T = np.asarray(sites.temperature)
    line = lyman_alpha_line(5, 3, torch.from_numpy(T))
    path, jpath = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    t_ckpt.CheckpointFile(path).create_voronoi(line, sites, 3)
    j_ckpt.CheckpointFile(jpath).create_voronoi(
        j_line(5, 3, jnp.asarray(T)), sites, 3)
    assert _datasets(path) == _datasets(jpath)
    with h5py.File(path) as f, h5py.File(jpath) as g:
        assert f["source_function"].shape == (line.n_lambda, sites.n)
        assert f["populations"].shape == (sites.n, 3)
        assert f["positions"].shape == (3, sites.n)
        assert f["boundaries"].shape == (6,)
        for name in f:
            np.testing.assert_array_equal(f[name][...], g[name][...],
                                          err_msg=name)
    # a Voronoi run writes its state in the file's shapes
    eng = VoronoiEngine(sites, line, Config(**{**KW, "maxiter": 1}))
    ckpt = t_ckpt.CheckpointFile(path)
    res = eng.run(checkpoint=ckpt)
    pops, S, conv = ckpt.read_state()
    np.testing.assert_array_equal(S, res.S.numpy())
    np.testing.assert_array_equal(pops, res.populations.numpy())
    assert conv[1] == 1.0 and conv[2] == res.convergence[1]


def test_files_cross_between_the_packages(atmos, tmp_path):
    """A checkpoint the port writes is read by the JAX package's
    CheckpointFile, and the reverse: equal state, equal resume point."""
    path, jpath = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    eng, jeng = _engine(atmos, maxiter=2), _j_engine(atmos, maxiter=2)
    ckpt = t_ckpt.CheckpointFile(path)
    ckpt.create_regular(eng.line, atmos, 4)
    res = eng.run(checkpoint=ckpt)
    jckpt = j_ckpt.CheckpointFile(jpath)
    jckpt.create_regular(jeng.line, atmos, 4)
    jres = jeng.run(checkpoint=jckpt)

    pops, S, conv = j_ckpt.CheckpointFile(path).read_state()
    np.testing.assert_array_equal(S, res.S.numpy())
    np.testing.assert_array_equal(pops, res.populations.numpy())
    np.testing.assert_array_equal(conv[1:4], res.convergence)
    assert j_ckpt.CheckpointFile(path).resume_iteration() == 3

    pops, S, conv = t_ckpt.CheckpointFile(jpath).read_state()
    np.testing.assert_array_equal(S, jres.S)
    np.testing.assert_array_equal(pops, jres.populations)
    assert t_ckpt.CheckpointFile(jpath).resume_iteration() == 3
    # the two runs wrote the same numbers: S to 1e-10, populations 1e-8
    np.testing.assert_allclose(res.S.numpy(), jres.S, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.populations.numpy(), jres.populations,
                               rtol=1e-8, atol=0)

    # and each package resumes from the other's file
    resumed = t_ckpt.recover(_engine(atmos), jpath)
    jresumed = j_ckpt.recover(_j_engine(atmos), path)
    assert resumed.iterations == jresumed.iterations
    np.testing.assert_allclose(resumed.S.numpy(), jresumed.S, rtol=1e-8)
    np.testing.assert_allclose(resumed.populations.numpy(),
                               jresumed.populations, rtol=1e-8)


@pytest.mark.parametrize("every", [1, 2])
def test_crash_and_resume_equal_the_uninterrupted_run(atmos, tmp_path,
                                                      every):
    """tests/test_checkpoint.py's contract on the port: a run killed
    after its second write_state and resumed equals the uninterrupted
    run (rtol 1e-8), and both equal the JAX package's resumed run."""
    kw = dict(checkpoint_every=every)
    res_full = _run_iteration(_engine(atmos, **kw))

    path = str(tmp_path / "crash.h5")
    eng = _engine(atmos, **kw)
    ckpt = t_ckpt.CheckpointFile(path)
    ckpt.create_regular(eng.line, atmos, KW["maxiter"])
    with pytest.raises(KeyboardInterrupt):
        _run_iteration(eng, checkpoint=StopAfter(ckpt, 2))
    it = ckpt.resume_iteration()
    assert it >= 1

    res = t_ckpt.recover(_engine(atmos, **kw), path)
    assert res.S.dtype == torch.float64
    np.testing.assert_allclose(res.S.numpy(), res_full.S.numpy(), rtol=1e-8)
    np.testing.assert_allclose(res.populations.numpy(),
                               res_full.populations.numpy(), rtol=1e-8)
    # the reference-side behaviour, mirrored: the resumed loop's first
    # criterion compares against zeros and records a spurious 1.0
    assert res.convergence[0] == 1.0
    if every == 1:
        jpath = str(tmp_path / "jcrash.h5")
        jeng = _j_engine(atmos)
        jckpt = j_ckpt.CheckpointFile(jpath)
        jckpt.create_regular(jeng.line, atmos, KW["maxiter"])
        with pytest.raises(KeyboardInterrupt):
            j_run_iteration(jeng, checkpoint=StopAfter(jckpt, 2))
        assert jckpt.resume_iteration() == it
        jres = j_ckpt.recover(_j_engine(atmos), jpath)
        assert jres.iterations == res.iterations
        np.testing.assert_allclose(res.S.numpy(), jres.S, rtol=1e-8)
        np.testing.assert_allclose(res.convergence, jres.convergence,
                                   rtol=1e-6)


def test_streamed_loop_checkpoints_like_jax(atmos, tmp_path):
    """The lambda-streamed loop writes its criterion and state where the
    JAX package's does; a resume re-enters the standard loop whatever
    cfg.stream_rates says."""
    kw = dict(stream_rates=True, lambda_chunk=4, maxiter=3, eps=1e-9)
    path, jpath = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    eng, jeng = _engine(atmos, **kw), _j_engine(atmos, **kw)
    ckpt, jckpt = t_ckpt.CheckpointFile(path), j_ckpt.CheckpointFile(jpath)
    ckpt.create_regular(eng.line, atmos, 5)
    jckpt.create_regular(jeng.line, atmos, 5)
    res, jres = eng.run(checkpoint=ckpt), jeng.run(checkpoint=jckpt)
    (pops, S, conv), (jpops, jS, jconv) = ckpt.read_state(), jckpt.read_state()
    np.testing.assert_array_equal(S, res.S.numpy())
    assert conv[0] == 0.0 and conv[1] == 1.0 and conv[5] == 0.0
    np.testing.assert_allclose(conv, jconv, rtol=1e-6)
    np.testing.assert_allclose(S, jS, rtol=1e-10, atol=0)
    np.testing.assert_allclose(pops, jpops, rtol=1e-8, atol=0)
    assert ckpt.resume_iteration() == jckpt.resume_iteration() == 4
    resumed = t_ckpt.recover(_engine(atmos, **{**kw, "maxiter": 5}), path)
    assert resumed.J is not None        # the standard loop ran
    assert resumed.iterations == 5


def test_write_state_takes_tensors_and_arrays(atmos, tmp_path):
    eng = _engine(atmos)
    ckpt = t_ckpt.CheckpointFile(str(tmp_path / "s.h5"))
    ckpt.create_regular(eng.line, atmos, 2)
    ckpt.write_state(eng.lte, eng.B0.clone().requires_grad_(False))
    pops, S, _ = ckpt.read_state()
    np.testing.assert_array_equal(S, eng.B0.numpy())
    ckpt.write_state(eng.lte.numpy() * 2.0, eng.B0.numpy())
    np.testing.assert_array_equal(ckpt.read_state()[0], eng.lte.numpy() * 2.0)
    ckpt.write_time(12.5)
    ckpt.write_convergence(99, 0.5)          # out of range: dropped
    with h5py.File(ckpt.path) as f:
        assert f["time"][0] == 12.5 and not f["convergence"][...].any()
