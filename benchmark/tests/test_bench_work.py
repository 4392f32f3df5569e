"""The frozen work counts equal the chip smoke test's arithmetic they
were copied from, at phase 2's shapes that a CPU holds."""


import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmark import work

ES = {"float64": 8, "float32": 4}


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("shape", cs.PHASE2_SHAPES)
def test_sweep_bounds(dtype_name, shape):
    B, nx, ny = shape
    want = cs._bounds(B, nx, ny, dtype_name=dtype_name)
    dtype = getattr(torch, dtype_name)
    es = ES[dtype_name]
    for name, got in (("march_plane", work.march_plane(B, nx, ny, 3, es)),
                      ("xy_segment", work.xy_segment(1, B, nx, ny, es))):
        s, by = work.least_s(*got, dtype)
        assert (1e3 * s, by) == pytest.approx(want[name]) or \
            (1e3 * s == pytest.approx(want[name][0]) and by == want[name][1])


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_group_work(dtype_name):
    nz, B, nx, ny = (cs.PROD[k] for k in ("nz", "lambda_chunk", "nx",
                                          "ny"))
    es, P = ES[dtype_name], 4
    for L in (1, 39):
        nbytes, ops = cs._group_work("group_emit", L, P, B, nx, ny)
        assert work.group_emit(L, P, B, nx, ny, es) == (nbytes * es, ops)
    nbytes, ops = cs._group_work("group_stack", 1, P, B, nx, ny, nz)
    pts = nz * B * nx * ny
    assert work.group_stack(pts, P * pts, es) == (nbytes * es, ops)
    nbytes, ops = cs._group_work("group_fold", 1, P, B, nx, ny, nz)
    assert work.group_fold(B, nx, ny, nz, es) == (nbytes * es, ops)


def _fields(cells, dtype):
    """Phase 2's extinction and rate fields on a corner tile of `cells`
    of the production atmosphere's first planes, on the CPU."""
    from voronoirt_tpu_torch import Config, synthetic_atmosphere
    from voronoirt_tpu_torch.engine.lambda_iter import frozen_setup
    from voronoirt_tpu_torch.physics.atom import (line_of_sight_velocity,
                                                  lyman_alpha_line)
    from voronoirt_tpu_torch.physics.broadening import gamma_constant
    atmos = synthetic_atmosphere(*cells)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    cfg = Config()
    T, ne, nH = (f(atmos.temperature), f(atmos.electron_density),
                 f(atmos.hydrogen_populations))
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    lte, a_cont, eps = frozen_setup(line, T, ne, nH, cfg,
                                    block=slice(0, 0))[:3]
    g = gamma_constant(line, T, lte[..., 0] + lte[..., 1], ne,
                       cfg.gamma_natural)
    velocity = f(atmos.velocity_zxy()).contiguous()
    ks = [np.asarray(k) for k in cs._production_group(atmos)[0]]
    return {"line": line, "populations": lte, "a_cont": a_cont,
            "g_cell": g, "g": g, "T": T, "lte": lte, "eps": eps,
            "velocity": velocity, "ks": ks,
            "v_los": line_of_sight_velocity(velocity, -ks[1])}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extinction_work(dtype):
    F = _fields((5, 37, 29), dtype)
    line = F["line"]
    lam = line.lam_tensor()[24:27]
    es = ES[str(dtype).split(".")[1]]
    for kind, angles in (("alpha_tot", [F["ks"][1]]),
                         ("alpha_tot_group", F["ks"])):
        nbytes, ops, _ = cs._ext_work(kind, F, lam, angles=angles)
        v_loses = [(F["velocity"] * torch.as_tensor(-k, dtype=dtype)).sum(-1)
                   for k in angles]
        got = work.extinction(kind, lam, line.lam0, F["g_cell"], line.dlamD,
                              v_loses, es)
        assert got == (nbytes, ops)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rates_and_s_update_work(dtype):
    from voronoirt_tpu_torch.physics import rates
    F = _fields((5, 37, 29), dtype)
    line = F["line"]
    es = ES[str(dtype).split(".")[1]]
    acc = {}
    for ci, (r0, n_rows) in enumerate(((0, 13), (12, 14), (25, 14),
                                       (77, 14))):
        want = cs._rates_work(F, r0, n_rows, acc)
        got = work.rates_chunk(line.lam_tensor(), line.lam_idx, line.lam0,
                               r0, n_rows, frozenset(acc), F["g"],
                               line.dlamD, es)
        assert got == want
        for kind, _, _, _ in rates._chunk_windows(line, r0, n_rows):
            acc.update(dict.fromkeys(rates._RATE_KEYS[kind]))
    assert work.s_update(F["T"].numel(), 13, es) == cs._s_update_work(F, 13)


def test_voronoi_stage_work():
    """V1's count over a small plan's stages (phase 2's 3,000 sites)."""
    import warnings

    from voronoirt_tpu_torch import get_quadrature, grid
    from voronoirt_tpu_torch import synthetic_atmosphere
    from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
    atmos = synthetic_atmosphere(20, 12, 12)
    pos = grid.sample_sites(atmos, cs.V1_SMALL_SITES, seed=2022)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    quad = get_quadrature("ul7n12")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = grid.build_voronoi_plan(sites, quad.k[8], bool(quad.is_up[8]))
    stages, _, _ = sv.device_plan(plan, 3, torch.device("cpu"),
                                  torch.float64)
    for sd in stages:
        for B, es in ((91, 8), (13, 4), (1, 8)):
            want = cs._v1_stage_work(sd, B, es)
            got = work.voronoi_stage(
                sd.off, sd.up_slot.numpy(), sd.up_site.numpy(),
                sd.row_site.numpy(), sd.passes, B, es)
            assert got == want


def test_least_time():
    for dtype_name in ("float64", "float32"):
        dtype = getattr(torch, dtype_name)
        for nbytes, ops in ((6.7633e9, 1e9), (1e6, 1e12)):
            ms, by = cs._bound_ms(nbytes, ops, dtype_name)
            s, by2 = work.least_s(nbytes, ops, dtype)
            assert 1e3 * s == pytest.approx(ms, rel=1e-15) and by == by2
