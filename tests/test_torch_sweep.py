"""voronoirt_tpu_torch regular sweep against the JAX package and the
oracle fixtures, float64 on the CPU (plain kernel versions)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voronoirt_tpu.solvers import sweep_regular as jsr
from voronoirt_tpu_torch.quadrature import get_quadrature
from voronoirt_tpu_torch.solvers import sweep_regular as tsr

FIX = "tests/golden/regular_sweep_fixtures.npz"
CASES = ["up_xy", "dn_xy", "up_yz", "dn_yz", "up_xz", "dn_xz", "up_mix",
         "dn_mix"]


def kvec(theta_deg, phi_deg):
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    return np.array([np.cos(t), np.cos(p) * np.sin(t), np.sin(p) * np.sin(t)])


def _same_plan(a, b):
    """Port plan == JAX plan, field by field (the port's plan classes
    are copies, so compare as dicts)."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("z_kind", ["uniform", "stretched"])
def test_plans_and_groups_equal(z_kind):
    q = get_quadrature("ul7n12")
    if z_kind == "uniform":
        z = np.linspace(-0.1e6, 2.0e6, 24)
    else:
        z = np.concatenate([[0.0], np.cumsum(np.linspace(1.0, 3.0, 23))])
    dx, dy = 2.0e6 / 15, 2.0e6 / 17
    for k, up in zip(q.k, q.is_up):
        _same_plan(tsr.build_plan(k, z, dx, dy, bool(up)),
                   jsr.build_plan(k, z, dx, dy, bool(up)))
        assert tsr.canonical_flips(k) == jsr.canonical_flips(k)
    for cap in (None, 2):
        gt = tsr.group_plans(q.k, q.is_up, z, dx, dy, max_group=cap)
        gj = jsr.group_plans(q.k, q.is_up, z, dx, dy, max_group=cap)
        assert len(gt) == len(gj)
        for a, b in zip(gt, gj):
            assert [(i, f) for (i, _, f) in a] == [(i, f) for (i, _, f) in b]
            for (_, pa, _), (_, pb, _) in zip(a, b):
                _same_plan(pa, pb)
                assert tsr.plan_signature(pa) == jsr.plan_signature(pb)


@pytest.mark.parametrize("case", CASES)
def test_matches_oracle(case):
    fx = np.load(FIX)
    S = fx[f"{case}_S"]
    dx = 1.0 / S.shape[1]
    I = tsr.short_characteristics(
        fx[f"{case}_k"], torch.from_numpy(S),
        torch.from_numpy(fx[f"{case}_alpha"]),
        torch.from_numpy(fx[f"{case}_I0"]), fx[f"{case}_z"], dx, dx,
        up=bool(fx[f"{case}_up"]), n_sweeps=3).numpy()
    expected = fx[f"{case}_I"]
    err = np.max(np.abs(I - expected) / (np.abs(expected) + 1e-12))
    assert err < 1e-12, f"{case}: max rel err {err}"


def _fields(nz, nx, ny, B, seed):
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.1, 1.0, (nz, B, nx, ny))
    alpha = 10.0 ** rng.uniform(-2, 1, (nz, B, nx, ny))
    I0_up = rng.uniform(0.5, 1.0, (B, nx, ny))
    return S, alpha, I0_up, np.zeros((B, nx, ny))


GROUP_ANGLES = [((100.0, 80.0), 30.0),    # xy case (steep)
                ((94.0, 86.0), 20.0),     # yz case (grazing, x march)
                ((95.0, 85.0), 75.0)]     # xz case (grazing, y march)


def _mixed_group(theta_pair, phi, nz=12, nx=8, ny=8):
    dx = 1.0 / nx
    z = np.linspace(0.0, 1.0, nz)
    th_up, th_dn = theta_pair
    ks = [kvec(th_up, phi), kvec(th_dn, phi),
          kvec(th_up, phi + 180.0), kvec(th_dn, phi + 180.0)]
    ups = [True, False, True, False]
    groups = tsr.group_plans(ks, ups, z, dx, dx)
    merged = [g for g in groups if len(g) > 1]
    assert merged, "expected up/down angles to merge on uniform z"
    return ks, ups, z, dx, merged


@pytest.mark.parametrize("theta_pair,phi", GROUP_ANGLES)
def test_sweep_group_J_matches_jax(theta_pair, phi):
    ks, ups, z, dx, merged = _mixed_group(theta_pair, phi)
    B = 3
    S, alpha, I0_up, I0_dn = _fields(12, 8, 8, B, seed=7)
    rng = np.random.default_rng(8)
    j_merged = [g for g in jsr.group_plans(ks, ups, z, dx, dx) if len(g) > 1]
    for g, jg in zip(merged, j_merged):
        plans = tuple(p for (_, p, _) in g)
        flips = tuple(f for (_, _, f) in g)
        a_list = [alpha * rng.uniform(0.5, 2.0) for _ in g]
        I0_list = [I0_dn if f[2] else I0_up for f in flips]
        w = rng.uniform(0.05, 0.1, len(g))
        want = jsr.sweep_group_J(
            tuple(p for (_, p, _) in jg),
            jnp.asarray(S), tuple(map(jnp.asarray, a_list)),
            tuple(map(jnp.asarray, I0_list)), jnp.asarray(w), n_sweeps=3,
            flips=flips)
        got = tsr.sweep_group_J(plans, torch.from_numpy(S),
                                [torch.from_numpy(a) for a in a_list],
                                [torch.from_numpy(i) for i in I0_list],
                                w, n_sweeps=3, flips=flips)
        want = np.asarray(want)
        err = np.max(np.abs(got.numpy() - want) / (np.abs(want) + 1e-300))
        assert err < 1e-12, f"max rel err {err}"


@pytest.mark.parametrize("theta_pair,phi", GROUP_ANGLES)
def test_grouped_equals_per_angle(theta_pair, phi):
    """A mixed up/down group in one batched sweep reproduces the
    per-angle sweeps (tests/test_sweep_regular.py's TestZFlipBatchedGroups
    bar, < 1e-13)."""
    ks, ups, z, dx, merged = _mixed_group(theta_pair, phi)
    B = 3
    S, alpha, I0_up, I0_dn = (torch.from_numpy(a) for a in
                              _fields(12, 8, 8, B, seed=7))
    for g in merged:
        parts_S, parts_a, parts_I0 = [], [], []
        for (i, _, (fx, fy, fz)) in g:
            parts_S.append(tsr.flip_field(S, fx, fy, fz))
            parts_a.append(tsr.flip_field(alpha, fx, fy, fz))
            parts_I0.append(tsr.flip_field(I0_dn if fz else I0_up, fx, fy))
        I_b = tsr.sweep_batched(tuple(p for (_, p, _) in g),
                                torch.cat(parts_S, 1), torch.cat(parts_a, 1),
                                torch.cat(parts_I0, 0), n_sweeps=3,
                                down_flags=tuple(f[2] for (_, _, f) in g))
        for e, (i, _, f) in enumerate(g):
            got = tsr.flip_field(I_b[:, e * B:(e + 1) * B], *f).numpy()
            plan_i = tsr.build_plan(ks[i], z, dx, dx, ups[i])
            want = tsr.sweep(plan_i, S, alpha, I0_up if ups[i] else I0_dn,
                             n_sweeps=3).numpy()
            err = np.max(np.abs(got - want) / (np.abs(want) + 1e-300))
            assert err < 1e-13, f"angle {i}: max rel err {err}"


def test_bezier_not_ported():
    fx = np.load(FIX)
    plan = tsr.build_plan(fx["up_xy_k"], fx["up_xy_z"], 0.125, 0.125, True)
    S = torch.from_numpy(fx["up_xy_S"])[:, None]
    with pytest.raises(NotImplementedError):
        tsr.sweep(plan, S, S, S[0], interpolation="bezier")
