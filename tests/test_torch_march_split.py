"""The split schedule of march_chain (csrc/march_plane.cu), emulated in
plain PyTorch on the CPU and held bit for bit to march_chain_plain.

The kernel gives each line to W warps: warp w owns the run of P = MP / W
points from w P and steps, besides, a halo of hh = max(H, 1) points on
the run's upwind side; every hh steps the warps put the points their
neighbours' halos read into a line buffer, meet, and reload their halos
from it.  The emulation below runs that schedule, warp by warp, with the
kernel's arithmetic; a stretch's end, whose neighbour no warp holds,
reads NaN, so an owned point that read a stale value would show.  Also
here: chain_split's choice for every line, the C entry points'
arguments, and the counter observability.report() shows.
"""

import contextlib
import itertools
import re
import types
from pathlib import Path

import pytest
import torch

from voronoirt_tpu_torch.solvers import march_plane as mp

SRC = Path(mp.__file__).resolve().parent.parent / "csrc" / "march_plane.cu"


def _scratch(B, N, M, seed):
    gen = torch.Generator().manual_seed(seed)
    scratch = torch.zeros((B, N, mp.line_pad(M), 2), dtype=torch.float64)
    scratch[:, :, :M, 0] = torch.rand((B, N, M), generator=gen,
                                      dtype=torch.float64)
    scratch[:, :, :M, 1] = torch.rand((B, N, M), generator=gen,
                                      dtype=torch.float64) - 0.3
    f_line = torch.rand((B,), generator=gen, dtype=torch.float64)
    f_line[0] = 0.0
    return scratch, f_line


def march_chain_split(scratch, f_line, line, *, march_axis, sign, s_base,
                      n_sweeps, W, H):
    """march_chain's schedule at (W, H), in plain PyTorch."""
    B, N, MP = scratch.shape[:3]
    M, P, hh = line, MP // W, max(H, 1)
    coeff, const = scratch[..., 0], scratch[..., 1]
    f = f_line.reshape(-1, 1)
    warps = []
    for w in range(W):
        n_own = min(max(M - w * P, 0), P)
        if n_own == 0:
            continue                     # a warp past the line's end
        lead = 0 if s_base == 0 else hh
        pts = (w * P - lead + torch.arange(n_own + hh)) % M
        own = slice(lead, lead + n_own)
        n_x = min(hh, n_own)
        sent = slice(0, n_x) if s_base == 0 else slice(lead + n_own - n_x,
                                                        lead + n_own)
        halo = slice(n_own, n_own + hh) if s_base == 0 else slice(0, hh)
        warps.append(dict(pts=pts, own=own, sent=sent, halo=halo,
                          v=coeff.new_zeros((B, n_own + hh))))
    nan = coeff.new_full((B, 1), float("nan"))
    lines = coeff.new_empty((B, N, M))
    cols = list(range(N) if sign > 0 else range(N - 1, -1, -1))
    since = 0
    for n in range(n_sweeps * N):
        if since == hh:                  # exchange, at one barrier
            buf = coeff.new_full((B, M), float("nan"))
            for wp in warps:
                buf[:, wp["pts"][wp["sent"]]] = wp["v"][:, wp["sent"]]
            for wp in warps:
                wp["v"][:, wp["halo"]] = buf[:, wp["pts"][wp["halo"]]]
            since = 0
        since += 1
        c = cols[n % N]
        for wp in warps:
            v = wp["v"]
            if s_base == 0:
                lo, hi = v, torch.cat([v[:, 1:], nan], dim=1)
            else:
                lo, hi = torch.cat([nan, v[:, :-1]], dim=1), v
            li = (1.0 - f) * lo + f * hi
            wp["v"] = coeff[:, c, wp["pts"]] * li + const[:, c, wp["pts"]]
        if n >= (n_sweeps - 1) * N:
            for wp in warps:
                lines[:, c, wp["pts"][wp["own"]]] = wp["v"][:, wp["own"]]
    return (lines if march_axis == "x" else lines.transpose(-1, -2)
            ).contiguous()


def _cases():
    for M, W in itertools.product((32, 100, 256, 512), (1, 2, 4, 8)):
        P = mp.line_pad(M) // W
        for H in sorted({h for h in (0, 1, 7, 32, P) if h <= P}):
            for s_base, axis, sign, n_sweeps in itertools.product(
                    (0, -1), ("x", "y"), (1, -1), (1, 3)):
                yield M, W, H, s_base, axis, sign, n_sweeps


@pytest.mark.parametrize("M,W,H,s_base,axis,sign,n_sweeps", list(_cases()))
def test_split_schedule_equals_plain_chain(M, W, H, s_base, axis, sign,
                                           n_sweeps):
    """Every (W, H) of the split gives march_chain_plain's plane, bit for
    bit: runs, halos, exchanges, warps past a ragged line's end."""
    N = max(H, 1) + 6                   # an exchange in every pass
    scratch, f_line = _scratch(2, N, M, seed=M + 7 * W + H)
    st = dict(march_axis=axis, sign=sign, s_base=s_base, n_sweeps=n_sweeps)
    got = march_chain_split(scratch, f_line, M, W=W, H=H, **st)
    want = mp.march_chain_plain(scratch, f_line, M, **st)
    assert not got.isnan().any()
    assert torch.equal(got, want)


def test_chain_entry_points_from_source():
    """vrt_march_chain_f64 / _f32 are extern "C" with the arguments
    _SIGNATURES gives them: three pointers, nine ints (the last W), the
    stream."""
    from voronoirt_tpu_torch.kernels.build import _I, _P, _SIGNATURES
    assert _SIGNATURES["vrt_march_chain"] == [_P] * 3 + [_I] * 9 + [_P]
    src = SRC.read_text()
    kinds = {"double*": _P, "float*": _P, "void*": _P, "int": _I}
    for suffix, ptr in (("_f64", "double*"), ("_f32", "float*")):
        m = re.search(r'extern "C" int vrt_march_chain' + suffix
                      + r"\(([^)]*)\)", src)
        assert m, suffix
        args = [re.sub(r"\s+", " ", a).strip()
                for a in m.group(1).split(",")]
        types = [a.replace("const ", "").rsplit(" ", 1)[0].replace(" *", "*")
                 for a in args]
        assert [kinds[t] for t in types] == _SIGNATURES["vrt_march_chain"]
        assert types[:3] == [ptr] * 3
        assert args[-2].rsplit(" ", 1)[1] == "w"


@pytest.mark.parametrize("ppl", [1, 2, 4, 8, 16, 32, 64])
def test_chain_split_choice(ppl):
    """Every line of 32 (ppl - 1) + 1 to 32 ppl points gets one split: W
    warps of at least 32 points each, MP divisible by W, the halo within
    a run (H <= P), and one warp exactly when no halo."""
    MP = 32 * ppl
    splits = {mp.chain_split(M) for M in range(MP - 31, MP + 1)}
    assert len(splits) == 1
    (W, H), = splits
    assert W in (1, 2, 4, 8) and MP % W == 0
    assert (W == 1) == (H == 0)
    assert W == 1 or (MP // W >= 32 and H == mp.HALO <= MP // W)
    # the production lines (256 and 512 points) are split
    assert (W > 1) == (ppl >= 4)


def test_report_shows_the_chain_split(monkeypatch):
    """A chain launch counts its split in march_plane.CHAIN_SPLIT and in
    observability.report()'s counts; the plain version on a CPU tensor
    counts none."""
    from collections import Counter

    from voronoirt_tpu_torch import observability as obs
    from voronoirt_tpu_torch.kernels import build
    monkeypatch.setattr(mp, "CHAIN_SPLIT", Counter())
    obs.reset()
    scratch, f_line = _scratch(1, 3, 256, seed=3)
    st = dict(march_axis="x", sign=1, s_base=0, n_sweeps=1)
    mp.march_chain(scratch, f_line, 256, **st)
    assert mp.CHAIN_SPLIT == Counter()
    assert not any(k.startswith("march_plane.CHAIN_SPLIT")
                   for k in obs.report()["counts"])
    # the card's route, its launch replaced by one that records W
    launched = []
    monkeypatch.setattr(mp, "_on_card", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(build, "launch_fn",
                        lambda name, dtype: lambda *a: launched.append(a[-2])
                        or 0)
    for M in (256, 256, 40):
        mp.march_chain(*_scratch(1, 3, M, seed=3), M, **st)
    assert launched == [8, 8, 1]
    assert mp.CHAIN_SPLIT == Counter({(8, 32): 2, (1, 0): 1})
    counts = obs.report()["counts"]
    assert counts["march_plane.CHAIN_SPLIT.W8 H32"] == 2
    assert counts["march_plane.CHAIN_SPLIT.W1 H0"] == 1
    obs.reset()
