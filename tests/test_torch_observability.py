"""voronoirt_tpu_torch.observability's spans: nesting, the two tiers
(always on; only while a profiler records), the "layer:" names of every
range, the records' bound, the engines' spans, phases and waits on the
CPU, and the benchmark's trace reduction with the program's ranges in
it."""

import contextlib
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import trace
from voronoirt_tpu_torch import Config, grid, synthetic_atmosphere
from voronoirt_tpu_torch import observability as obs
from voronoirt_tpu_torch.engine import RegularEngine, VoronoiEngine
from voronoirt_tpu_torch.observability import metrics
from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
from voronoirt_tpu_torch.solvers import sweep_regular as sr

EAGER = {"engine.damping", "engine.criterion", "engine.populations"}


@pytest.fixture
def rec(monkeypatch):
    """A fresh process-wide recorder for the test."""
    r = metrics.Recorder()
    monkeypatch.setattr(metrics, "RECORDER", r)
    return r


@pytest.fixture(scope="module")
def atmos():
    return synthetic_atmosphere(nz=8, nx=6, ny=6, seed=5)


def _regular(atmos, **kw):
    cfg = Config(maxiter=2, eps=0.0, nlam_bb=5, nlam_bf=3, **kw)
    T = torch.as_tensor(atmos.temperature, dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return RegularEngine(atmos, lyman_alpha_line(5, 3, T), cfg,
                             device="cpu")


def _voronoi(atmos):
    pos = grid.sample_sites(atmos, 300, seed=4)
    bounds = (atmos.z[0], atmos.z[-1], atmos.x[0], atmos.x[-1],
              atmos.y[0], atmos.y[-1])
    sites = grid.build_sites(pos, bounds, grid.initialise_sites(pos, atmos))
    T = torch.as_tensor(np.asarray(sites.temperature))
    cfg = Config(maxiter=2, eps=0.0, nlam_bb=5, nlam_bf=3,
                 voronoi_order="layer")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return VoronoiEngine(sites, lyman_alpha_line(5, 3, T), cfg,
                             device="cpu")


def test_span_nesting_parent_and_iteration(rec):
    with obs.span("outer") as outer:
        with obs.span("inner") as inner:
            pass
    with obs.iteration() as it:
        with obs.span("engine.chunk") as chunk:
            with obs.wait(3) as w:
                pass
    with obs.iteration() as it2:
        pass
    assert outer.parent is None and inner.parent == outer.id
    assert outer.iteration is None and inner.iteration is None
    assert chunk.parent == it.id and w.parent == chunk.id
    assert it.iteration == chunk.iteration == w.iteration == 0
    assert it2.iteration == 1
    assert [s.name for s in rec.spans] == [
        "inner", "outer", "engine.wait", "engine.chunk", "engine.iteration",
        "engine.iteration"]
    assert all(s.end >= s.start for s in rec.spans)
    first, second = rec.iterations
    # the spans before the first iteration count in its record
    assert first["waits"] == 3 and first["spans"] == 5
    assert second["waits"] == 0 and second["spans"] == 1
    assert first["device_s"] is None
    assert rec.timer.counts["engine.iteration"] == 2
    assert rec.counts["engine.wait"] == 3
    assert rec.first_iteration is first


def test_layer_call_without_profiler_records_nothing(rec, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was opened")
    monkeypatch.setattr(metrics, "_range", refuse)

    @obs.layer("march_plane")
    def kernel(x, *, y=1):
        return x + y

    assert kernel(1, y=2) == 3
    assert kernel.__name__ == "kernel"
    assert len(rec.spans) == 0 and not rec.timer.counts
    # the program's layer entry points are such calls
    assert sr.march_plane.__wrapped__ is not None


def test_layer_call_under_profiler_is_a_span(rec):
    @obs.layer("extinction")
    def kernel(x):
        return x * 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.iteration():
            kernel(torch.ones(3))
    names = [s.name for s in rec.spans]
    assert names == ["extinction", "engine.iteration"]
    assert rec.spans[0].parent == rec.spans[1].id
    assert {"layer:extinction", "layer:engine.iteration"} <= {
        e.name for e in prof.events()}


def test_every_program_range_is_a_layer_range(rec, monkeypatch, atmos):
    """A streamed and a Voronoi run under a CPU profiler: every range the
    program opens is named layer:..."""
    opened = []
    real = metrics._range

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(metrics, "_range", spy)
    reg = _regular(atmos, stream_rates=True, lambda_chunk=3,
                   group_max_angles=4)
    vor = _voronoi(atmos)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reg.run()
        vor.run()
    assert opened and all(n.startswith("layer:") for n in opened)
    names = set(opened)
    assert {"layer:engine.iteration", "layer:engine.chunk",
            "layer:engine.direction", "layer:engine.wait",
            "layer:march_plane", "layer:group_emit", "layer:extinction",
            "layer:rates", "layer:voronoi_level"} <= names
    assert names <= {e.name for e in prof.events()}


def test_records_stay_within_their_bound(monkeypatch):
    r = metrics.Recorder(max_spans=8, max_iterations=3)
    monkeypatch.setattr(metrics, "RECORDER", r)
    for _ in range(10):
        with obs.iteration():
            for _ in range(4):
                with obs.wait():
                    pass
    assert len(r.spans) == 8 and len(r.iterations) == 3
    assert [it["iteration"] for it in r.iterations] == [7, 8, 9]
    assert r.timer.counts["engine.wait"] == 40
    assert r.first_iteration["iteration"] == 0
    rep = obs.report()
    assert rep["first_iteration"]["waits"] == 4
    assert rep["iterations"]["n"] == 3
    assert rep["iterations"]["waits"] == 4


def test_phase_timer_without_device_never_synchronises(monkeypatch, rec):
    def refuse(*a, **k):
        raise AssertionError("synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    timer = obs.PhaseTimer()
    with timer.phase("a"):
        torch.ones(4).sum()
    with timer.phase("b", "cpu"):
        pass
    with obs.span("engine.criterion", "cpu"):
        pass
    assert timer.counts == {"a": 1, "b": 1}


class _Event:
    """A stand-in CUDA event: recorded at a given device time, completed
    when the test says so; it cannot be waited for."""

    clock = 0.0

    def __init__(self):
        self.done = False

    def record(self, stream):
        _Event.clock += 0.25
        self.t = _Event.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return (end.t - self.t) * 1e3


def test_phase_device_times_are_read_without_waiting(rec, monkeypatch):
    """An eager phase under a profiler on a CUDA device: its events are
    read once completed, at a later wait or by report(), into its
    iteration's record; until then the record holds nothing of it."""
    made = []

    def event(device):
        made.append(_Event())
        return made[-1]
    monkeypatch.setattr(metrics, "_profiling", lambda: True)
    monkeypatch.setattr(metrics, "_range", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(device="cuda:0"))
    monkeypatch.setattr(rec, "event", event)
    with obs.iteration():
        with obs.span("engine.damping", "cuda") as damp:
            pass
        with obs.wait():
            pass
    record = rec.iterations[-1]
    assert record["device_s"] == {} and damp.device_s is None
    assert len(made) == 2
    for e in made:
        e.done = True
    with obs.iteration():
        with obs.wait():        # reads the first iteration's phase
            pass
    assert record["device_s"] == {"engine.damping": pytest.approx(0.25)}
    assert damp.device_s == pytest.approx(0.25)
    assert rec.iterations[-1]["device_s"] is None
    assert obs.report()["first_iteration"]["device_s"] == {
        "engine.damping": pytest.approx(0.25)}


@pytest.mark.parametrize("kind", ["streamed", "voronoi"])
def test_engine_run_records_setup_iterations_phases_and_waits(rec, atmos,
                                                              kind):
    if kind == "streamed":
        eng = _regular(atmos, stream_rates=True, lambda_chunk=3,
                       group_max_angles=4)
    else:
        eng = _voronoi(atmos)
    res = eng.run()
    assert rec.timer.counts["engine.setup"] == 1
    assert rec.timer.counts["engine.frozen_setup"] == 1
    setup = next(s for s in rec.spans if s.name == "engine.setup")
    child = next(s for s in rec.spans if s.name == "engine.frozen_setup")
    assert child.parent == setup.id
    assert len(rec.iterations) == len(res.timings) == 2
    for it in rec.iterations:
        assert it["waits"] >= 1
        assert EAGER <= set(it["host_s"])
        assert "engine.iteration" in it["host_s"]
        assert it["device_s"] is None       # no card, no device times
    # timings: the iteration's host seconds up to its criterion's readback
    for t, it in zip(res.timings, rec.iterations):
        assert 0.0 < t <= it["host_s"]["engine.iteration"]
    sub = "engine.chunk" if kind == "streamed" else "engine.direction"
    assert sub in rec.iterations[0]["host_s"]
    if kind == "voronoi":
        assert rec.timer.counts["engine.slot_plans"] == 1
        assert {"engine.sweep_fill", "engine.sweep_gather",
                "engine.boundary", "engine.j_accumulate",
                "engine.s_update"} <= set(rec.iterations[0]["host_s"])
    rep = obs.report()
    assert rep["setup"]["engine.setup"] > 0.0
    assert rep["first_iteration"]["n"] == 1 and rep["iterations"]["n"] == 1


def _ev(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_program_ranges_leave_layer_device_time_unchanged():
    """benchmark/trace.py attribute(): an outer layer:engine.iteration
    range and the program's layer:march_plane nested in the benchmark's
    wrapper range of that name leave each layer's device seconds as they
    are without them."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    ops = [_ev("k_pre", 0, 10, cuda), _ev("march_chain_kernel", 20, 120, cuda),
           _ev("march_coeffs_kernel", 120, 160, cuda),
           _ev("fill", 170, 180, cuda), _ev("group_emit_kernel", 190, 230, cuda),
           _ev("alpha_tot_kernel", 240, 300, cuda)]
    wrappers = [_ev("layer:march_plane", 20, 160, cuda),
                _ev("layer:group_emit", 190, 230, cuda),
                _ev("layer:march_plane", 15, 165, cpu)]
    program = [_ev("layer:engine.iteration", 0, 300, cuda),
               _ev("layer:march_plane", 20, 160, cuda),
               _ev("layer:engine.j_accumulate", 170, 180, cuda),
               _ev("layer:engine.iteration", 0, 305, cpu)]
    patterns = {"march_plane": r"march_(coeffs|chain)_kernel",
                "group_emit": r"group_emit_kernel",
                "extinction": r"alpha_tot_kernel"}

    def reduce(events):
        prof = SimpleNamespace(events=lambda: events)
        return trace.attribute(prof, patterns), trace.summary(prof, 305e-6)

    (want, want_sum), (got, got_sum) = reduce(ops + wrappers), reduce(
        ops + wrappers + program)
    assert got["layers"] == want["layers"]
    assert got["source"] == want["source"]
    assert want["layers"] == {"march_plane": pytest.approx(140e-6),
                              "group_emit": pytest.approx(40e-6),
                              "extinction": pytest.approx(60e-6)}
    # the program's ranges are not operations: busy time and the top
    # operations are unchanged
    assert got_sum == want_sum
