"""Observability: spans, per-phase timings, throughput metrics, profiler
traces.

Port of voronoirt_tpu/observability/metrics.py (the reference wraps each
Lambda iteration in @time, whole runs in @timed, and stores total wall
time in the HDF5 `time` dataset).  Here: a PhaseTimer whose report feeds
the output store, the program's spans, and a torch.profiler hook for
device traces.  CUDA launches return before the card has done the work,
so a PhaseTimer phase that is given a device synchronises it on exit;
otherwise it times the launch only.  The peak device memory is
torch.cuda.max_memory_allocated(): the JAX package's modelled ledger and
allocation probe have no counterpart.

Spans.  span(name) records a host interval in the process-wide RECORDER:
its name, the enclosing span (parent), the Lambda iteration it belongs
to and its host start and end; RECORDER.timer, a PhaseTimer, keeps the
totals by name.  No span synchronises the card.  Two tiers:

- always recorded, on the host clock: set-up (kernels.load,
  kernels.build, grid.build_sites, grid.build_plans, engine.setup and
  its children), engine.iteration, a lambda chunk (engine.chunk) or
  direction (engine.direction), the eager engine phases and the waits
  (wait(): engine.wait, counted): about a hundred spans an iteration on
  the Voronoi path, about two hundred on the streamed one;
- only while a torch.profiler session records (tested with
  torch.autograd._profiler_enabled()): the spans of layer calls
  (layer(name), a decorator that otherwise costs one flag test), CUDA
  events at the edges of a span given a device (an eager phase; the
  device seconds between them are read without waiting once its end
  event has completed: before a later wait, or by report()), and a
  profiler range for every span.

Every range is named "layer:<name>".  The benchmark's trace reduction
(benchmark/trace.py) counts every event on the card's timeline whose
name does not start with "layer:" as a device operation; a range under
any other name that reached the card's timeline would be counted as busy
time.  The ranges are the profiler's fast record functions, which it
keeps on the host's timeline only (under a profiler less than half the
host cost of torch.profiler.record_function, which matters at a few
thousand layer calls an iteration): they name what the host was doing when the card
went idle, and leave the card's timeline, and so every layer's device
time, to the benchmark's own ranges.  A layer call's range carries the
benchmark's layer name, so it nests inside the benchmark's range of that
name on the host; no other span opens inside a layer call.

An iteration record (RECORDER.iterations) sums what happened from the
end of the previous iteration to the end of this one: host seconds by
span name, waits, spans, and the eager phases' device seconds (None
where no CUDA events were recorded).  A loop head's criterion before an
iteration counts in it.  The recorder is not thread-safe: the port's
host work runs on one thread.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import defaultdict, deque

import numpy as np
import torch

PREFIX = "layer:"
# the spans that set a run up, report()'s "setup"
SETUP_SPANS = ("kernels.load", "kernels.build", "grid.build_sites",
               "grid.build_plans", "engine.setup", "engine.frozen_setup",
               "engine.slot_plans")
# span records and iteration records kept (the oldest dropped first)
MAX_SPANS = 1 << 16
MAX_ITERATIONS = 512

_profiling = torch.autograd._profiler_enabled
# a profiler range on the host's timeline (see the module's docstring)
_range = torch._C._profiler._RecordFunctionFast


class PhaseTimer:
    """Accumulates wall-clock per named phase; the span recorder's
    totals by name too (RECORDER.timer).

    with timer.phase("sweep", device): ...
    timer.report() -> {"sweep": {"total_s": ..., "count": ..., "mean_s": ...}}

    device: the default device to synchronise at the end of each phase
    (a CUDA device; None or the CPU synchronise nothing): only a caller
    that passes one waits for the card.
    """

    def __init__(self, device=None):
        self.device = device
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name, device=None):
        device = torch.device(device if device is not None
                              else (self.device or "cpu"))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.add(name, time.perf_counter() - t0)

    def add(self, name, seconds):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self):
        out = {}
        for name, tot in self.totals.items():
            c = self.counts[name]
            out[name] = {"total_s": tot, "count": c, "mean_s": tot / c}
        out["_wall_s"] = time.perf_counter() - self._t0
        return out

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)


class Span:
    """One span: name, the id of the span open around it (parent), the
    Lambda iteration it belongs to (None outside one), its host start and
    end (time.perf_counter seconds) and, for an eager phase traced on the
    card, device_s, the seconds between its CUDA events."""

    __slots__ = ("id", "name", "parent", "iteration", "start", "end",
                 "device_s")

    def __init__(self, id, name, parent, iteration, start):
        self.id, self.name, self.parent = id, name, parent
        self.iteration, self.start = iteration, start
        self.end = self.device_s = None


class _Tally:
    """What an iteration record sums."""

    __slots__ = ("host_s", "device_s", "waits", "spans", "traced")

    def __init__(self):
        self.host_s = defaultdict(float)
        self.device_s = defaultdict(float)
        self.waits = self.spans = 0
        self.traced = False


class Recorder:
    """The span records (spans), the iteration records (iterations), the
    totals by name (timer) and the counters (counts) of a process."""

    def __init__(self, max_spans=MAX_SPANS, max_iterations=MAX_ITERATIONS):
        self.max_spans, self.max_iterations = max_spans, max_iterations
        self.reset()

    def reset(self):
        self.spans = deque(maxlen=self.max_spans)
        self.iterations = deque(maxlen=self.max_iterations)
        self.first_iteration = None
        self.timer = PhaseTimer()
        self.counts = defaultdict(int)
        self._open = []
        self._ids = itertools.count()
        self._n_iterations = 0
        self._iteration = None
        self._tally = _Tally()
        # (span, tally, device, start event, end event)
        self._pending = deque()
        self._events = defaultdict(list)    # free timing events by device

    def open(self, name):
        parent = self._open[-1].id if self._open else None
        s = Span(next(self._ids), name, parent, self._iteration,
                 time.perf_counter())
        self._open.append(s)
        return s

    def close(self, s):
        s.end = time.perf_counter()
        self._open.pop()
        self._keep(s)

    def leaf(self, name, start):
        """Record a span from `start` to now inside which no span opened
        (a layer call), without pushing it on the stack of open ones."""
        end = time.perf_counter()
        s = Span(next(self._ids), name,
                 self._open[-1].id if self._open else None, self._iteration,
                 start)
        s.end = end
        self._keep(s)

    def _keep(self, s):
        self.spans.append(s)
        self.timer.add(s.name, s.end - s.start)
        self._tally.host_s[s.name] += s.end - s.start
        self._tally.spans += 1

    def open_spans(self):
        """The names of the open spans, outermost first."""
        return [s.name for s in self._open]

    def begin_iteration(self):
        self._iteration = self._n_iterations
        self._n_iterations += 1

    def end_iteration(self, s):
        """Close the iteration record of span s; its eager phases' device
        seconds are added to it as resolve() reads them."""
        t, self._tally = self._tally, _Tally()
        self._iteration = None
        record = {"iteration": s.iteration, "host_s": dict(t.host_s),
                  "waits": t.waits, "spans": t.spans,
                  "device_s": t.device_s if t.traced else None}
        self.iterations.append(record)
        if self.first_iteration is None:
            self.first_iteration = record

    def resolve(self):
        """Read the device seconds of the eager phases whose end events
        have completed, oldest first, stopping at the first that has not
        (events complete in stream order): nothing is waited for.  Called
        before each wait, while the card still works through its queue,
        so the reads cost the card no idle time, and by report()."""
        pending = self._pending
        while pending:
            span_, tally, dev, e0, e1 = pending[0]
            if not e1.query():
                break
            pending.popleft()
            span_.device_s = e0.elapsed_time(e1) / 1e3
            tally.device_s[span_.name] += span_.device_s
            self._events[dev] += (e0, e1)

    def event(self, device):
        """A CUDA timing event for `device`, reused once its span's time
        is read."""
        free = self._events[device]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)


RECORDER = Recorder()


class span(contextlib.ContextDecorator):
    """A span named `name` in RECORDER, as a `with` block or a decorator
    (each call a span); while a profiler records, a range "layer:<name>"
    around it and, with a CUDA `device`, CUDA events at its edges on the
    device's current stream.  `with` gives the Span."""

    def __init__(self, name, device=None):
        self.name, self.device = name, device

    def _recreate_cm(self):
        return type(self)(self.name, self.device)

    def __enter__(self):
        self._rec = rec = RECORDER
        self._s = rec.open(self.name)
        self._rf = self._timing = None
        if _profiling():
            self._rf = _range(PREFIX + self.name)
            self._rf.__enter__()
            if self.device is not None and \
                    torch.device(self.device).type == "cuda":
                self._stream = torch.cuda.current_stream(self.device)
                dev = self._stream.device
                self._timing = (dev, rec.event(dev), rec.event(dev))
                self._timing[1].record(self._stream)
        return self._s

    def __exit__(self, *exc):
        rec = self._rec
        if self._timing is not None:
            self._timing[2].record(self._stream)
            rec._pending.append((self._s, rec._tally) + self._timing)
            rec._tally.traced = True
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        rec.close(self._s)
        return False


class iteration(span):
    """One Lambda iteration, engine.iteration: its body and the readback
    that completes it; closes its iteration record."""

    def __init__(self):
        super().__init__("engine.iteration")

    def _recreate_cm(self):
        return iteration()

    def __enter__(self):
        RECORDER.begin_iteration()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._rec.end_iteration(self._s)
        return False


class wait(span):
    """engine.wait around a place where the host blocks on the card (a
    readback, a copy from pageable host memory), counting n waits in the
    iteration's record."""

    def __init__(self, n=1):
        super().__init__("engine.wait")
        self.n = n

    def _recreate_cm(self):
        return wait(self.n)

    def __enter__(self):
        RECORDER.resolve()
        RECORDER._tally.waits += self.n
        RECORDER.counts["engine.wait"] += self.n
        return super().__enter__()


def reset():
    """Empty RECORDER."""
    RECORDER.reset()


def count(name, n=1):
    """Add n to RECORDER's counter `name`."""
    RECORDER.counts[name] += n


def layer(name):
    """Decorator: the function is a call into the layer `name` (the
    benchmark's layer name); while a profiler records, each call is a
    span and its range.  Without one a call costs one flag test."""
    label = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            start = time.perf_counter()
            try:
                with _range(label):
                    return fn(*args, **kwargs)
            finally:
                RECORDER.leaf(name, start)
        return call
    return wrap


def _mean_iteration(records):
    """The per-iteration means of iteration records, or None."""
    if not records:
        return None
    n = len(records)
    names = sorted(set().union(*(r["host_s"] for r in records)))
    out = {"n": n, "host_s": {k: sum(r["host_s"].get(k, 0.0)
                                     for r in records) / n for k in names},
           "waits": sum(r["waits"] for r in records) / n,
           "spans": sum(r["spans"] for r in records) / n}
    dev = [r["device_s"] for r in records if r["device_s"] is not None]
    if dev:
        keys = sorted(set().union(*dev))
        out["device_s"] = {k: sum(d.get(k, 0.0) for d in dev) / len(dev)
                           for k in keys}
    return out


def report():
    """RECORDER as JSON-ready values: the set-up spans' host seconds
    ("setup"), the counters, the first iteration's record and the mean of
    the other iterations kept ("iterations": host seconds by span name,
    waits, spans, device seconds by eager phase where traced), and the
    totals by span name (PhaseTimer.report())."""
    r = RECORDER
    r.resolve()
    first = r.first_iteration
    rest = [it for it in r.iterations if it is not first]
    return {"setup": {k: r.timer.totals[k] for k in SETUP_SPANS
                      if k in r.timer.counts},
            "counts": dict(r.counts),
            "first_iteration": _mean_iteration([first] if first else []),
            "iterations": _mean_iteration(rest),
            "spans": r.timer.report()}


def throughput(n_points, n_angles, n_lambda, n_iterations, seconds):
    """grid-points * rays / s."""
    return n_points * n_angles * n_lambda * n_iterations / seconds


@contextlib.contextmanager
def device_trace(log_dir):
    """torch.profiler trace context over the CPU and, where one is
    visible, the CUDA card; on exit a Chrome trace (view in
    chrome://tracing or Perfetto) is written to log_dir/trace.json.
    Yields the profiler, whose key_averages() sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def nan_guard(name, *arrays):
    """NaN watchdog mirroring the reference's convergence NaN check
    (lambda_iteration.jl:310-312), on tensors (checked on their device)
    or numpy arrays."""
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            n_bad = int((~torch.isfinite(a)).sum())
        else:
            n_bad = int((~np.isfinite(np.asarray(a))).sum())
        if n_bad:
            raise FloatingPointError(
                f"{name}: array {i} has {n_bad} non-finite values")
