"""Observability: per-phase timings, throughput metrics, profiler traces.

Port of voronoirt_tpu/observability/metrics.py (the reference wraps each
Lambda iteration in @time, whole runs in @timed, and stores total wall
time in the HDF5 `time` dataset).  Here: a PhaseTimer whose report feeds
the output store, and a torch.profiler hook for device traces.  CUDA
launches return before the card has done the work, so a phase that is
given a device synchronises it on exit; otherwise it times the launch
only.  The peak device memory is torch.cuda.max_memory_allocated(): the
JAX package's modelled ledger and allocation probe have no counterpart.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    with timer.phase("sweep", device): ...
    timer.report() -> {"sweep": {"total_s": ..., "count": ..., "mean_s": ...}}

    device: the default device to synchronise at the end of each phase
    (a CUDA device; None or the CPU synchronise nothing).
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
