"""Spans, timings, throughput metrics and profiler traces."""

from .metrics import (RECORDER, PhaseTimer, count, device_trace, iteration,
                      layer, nan_guard, report, reset, span, throughput,
                      wait)

__all__ = ["RECORDER", "PhaseTimer", "count", "device_trace", "iteration",
           "layer", "nan_guard", "report", "reset", "span", "throughput",
           "wait"]
