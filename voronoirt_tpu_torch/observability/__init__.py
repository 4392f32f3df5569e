"""Timings, throughput metrics and profiler traces."""

from .metrics import PhaseTimer, device_trace, nan_guard, throughput

__all__ = ["PhaseTimer", "device_trace", "nan_guard", "throughput"]
