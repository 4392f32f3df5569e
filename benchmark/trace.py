"""The traced run's reductions: spans around the program's layer calls,
the device's busy and idle time, each layer's device time, and the
breakdown of device operations and idle gaps.

A traced run profiles two windows of the same iterations.  The first
records the card alone: its busy time (the union of its operations'
intervals), the window's length and the operations that took the most
time.  Recording the host's operations too slows the host's launch loop
by about a third at the regular grid's iteration, which would show as
idle time on the card; so the second window, which does record the
host, gives only what needs it: each layer's device time and the idle
gaps by what the host was doing.  Its spans come from the benchmark's
own wrappers: each layer entry point of the program is replaced, for
that window, by a wrapper that opens a `torch.profiler.record_function`
range named "layer:<layer>" around the call and records what the call's
work counts need (its shapes, a few host values, references to small
tensors).  No wrapper synchronises the card.  The profiler places each
range on the card's timeline too; an operation belongs to the layer
whose range holds it, and a layer with no range there is found by its
kernel names.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

import torch

SPAN = "layer:"


class Recorder:
    """Wraps attributes of the program's modules for the length of a
    `with` block; `calls[layer]` lists what each call's counter
    recorded."""

    def __init__(self):
        self.calls = defaultdict(list)
        self._saved = []

    def wrap(self, module, attr, layer, note=None, span=True):
        """Replace module.attr (a module's function or an object's
        method) by a wrapper that records note(*args) for `layer` and,
        with span, opens the layer's range around the call."""
        fn = getattr(module, attr)
        calls = self.calls[layer]
        name = SPAN + layer

        def wrapped(*args, **kwargs):
            if note is not None:
                calls.append(note(*args, **kwargs))
            if not span:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        self._saved.append((module, attr, fn))
        setattr(module, attr, wrapped)

    def restore(self):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals:
    overlapping device operations count once."""
    return sum(e - s for s, e in _union(intervals)) / 1e6


def _us(e):
    return e.time_range.start, e.time_range.end


def device_ops(prof):
    """[(name, start_us, end_us)] of the operations that ran on the card
    (kernels, copies, sets), and {layer: [(start_us, end_us)]} of the
    layer spans as the profiler placed them on the card's timeline (a
    range from the first to the last operation launched inside it)."""
    from torch.autograd import DeviceType
    ops, spans = [], defaultdict(list)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = _us(e)
        if e.name.startswith(SPAN):
            spans[e.name[len(SPAN):]].append((s, t))
        else:
            ops.append((e.name, s, t))
    return ops, spans


def summary(prof, window_s):
    """{'busy_s', 'window_s', 'device_ops'} of a profile of the device
    alone: the union of its operations' intervals, and the ten names
    that took the most time."""
    ops, _ = device_ops(prof)
    by_name = defaultdict(float)
    for name, s, t in ops:
        by_name[name] += (t - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_seconds([(s, t) for _, s, t in ops]),
            "window_s": window_s, "device_ops": [[n, v] for n, v in top]}


def attribute(prof, patterns):
    """{'layers': {layer: device s}, 'source': {layer: 'span' | 'name'},
    'idle_gaps'} of a profile of the host and the device: each
    operation's time goes to the layer whose span holds its midpoint on
    the card's timeline; a layer with no span there is found by its
    kernel names (patterns: {layer: regex})."""
    from torch.autograd import DeviceType
    ops, spans = device_ops(prof)
    marks = sorted((s, t, layer) for layer, iv in spans.items()
                   for s, t in iv)
    starts = [m[0] for m in marks]
    in_span, by_name = defaultdict(float), defaultdict(float)
    for name, s, t in ops:
        by_name[name] += (t - s) / 1e6
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and marks[i][0] <= mid <= marks[i][1]:
            in_span[marks[i][2]] += (t - s) / 1e6
    layers, source = {}, {}
    for layer, pat in patterns.items():
        if in_span.get(layer, 0.0) > 0.0:
            layers[layer], source[layer] = in_span[layer], "span"
            continue
        rx = re.compile(pat)
        named = sum(v for n, v in by_name.items() if rx.search(n))
        if named > 0.0:
            layers[layer], source[layer] = named, "name"
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    return {"layers": layers, "source": source,
            "idle_gaps": idle_gaps([(s, t) for _, s, t in ops], cpu)}


def idle_gaps(intervals, cpu_events, top=10):
    """[[host span, seconds], ...]: the device's idle time between its
    operations, summed by the innermost host range open when each gap
    began, the largest first."""
    merged = _union(intervals)
    cpu = sorted((_us(e) + (e.name,) for e in cpu_events),
                 key=lambda t: t[0])
    starts = [c[0] for c in cpu]
    by_span = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gap = (nxt - end) / 1e6
        if gap <= 0:
            continue
        i = bisect.bisect_right(starts, end)
        label, width = "(no host range)", float("inf")
        for s, e, name in cpu[max(0, i - 400):i]:
            if s <= end < e and e - s < width:
                label, width = name, e - s
        by_span[label] += gap
    return [[k, v] for k, v in sorted(by_span.items(),
                                      key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled(host=True):
    """A torch.profiler session over the CUDA card, and with host over
    the CPU's operations and ranges too (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if card else []) + (
        [ProfilerActivity.CPU] if host or not card else [])
    with profile(activities=acts) as prof:
        yield prof
