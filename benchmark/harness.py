"""One run of one cell: set-up, warm-up, the measured window, the check
of the window's iteration against the plain reference, and the result
line.

Everything is found by name from BENCHMARK.json: a workload names its
configuration (whose entry gives the file) and its traffic mix
(benchmark/traffic/<traffic>.json); a per-layer metric is read by
benchmark/metrics/<metric>.py.  Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voronoirt_tpu")


class Refused(RuntimeError):
    """The run cannot be made here (no card, too few, a missing file)."""


# ------------------------------------------------------------- discovery

def load_spec(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"no {path}")
    return json.loads(path.read_text())


def resolve(spec, workload, root=ROOT):
    """(cell, configuration entry, configuration, traffic, end-to-end
    metrics, per-layer metrics) of a workload, its files read."""
    root = Path(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in spec["per_layer"]
              if mine(m) and ("workloads" in m or m["moves"] in moved)]
    return cell, entry, config, traffic, e2e, layers


def metric_reader(name, root=ROOT):
    """The read(run) function of benchmark/metrics/<name>.py."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------- the run

class Run:
    """What a run measured, for the per-layer readers: host spans, the
    reduced trace, the work of each layer's calls, the counters."""

    def __init__(self):
        self.spans = {}
        self.trace = None
        self.least_s = {}
        self.counters = {}
        self.peak_bytes = None
        self.iter_s = []

    def roofline_pct(self, layer):
        """The least time of the layer's calls in the traced window over
        the device time attributed to them, in per cent; None where the
        layer ran no call or no device time was attributed."""
        if self.trace is None:
            return None
        dev = self.trace["layers"].get(layer)
        least = self.least_s.get(layer)
        if not dev or not least:
            return None
        return 100.0 * least / dev


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_card(chips):
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device is visible: the benchmark measures "
                      "the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} card(s), "
                      f"{torch.cuda.device_count()} visible")


def _least(calls, system, fields, took):
    """{layer: least seconds} of the recorded calls; took[layer]: the
    host seconds their counting took."""
    from . import systems, work
    cache, out = {}, {}
    for layer, notes in calls.items():
        t0 = time.perf_counter()
        total = 0.0
        for kind, w, dtype in notes:
            if kind in ("e1", "r1"):
                if kind == "e1":
                    key = (kind, w[0], tuple(w[1].tolist()), w[2], w[3])
                else:
                    key = (kind,) + w
                key += (str(dtype),)
                if key not in cache:
                    k = (w[0], w[1].tolist(), w[2], w[3]) if kind == "e1" \
                        else w
                    cache[key] = systems.data_work(
                        kind, k, fields, 8 if "64" in str(dtype) else 4)
                w = cache[key]
            elif kind == "v1":
                key = ("v1", id(w[0]), w[1], w[2])
                if key not in cache:
                    sd = w[0]
                    cache[key] = work.voronoi_stage(
                        sd.off, sd.up_slot.cpu().numpy(),
                        sd.up_site.cpu().numpy(), sd.row_site.cpu().numpy(),
                        sd.passes, w[1], w[2])
                w = cache[key]
            total += work.least_s(*w, dtype)[0]
        out[layer] = total
        took[layer] = (round(time.perf_counter() - t0, 3), len(notes))
    took["distinct calls"] = len(cache)
    return out


def run_cell(workload, seed, seconds, traced, root=ROOT, device="cuda",
             dtype=None, t_start=None, log=sys.stderr):
    """Run one cell; returns the result dict (the contract's line)."""
    import torch

    from . import systems, trace
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    cell, entry, config, traffic, e2e, layers = resolve(spec, workload, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        require_card(cell["chips"])
    system_cls = systems.SYSTEMS[config["grid"]["kind"]]
    run = Run()

    # ---- set-up: inputs from the seed, the engine, one warm-up iteration
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = system_cls(config, traffic, seed, dev, dtype)
    run.spans.update(system.spans)
    t = time.perf_counter()
    system.step()
    _sync(dev)
    run.spans["warm_iter_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    # ---- the measured window; traced: two windows of the traffic's
    # trace_iterations, the card alone, then the host and the card with
    # the layers' spans
    diffs = []
    n_trace = int(traffic.get("trace_iterations", 3))

    def window(stop):
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            diffs.append(system.step())
            now = time.perf_counter()
            run.iter_s.append(now - t)
            if stop(now - t0):
                break
        _sync(dev)
        return time.perf_counter() - t0

    if not traced:
        window_s = window(lambda elapsed: elapsed >= seconds)
    else:
        with trace.profiled(host=False) as prof:
            window_s = window(lambda _: len(run.iter_s) >= n_trace)
        summary = trace.summary(prof, window_s)
        del prof
        rec = trace.Recorder()
        patterns = system.layers(rec)
        system.counters_reset()
        with trace.profiled(host=True) as prof:
            window(lambda _: len(run.iter_s) >= 2 * n_trace)
        rec.restore()
        run.counters = system.counters()

    # ---- the check: the window's state, one more iteration of the same
    # call, then the program freed and the reference run
    start = system.host_state()
    frozen = {k: v.detach().cpu() for k, v in system.frozen().items()}
    diff = system.step()
    _sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    run.peak_bytes = peak
    if traced:
        t = time.perf_counter()
        fields = system.work_fields(system.state[1])
        took = {}
        run.least_s = _least(rec.calls, system, fields, took)
        print(f"work counts: host seconds by layer {took}", file=log)
        del fields
        run.spans["work_counts_s"] = time.perf_counter() - t
        t = time.perf_counter()
        run.trace = dict(summary, **trace.attribute(prof, patterns))
        run.spans["trace_reduce_s"] = time.perf_counter() - t
        del prof
    out = (system.state[0], system.state[1], diff)
    system.free()
    t = time.perf_counter()
    ref = system.reference(start)
    _sync(dev)
    run.spans["reference_s"] = time.perf_counter() - t
    numbers = system.compare(frozen, out, ref)
    del out, ref, start
    limits = config["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)

    # ---- the result
    metrics = {}
    if not traced:
        values = {"iter_s": window_s / len(run.iter_s),
                  "iter_p95_s": (statistics.quantiles(run.iter_s, n=20)[-1]
                                 if len(run.iter_s) >= 20 else None),
                  "setup_s": setup_s}
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in layers:
            v = metric_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(run.iter_s) + 1,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": device_info}
    if traced:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
        print(f"layer device time source {run.trace['source']}; device s "
              f"{run.trace['layers']}; least s {run.least_s}; counters "
              f"{run.counters}", file=log)
    print(f"window {window_s:.4f} s, {len(run.iter_s)} iterations, "
          f"iteration s {[round(x, 4) for x in run.iter_s]}, "
          f"criteria {diffs[0]:.4e} .. {diffs[-1]:.4e}; set-up {setup_s:.3f}"
          f" s; spans {run.spans}", file=log)
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=log)
    result["checks"] = checks
    return result


def loaded_forbidden():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
