#!/usr/bin/env python3
"""Where a benchmark cell's Lambda iteration blocks the host on the card.

    python3 tools/sync_audit.py [--cells a,b] [--grid NZ NX NY]
                                [--n-sites N] [--out audit.json]

For each cell of BENCHMARK.json (all by default), builds the benchmark's
system (benchmark/systems.py) from the cell's configuration and traffic,
optionally on a smaller grid (--grid: the regular grid's size; --n-sites:
the Voronoi sites), runs one warm-up iteration, then one iteration under
torch.cuda.set_sync_debug_mode("warn") with nothing profiled, one with
torch.profiler recording the card alone (as the benchmark's first traced
window does) and one recording the host and the card (its second).  Every synchronising call the mode reports is listed by
the program's innermost frame (file:line) with the spans open around it
(voronoirt_tpu_torch.observability), and flagged where no engine.wait
span holds it.  Also prints the iteration record (waits, spans, eager
phases' device seconds), whether torch.autograd._profiler_enabled()
reads true while the profiler records, and the program's ranges that
the profiler placed on the card's timeline.

Needs a CUDA card; the Voronoi cells build the tessellation with the
repository's native library (make) unless it is cached.
"""

import argparse
import contextlib
import json
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _site(stack):
    """file:line of the innermost frame in the program's package, else
    the innermost frame outside the warnings module, with its callers."""
    for fr in reversed(stack):
        if "voronoirt_tpu_torch" in fr.filename:
            rel = Path(fr.filename).resolve().relative_to(ROOT)
            return f"{rel}:{fr.lineno} ({fr.name})"
    frames = [fr for fr in stack if not fr.filename.endswith("warnings.py")]
    return " <- ".join(f"{fr.filename}:{fr.lineno} ({fr.name})"
                       for fr in reversed(frames[-4:]))


def audit_step(system, mode):
    """One iteration under the sync debug mode: [(site, open spans)],
    whether the profiler reads as enabled, and the names of the program's
    ranges on the card's timeline (profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from voronoirt_tpu_torch.observability import RECORDER
    found = []
    stepping = False

    def show(message, category, filename, lineno, file=None, line=None):
        if stepping and "synchronizing" in str(message):
            found.append((_site(traceback.extract_stack()[:-1]),
                          tuple(RECORDER.open_spans())))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        acts = {"plain": [], "card": [ProfilerActivity.CUDA],
                "host+card": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
        try:
            with (profile(activities=acts[mode]) if acts[mode]
                  else contextlib.nullcontext()) as prof:
                enabled = torch.autograd._profiler_enabled()
                stepping = True
                system.step()
                stepping = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    on_card = set()
    if prof is not None:
        from torch.autograd import DeviceType
        on_card = {e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name.startswith("layer:")}
    return found, enabled, sorted(on_card)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=None)
    p.add_argument("--grid", type=int, nargs=3, default=None)
    p.add_argument("--n-sites", type=int, default=None)
    p.add_argument("--seed", type=int, default=2**31 + 5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, systems
    from voronoirt_tpu_torch.observability import RECORDER
    spec = harness.load_spec()
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in spec["workloads"]])
    print(f"card {torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    report = {}
    for name in names:
        cell, entry, config, traffic, _, _ = harness.resolve(spec, name)
        kind = config["grid"]["kind"]
        if kind == "regular" and args.grid:
            config["grid"].update(zip(("nz", "nx", "ny"), args.grid))
        if kind == "voronoi" and args.n_sites:
            config["grid"]["n_sites"] = args.n_sites
        system = systems.SYSTEMS[kind](config, traffic, args.seed,
                                       torch.device("cuda"))
        system.step()
        torch.cuda.synchronize()
        out = {}
        for key in ("plain", "card", "host+card"):
            found, enabled, on_card = audit_step(system, key)
            rec = RECORDER.iterations[-1]
            sites = Counter(site for site, _ in found)
            outside = Counter(site for site, spans in found
                              if "engine.wait" not in spans)
            out[key] = {"profiler_enabled": enabled,
                        "syncs": len(found), "waits": rec["waits"],
                        "spans": rec["spans"],
                        "device_s": rec["device_s"],
                        "sites": dict(sites),
                        "outside_wait": dict(outside),
                        "ranges_on_card": on_card}
            print(f"{name} {key}: profiler enabled {enabled}; "
                  f"{len(found)} synchronising calls, {rec['waits']} waits "
                  f"counted, {rec['spans']} spans; outside engine.wait: "
                  f"{dict(outside) or 'none'}", flush=True)
            for site, n in sorted(sites.items()):
                print(f"    {n:5d}  {site}")
            if key != "plain":
                print(f"    program ranges on the card: {on_card}")
            if rec["device_s"]:
                print(f"    eager device s {sum(rec['device_s'].values()):.6f}"
                      f" {rec['device_s']}")
        report[name] = out
        system.free()
        del system
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    bad = any(v["outside_wait"] for r in report.values() for v in r.values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
