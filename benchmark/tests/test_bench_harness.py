"""Discovery by name, the refusal without a card, and the trace's
reductions."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from benchmark.tests.conftest import REPO, SMALL, make_root


def test_files_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files, with their entries, resolve with no edit to any file."""
    root = make_root(tmp_path, {"extra-cfg.extra-mix": SMALL[
        "small-regular.chunk3"]})
    (root / "benchmark" / "metrics" / "extra.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "extra.metric", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "iter_s",
                              "workloads": ["extra-cfg.extra-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell, entry, config, traffic, e2e, layers = harness.resolve(
        harness.load_spec(root), "extra-cfg.extra-mix", root)
    assert config["name"] == "extra-cfg"
    assert traffic["engine"]["lambda_chunk"] == 3
    assert "extra.metric" in [m["name"] for m in layers]
    assert harness.metric_reader("extra.metric", root)(None) == 42.0


def test_every_entry_has_its_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        harness.resolve(spec, w["name"])
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line, never a CPU run."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "regular-215x256x256.nlte-chunk13", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "refused" in out.stderr


def test_refuses_too_few_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.Refused):
        harness.require_card(4)


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time_total=0.0, cuda_time_total=0.0)


def test_idle_is_the_union_of_intervals():
    """Overlapping device operations count once; gaps are idle; an
    operation belongs to the layer whose span holds it on the card."""
    from torch.autograd import DeviceType
    dev = [(0, 100), (50, 150), (300, 400), (390, 420), (1000, 1100)]
    events = [_event(f"k{i}", s, e, DeviceType.CUDA)
              for i, (s, e) in enumerate(dev)]
    events += [_event("layer:sweep", 0, 150, DeviceType.CUDA),
               _event("layer:sweep", 0, 200, DeviceType.CPU),
               _event("aten::item", 420, 1000, DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    red = dict(trace.summary(prof, 1100e-6),
               **trace.attribute(prof, {"sweep": r"^k[01]$",
                                        "rest": r"^k[34]$"}))
    assert red["busy_s"] == pytest.approx(370e-6)
    run = harness.Run()
    run.trace = red
    idle = harness.metric_reader("device.idle_pct")(run)
    assert idle == pytest.approx(100 * (1 - 370 / 1100))
    # k0 and k1 inside the span: 200 us; k3, k4 by their names: 130 us
    assert red["layers"]["sweep"] == pytest.approx(200e-6)
    assert red["source"] == {"sweep": "span", "rest": "name"}
    assert red["layers"]["rest"] == pytest.approx(130e-6)
    assert "layer:sweep" not in dict(red["device_ops"])
    gaps = dict(red["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(580e-6)
    assert gaps["layer:sweep"] == pytest.approx(150e-6)


def test_benchmark_json_contract():
    """The keys and limits a BENCHMARK.json keeps to."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in [m["name"] for m in spec["end_to_end"]]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= cells
    assert (REPO / "BENCHMARK.json").stat().st_size < 64 * 1024
