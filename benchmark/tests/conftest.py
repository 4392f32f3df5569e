"""Fixtures of the benchmark's own tests: a checkout-like root holding
BENCHMARK.json and the benchmark's files, with small copies of the
configurations that the CPU runs through the program's plain versions.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m cuda    # on a machine with a card
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the small cells: (configuration, its changes, traffic, its settings)
SMALL = {
    "small-regular.chunk3": (
        "regular-215x256x256", {"grid": dict(nz=12, nx=8, ny=8),
                                "physics": dict(nlam_bb=5, nlam_bf=3)},
        {"engine": {"stream_rates": True, "lambda_chunk": 3,
                    "group_max_angles": 4}, "trace_iterations": 2}),
    "small-voronoi.layer": (
        "voronoi-442k", {"grid": dict(n_sites=400, sampled_from=dict(
            nz=20, nx=12, ny=12, seed=1998)),
            "atmosphere": dict(nz=20, nx=12, ny=12),
            "physics": dict(nlam_bb=5, nlam_bf=3)},
        {"engine": {"voronoi_order": "layer"}, "trace_iterations": 2}),
}


def make_root(path, cells=SMALL):
    """A copy of the benchmark's files under path whose BENCHMARK.json
    holds the small cells too."""
    shutil.copytree(REPO / "benchmark", path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (base, changes, traffic) in cells.items():
        cfg_name, mix = cell.split(".")
        cfg = json.loads((REPO / "benchmark" / "configs"
                          / f"{base}.json").read_text())
        cfg["name"] = cfg_name
        for key, sub in changes.items():
            cfg[key].update(sub)
        (path / "benchmark" / "configs" / f"{cfg_name}.json").write_text(
            json.dumps(cfg))
        (path / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(traffic))
        spec["configs"].append({"name": cfg_name, "source": "a test size",
                                "file": f"benchmark/configs/{cfg_name}.json",
                                "reduced": [], "why": "a test size"})
        spec["workloads"].append({"name": cell, "config": cfg_name,
                                  "traffic": mix, "chips": 1,
                                  "why": "a test size"})
        for m in spec["per_layer"]:
            m["workloads"].append(cell)
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """Skips where no CUDA card is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
