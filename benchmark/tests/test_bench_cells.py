"""The harness on the small cells, here through the program's plain
versions on the CPU: the reference agrees with the program, the result
has the contract's keys with the numbers compared last, and the control
and the planted faults come out as not correct."""

import json

import pytest
import torch

from benchmark import harness

CELLS = ("small-regular.chunk3", "small-voronoi.layer")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(root, cell, **kw):
    return harness.run_cell(cell, 2**31 + 11, 0.2, False, root=root,
                            device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees(small_root, cell):
    res = run(small_root, cell)
    assert res["correct"], res["checks"]
    assert list(res) == KEYS
    for name in ("iter_s", "setup_s"):
        assert res["metrics"][name]["value"] > 0
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(small_root, cell):
    res = run(small_root, cell, dtype="float32")
    assert not res["correct"]
    assert res["checks"]["S_rel"]["value"] > res["checks"]["S_rel"]["limit"]


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from benchmark import systems

    def step(self):
        if self.state is None:
            return original(self)
        return 0.5

    original = systems.System.step
    monkeypatch.setattr(systems.System, "step", step)


def _half_batch(monkeypatch):
    """Half of each sweep's batch of wavelengths left out, their J the
    mean over the rest."""
    from voronoirt_tpu_torch.engine import lambda_iter as li

    def halved(fn, dim):
        def J_chunk(self, S_c, populations, damp_c, lam_c, g_cell=None):
            h = max(1, lam_c.shape[0] // 2)
            J = fn(self, S_c[:h], populations,
                   None if damp_c is None else damp_c[:h], lam_c[:h],
                   g_cell)
            rest = J.mean(dim, keepdim=True).expand_as(
                J.narrow(dim, 0, 1)).expand(
                    *[lam_c.shape[0] - h if d == dim else -1
                      for d in range(J.dim())])
            return torch.cat([J, rest], dim)
        return J_chunk

    monkeypatch.setattr(li.RegularEngine, "_J_chunk_grouped",
                        halved(li.RegularEngine._J_chunk_grouped, 0))
    monkeypatch.setattr(li.VoronoiEngine, "_J_chunk_T",
                        halved(li.VoronoiEngine._J_chunk_T, 1))


def _altered(monkeypatch):
    """One value of S altered where the iteration produces it."""
    from benchmark import systems
    original = systems.System.step

    def step(self):
        diff = original(self)
        self.state[0].view(-1)[7] *= 1.001
        return diff

    monkeypatch.setattr(systems.System, "step", step)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_faults_fail(small_root, cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(small_root, cell)["correct"]


def test_cpu_result_has_no_device_metrics(small_root):
    res = harness.run_cell(CELLS[0], 5, 0.2, True, root=small_root,
                           device="cpu")
    assert "device.idle_pct" not in res["metrics"]
    assert not any(k.endswith("_roofline") for k in res["metrics"])
    assert res["correct"]


@pytest.mark.cuda
def test_cell_on_card(card):
    """Each cell of BENCHMARK.json once on the card, briefly."""
    spec = harness.load_spec()
    for w in spec["workloads"]:
        res = harness.run_cell(w["name"], 3, 1.0, False)
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
