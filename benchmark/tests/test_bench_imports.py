"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import ast
import subprocess
import sys

from benchmark.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "voronoirt_tpu"}
PROGRAM = "voronoirt_tpu_torch"


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in (REPO / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_top_imports(path)) & FORBIDDEN, path


def test_reference_sources_import_no_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert PROGRAM not in set(_top_imports(path)), path


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], capture_output=True, text=True,
        cwd=REPO, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(small_root):
    names = _loaded_after(
        "from benchmark import harness\n"
        f"harness.run_cell('small-regular.chunk3', 1, 0.1, False, "
        f"root={str(small_root)!r}, device='cpu')")
    assert not names & FORBIDDEN
    assert PROGRAM in names


def test_the_reference_loads_no_program():
    names = _loaded_after(
        "import numpy as np, torch\n"
        "from benchmark import data\n"
        "from benchmark.reference import physics, regular, voronoi\n"
        "a = data.synthetic_atmosphere(6, 4, 4, 1)\n"
        "g = regular.Grid(a, 'cpu')\n"
        "line = physics.lyman_alpha(5, 3)\n"
        "fr = physics.frozen_setup(line, g.T, g.ne, g.nH, 2e9)\n"
        "S = physics.planck(torch.as_tensor(line.lam)[:, None, None, None],"
        " g.T[None])\n"
        "q = physics.quadrature([[0.5, 120.0, 30.0], [0.5, 60.0, 210.0]])\n"
        "regular.iterate(g, line, fr, S, fr.lte, q)")
    assert not names & (FORBIDDEN | {PROGRAM})
