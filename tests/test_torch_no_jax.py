"""voronoirt_tpu_torch and every submodule import without jax and
without any module of the JAX package (voronoirt_tpu)."""

import os
import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import voronoirt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "voronoirt_tpu" or m.startswith("voronoirt_tpu."))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""


def test_port_never_imports_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 51, proc.stdout
    for name in ("analysis", "analysis.plots", "analysis.line_figures"):
        assert f"voronoirt_tpu_torch.{name}" in proc.stdout.split(), name
