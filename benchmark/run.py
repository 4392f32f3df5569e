"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the
cell asks for.  --trace 0 measures the cell's end-to-end metrics with
nothing traced; --trace 1 reads its per-layer metrics from a profiled
window.  Either way the window's iteration is checked against the plain
reference after the window, and every number compared is printed beside
its limit, on standard error and last in the result line.  Exits
non-zero with no result line without a card (there is no CPU
fallback), with fewer cards than the cell asks for, or when jax, jaxlib,
flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Caches inside the checkout at fixed paths; no JAX through
    transformers-style optional imports."""
    cache = ROOT / "build" / "benchmark-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from benchmark import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.Refused as err:
        print(f"refused: {err}", file=sys.stderr)
        return 2
    found = harness.loaded_forbidden()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
