"""The readings that the correctness limits are set from, on the card
at a cell's own size: the program's numbers over many seeds, and the
control's, the program with its float32 path switched on.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--dtype float32] [--seconds 5]

One process runs every seed (set-up, a short window, the check), and
prints one JSON line a seed with each number compared.  The benchmark's
own runs never run this.
"""

import argparse
import json
import sys

from run import ROOT, _environment


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default=None)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    _environment()
    import gc

    import torch

    from benchmark import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               root=ROOT, dtype=args.dtype)
        print(json.dumps({"seed": seed, "dtype": args.dtype or "config",
                          "correct": res["correct"],
                          "iter_s": res["metrics"].get("iter_s"),
                          "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
