#!/usr/bin/env python3
"""chip_smoke.py phase 5's production iteration with the package of a
given checkout, on one CUDA card: its seconds, peak memory and the
sha256 of S and the populations.

    python3 tools/phase5_checksum.py [--repo DIR] [--dtype float32]
                                     [--repeat N] [--save P.npy]
                                     [--against P.npy]

Runs phase 5's configuration (215x256x256 grid, 91 wavelengths, ul7n12,
lambda-streamed, lambda_chunk 13, 4-angle groups; --dtype float32 makes
it phase 15's) through RegularEngine.run(), one iteration from the LTE
start, N times, each on a new engine, with the voronoirt_tpu_torch
package of --repo (its kernels built there), e.g. the parent commit
unpacked with git archive; the helpers (chip_smoke.py's PROD and
state_digest) are always this checkout's.  It prints each iteration's
seconds and peak memory and the digests of the last run, the line
phase 5 prints: equal digests from two checkouts on one card mean
bit-equal results, and the seconds of two checkouts run in turns in one
call compare them on that card.  --save writes the last run's
populations to a .npy file; --against reads another checkout's (a
--save of the same configuration) and prints the largest relative
difference of the populations from them, and where it lies, when the
two differ.
"""

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _this_chip_smoke():
    """This checkout's chip_smoke.py as a module, whatever --repo
    names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package runs the iteration")
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--save", default=None,
                    help="write the last run's populations here (.npy)")
    ap.add_argument("--against", default=None,
                    help="another checkout's populations (.npy) to compare")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    cs = _this_chip_smoke()
    sys.path.insert(0, repo)
    import torch
    from voronoirt_tpu_torch import Config, require_cuda, synthetic_atmosphere
    from voronoirt_tpu_torch.engine import RegularEngine
    from voronoirt_tpu_torch.kernels import build
    from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
    require_cuda()
    print(cs.smi_line(), flush=True)
    t = time.perf_counter()
    build.library()
    print(f"{repo}: kernels built/loaded in {time.perf_counter() - t:.2f} s",
          flush=True)
    p = cs.PROD
    atmos = synthetic_atmosphere(nz=p["nz"], nx=p["nx"], ny=p["ny"])
    cfg = Config(nlam_bb=p["nlam_bb"], nlam_bf=p["nlam_bf"],
                 quadrature=p["quadrature"], stream_rates=True,
                 lambda_chunk=p["lambda_chunk"],
                 group_max_angles=p["group_max_angles"], maxiter=1, eps=0.0,
                 dtype=args.dtype)
    T = torch.as_tensor(atmos.temperature, dtype=getattr(torch, args.dtype),
                        device="cuda")
    line = lyman_alpha_line(cfg.nlam_bb, cfg.nlam_bf, T)
    for i in range(args.repeat):
        res = None
        eng = RegularEngine(atmos, line, cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = eng.run()
        peak = torch.cuda.max_memory_allocated()
        print(f"{repo} {args.dtype} run {i + 1}: the iteration "
              f"{res.timings[0]:.4f} s, peak {peak / 2**30:.3f} GiB",
              flush=True)
        del eng
    d_S, d_P = cs.state_digest(res.S, res.populations)
    print(f"{repo} {args.dtype}: sha256 of S {d_S}, of the populations "
          f"{d_P}", flush=True)
    import numpy as np
    P = res.populations.cpu().numpy()
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)),
                    exist_ok=True)
        np.save(args.save, P)
    if args.against:
        ref = np.load(args.against)
        rel = np.abs(P / ref - 1.0)
        per_nH = np.abs(P - ref) / ref.sum(-1, keepdims=True)
        at = np.unravel_index(np.argmax(rel), rel.shape)
        print(f"{repo} {args.dtype}: populations against {args.against}: "
              f"bit-equal {np.array_equal(P, ref)}, largest relative "
              f"difference {float(rel.max()):.3e} at (z, x, y, level) "
              f"{tuple(int(i) for i in at)}, largest |difference| / n_H "
              f"{float(per_nH.max()):.3e}",
              flush=True)


if __name__ == "__main__":
    main()
