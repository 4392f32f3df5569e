#!/usr/bin/env python3
"""The Bezier xy step timed on one CUDA card as a step of a segment (X1
as a segment piece, solvers/xy_bezier_segment.py) with the package of a
given checkout.

    python3 tools/time_xy_bezier_segment.py [--repo DIR]
                                            [--cases 13:float64,...]
                                            [--profiler-check]

For each case (B:dtype) a 214-step Bezier xy segment at (B, 256, 256),
one launch, through chip_smoke.py's time_xy_bezier_segment: the
kernel's ms a step by CUDA events, X1's plane step (device time) and
the plain version's on the same inputs, the bound of a step, and the
kernel's registers, local memory and the clusters the card runs at
once.

--profiler-check first asks, in this fresh process, which torch.profiler
sessions record the segment kernel (a thread-block cluster launch,
cudaLaunchKernelEx): the device time of a 214-step segment at (13, 256,
256) float64 in the process's first profiler session, then in a session
after one of X1 (a plain launch), then again, and of xy_segment (K1 as
a segment, also a cluster launch) last; 0 where a session recorded
none of the kernel.  With --repo the voronoirt_tpu_torch
package (and its kernels, built there) is that checkout's, e.g. the
parent commit or a variant unpacked under build/; the helpers
(chip_smoke.py) are always this checkout's.  Run several checkouts in
turns in one call to compare them on one card.
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recorded_ms(fn, kernel):
    """ms of device time torch.profiler records in kernels whose name
    holds `kernel` over one call of fn (0.0 where it records none), and
    the number of device events it records in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", 0) for e in events
             if kernel in e.key)
    return us / 1e3, sum(e.count for e in events)


def profiler_check(cs):
    import torch
    from voronoirt_tpu_torch.solvers import xy_bezier as xb
    from voronoirt_tpu_torch.solvers import xy_bezier_segment as xbs
    from voronoirt_tpu_torch.solvers import xy_segment as xs
    B, nz, nx, ny = 13, 215, 256, 256
    gen = torch.Generator(device="cuda").manual_seed(7)
    alpha, S, I0 = cs._xbs_fields(gen, nz, B, nx, ny, torch.float64)
    steps, r, fx, fy = cs._xbs_segment(torch.Generator().manual_seed(7), nz,
                                       nz - 1, 1, "boundary")
    cube = torch.empty_like(alpha)
    geom = [torch.full((B,), v, dtype=torch.float64, device="cuda")
            for v in (0.7, 0.3, 0.6)]
    k = min(nz - 1, xs.piece_steps(B, nx, ny, torch.float64))
    buf = torch.empty((k, B, nx, ny), dtype=torch.float64, device="cuda")

    def segment():
        xbs.xy_bezier_segment(alpha, S, I0, steps, 1, r, fx, fy, -1, 0, cube)

    def x1():
        xb.xy_bezier(I0, alpha[2], alpha[1], S[2], S[1], alpha[0], S[0],
                     1.0, 0.3, 0.6, 1.0, 0.3, 0.6, 0.0, -1, 0)

    def k1():
        xs.xy_segment(alpha, S, I0, list(range(1, k + 1)), 1,
                      *(g.expand(k, B).contiguous() for g in geom), -1, 0,
                      buf)

    for fn in (segment, x1, k1):
        fn()        # launched (and loaded) before any profiler session
    for i, (name, fn, kernel) in enumerate((
            ("segment", segment, "xy_bezier_segment_kernel"),
            ("X1", x1, "xy_bezier_kernel"),
            ("segment", segment, "xy_bezier_segment_kernel"),
            ("xy_segment", k1, "xy_segment_"))):
        ms, n = _recorded_ms(fn, kernel)
        print(f"  profiler session {i + 1}: {name} {ms:.4f} ms of device "
              f"time recorded ({n} device events in the session)",
              flush=True)
    del alpha, S, I0, cube, buf
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="the checkout whose package is timed")
    ap.add_argument("--cases", default="13:float64,13:float32,1:float64",
                    help="comma-separated B:dtype cases")
    ap.add_argument("--profiler-check", action="store_true",
                    help="first, which profiler sessions record the "
                         "segment kernel")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    sys.path.insert(0, repo)
    from voronoirt_tpu_torch import require_cuda
    from voronoirt_tpu_torch.kernels import build
    require_cuda()
    print(cs.smi_line(), flush=True)
    build.library()
    print(f"{repo}:", flush=True)
    if args.profiler_check:
        profiler_check(cs)
    for case in args.cases.split(","):
        B, dtype_name = case.split(":")
        cs.time_xy_bezier_segment(int(B), dtype_name)


if __name__ == "__main__":
    main()
