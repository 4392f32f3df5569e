#!/usr/bin/env python3
"""What holds the xy_segment kernel (K1 a segment a launch) back, on one
CUDA card.

    python3 tools/profile_xy_segment.py [--out xy_segment.json]

Times a 214-plane xy segment at (B, 256, 256), B = 52, 13 and 1, in
float64 and float32, in the sweep's pieces, through four builds of
csrc/xy_segment.cu, in the order A B C D D C B A:

  kernel       the package's kernel (voronoirt_tpu_torch/kernels/build.py);
  no-math      a probe: each point's arithmetic replaced by a sum of
               four of its taps, the loads, stores and barriers kept
               (what the kernel costs without its floating-point work);
  no-barrier   a probe: the cluster barrier of the step loop removed
               (its results are wrong; what the barrier costs);
  per-plane    a loop of the per-plane kernel xy_plane over the same
               segment (csrc/xy_plane.cu, one launch a plane).

The probes are built from the kernel's source by text substitution into
build/kernels/ beside the package's library, and are timed only; the
kernel's planes are held bit-equal to the per-plane loop's.  Prints ms a
step beside the bytes bound of a step (three planes over 3.35 TB/s);
--out also writes the table as JSON.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from voronoirt_tpu_torch import require_cuda  # noqa: E402
from voronoirt_tpu_torch.kernels import build  # noqa: E402
from voronoirt_tpu_torch.solvers import xy_plane as xp  # noqa: E402
from voronoirt_tpu_torch.solvers import xy_segment as xs  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA's data sheet)
NZ, NX, NY = 215, 256, 256

_MATH_FROM = "        const T dtau =\n"
_MATH_TO = "        Ni[p] = v;"
_NO_MATH = ("        const T v = Ca[p] + Cs[p] + ld_cluster(a0 + oi, T()) +\n"
            "                    ld_cluster(a1 + os, T()) + T(dy) * fxb * fyb"
            " * rb;\n")
_WAIT = "    if (j > 0) cluster_wait();\n"
_ARRIVE = "      if (i == i_arrive) cluster_arrive();\n"
_LAST_WAIT = "  if (n_steps > 0) cluster_wait();\n"


def _probe_sources():
    src = (build.SRC_DIR / "xy_segment.cu").read_text()
    for marker in (_MATH_FROM, _MATH_TO, _WAIT, _ARRIVE, _LAST_WAIT):
        if marker not in src:
            raise RuntimeError(f"xy_segment.cu changed: {marker.strip()!r} "
                               f"not found; update the probes")
    a, b = src.index(_MATH_FROM), src.index(_MATH_TO)
    return {"no-math": src[:a] + _NO_MATH + src[b:],
            # the step loop's barrier halves go; one whole barrier at the
            # end keeps the CTAs' shared memory alive for their neighbours
            "no-barrier": src.replace(_WAIT, "").replace(_ARRIVE, "").replace(
                _LAST_WAIT, "  cluster.sync();\n")}


def _build_probes():
    """Compile each probe into its own shared library, all at once."""
    flags = list(build.NVCC_FLAGS) + ["-I", str(build.SRC_DIR)]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in _probe_sources().items():
        tag = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()
        cu = build.BUILD_DIR / f"probe_{name}_{tag[:12]}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on probe {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for suffix in ("_f64", "_f32"):
            fn = getattr(lib, "vrt_xy_segment" + suffix)
            fn.argtypes = build._SIGNATURES["vrt_xy_segment"]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def measure(B, dtype, libs):
    """ms a step of each build over one 214-plane segment at (B, 256,
    256); the kernel's last plane against the per-plane loop's."""
    g = torch.Generator(device="cuda").manual_seed(17)

    def u(*shape):
        return torch.rand(*shape, generator=g, device="cuda",
                          dtype=torch.float64)
    alpha = (10.0 ** (-5.0 + 7.0 * u(NZ, B, NX, NY))).to(dtype)
    S = (0.1 + 0.9 * u(NZ, B, NX, NY)).to(dtype)
    I0 = u(B, NX, NY).to(dtype)
    n = NZ - 1
    r = (10.0 ** (-1.0 + 2.0 * u(n, B))).to(dtype)
    fx, fy = u(n, B).to(dtype), u(n, B).to(dtype)
    steps = list(range(1, NZ))
    k = min(n, xs.piece_steps(B, NX, NY, dtype))
    buf = torch.empty((k, B, NX, NY), dtype=dtype, device="cuda")
    suffix = "_f64" if dtype == torch.float64 else "_f32"
    stream = torch.cuda.current_stream().cuda_stream
    last = {}

    def segment(launch):
        def run():
            carry = I0
            for j0 in range(0, n, k):
                j1 = min(j0 + k, n)
                out = buf[:j1 - j0]
                launch(carry, j0, j1, out)
                carry = out[-1].clone()
            last[launch] = carry
        return run

    def package(carry, j0, j1, out):
        xs.xy_segment(alpha, S, carry, steps[j0:j1], 1, r[j0:j1], fx[j0:j1],
                      fy[j0:j1], -1, 0, out)

    def probe(lib):
        fn = getattr(lib, "vrt_xy_segment" + suffix)

        def launch(carry, j0, j1, out):
            err = fn(alpha.data_ptr(), S.data_ptr(), carry.data_ptr(),
                     r[j0:j1].data_ptr(), fx[j0:j1].data_ptr(),
                     fy[j0:j1].data_ptr(), out.data_ptr(), B, NX, NY, -1, 0,
                     steps[j0], 1, j1 - j0, stream)
            build.check(err, "xy_segment probe")
        return launch

    def per_plane():
        I = I0
        for j, t in enumerate(steps):
            I = xp.xy_plane(alpha[t - 1], alpha[t], S[t - 1], S[t], I, r[j],
                            fx[j], fy[j], -1, 0)
        last["per-plane"] = I

    runs = {"kernel": segment(package), "per-plane": per_plane}
    runs.update({name: segment(probe(lib)) for name, lib in libs.items()})
    order = list(runs)
    times = defaultdict(list)
    for name in order + order[::-1]:
        times[name].append(_ms(runs[name], 3) / n)
    equal = torch.equal(last[package], last["per-plane"])
    del alpha, S, I0, buf, last
    torch.cuda.empty_cache()
    plane = B * NX * NY * torch.empty((), dtype=dtype).element_size()
    return {"ms_a_step": dict(times), "piece": k,
            "bound_ms": 1e3 * 3 * plane / HBM_BYTES_PER_S,
            "kernel_equals_per_plane": equal}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    libs = _build_probes()
    table = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        print(f"{name}: {xs.layout(NX, NY, dtype)}", flush=True)
        for B in (52, 13, 1):
            row = measure(B, dtype, libs)
            table[f"{name}_B{B}"] = row
            print(f"  B={B}: ms a step (each build twice) "
                  + "; ".join(f"{k} {' / '.join(f'{t:.5f}' for t in v)}"
                              for k, v in row["ms_a_step"].items())
                  + f"; bound {row['bound_ms']:.5f} ms; kernel bit-equal "
                  f"to the per-plane loop: {row['kernel_equals_per_plane']}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "table": table}, f, indent=1)
    if not all(row["kernel_equals_per_plane"] for row in table.values()):
        raise SystemExit("xy_segment differs from the per-plane kernel")


if __name__ == "__main__":
    main()
