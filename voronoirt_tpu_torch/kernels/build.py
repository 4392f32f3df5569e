"""nvcc build and ctypes loader for voronoirt_tpu_torch/csrc/*.cu.

The kernels have a plain C interface: every pointer, and the CUDA
stream, passes as ctypes.c_void_p, every size as ctypes.c_int (a stride
that may pass 2^31 as ctypes.c_longlong), every
physical constant as ctypes.c_double, and each launch returns
cudaGetLastError() for the wrapper to check.  No PyTorch
header is compiled, so the build takes seconds.

At first use, library() compiles each source with its own nvcc, all
started together, and links the objects into one shared library for
sm_90a (Hopper) under <repo>/build/kernels/, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads the cached library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..observability import span

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so the kernels round op by op
# like their plain PyTorch versions (float32 march chains of n_sweeps * N
# dependent steps would otherwise drift apart by up to ~1e-4 relative)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
# (name, argtypes) of every exported launch function
_SIGNATURES = {
    "vrt_xy_plane": [_P] * 9 + [_I] * 5 + [_P],
    "vrt_xy_bezier": [_P] * 8 + [_I] * 5 + [_D] * 7 + [_P],
    "vrt_xy_bezier_segment": [_P] * 5 + [_I] * 9 + [_P],
    "vrt_xy_bezier_segment_info": [_I] * 2 + [_P],
    "vrt_march_coeffs": [_P] * 10 + [_I] * 7 + [_P],
    "vrt_march_chain": [_P] * 3 + [_I] * 9 + [_P],
    "vrt_xy_segment": [_P] * 7 + [_I] * 8 + [_P],
    "vrt_xy_segment_info": [_I] * 2 + [_P],
    "vrt_alpha_tot": [_P] * 8 + [_I] * 7 + [_P] * 2 + [_D] * 7 + [_P],
    "vrt_voigt_rows": [_P] * 4 + [_I] * 2 + [_D] * 2 + [_P],
    "vrt_voronoi_stage": [_P] * 12 + [_I] * 7 + [_P],
    "vrt_voronoi_stage_info": [_I] * 2 + [_P],
    "vrt_group_emit": [_P] * 4 + [_I] * 10 + [_P],
    "vrt_group_stack": [_P] * 2 + [_I] * 5 + [_L] * 3 + [_I] * 3 + [_P],
    "vrt_group_fold": [_P] * 3 + [_I] * 4 + [_L] * 3 + [_P],
    "vrt_rates_chunk": [_P] * 12 + [_I] + [_L] * 2 + [_I] * 3 + [_D] * 8
    + [_P],
    "vrt_s_update": [_P] * 6 + [_L] + [_I] + [_D] * 2 + [_P] * 2,
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build voronoirt_tpu_torch's kernels")


def _sources(flags):
    srcs = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in srcs + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return srcs, digest.hexdigest()[:16]


def library_path(flags: tuple = NVCC_FLAGS) -> Path:
    """Where library(flags) is (or will be) built: the name carries a
    hash of the sources and flags."""
    return BUILD_DIR / f"libvrt_kernels_{_sources(flags)[1]}.so"


@functools.cache
@span("kernels.load")
def library(flags: tuple = NVCC_FLAGS) -> ctypes.CDLL:
    """The kernels' shared library, built on first call (the spans
    kernels.load, and kernels.build around an nvcc run).  The wrappers
    use the default flags; other flags build a variant beside it, for
    measurement (tools/profile_iteration.py)."""
    srcs, _ = _sources(flags)
    lib_path = library_path(flags)
    if not lib_path.exists():
        _build(srcs, flags, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f64", "_f32"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@span("kernels.build")
def _build(srcs, flags, lib_path):
    """Compile each source with its own nvcc, all started together, and
    link the objects into lib_path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a private name, then rename: a concurrent build
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            compile_flags = [f for f in flags if f != "-shared"]
            objs = [os.path.join(objdir, p.stem + ".o") for p in srcs]
            procs = [subprocess.Popen(
                [_nvcc(), *compile_flags, "-c", "-o", o, str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for p, o in zip(srcs, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            failed = [f"{p.name}:\n{log}" for p, log, proc
                      in zip(srcs, logs, procs) if proc.returncode != 0]
            if not failed:
                link = subprocess.run([_nvcc(), *flags, "-o", tmp, *objs],
                                      capture_output=True, text=True)
                if link.returncode != 0:
                    failed = [link.stdout + link.stderr]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def launch_fn(name: str, dtype):
    """The C launch function `name` for a torch dtype (f32 or f64)."""
    import torch
    suffix = {torch.float64: "_f64", torch.float32: "_f32"}[dtype]
    return getattr(library(), name + suffix)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
