"""nvcc build and ctypes loader for voronoirt_tpu_torch/csrc/*.cu.

The kernels have a plain C interface: every pointer, and the CUDA
stream, passes as ctypes.c_void_p, every size as ctypes.c_int, and each
launch returns cudaGetLastError() for the wrapper to check.  No PyTorch
header is compiled, so the build takes seconds.

At first use, library() compiles all sources into one shared library
for sm_90a (Hopper) under <repo>/build/kernels/, named by a hash of the
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

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so the kernels round op by op
# like their plain PyTorch versions (float32 march chains of n_sweeps * N
# dependent steps would otherwise drift apart by up to ~1e-4 relative)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# (name, argtypes) of every exported launch function
_SIGNATURES = {
    "vrt_xy_plane": [_P] * 9 + [_I] * 5 + [_P],
    "vrt_march_coeffs": [_P] * 10 + [_I] * 7 + [_P],
    "vrt_march_chain": [_P] * 3 + [_I] * 8 + [_P],
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
def library(flags: tuple = NVCC_FLAGS) -> ctypes.CDLL:
    """The kernels' shared library, built on first call.  The wrappers
    use the default flags; other flags build a variant beside it, for
    measurement (tools/profile_iteration.py)."""
    srcs, _ = _sources(flags)
    lib_path = library_path(flags)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a private name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", tmp, *map(str, srcs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + proc.stdout
                                   + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f64", "_f32"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def launch_fn(name: str, dtype):
    """The C launch function `name` for a torch dtype (f32 or f64)."""
    import torch
    suffix = {torch.float64: "_f64", torch.float32: "_f32"}[dtype]
    return getattr(library(), name + suffix)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
