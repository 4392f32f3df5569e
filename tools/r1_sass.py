#!/usr/bin/env python3
"""Registers, spills and instructions a point of the rates kernel R1
(rates_chunk_kernel of csrc/rates.cu), by row kind, counted in the code
nvcc compiles for the H100.

    python3 tools/r1_sass.py [--src voronoirt_tpu_torch/csrc/rates.cu]
                             [--out r1_sass.json]

The source is compiled (nvcc -cubin for sm_90a with the package's flags,
kernels/build.py, and -Xptxas -v, whose report gives each instance's
registers, spill stores and loads and static shared memory) as it is,
and in five forced variants: every row bound-free (the line `const bool
bb = ...;` made false), and every row bound-bound with its Humlicek
evaluator (csrc/voigt.cuh humlicek_H) sent to region I, II, III or IV
(its region tests fixed, as tools/e1_sass.py does for E1).  In each
rates_chunk_kernel instance the innermost loop that divides is one
point: a J row's value at one cell, its cross-section, G and the pair's
sums.  Its instructions are counted by class with tools/e1_sass.py's
parser (the double-precision pipe's, MUFU, CALL, the single-precision
ones and all); a loop nested inside it is counted apart.  Works on any
revision of rates.cu whose row-kind flag is written `const bool bb =
<expr>;` and whose point loop is the innermost loop that divides.

issue_ms turns the counts into the least time the SMs need to issue a
launch's instructions (its FP64 or FP32 pipe's, its MUFU's, or all of
them at one a clock a warp scheduler), given its bound-free points and
the points each Humlicek region's warps run.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import e1_sass  # noqa: E402

BB_FLAG = re.compile(r"const bool bb = [^;]+;")
VARIANTS = (None, "bf", 1, 2, 3, 4)


def forced_source(text, voigt, variant):
    """(rates.cu, voigt.cuh) texts with every row of `variant`: 'bf', or
    a bound-bound row whose points take Humlicek region 1-4."""
    if not BB_FLAG.search(text):
        raise ValueError("no `const bool bb = ...;` in the source")
    text = BB_FLAG.sub(f"const bool bb = {str(variant != 'bf').lower()};",
                       text)
    if variant != "bf":
        for test, value in zip(e1_sass.TESTS, e1_sass.FORCE[variant]):
            if test not in voigt:
                raise ValueError(f"region test {test!r} not in voigt.cuh")
            voigt = voigt.replace(test, f"if ({str(value).lower()})")
    return text, voigt


def _compile(src, variant, workdir):
    """(SASS, ptxas report) of `src` forced to `variant` (None: as it
    is)."""
    from voronoirt_tpu_torch.kernels import build
    d = os.path.join(workdir, f"v{variant}")
    os.makedirs(d)
    srcdir = os.path.dirname(os.path.abspath(src))
    for name in os.listdir(srcdir):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(srcdir, name), d)
    text = open(src).read()
    voigt = open(os.path.join(d, "voigt.cuh")).read()
    if variant is not None:
        text, voigt = forced_source(text, voigt, variant)
    with open(os.path.join(d, "voigt.cuh"), "w") as f:
        f.write(voigt)
    cu = os.path.join(d, "rates.cu")
    with open(cu, "w") as f:
        f.write(text)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(d, "r.cubin")
    res = subprocess.run([build._nvcc(), *flags, "-Xptxas", "-v", "-cubin",
                          "-o", cubin, cu], check=True, capture_output=True,
                         text=True)
    sass = subprocess.run([e1_sass._tool("cuobjdump"), "-sass", cubin],
                          check=True, capture_output=True, text=True).stdout
    return sass, res.stdout + res.stderr


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" '?([\w$]+)'?")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas(report):
    """{mangled function name: {"registers", "spill_stores",
    "spill_loads", "static_smem"}} from nvcc -Xptxas -v's report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return out


def _instance(name):
    """The record key of a rates_chunk_kernel instance: its dtype, with
    "_bf_only" for the instance that launches without a bound-bound
    window (template argument BB false), where the source has one."""
    m = re.search(r"rates_chunk_kernelI([df])(?:Lb([01])E)?", name)
    if not m:
        return None
    dtype = {"d": "float64", "f": "float32"}[m.group(1)]
    return dtype + ("_bf_only" if m.group(2) == "0" else "")


def count(src=None):
    """{instance key (_instance): {"ptxas": {...}, "bf": point counts,
    "regions": {1-4: bound-bound point counts}, "nested": {"bf" | 1-4:
    ...}, "whole": the unforced kernel's counts}} for the
    rates_chunk_kernel instances of `src` (the package's source by
    default); a "_bf_only" instance (a launch without a bound-bound
    window) has no "regions"."""
    src = src or os.path.join(ROOT, "voronoirt_tpu_torch", "csrc", "rates.cu")
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            got = dict(zip(VARIANTS, pool.map(
                lambda v: _compile(src, v, work), VARIANTS)))
    out = {}
    for variant, (sass, report) in got.items():
        for name, insns in e1_sass.parse(sass).items():
            key = _instance(name)
            if key is None or ("_bf_only" in key
                               and variant not in (None, "bf")):
                continue
            rec = out.setdefault(key, {"regions": {}, "nested": {}})
            if variant is None:
                rec["whole"] = e1_sass._classes(insns)
                rec["name"] = name
                rec["ptxas"] = ptxas(report).get(name, {})
                continue
            point, nested = e1_sass.point_loop(insns)
            if variant == "bf":
                rec["bf"] = point
            else:
                rec["regions"][variant] = point
            rec["nested"][variant] = nested
    return out


# instructions an SM issues a clock: one a warp scheduler, four
# schedulers, 32 threads a warp
ISSUE_LANES = 4 * 32


def issue_ms(rec, bf_points, bb_issued, dtype, clock_hz):
    """The least time (ms) the SMs take to issue the instructions of one
    launch with bf_points bound-free points and, for each Humlicek
    region r (1-4), bb_issued[r] bound-bound points its warps run (a
    warp whose points span two regions runs both): the longest of the
    FP64 (FP32 in float32) pipe's, the MUFU's and all instructions' at
    one a clock a scheduler, at clock_hz on the card's SMs.  Returns
    (ms, 'pipe' | 'mufu' | 'issue')."""
    key = "fp64" if dtype == "float64" else "fp32"
    counts = [(bf_points, rec["bf"])] + [
        (pts, rec["regions"][r]) for r, pts in bb_issued.items() if pts]
    lanes = {"pipe": e1_sass.LANES[dtype], "mufu": e1_sass.LANES["mufu"],
             "issue": ISSUE_LANES}
    cls = {"pipe": key, "mufu": "mufu", "issue": "all"}
    t = {k: sum(pts * c[cls[k]] for pts, c in counts)
         / (e1_sass.N_SMS * lanes[k] * clock_hz) for k in lanes}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = count(args.src)
    for key, rec in sorted(res.items()):
        print(f"rates_chunk_kernel ({key}): ptxas {json.dumps(rec['ptxas'])}",
              flush=True)
        print(f"  bound-free point: {json.dumps(rec['bf'])}; nested "
              f"{json.dumps(rec['nested']['bf'])}", flush=True)
        for r, c in sorted(rec["regions"].items()):
            print(f"  bound-bound point, region {r}: {json.dumps(c)}; nested "
                  f"{json.dumps(rec['nested'][r])}", flush=True)
        print(f"  whole kernel, unforced: {json.dumps(rec['whole'])}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
