#!/usr/bin/env python3
"""Instructions a point of the extinction kernel E1 (alpha_tot_kernel of
csrc/extinction.cu), per Humlicek region, counted in the code nvcc
compiles for the H100.

    python3 tools/e1_sass.py [--src voronoirt_tpu_torch/csrc/extinction.cu]
                             [--out sass.json]

For each region I-IV the source is compiled (nvcc -cubin for sm_90a with
the package's flags, kernels/build.py) with the region tests of its
Humlicek evaluators fixed, so that every point takes that region, and
its wavelength loop kept rolled (#pragma unroll 1); cuobjdump -sass
prints the code.  In each alpha_tot_kernel instance the innermost loop
that divides is one point: its damping a, its shift v, H and the store.
Its instructions are counted by class: the double-precision pipe's
(DFMA, DMUL, DADD, DSETP, ...), MUFU (a division's reciprocal seed),
CALL (a division's slow path, taken only for operands near the limits
of the type), the single-precision ones and all.  A loop nested inside
it (a slow path) is counted apart.  The counts are static: a branch
inside the point (cdiv's two cases in regions I and II) counts both
sides.  Works on any revision of the source whose evaluators write the
region tests as `if (s >= T(15.0))`, `if (s >= T(5.5))` and `if (a >=
T(0.195) * av - T(0.176))` and whose wavelength loop is `for (int b =
0; b < B; ++b)` or `... b < p.B; ...`.

issue_ms turns the counts into the least time the SMs need to issue a
launch's FP64 (or FP32) instructions, given how many points of each
region the warps run (a warp whose points span two regions runs both).
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

TESTS = ("if (s >= T(15.0))", "if (s >= T(5.5))",
         "if (a >= T(0.195) * av - T(0.176))")
# the region tests' values that send every point to region 1-4
FORCE = {1: (True, False, False), 2: (False, True, False),
         3: (False, False, True), 4: (False, False, False)}
LOOP = re.compile(r"^(\s*)(for \(int b = 0; b < (?:p\.)?B; \+\+b\))",
                  re.MULTILINE)
FP64 = {"DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET"}
FP32 = {"FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FCHK", "FSET"}
# per SM and clock on Hopper (H100 SXM): FP64 and FP32 lanes, and the
# special-function unit's (MUFU) lanes
LANES = {"float64": 64, "float32": 128, "mufu": 16}
N_SMS = 132


def _tool(name):
    from voronoirt_tpu_torch.kernels import build
    found = shutil.which(name)
    if found:
        return found
    near = os.path.join(os.path.dirname(build._nvcc()), name)
    if os.path.exists(near):
        return near
    raise RuntimeError(f"{name} not found beside nvcc")


def forced_source(text, region):
    """The source with every point sent to `region` (1-4) and the
    wavelength loop rolled."""
    for test, value in zip(TESTS, FORCE[region]):
        if test not in text:
            raise ValueError(f"region test {test!r} not in the source")
        text = text.replace(test, f"if ({str(value).lower()})")
    if not LOOP.search(text):
        raise ValueError("no wavelength loop in the source")
    return LOOP.sub(lambda m: m.group(0) if "#pragma unroll 1" in
                    text[max(0, m.start() - 40):m.start()] else
                    f"{m.group(1)}#pragma unroll 1\n{m.group(1)}"
                    f"{m.group(2)}", text)


def _compile(src, region, workdir):
    """The SASS of `src` with its points forced to `region` (None: as
    it is)."""
    from voronoirt_tpu_torch.kernels import build
    d = os.path.join(workdir, f"r{region}")
    os.makedirs(d)
    srcdir = os.path.dirname(os.path.abspath(src))
    for name in os.listdir(srcdir):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(srcdir, name), d)
    text = open(src).read()
    cu = os.path.join(d, "extinction.cu")
    with open(cu, "w") as f:
        f.write(text if region is None else forced_source(text, region))
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(d, "e.cubin")
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, cu],
                   check=True, capture_output=True, text=True)
    return subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"`?\(?(\.L_x_\d+|0x[0-9a-f]+)\)?`?")


def parse(sass):
    """{function name: [(address, opcode, operands)]} of cuobjdump
    -sass output, branch targets resolved to addresses."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            cur = s.split(":", 1)[1].strip()
            funcs[cur], labels, pending = [], {}, []
            continue
        if cur is None:
            continue
        if re.fullmatch(r"\.L_x_\d+:", s):
            pending.append(s[:-1])
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        body = m.group(2).strip()
        if body.startswith("@"):
            body = body.split(None, 1)[1] if " " in body else ""
        op, _, rest = body.partition(" ")
        funcs[cur].append([addr, op, rest])
        funcs[cur][-1].append(labels)      # resolved below
    out = {}
    for name, insns in funcs.items():
        res = []
        for addr, op, rest, labs in insns:
            target = None
            if op.startswith(("BRA", "CALL")):
                t = _TARGET.search(rest)
                if t:
                    tok = t.group(1)
                    target = labs.get(tok) if tok.startswith(".L") \
                        else int(tok, 16)
            res.append((addr, op, target))
        out[name] = res
    return out


def _classes(insns):
    c = {"fp64": 0, "dfma": 0, "dmul": 0, "dadd": 0, "mufu": 0, "call": 0,
         "fp32": 0, "all": len(insns)}
    for _, op, _ in insns:
        root = op.split(".")[0]
        if root in FP64:
            c["fp64"] += 1
            if root in ("DFMA", "DMUL", "DADD"):
                c[root.lower()] += 1
        elif root in FP32:
            c["fp32"] += 1
        elif root == "MUFU":
            c["mufu"] += 1
        elif root == "CALL":
            c["call"] += 1
    return c


def point_loop(insns):
    """Counts of the innermost loop that divides (one point), and of
    any loop nested inside it, counted apart."""
    loops = [(t, a) for a, op, t in insns
             if op.startswith("BRA") and t is not None and t <= a]

    def within(lo, hi):
        return [i for i in insns if lo <= i[0] <= hi]

    divides = [(lo, hi) for lo, hi in loops
               if any(op.startswith("MUFU.RCP") for _, op, _ in
                      within(lo, hi))]
    if not divides:
        raise ValueError("no dividing loop found")
    lo, hi = min(divides, key=lambda s: s[1] - s[0])
    nested = [(a, b) for a, b in loops if lo < a and b < hi]
    inner = [i for i in within(lo, hi)
             if not any(a <= i[0] <= b for a, b in nested)]
    return _classes(inner), _classes([i for i in within(lo, hi)
                                      if i not in inner])


def _dtype(name):
    m = re.search(r"alpha_tot_kernelI([df])", name)
    return {"d": "float64", "f": "float32"}[m.group(1)] if m else None


def count(src=None):
    """{kernel name from "alpha_tot_kernel" on: {"dtype", "regions":
    {1-4: point counts}, "nested": {...}, "whole": the unforced kernel's
    counts}} for every alpha_tot_kernel instance of `src` (the
    package's source by default)."""
    src = src or os.path.join(ROOT, "voronoirt_tpu_torch", "csrc",
                              "extinction.cu")
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(5) as pool:
            sass = dict(zip((None, 1, 2, 3, 4), pool.map(
                lambda r: _compile(src, r, work), (None, 1, 2, 3, 4))))
    out = {}
    for region, text in sass.items():
        for name, insns in parse(text).items():
            if "alpha_tot_kernel" not in name:
                continue
            # the anonymous namespace's mangled name carries a hash of
            # the source, which the forcing changes
            name = name[name.index("alpha_tot_kernel"):]
            rec = out.setdefault(name, {"dtype": _dtype(name), "regions": {},
                                        "nested": {}})
            if region is None:
                rec["whole"] = _classes(insns)
            else:
                rec["regions"][region], rec["nested"][region] = \
                    point_loop(insns)
    return out


def issue_ms(regions, points, dtype, clock_hz):
    """The least time (ms) the SMs take to issue the instructions of
    one launch whose warps run points[r] points of region r (1-4): the
    larger of the FP64 (FP32 in float32) pipe's and the MUFU's, at
    clock_hz on N_SMS SMs."""
    key = "fp64" if dtype == "float64" else "fp32"
    pipe = sum(points[r] * regions[r][key] for r in points) \
        / (N_SMS * LANES[dtype] * clock_hz)
    mufu = sum(points[r] * regions[r]["mufu"] for r in points) \
        / (N_SMS * LANES["mufu"] * clock_hz)
    return 1e3 * max(pipe, mufu), ("pipe" if pipe >= mufu else "mufu")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = count(args.src)
    for name, rec in res.items():
        print(f"{name} ({rec['dtype']}):", flush=True)
        for r, c in sorted(rec["regions"].items()):
            print(f"  region {r}: a point {json.dumps(c)}; nested "
                  f"{json.dumps(rec['nested'][r])}", flush=True)
        print(f"  whole kernel, unforced: {json.dumps(rec['whole'])}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
