#!/usr/bin/env python
"""Compare versions of K1's V=1 CUDA source on one card, and read the SASS
of the K1 kernels.

  python chip_variants.py time DIR [DIR ...]
      DIR: a copy of qpalette_tpu_torch/csrc (a variant of tcq1_gemv.cu or
      of the headers it includes).  Each DIR's tcq1_gemv.cu is built beside
      the others (ptxas registers and spills of its v1_gemv_kernel
      instances), checked against the plain version at N = 1 and 8 (a DIR
      whose name starts with "probe" drops work on purpose and is timed
      unchecked), then K1 1mad/2mad is timed, a8 and exact at N = 1
      (CUDA-graph replays, weights cycled past L2), at Path A's o and
      down and at 4096x4096, in turns A B .. B A: us a call, SM cycles a
      tile at 132 SMs and 1.755 GHz, and ms a Path A step.
  python chip_variants.py sass NEW.cu PARENT.cu KERNEL
      the SASS of every instance of the kernel template KERNEL in two
      builds, instruction by instruction (cuobjdump -sass of nvcc -cubin).
  python chip_variants.py opcodes SRC PATTERN
      the opcodes of the instance of SRC whose name matches PATTERN: the
      whole function, and a tile's share in its first unrolled slot
      (between its 3rd and 31st MMA: 14 tiles of 2 MMAs).

Needs the CUDA toolkit (nvcc, cuobjdump); `time` needs a CUDA device.
"""

import collections
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# (name, m, k, mode, KV, calls a Path A step)
CASES = [("o", 4096, 4096, "1mad", 3, 32),
         ("down", 4096, 14336, "1mad", 3, 32),
         ("2mad3", 4096, 4096, "2mad", 3, 0),
         ("2mad4", 4096, 4096, "2mad", 4, 0),
         ("kv5", 4096, 4096, "1mad", 5, 0)]
SM_HZ, SMS = 1.755e9, 132


def time_variants(dirs):
    import torch

    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import _build as kb
    from qpalette_tpu_torch.kernels import arith

    _, _, smi = cs.card()
    dev = torch.device("cuda:0")
    libs = {}
    with ThreadPoolExecutor(len(dirs)) as ex:
        futs = [ex.submit(kb.compile_cu, Path(d) / "tcq1_gemv.cu",
                          kb.BUILD / f"libtcq1_gemv_variant{i}.so")
                for i, d in enumerate(dirs)]
        for i, (d, fut) in enumerate(zip(dirs, futs)):
            ents = [e for e in cs.ptxas_entries(fut.result())
                    if "v1_gemv" in e[0]]
            spills = [e[0] for e in ents if cs.SPILL.search(e[2])]
            regs = sorted({e[1].split(" registers")[0] for e in ents})
            print(f"[ptxas] {d}: {len(ents)} v1 instances, registers {regs}, "
                  f"spills in {spills}", flush=True)
            libs[d] = kb.bind(kb.BUILD / f"libtcq1_gemv_variant{i}.so",
                              arith.SIGNATURES["tcq1_gemv"])
    copies = {c: cs._copies(c[1], c[2], 8 * c[4], dev)[0] for c in CASES}
    orig = arith._lib

    def use(lib):
        arith._lib = lambda *a: lib if a[0] == "tcq1_gemv" else orig(*a)

    try:
        for d, lib in libs.items():
            if Path(d).name.startswith("probe"):
                continue
            use(lib)
            for (name, m, k, mode, KV, _), cp in copies.items():
                for N in (1, 8):
                    for a8 in (True, False):
                        x = torch.randn((N, k), device=dev)
                        cs._rel_check(
                            f"{d} {name} {mode} N={N} a8={a8}",
                            arith.tcq1_decode_gemv(x, cp[0], KV, mode, m, k,
                                                   a8),
                            arith.arith_gemv_plain(x, cp[0], mode, KV, m, k,
                                                   a8), cs.TOL[a8])
        for d in list(libs) + list(libs)[::-1]:
            use(libs[d])
            step = {True: 0.0, False: 0.0}
            per = []
            for (name, m, k, mode, KV, calls), cp in copies.items():
                x = torch.randn((1, k), device=dev)
                out = torch.empty((1, m), device=dev)
                for a8 in (True, False):
                    t = cs._time_ms(lambda i=0: arith.tcq1_decode_gemv(
                        x, cp[i % len(cp)], KV, mode, m, k, a8, out=out),
                        200, graph=True)
                    step[a8] += calls * t
                    cyc = t * 1e-3 * SM_HZ / ((m // 16) * (k // 16) / SMS)
                    per.append(f"{name} {'a8' if a8 else 'ex'} "
                               f"{t * 1e3:.3f}us ({cyc:.1f} cyc/tile)")
            print(f"[time] {d}: 1mad a8 {step[True]:.4f} ms, exact "
                  f"{step[False]:.4f} ms a Path A step; " + ", ".join(per)
                  + f" ({smi})", flush=True)
    finally:
        arith._lib = orig


def _sass(src, cubin):
    from qpalette_tpu_torch.kernels._build import _nvcc

    nvcc = _nvcc()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", cubin, src],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                         text=True, check=True).stdout
    return re.split(r"\n\t\tFunction : ", txt)[1:]


def _instructions(func):
    return [re.sub(r"\s+", " ", x).strip() for x in
            re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", func)]


def sass_diff(new_src, parent_src, kernel):
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as ex:
            new, par = ex.map(_sass, [new_src, parent_src],
                              [f"{tmp}/new.cubin", f"{tmp}/parent.cubin"])
    pat = re.compile(kernel + r"I(\w+)E")

    def by_instance(funcs):
        return {m.group(1): _instructions(f) for f in funcs
                for m in [pat.search(f.split("\n", 1)[0])] if m}

    new, par = by_instance(new), by_instance(par)
    same = 0
    for key in sorted(par):
        a, b = par[key], new.get(key, [])
        if a == b:
            same += 1
            continue
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        print(f"[sass] {key}: differs ({len(a)} vs {len(b)} instructions, "
              f"first at {d})")
    print(f"[sass] {kernel} instances with the same instructions: {same} of "
          f"{len(par)} (new has {len(new)})")


def opcodes(src, pattern):
    with tempfile.TemporaryDirectory() as tmp:
        funcs = _sass(src, f"{tmp}/op.cubin")
    for f in funcs:
        head = f.split("\n", 1)[0]
        if not re.search(pattern, head):
            continue
        ops = [re.match(r"(?:@!?U?P\w+ )?([A-Z0-9_]+)", i).group(1)
               for i in _instructions(f)]
        top = collections.Counter(ops).most_common(30)
        print(f"{head}: {len(ops)} instructions; {top}")
        mma = [i for i, op in enumerate(ops) if op in ("IMMA", "HMMA")]
        win = collections.Counter(ops[mma[2]:mma[30]])
        print(f"  first unrolled slot: {sum(win.values()) / 14:.1f} "
              f"instructions a tile; " + ", ".join(
                  f"{op} {n / 14:.2f}" for op, n in win.most_common()))


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    {"time": lambda: time_variants(args),
     "sass": lambda: sass_diff(*args),
     "opcodes": lambda: opcodes(*args)}[cmd]()
