#!/usr/bin/env python
"""Compare versions of a CUDA source of the port on one card, and read the
SASS of its kernels.

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
  python chip_variants.py time vq DIR [DIR ...]
      the same for each DIR's vq.cu (K8): ldlq_2_6 at Path C's four shapes,
      ldlq_1_4 at Path D's down and ldlq_4_8 at Path F's o and down, N = 1;
      us a call, ms a Path C forward and a 32-layer Path F forward's 64
      vec-4 calls.
  python chip_variants.py time wide DIR [DIR ...]
      the same for each DIR's tcq2_gemv.cu (K1 sum2 above 8 rows,
      wide_gemv_kernel): checked at o, N = 49, then the 215 shapes at N =
      16, 64 and 256 as a zero-shot forward calls them (layers exact, the
      head a8); ms a zero-shot forward's 129 calls.
  python chip_variants.py time dequant DIR [DIR ...]
      the same for each DIR's arith_dequant.cu (K2, K3) and tcq_lut.cu (K6,
      K7), through chip_smoke.dequant_turns (what --ab dequant runs, without
      the paths): ptxas registers, checked bit-equal to the plain versions
      at 4096x4096 and at the ragged m 16 / 48, k 272 / 544 / 4128 (but a
      DIR named probe*: a copy whose kernels drop work on purpose), then
      each chip_smoke.DQ_CASES instance (CUDA-graph replays, words cycled
      past L2) in turns A B .. B A: us a call and its share of the bound,
      the SM clock a turn.
  python chip_variants.py sweep [DIR ...]
      K8's fixed cost a call: vq_gemv at N = 1, k = 4096, over m from 16
      to 16384 rows, at ldlq_4_8 (vec 4) and ldlq_2_6 (vec 2), of the
      repo's vq.cu or, in turns A B .. B A, of each DIR's (CUDA-graph
      replays, words cycled past L2), and a one-element fill_ in the same
      graph setting (the replay's floor a node); a least-squares line
      us = a + bytes / rate over the rows from 2048 up (their words
      cycled past L2; below, the 200 replays' words fit in it), whose a
      is the cost a call that no byte pays, beside the time at 16 rows.
  python chip_variants.py sass NEW.cu PARENT.cu KERNEL[=PARENT_KERNEL],...
      the SASS of every instance of each kernel template KERNEL in two
      builds, instruction by instruction (cuobjdump -sass of nvcc -cubin),
      each parent instance against the new one of its template arguments
      or else any new one with its instructions; PARENT_KERNEL names the
      parent's template where it was renamed (wide_gemv_kernel, which was
      v2_wide_kernel).
  python chip_variants.py sass NEW_CSRC PARENT_CSRC
      the same for every kernel of every .cu file of two csrc directories,
      counted by kernel template.
  python chip_variants.py opcodes SRC PATTERN [MMAS]
      the opcodes of the instance of SRC whose name matches PATTERN: the
      whole function, and a tile's share in its first unrolled slot
      (between its 3rd and 31st MMA: 14 tiles of 2 MMAs); with MMAS, the
      share of one unit of MMAS MMAs (vq_gemv_kernel: a chunk, 16 MMAs at
      vec 2, 8 at vec 1) in the smallest loop that holds an MMA (branches
      taken once a tile included), and the instructions an MMA between
      that loop's first and last MMA; a kernel without MMAs (the dequants)
      gets the whole function's counts alone.
  python chip_variants.py conflicts [COPIES ...]
      no card: the shared-memory wavefronts a warp's table read of K8
      takes, on uniform random indices, for every ldlq (bits, vec) at the
      kernels' copies (vec 2 at bits 9-12 keeps fewer than 32); at vec 4
      also at each COPIES (default 1, 2, .., 32) that fits the table.

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
# (name, m, k, bits, vec, path, calls a forward of it): Path C's four
# shapes, Path D's down (timed), Path F's vec-4 o and down (32 layers)
VQ_CASES = [("qkv", 6144, 4096, 6, 2, "Path C", 32),
            ("o", 4096, 4096, 6, 2, "Path C", 32),
            ("ug", 28672, 4096, 6, 2, "Path C", 32),
            ("down", 4096, 14336, 6, 2, "Path C", 32),
            ("D down", 4096, 14336, 4, 1, "Path D", 0),
            ("F o", 4096, 4096, 8, 4, "Path F", 32),
            ("F down", 4096, 14336, 8, 4, "Path F", 32)]
SM_HZ, SMS = 1.755e9, 132


def _variants(dirs, source, sigs, kernel):
    """Build each DIR's source beside the others; {DIR: bound library}."""
    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import _build as kb

    libs = {}
    with ThreadPoolExecutor(len(dirs)) as ex:
        futs = [ex.submit(kb.compile_cu, Path(d) / f"{source}.cu",
                          kb.BUILD / f"lib{source}_variant{i}.so")
                for i, d in enumerate(dirs)]
        for i, (d, fut) in enumerate(zip(dirs, futs)):
            ents = [e for e in cs.ptxas_entries(fut.result())
                    if kernel in e[0]]
            spills = [e[0] for e in ents if cs.SPILL.search(e[2])]
            regs = sorted({e[1].split(" registers")[0] for e in ents})
            print(f"[ptxas] {d}: {len(ents)} {kernel} instances, registers "
                  f"{regs}, spills in {spills}", flush=True)
            libs[d] = kb.bind(kb.BUILD / f"lib{source}_variant{i}.so", sigs)
    return libs


def time_variants(dirs):
    import torch

    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import arith

    _, _, smi = cs.card()
    dev = torch.device("cuda:0")
    libs = _variants(dirs, "tcq1_gemv", arith.SIGNATURES["tcq1_gemv"],
                     "v1_gemv")
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


def time_wide(dirs):
    import torch

    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import arith

    _, _, smi = cs.card()
    dev = torch.device("cuda:0")
    libs = _variants(dirs, "tcq2_gemv", arith.SIGNATURES["tcq2_gemv"],
                     "wide_gemv_kernel")
    copies = {(n, KV): cs._copies(m, k, 4 * KV, dev)[0]
              for n, m, k, KV in cs.SHAPES_215}
    qdict, _ = cs._load_215()
    orig = arith._lib

    def use(lib):
        arith._lib = lambda *a: lib if a[0] == "tcq2_gemv" else orig(*a)

    try:
        _, m, k, KV = cs.SHAPES_215[1]
        for d, lib in libs.items():
            if Path(d).name.startswith("probe"):
                continue
            use(lib)
            x = torch.randn((49, k), device=dev).bfloat16()
            for a8 in (False, True):
                cs._rel_check(
                    f"{d} o N=49 a8={a8}",
                    arith.tcq2s_decode_gemv(x, copies[("o", KV)][0], KV, m,
                                            k, a8),
                    arith.arith_gemv_plain(x, copies[("o", KV)][0], "sum2",
                                           KV, m, k, a8), cs.TOL[a8])
        for d in list(libs) + list(libs)[::-1]:
            use(libs[d])
            per = []
            for N in (16, 64, 256):
                times = {}
                for name, m, k, KV in cs.SHAPES_215:
                    cp = copies[(name, KV)]
                    a8 = name == "lm_head"
                    x = torch.randn((N, k), device=dev).bfloat16()
                    out = torch.empty((N, m), device=dev)
                    t = cs._time_ms(lambda i=0: arith.tcq2s_decode_gemv(
                        x, cp[i % len(cp)], KV, m, k, a8, out=out), 20,
                        graph=True)
                    times[(name, KV)] = (t, 0.0, 0.0)
                per.append(f"N={N} {cs.step_ms(times, qdict)[0]:.3f} ms ("
                           + ", ".join(f"{n}/{kv} {v[0] * 1e3:.1f}us"
                                       for (n, kv), v in times.items())
                           + ")")
            print(f"[time] {d}: a zero-shot forward's 129 sum2 calls "
                  + "; ".join(per) + f" ({smi})", flush=True)
    finally:
        arith._lib = orig


def time_vq(dirs):
    import torch

    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import vq

    _, _, smi = cs.card()
    dev = torch.device("cuda:0")
    libs = _variants(dirs, "vq", vq.SIGNATURES, "_gemv_kernel")
    cases = {}
    for name, m, k, bits, vec, path, calls in VQ_CASES:
        nbytes = m * vq.row_words(k, bits, vec) * 4
        cases[name] = (m, k, bits, vec, path, calls,
                       cs._vq_lut(bits, vec, dev), [
            cs._vq_words(m, k, bits, vec, dev, seed=100 + i)
            for i in range(min(64, -(-3 * cs.L2_BYTES // nbytes)))])
    orig = vq._lib
    try:
        for d, lib in libs.items():
            if Path(d).name.startswith("probe"):
                continue
            vq._lib = lambda lib=lib: lib
            for name, (m, k, bits, vec, _, _, lut, cp) in cases.items():
                for N in (1, 8):
                    x = torch.randn((N, k), device=dev).bfloat16()
                    cs._rel_check(
                        f"{d} {name} bits={bits} vec={vec} N={N}",
                        vq.vq_gemv(x, cp[0], lut, bits, vec, m, k),
                        vq.vq_gemv_plain(x, cp[0], lut, bits, vec, m, k),
                        cs.VQ_TOL)
        for d in list(libs) + list(libs)[::-1]:
            vq._lib = lambda lib=libs[d]: lib
            fwd, per = collections.Counter(), []
            with cs.SmClock() as clock:
                for name, (m, k, bits, vec, path, calls, lut, cp) in \
                        cases.items():
                    x = torch.randn((1, k), device=dev).bfloat16()
                    out = torch.empty((1, m), device=dev)
                    t = cs._time_ms(lambda i=0: vq.vq_gemv(
                        x, cp[i % len(cp)], lut, bits, vec, m, k, out=out),
                        200, graph=True)
                    fwd[path] += calls * t
                    per.append(f"{name} {t * 1e3:.3f}us")
            print(f"[time] {d}: vq_gemv {fwd['Path C']:.4f} ms a Path C "
                  f"forward, {fwd['Path F']:.4f} ms a 32-layer Path F "
                  f"forward's vec-4 calls; " + ", ".join(per)
                  + f" ({smi}, {clock})", flush=True)
    finally:
        vq._lib = orig


def time_dequant(dirs):
    """chip_smoke.dequant_turns over the dirs, A B .. B A, at DQ_CASES
    alone; a dir named probe* is timed but not checked."""
    import chip_smoke as cs

    cs.dequant_turns({d: d for d in dirs}, list(dirs) + list(dirs)[::-1],
                     paths=False,
                     unchecked={d for d in dirs
                                if Path(d).name.startswith("probe")})


SWEEP_M = (16, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def sweep_vq(dirs=(), k=4096):
    import numpy as np
    import torch

    import chip_smoke as cs
    from qpalette_tpu_torch.kernels import vq

    _, _, smi = cs.card()
    dev = torch.device("cuda:0")
    libs = (_variants(dirs, "vq", vq.SIGNATURES, "_gemv_kernel") if dirs
            else {"repo": vq._lib()})
    x = torch.randn((1, k), device=dev).bfloat16()
    one = torch.empty(1, device=dev)
    floor = cs._time_ms(lambda i=0: one.fill_(i), 200, graph=True)
    print(f"[sweep] a one-element fill_: {floor * 1e3:.3f} us a node "
          f"({smi})", flush=True)
    orig = vq._lib
    try:
        for d in list(libs) + (list(libs)[::-1] if dirs else []):
            vq._lib = lambda lib=libs[d]: lib
            for bits, vec in ((8, 4), (6, 2)):
                lut = cs._vq_lut(bits, vec, dev)
                rows = []
                for m in SWEEP_M:
                    nbytes = m * vq.row_words(k, bits, vec) * 4
                    cp = [cs._vq_words(m, k, bits, vec, dev, seed=100 + i)
                          for i in range(min(64, -(-3 * cs.L2_BYTES
                                                   // nbytes)))]
                    out = torch.empty((1, m), device=dev)
                    t = cs._time_ms(lambda i=0: vq.vq_gemv(
                        x, cp[i % len(cp)], lut, bits, vec, m, k, out=out),
                        200, graph=True)
                    rows.append((m, nbytes, t * 1e3))
                    print(f"[sweep] {d} ldlq_{vec}_{bits} {m}x{k}: "
                          f"{t * 1e3:.3f} us, {nbytes} bytes of row-pack, "
                          f"{nbytes / (t * 1e-3) / 1e9:.0f} GB/s", flush=True)
                    del cp
                fit = np.array([(b, us) for m, b, us in rows if m >= 2048])
                slope, a = np.polyfit(fit[:, 0], fit[:, 1], 1)
                us = {m: t for m, _, t in rows}
                print(f"[sweep] {d} ldlq_{vec}_{bits}: us = {a:.3f} + bytes "
                      f"/ {1e-3 / slope:.0f} GB/s (m >= 2048); 16 rows "
                      f"{us[16]:.3f} us; the 4096x4096 call {us[4096]:.3f} "
                      f"us ({smi})", flush=True)
    finally:
        vq._lib = orig


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


def _drop_anon(name):
    """A mangled name without its anonymous namespace (a length-prefixed
    _GLOBAL__N__... whose hash differs from build to build)."""
    m = re.search(r"(\d+)_GLOBAL__N__", name)
    if not m:
        return name
    return name[:m.start()] + name[m.start(1) + len(m.group(1))
                                    + int(m.group(1)):]


def sass_dirs(new_dir, parent_dir):
    """Every kernel of every .cu file of two csrc directories, by name (the
    anonymous namespace's hash dropped), counted by kernel template."""
    for src in sorted(Path(parent_dir).glob("*.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            with ThreadPoolExecutor(2) as ex:
                new, par = ex.map(_sass, [str(Path(new_dir) / src.name),
                                          str(src)],
                                  [f"{tmp}/new.cubin", f"{tmp}/parent.cubin"])

        def by_name(funcs):
            return {_drop_anon(f.split("\n", 1)[0].strip()):
                    _instructions(f) for f in funcs}

        new, par = by_name(new), by_name(par)
        count = collections.defaultdict(lambda: [0, 0, 0])
        for name in set(new) | set(par):
            base = re.search(r"\d+(\w+?_kernel)I", name)
            n = count[base.group(1) if base else name]
            n[0] += name in par and par[name] == new.get(name)
            n[1] += name in par
            n[2] += name in new
        for base, (same, np_, nn) in sorted(count.items()):
            print(f"[sass] {src.name} {base}: {same} of {np_} parent "
                  f"instances the same (new has {nn})", flush=True)


def sass_diff(new_src, parent_src, kernels):
    """kernels: comma-separated KERNEL or KERNEL=PARENT_KERNEL, compared
    from one build of each source.  A parent instance of PARENT_KERNEL
    (default KERNEL) is the same if the new instance of KERNEL with its
    template arguments has its instructions (a renamed template:
    wide_gemv_kernel=v2_wide_kernel) or, failing that, if any new
    instance of KERNEL has them (a template that took another argument:
    wide_x_kernel<XT, A8, V> against wide_x_kernel<XT, A8>)."""
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(2) as ex:
            new_f, par_f = ex.map(_sass, [new_src, parent_src],
                                  [f"{tmp}/new.cubin", f"{tmp}/parent.cubin"])

    def by_instance(funcs, name):
        pat = re.compile(name + r"I(\w+)E")
        out = {}
        for f in funcs:
            m = pat.search(f.split("\n", 1)[0])
            if m:
                out[m.group(1)] = _instructions(f)
        return out

    for spec in kernels.split(","):
        kernel, _, parent_kernel = spec.partition("=")
        new = by_instance(new_f, kernel)
        par = by_instance(par_f, parent_kernel or kernel)
        bodies = {tuple(v) for v in new.values()}
        same = 0
        for key in sorted(par):
            a, b = par[key], new.get(key, [])
            if a == b or tuple(a) in bodies:
                same += 1
                continue
            d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            print(f"[sass] {key}: differs ({len(a)} vs {len(b)} "
                  f"instructions, first at {d})")
        print(f"[sass] {spec} instances with the same instructions: {same} "
              f"of {len(par)} (new has {len(new)})", flush=True)


def _opcode(ins):
    return re.match(r"(?:@!?U?P\w+ )?([A-Z0-9_]+)", ins).group(1)


def _loop(func):
    """The smallest loop (a backward branch and its target) that holds an
    MMA: its instructions."""
    lines = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*;)", func)
    addr = [int(a, 16) for a, _ in lines]
    ins = [re.sub(r"\s+", " ", t).strip() for _, t in lines]
    best = None
    for i, t in enumerate(ins):
        br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        if not br or int(br.group(1), 16) >= addr[i]:
            continue
        j = addr.index(int(br.group(1), 16))
        body = ins[j:i + 1]
        if (any(_opcode(b) in ("IMMA", "HMMA") for b in body)
                and (best is None or len(body) < len(best))):
            best = body
    return best


def opcodes(src, pattern, mmas=None):
    with tempfile.TemporaryDirectory() as tmp:
        funcs = _sass(src, f"{tmp}/op.cubin")
    for f in funcs:
        head = f.split("\n", 1)[0]
        if not re.search(pattern, head):
            continue
        ops = [_opcode(i) for i in _instructions(f)]
        top = collections.Counter(ops).most_common(30)
        print(f"{head}: {len(ops)} instructions; {top}")
        if mmas:
            loop = [_opcode(i) for i in _loop(f)]
            body = collections.Counter(loop)
            units = (body["HMMA"] + body["IMMA"]) / int(mmas)
            print(f"  loop of {sum(body.values())} instructions, {units:g} "
                  f"units of {mmas} MMAs: {sum(body.values()) / units:.1f} "
                  f"instructions a unit; " + ", ".join(
                      f"{op} {n / units:.2f}" for op, n in
                      body.most_common()), flush=True)
            at = [i for i, op in enumerate(loop) if op in ("IMMA", "HMMA")]
            win = collections.Counter(loop[at[0] + 1:at[-1] + 1])
            n = len(at) - 1  # an MMA and the work that feeds the next one
            print(f"  from its first MMA to its last: "
                  f"{sum(win.values()) / n:.1f} instructions an MMA; "
                  + ", ".join(f"{op} {c / n:.2f}"
                              for op, c in win.most_common()), flush=True)
            continue
        mma = [i for i, op in enumerate(ops) if op in ("IMMA", "HMMA")]
        if len(mma) < 31:  # no unrolled MMA slots (a dequant)
            continue
        win = collections.Counter(ops[mma[2]:mma[30]])
        print(f"  first unrolled slot: {sum(win.values()) / 14:.1f} "
              f"instructions a tile; " + ", ".join(
                  f"{op} {n / 14:.2f}" for op, n in win.most_common()))


def conflicts(copies=(), samples=20000, seed=0):
    """Mean and largest wavefronts of a warp's table read (uniform random
    windows): lane l reads copy l mod C of its entry, entry e's copies at
    words e*C .. e*C + C - 1 (vec 4: two words an entry, e's copy r at
    words 2(e*C + r), +1, the lanes' 64 words one read), bank = word mod
    32.  C: the kernel's (vq_gemv_kernel, vq4_gemv_kernel) and, at vec 4,
    each of `copies` (default 1, 2, .., 32) whose table fits 32 KB."""
    import numpy as np

    from qpalette_tpu_torch.kernels import vq

    rng = np.random.default_rng(seed)
    lane = np.arange(32)
    for bits, vec in vq.SUPPORTED:
        win = 2 * bits if vec == 1 and bits <= 4 else bits
        ew = 2 if vec == 4 else 1  # words an entry
        if vec == 4:
            mine = vq.gemv4_copy_bits(bits)
            counts = sorted({mine, *(int(c).bit_length() - 1
                                     for c in copies or (1, 2, 4, 8, 16, 32))})
            counts = [cb for cb in counts
                      if (4 * ew << win << cb) <= 1 << vq.GEMV_TABLE_BITS]
        else:
            mine = min(5, vq.GEMV_TABLE_BITS - 2 - win)
            counts = [mine]
        e = rng.integers(0, 1 << win, (samples, 32))
        for cb in counts:
            word = (e << cb) | (lane & ((1 << cb) - 1))
            word = np.concatenate([ew * word + i for i in range(ew)], axis=1)
            waves = np.zeros(samples, np.int64)
            for b in range(32):  # distinct words a bank serves
                w = np.where(word % 32 == b, word, -1)
                w.sort(axis=1)
                distinct = ((w[:, 1:] != w[:, :-1]) & (w[:, 1:] >= 0)).sum(1)
                waves = np.maximum(waves, distinct + (w[:, 0] >= 0))
            print(f"[conflicts] bits={bits} vec={vec}: {1 << win} entries x "
                  f"{1 << cb} copies ({(4 * ew << win << cb) // 1024} KB"
                  f"{', the kernel' if cb == mine else ''}), wavefronts a "
                  f"read: mean {waves.mean():.3f}, max {waves.max()}",
                  flush=True)


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    {"time": lambda: (time_vq(args[1:]) if args[0] == "vq"
                      else time_wide(args[1:]) if args[0] == "wide"
                      else time_dequant(args[1:]) if args[0] == "dequant"
                      else time_variants(args)),
     "sass": lambda: sass_diff(*args) if len(args) == 3 else sass_dirs(*args),
     "opcodes": lambda: opcodes(*args),
     "conflicts": lambda: conflicts(args),
     "sweep": lambda: sweep_vq(args)}[cmd]()
