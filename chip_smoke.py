#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

  python chip_smoke.py
  python chip_smoke.py --parent OLD_TCQ_LUT_CU

With --parent it runs only parent_ab (see there): the LUT GEMVs and the
flagship decode with csrc/tcq_lut.cu against an older version of the file.

Phases (each raises on failure):
  1. card: name, count, power limit; no CUDA device -> exit 1
  2. build every CUDA library from qpalette_tpu_torch/csrc, one nvcc each,
     all started together (ptxas -v: registers, shared memory, spills)
  3. the arithmetic trellis GEMV (K1) against its plain PyTorch version:
     sum2 at every Llama-3.1-8B shape of the 215.0thp_cc path (N in
     {1,4,16}); dualmad, 1mad, 2mad and odd-KV sum2 at every shape of
     bench.py's tcq2mix scheme plus 4096x4096 and odd k/16 shapes (N in
     {1,8,256}); exact and a8; kernel and plain times at N=1
  4. the arithmetic dequants (K2 tcq2, K3 tcq1) bit-equal to their plain
     versions at the tcq2mix and 215 shapes; kernel and plain times
  5. the LUT trellis kernels (K4-K7) against their plain versions at every
     shape of the 3.25-bit flagship and, at KV 3 (tcq_3, tcomb_3_4), at o
     and down: GEMV (N = 1..8, within 1e-4 of max|y|; two launches
     bit-equal), dequant (bit-equal), the dequant + product at N=16; times
     at the flagship's shapes (the GEMV's: ms a call, GB/s of packed
     trellis, share of the bound, the table layout in use)
  5b. the SQ/VQ row-pack kernels (K8 vq_gemv, K9 vq_dequant) against their
     plain versions: ldlq_2_6 (bits 6, vec 2) at the four 8B shapes and
     every ldlq (bits, vec) at o and down; K8 at N in {1,8} within 1e-4 of
     max|y|, K9 bit-equal; times (kernel at every shape, plain at Path C's)
  5c. the int8 lm_head GEMVs (K10 int8_gemv_a8 bit-equal, K11 int8_gemv
     within 1e-5) at the 129024x4096 head, N in {1,8}; times with
     torch._int_mm on the same int8 operands as K10's yardstick
  6. the 215 path: the 8B model from the 215.0thp_cc solver output (merged
     qkv/ug, 4-bit tcq2s lm_head, impl a8, dummy weights from seed 0) on
     cuda:0; prefill 16 tokens and decode 64 at temperature 0.6, top-k 5,
     129 sum2 K1 launches per forward; decode twice for determinism
  7. the flagship path: the 8B model from the 3.25-bit mem-constrained
     solver output (unmerged tcq 6/8/10 and tcomb 8/9, bf16 lm_head, impl
     exact, dummy weights from seed 0); the 16-token prefill launches 194
     tcq + 30 tcomb dequants, each of 64 decode forwards 194 tcq + 30
     tcomb GEMVs; decode twice for determinism
  8. Path A: the 8B tcq2mix model (merged qkv tcq2_6 and ug tcq2_7 in mode
     dualmad, o/down tcq1_3 in mode 1mad, the 4-bit tcq2s_8 lm_head), impl
     a8 and impl exact; prefill 16 and decode 64, 129 K1 launches per
     forward (32 dualmad KV6 + 32 dualmad KV7, 64 1mad KV3, 1 sum2);
     tokens/s and peak memory
  9. Path B: a 512-token prefill at impl exact on tcq2mix (64 K2 + 64 K3,
     the head as 2 chunked sum2 K1 launches) and on the 215 config (128 K2
     sum2 + 2); prefill time and peak memory
 9b. Path C: the 8B ldlq_2_6 model (3-bit 2-D VQ, merged qkv/ug) with the
     rotated int8 lm_head, impl a8; the 16-token prefill launches 128 K9
     (the head a plain product), each of 64 decode forwards 128 K8 + 1 K10;
     tokens/s and peak memory
 9c. Path D: 8 layers of ldlq_1_4 (4-bit scalar, unmerged) with the int8
     head built here without the rotation: 56 K9 in the prefill, 56 K8 + 1
     K11 a decode forward
 10. 2-layer models with each path's scheme mix on the CPU (plain
     versions) against the same weights on the card (kernels); the tcq2mix
     one with a 300-token exact prompt (K2/K3) and one decode step; the
     Path C one with a 12-token prompt (K9) and one decode step (K8, K10)
 11. a JSON line of kernels, the nvidia-smi name/power line, and the final
     JSON status line
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
QDIR = os.path.join(ROOT, "msq_results", "3_8b", "lat_constrained", "v5e",
                    "default_err")
FLAGSHIP_QDICT = os.path.join(ROOT, "msq_results", "3_8b", "mem_constrained",
                              "default", "3.25bit.json")
SHAPES_215 = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 6),
              ("ug", 28672, 4096, 4), ("ug", 28672, 4096, 6),
              ("down", 4096, 14336, 6), ("lm_head", 131072, 4096, 8)]
EXTRA_KV = [("kv4", 4096, 4096, 4), ("kv8", 4096, 4096, 8)]
# per decode step: qkv, o, ug, down in each of 32 layers, plus the lm_head
CALLS_PER_STEP = {"qkv": 32, "o": 32, "ug": 32, "down": 32, "lm_head": 1}
LAUNCHES_PER_FORWARD = 129
# bench.py's tcq2mix scheme (3.27 bits/weight): (projection, m, k, mode,
# KV, calls a forward), then 2mad and odd-KV sum2 at 4096x4096 and odd
# k/16 shapes (calls 0: checked, not on a path)
TCQ2MIX = {"self_attn.q_proj": "tcq2_6_none_0.9",
           "self_attn.k_proj": "tcq2_6_none_0.9",
           "self_attn.v_proj": "tcq2_6_none_0.9",
           "self_attn.o_proj": "tcq1_3_none_0.9",
           "mlp.gate_proj": "tcq2_7_none_0.9",
           "mlp.up_proj": "tcq2_7_none_0.9",
           "mlp.down_proj": "tcq1_3_none_0.9"}
SHAPES_ARITH = [("qkv", 6144, 4096, "dualmad", 6, 32),
                ("ug", 28672, 4096, "dualmad", 7, 32),
                ("o", 4096, 4096, "1mad", 3, 32),
                ("down", 4096, 14336, "1mad", 3, 32),
                ("2mad3", 4096, 4096, "2mad", 3, 0),
                ("2mad4", 4096, 4096, "2mad", 4, 0),
                ("sum2_5", 4096, 4096, "sum2", 5, 0),
                ("sum2_7", 4096, 4096, "sum2", 7, 0),
                ("odd_kt", 256, 4112, "1mad", 3, 0),
                ("odd_kt", 256, 4112, "sum2", 5, 0),
                ("odd_kt", 256, 4112, "dualmad", 7, 0),
                ("odd_kt", 256, 4112, "dualmad", 9, 0)]
PATH_A_STEP = {"tcq2_decode_gemv": 64, "tcq1_decode_gemv": 64,
               "tcq2s_decode_gemv": 1}
PATH_A_MIX = {("tcq2", "dualmad", 6): 32, ("tcq2", "dualmad", 7): 32,
              ("tcq1", "1mad", 3): 64}
PREFILL_B = 512
PATH_B = {"tcq2mix": {"tcq2_dequant": 64, "tcq1_dequant": 64,
                      "tcq2s_decode_gemv": 2},
          "215": {"tcq2_dequant": 128, "tcq2s_decode_gemv": 2}}
PROMPT_LEN, NEW_TOKENS = 16, 64
TOL = {False: 1e-4, True: 1e-3}  # GEMV kernel vs plain, of max|y|
SMALL_TOL = 2e-2  # CPU plain vs card kernel through a 2-layer model
# flagship projections per forward, by (shape m x k, KV): 194 tcq, 30 tcomb
FLAGSHIP_TCQ, FLAGSHIP_TCOMB = 194, 30
LUT_TOL = 1e-4  # LUT GEMV kernel vs plain, of max|y|
# dequant + product at N=16: the kernel's W is bit-equal to the plain one,
# so the two products see the same operands
PRODUCT_TOL = 1e-6
# Path C: ldlq_2_6 everywhere, merged qkv / ug, the rotated int8 head
PATH_C_QSTR = "ldlq_2_6_none_1.0"
SHAPES_8B = [("qkv", 6144, 4096), ("o", 4096, 4096), ("ug", 28672, 4096),
             ("down", 4096, 14336)]
PATH_C_PREFILL = {"vq_dequant": 128}
PATH_C_STEP = {"vq_gemv": 128, "int8_gemv_a8": 1}
# Path D: 8 layers of ldlq_1_4, unmerged, the int8 head without rotation
PATH_D_QSTR, PATH_D_LAYERS = "ldlq_1_4_none_1.0", 8
PATH_D_PREFILL = {"vq_dequant": 7 * PATH_D_LAYERS}
PATH_D_STEP = {"vq_gemv": 7 * PATH_D_LAYERS, "int8_gemv": 1}
HEAD = (129024, 4096)  # the int8 head: 128256 padded to 2048s
VQ_TOL = 1e-4  # K8 vs plain, of max|y|
I8_TOL = 1e-5  # K11 vs plain, of max|y|
# what sets the bound of the K8-K11 calls timed, name -> "bytes" or
# "operations", filled as they are timed (the trellis kernels' bounds are
# bytes at every shape timed)
BOUND_BY = {}
L2_BYTES = 50_000_000
# the least time for a call: bytes over the H100's 3.35 TB/s, operations
# over its dense peak for their type (NVIDIA's data sheet, SXM, 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "float32": 67e12}
# KV 3 of the LUT kernels (tcq_3, tcomb_3_4 of the memory palette) at o and
# down: checked, on no path, (m, k, KV) -> 0 calls a forward
LUT_KV3 = {(4096, 4096, (3,)): 0, (4096, 14336, (3,)): 0,
           (4096, 4096, (3, 4)): 0, (4096, 14336, (3, 4)): 0}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes, ops, kind):
    """(least ms, "bytes" or "operations") for a call's work."""
    tb, to = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def gemv_bound(trellis_bytes, N, m, k, x_bytes, a8):
    """K1/K4/K5: packed words + x read once, f32 y written once; 2*N*m*k
    operations in int8 (a8) or float32."""
    return bound_ms(trellis_bytes + N * k * x_bytes + N * m * 4,
                    2 * N * m * k, "int8" if a8 else "float32")


def dequant_bound(trellis_bytes, m, k):
    """K2/K3/K6/K7: packed words read once, bf16 W written once; one
    float32 operation a weight."""
    return bound_ms(trellis_bytes + 2 * m * k, m * k, "float32")


def card():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {name}, {count} device(s), nvidia-smi: {smi}", flush=True)
    return name, count, smi


def all_kernels():
    from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                            tcq_lut, vq)
    return (arith.KERNELS + arith_dequant.KERNELS + tcq_lut.KERNELS
            + vq.KERNELS + int8_gemv.KERNELS)


def counts():
    return {f.__name__: f.launches for f in all_kernels()}


def _words(m, k, W, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, ((m // 16) * (k // 16), W),
                         generator=gen, dtype=torch.int32, device=device)


def _time_ms(fn, reps, graph=False):
    """ms per call: the better of two windows of reps calls each (a window
    can catch the card in another state).  graph: the reps calls are
    captured once in a CUDA graph and the window replays it, so the time
    is the device's alone; launched one by one from Python, a kernel
    shorter than its wrapper's ~20-30 us of host work would time the
    host."""
    fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        if graph:
            g.replay()
        else:
            for i in range(reps):
                fn(i)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def _copies(m, k, W, device):
    """Copies of random weights enough to exceed the L2 cache three times,
    so that repeated launches stream from device memory as a forward does."""
    nbytes = (m // 16) * (k // 16) * W * 4
    return [_words(m, k, W, device, seed=100 + i)
            for i in range(min(64, -(-3 * L2_BYTES // nbytes)))], nbytes


def _rel_check(label, y, ref, tol):
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    check(bool(torch.isfinite(y).all()), f"{label} non-finite")
    print(f"[kernel] {label}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(limit {tol:.0e})", flush=True)
    check(rel <= tol, f"{label}: rel {rel}")
    return err


def sum2_checks(arith, device):
    """K1 sum2 vs plain at every 215 shape; returns (max_abs_err,
    {(name, KV): (ms, plain_ms, bound_ms)} at a8, N=1)."""
    max_abs = 0.0
    for name, m, k, KV in SHAPES_215 + EXTRA_KV:
        words = _words(m, k, 4 * KV, device, seed=m + k + KV)
        for N in (1, 4, 16):
            # decode rows reach the kernel as the f32 rotation output,
            # prefill rows as bf16 (qlinear_apply)
            x_dtype = torch.float32 if N <= 8 else torch.bfloat16
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
            for a8 in (False, True):
                y = arith.tcq2s_decode_gemv(x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, words, "sum2", KV, m, k, a8)
                max_abs = max(max_abs, _rel_check(
                    f"sum2 {name} {m}x{k} KV={KV} N={N} "
                    f"{'a8' if a8 else 'exact'}", y, ref, TOL[a8]))
    times = {}
    for name, m, k, KV in SHAPES_215:
        copies, nbytes = _copies(m, k, 4 * KV, device)
        x = torch.randn((1, k), device=device)
        out = torch.empty((1, m), device=device)

        def kern(i=0):
            arith.tcq2s_decode_gemv(x, copies[i % len(copies)], KV, m, k,
                                    True, out=out)

        def plain(i=0):
            arith.arith_gemv_plain(x, copies[i % len(copies)], "sum2", KV, m,
                                   k, True)

        ms = _time_ms(kern, 200, graph=True)
        pms = _time_ms(plain, 5)
        bms, _ = gemv_bound(nbytes, 1, m, k, 4, True)
        times[(name, KV)] = (ms, pms, bms)
        print(f"[time] sum2 {name} {m}x{k} KV={KV} a8 N=1: kernel {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of packed trellis), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms", flush=True)
        del copies
    return max_abs, times


def step_ms(times, qdict):
    """(kernel, plain, bound) ms of one 215 decode step's 129 calls,
    weighting the ug shape by the 215 qdict's KV mix."""
    ug_kv = [int(qdict[f"{i}_mlp.up_proj"][0].split("_")[1])
             for i in range(32)]
    tot = [0.0, 0.0, 0.0]
    for (name, KV), trio in times.items():
        n = (sum(kv == KV for kv in ug_kv) if name == "ug"
             else CALLS_PER_STEP[name])
        for j in range(3):
            tot[j] += n * trio[j]
    return tot


def arith_checks(arith, arith_dequant, device):
    """K1 (dualmad, 1mad, 2mad, odd-KV sum2) and K2/K3 against their plain
    versions at SHAPES_ARITH, and K2 sum2 at the 215 shapes.  Returns
    ({wrapper: max_abs_err}, {wrapper: [ms, plain_ms, bound_ms] summed over
    a Path A decode step's calls (K1, a8, N=1) or a tcq2mix Path B
    prefill's calls (K2/K3)}, {(name, KV): (ms, plain_ms, bound_ms)} of K2
    sum2 at the 215 shapes)."""
    gemv_of = {"sum2": arith.tcq2s_decode_gemv,
               "dualmad": arith.tcq2_decode_gemv,
               "1mad": arith.tcq1_decode_gemv, "2mad": arith.tcq1_decode_gemv}
    names = [f.__name__ for f in arith.KERNELS + arith_dequant.KERNELS]
    err = {n: 0.0 for n in names}
    times = {n: [0.0, 0.0, 0.0] for n in names}
    deq215 = {}
    shapes = [(*sh, True) for sh in SHAPES_ARITH] + [
        (name, m, k, "sum2", KV, 0, False) for name, m, k, KV in SHAPES_215
        if name != "lm_head"]
    for name, m, k, mode, KV, calls, k1 in shapes:
        W = arith.words_per_tile(mode, KV)
        words = _words(m, k, W, device, seed=m + k + KV)
        label = f"{mode} {name} {m}x{k} KV={KV}"
        gemv = gemv_of[mode]
        deq = (arith_dequant.tcq2_dequant if mode in ("sum2", "dualmad")
               else arith_dequant.tcq1_dequant)
        for N in ((1, 8, 256) if k1 else ()):
            x_dtype = torch.float32 if N <= 8 else torch.bfloat16
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
            for a8 in (False, True):
                y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = arith.arith_gemv_plain(x, words, mode, KV, m, k, a8)
                err[gemv.__name__] = max(err[gemv.__name__], _rel_check(
                    f"{label} N={N} {'a8' if a8 else 'exact'}", y, ref,
                    TOL[a8]))
        w = arith_dequant.dequant(mode, words, KV, m, k)
        torch.cuda.synchronize()
        w_ref = arith_dequant.arith_dequant_plain(words, mode, KV, m, k)
        same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
        print(f"[kernel] {deq.__name__} {label}: bit-equal={same}",
              flush=True)
        check(same, f"{deq.__name__} {label}: not bit-equal")
        del w, w_ref
        if k1 and not calls:
            continue  # checked, not on a path: no times

        copies, nbytes = _copies(m, k, W, device)
        x1 = torch.randn((1, k), device=device)
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            arith.decode_gemv(mode, x1, copies[i % len(copies)], KV, m, k,
                              True, out=out)

        def kern_exact(i=0):
            arith.decode_gemv(mode, x1, copies[i % len(copies)], KV, m, k,
                              False, out=out)

        def plain(i=0):
            arith.arith_gemv_plain(x1, copies[i % len(copies)], mode, KV, m,
                                   k, True)

        def kern_deq(i=0):
            arith_dequant.dequant(mode, copies[i % len(copies)], KV, m, k,
                                  out=wout)

        def plain_deq(i=0):
            arith_dequant.arith_dequant_plain(copies[i % len(copies)], mode,
                                              KV, m, k)

        routes = ([(kern, 200), (kern_exact, 200), (plain, 5)] if k1
                  else []) + [(kern_deq, 50), (plain_deq, 5)]
        res = {}
        for route, reps in routes:
            res[route.__name__] = ms = _time_ms(
                route, reps, graph=route in (kern, kern_exact, kern_deq))
            gb = (f" ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of packed "
                  f"trellis)" if route in (kern, kern_exact, kern_deq) else "")
            print(f"[time] {label} {route.__name__}: {ms:.4f} ms{gb}",
                  flush=True)
        gb_ms, _ = gemv_bound(nbytes, 1, m, k, 4, True)
        db_ms, _ = dequant_bound(nbytes, m, k)
        print(f"[time] {label} bounds: GEMV a8 N=1 {gb_ms:.4f} ms, dequant "
              f"{db_ms:.4f} ms", flush=True)
        if k1:
            for fn, trio in ((gemv, (res["kern"], res["plain"], gb_ms)),
                             (deq, (res["kern_deq"], res["plain_deq"],
                                    db_ms))):
                for j, v in enumerate(trio):
                    times[fn.__name__][j] += calls * v
        else:
            deq215[(name, KV)] = (res["kern_deq"], res["plain_deq"], db_ms)
        del copies, wout
    return err, times, deq215


def build_all():
    """One nvcc per CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from qpalette_tpu_torch.kernels import (_build, arith, arith_dequant,
                                            int8_gemv, tcq_lut, vq)

    names = [*arith.SOURCES, arith_dequant.SOURCE, tcq_lut.SOURCE, vq.SOURCE,
             int8_gemv.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        logs = list(ex.map(_build.build, names))
    print(f"[build] {len(names)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in zip(names, logs):
        lines = log.strip().splitlines()
        spills = [ln for ln in lines if "spill" in ln and " 0 bytes" not in ln]
        print(f"[build] {name}.cu: {len(lines)} lines of ptxas output, "
              f"{len(spills)} with spills; first lines:", flush=True)
        print("\n".join(lines[:6] + spills[:6]), flush=True)


def drive(label, spec, params, device, prompt_len, new_tokens, want_prefill,
          want_step):
    """The counted run of a path: every count is set to 0 just before the
    prefill and read after it and after each decode forward; each must
    match want_prefill / want_step exactly (other kernels 0).  Returns the
    counts of the whole run."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, prompt_len))
    caches = llama.init_kv_caches(spec, 1, prompt_len + new_tokens + 1,
                                  device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    for f in all_kernels():
        f.launches = 0
    logits, caches = decode.prefill(spec, params,
                                    torch.as_tensor(prompt, device=device),
                                    caches)
    seen = [counts()]
    finite = bool(torch.isfinite(logits).all())
    check(logits.shape == (1, prompt_len, V),
          f"{label}: prefill logits shape {tuple(logits.shape)}")
    cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
    toks = [cur]
    for pos in range(prompt_len, prompt_len + new_tokens):
        logits, caches = llama.forward(spec, params, cur, kv_caches=caches,
                                       cache_pos=pos)
        seen.append(counts())
        finite = finite and bool(torch.isfinite(logits).all())
        cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    zero = {k: 0 for k in seen[0]}
    check(seen[0] == {**zero, **want_prefill},
          f"{label}: prefill launches {seen[0]}")
    for a, b in zip(seen, seen[1:]):
        step = {k: b[k] - a[k] for k in b}
        check(step == {**zero, **want_step},
              f"{label}: decode launches per forward {step}")
    if new_tokens:
        check(logits.shape == (1, 1, V), f"logits shape {tuple(logits.shape)}")
    check(finite, f"{label}: non-finite logits")
    toks = torch.cat(toks, dim=1).cpu().numpy()
    check(bool(((toks >= 0) & (toks < V)).all()), "token out of vocab")
    total = {k: v for k, v in seen[-1].items() if v}
    print(f"[{label}] prefill {prompt_len}: "
          f"{ {k: v for k, v in seen[0].items() if v} }; {new_tokens} decode "
          f"forwards: {want_step} each; total {total}; logits finite, tokens "
          f"in vocab", flush=True)
    return seen[-1]


def throughput(label, spec, params, device, card_label):
    """Determinism and tokens/s through the user-facing generate()."""
    from qpalette_tpu_torch.runtime import decode

    V = spec.config.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    T = PROMPT_LEN + NEW_TOKENS + 1
    torch.cuda.reset_peak_memory_stats(device)
    runs = [decode.generate(spec, params, prompt, NEW_TOKENS + 1,
                            max_seq=T, temperature=0.6, top_k=5, seed=99)
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(device)
    check(np.array_equal(runs[0][0], runs[1][0]),
          f"{label}: same seed, different tokens")
    tps = runs[1][1]["tokens_per_sec"]
    mbytes = decode.model_bytes(params)
    streamed = mbytes - decode.model_bytes(params["embed"])
    print(f"[{label}] decode {tps:.2f} tokens/s bs=1 (eager loop, host "
          f"clock, {runs[1][1]['timed_tokens']} steps), model "
          f"{mbytes / 1e9:.3f} GB, streamed {streamed / 1e9:.3f} GB/token "
          f"(computed from tensor sizes), {streamed * tps / 1e9:.1f} GB/s, "
          f"peak memory {peak / 1e9:.3f} GB; card {card_label}", flush=True)
    return tps


def prefill_time(label, spec, params, device, n, card_label):
    """A warm n-token prefill: host clock around a synchronized call, and
    the peak memory during it."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.runtime import decode

    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, spec.config.vocab_size, (1, n)), device=device)
    caches = llama.init_kv_caches(spec, 1, n, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    logits, _ = decode.prefill(spec, params, prompt, caches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"[{label}] warm {n}-token prefill {dt * 1e3:.1f} ms, peak memory "
          f"{peak / 1e9:.3f} GB; card {card_label}", flush=True)
    return dt


def _load_215():
    with open(os.path.join(QDIR, "215.0thp_cc.json")) as f:
        qdict = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(QDIR, "215.0thp_cc_merge_info.json")) as f:
        merge_info = json.load(f)
    return qdict, merge_info


def _build(what, qdict, merge_info, impl, lm_head_bits, device):
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        LlamaConfig.llama31_8b(), qdict, merge_info=merge_info, dummy=True,
        impl=impl, lm_head_bits=lm_head_bits, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"[{what}] 8B built in {time.perf_counter() - t0:.1f} s", flush=True)
    return spec, params


def with_impl(spec, impl):
    """The same model with every decoder projection at another impl (the
    4-bit head stays a8, as in the reference)."""
    def proj(ls):
        return dataclasses.replace(ls, impl=impl)
    layers = tuple((dataclasses.replace(a, projs=tuple(
        (n, proj(ls)) for n, ls in a.projs)), dataclasses.replace(
        m, projs=tuple((n, proj(ls)) for n, ls in m.projs)))
        for a, m in spec.layers)
    return dataclasses.replace(spec, layers=layers)


def main_path(device, card_label):
    """The 215 path: 129 sum2 K1 launches per forward."""
    qdict, merge_info = _load_215()
    spec, params = _build("main", qdict, merge_info, "a8", 4, device)
    want = {"tcq2s_decode_gemv": LAUNCHES_PER_FORWARD}
    launches = drive("main", spec, params, device, PROMPT_LEN, NEW_TOKENS,
                     want, want)
    throughput("main", spec, params, device, card_label)
    del params
    torch.cuda.empty_cache()
    return launches, qdict


def flagship_shapes(cfg, qdict):
    """{(m, k, KV): projections per forward} of the flagship qdict."""
    from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
    from qpalette_tpu_torch.runtime.loader import proj_shape

    out = {}
    for key, qstr in qdict.items():
        m, k = proj_shape(cfg, key.split("_", 1)[1])
        q = parse_quantizer_str(qstr)
        check(q.family in ("tcq", "tcomb"), f"{key}: {qstr}")
        out[m, k, q.KV] = out.get((m, k, q.KV), 0) + 1
    return out


def _lut_words(m, k, KV, device, seed):
    return [_words(m, k // len(KV), 4 * kv, device, seed + i)
            for i, kv in enumerate(KV)]


def lut_kernel_checks(tcq_lut, shapes, device):
    """K4-K7 against their plain versions at every flagship shape; returns
    ({kernel: max_abs_err}, {kernel: [ms, plain ms, bound ms per
    forward]})."""
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    err = {f.__name__: 0.0 for f in tcq_lut.KERNELS}
    times = {f.__name__: [0.0, 0.0, 0.0] for f in tcq_lut.KERNELS}
    for (m, k, KV), count in sorted(shapes.items()):
        tcomb = len(KV) == 2
        gemv, gemv_plain, deq, deq_plain = (
            (tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain,
             tcq_lut.tcomb_lut_dequant, tcq_lut.tcomb_lut_dequant_plain)
            if tcomb else
            (tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain,
             tcq_lut.tcq_lut_dequant, tcq_lut.tcq_lut_dequant_plain))
        tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                            device=device)
        words = _lut_words(m, k, KV, device, seed=m + k + sum(KV))
        label = f"{m}x{k} KV={'/'.join(map(str, KV))}"
        for N in (*range(1, 9), 16):
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).bfloat16()
            if N <= 8:
                y = gemv(x, *words, tlut, *KV, m, k)
                torch.cuda.synchronize()
                ref = gemv_plain(x, *words, tlut, *KV, m, k)
                err[gemv.__name__] = max(err[gemv.__name__], _rel_check(
                    f"{gemv.__name__} {label} N={N}", y, ref, LUT_TOL))
                if N == 8:  # the split-k sums are added in a fixed order
                    y2 = gemv(x, *words, tlut, *KV, m, k)
                    same = torch.equal(y.view(torch.int32),
                                       y2.view(torch.int32))
                    print(f"[lut] {gemv.__name__} {label} N=8: two launches "
                          f"bit-equal={same}", flush=True)
                    check(same, f"{gemv.__name__} {label}: launches differ")
                continue
            w = deq(*words, tlut, *KV, m, k)
            torch.cuda.synchronize()
            w_ref = deq_plain(*words, tlut, *KV, m, k)
            same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
            y = x.float() @ w.float().T
            ref = x.float() @ w_ref.float().T
            e = (y - ref).abs().max().item()
            rel = e / ref.abs().max().item()
            err[deq.__name__] = max(err[deq.__name__], e)
            print(f"[lut] {deq.__name__} {label}: bit-equal={same}; "
                  f"product N=16 max_abs_err={e:.3e} rel={rel:.3e} (limit "
                  f"{PRODUCT_TOL:.0e})", flush=True)
            check(same, f"{deq.__name__} {label}: not bit-equal")
            check(rel <= PRODUCT_TOL, f"{deq.__name__} {label}: rel {rel}")
        if not count:
            continue  # checked, not on a path: no times

        # cycle through copies of the weights so that repeated launches
        # stream from device memory, as a forward does, not from L2
        nbytes = m * k * sum(KV) // (16 * len(KV))
        copies = [_lut_words(m, k, KV, device, seed=100 * i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        x1 = torch.randn((1, k), device=device).bfloat16()
        x16 = torch.randn((16, k), device=device).bfloat16()
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            gemv(x1, *copies[i % len(copies)], tlut, *KV, m, k, out=out)

        def plain(i=0):
            gemv_plain(x1, *copies[i % len(copies)], tlut, *KV, m, k)

        def kern16(i=0):
            deq(*copies[i % len(copies)], tlut, *KV, m, k, out=wout)
            x16.float() @ wout.float().T

        def plain16(i=0):
            w = deq_plain(*copies[i % len(copies)], tlut, *KV, m, k)
            x16.float() @ w.float().T

        def kern_deq(i=0):
            deq(*copies[i % len(copies)], tlut, *KV, m, k, out=wout)

        def plain_deq(i=0):
            deq_plain(*copies[i % len(copies)], tlut, *KV, m, k)

        # the kernels' entries in the JSON line: the kernel alone (GEMV at
        # N=1, dequant) against its plain version alone, summed over a
        # forward's calls; the dequant + product at N=16 is printed beside
        S = tlut_bits_for_kv(max(KV))
        tbytes = nbytes + 2 * 4 * (1 << S)
        tab_bits = tcq_lut.GEMV_TABLE_BITS
        ncopy = 1 << (tab_bits - 2 - S)
        layout = (f"table {(1 << tab_bits) // 1024} KB: {ncopy} copies of "
                  f"each of the 2^{S} entries, lane l reads copy l % {ncopy}")
        bounds = {gemv: gemv_bound(tbytes, 1, m, k, 2, False)[0],
                  deq: dequant_bound(tbytes, m, k)[0]}
        for fn, route, reps, plain_route in (
                (gemv, kern, 200, False), (gemv, plain, 5, True),
                (deq, kern_deq, 50, False), (deq, plain_deq, 5, True),
                (None, kern16, 50, False), (None, plain16, 5, True)):
            ms = _time_ms(route, reps, graph=not plain_route)
            if fn is not None:
                times[fn.__name__][plain_route] += count * ms
                if not plain_route:
                    times[fn.__name__][2] += count * bounds[fn]
            gbps = nbytes / (ms * 1e-3) / 1e9
            print(f"[time] {label} {route.__name__}: {ms:.4f} ms a call"
                  + (f" ({gbps:.0f} GB/s of packed trellis, bound "
                     f"{bounds[fn]:.4f} ms, {bounds[fn] / ms:.1%} of it)"
                     if route in (kern, kern_deq) else "")
                  + (f"; {layout}" if route is kern else ""), flush=True)
        del copies, wout
    return err, times


def parent_ab(parent_src):
    """K4/K5 of csrc/tcq_lut.cu against an older version of the file
    (parent_src, the same C interface) on one card, in turns: parent, new,
    new, parent.  Both are first checked against the plain versions at
    N = 1 and 8.  Each turn puts its library behind the wrappers, times a
    flagship decode forward's K4 and K5 calls (CUDA-graph replays at N=1,
    weights cycled past L2) and then the flagship's 64-token decode
    through generate() (tokens/s)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from qpalette_tpu_torch.kernels import _build as kb
    from qpalette_tpu_torch.kernels import tcq_lut
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    _, _, smi = card()
    parent_so = kb.BUILD / "libtcq_lut_parent.so"
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(kb.build, tcq_lut.SOURCE),
                  ex.submit(kb.compile_cu, Path(parent_src), parent_so)]
        for b in builds:
            b.result()
    libs = {"parent": kb.bind(parent_so, tcq_lut.SIGNATURES),
            "new": tcq_lut._lib()}
    lib_of = tcq_lut._lib
    device = torch.device("cuda:0")
    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    cases = []
    for (m, k, KV), calls in sorted(flagship_shapes(
            LlamaConfig.llama31_8b(), qdict).items()):
        gemv, plain = ((tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain)
                       if len(KV) == 2 else
                       (tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain))
        tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                            device=device)
        nbytes = m * k * sum(KV) // (16 * len(KV))
        copies = [_lut_words(m, k, KV, device, seed=100 * i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        for label, lib in libs.items():
            tcq_lut._lib = lambda lib=lib: lib
            for N in (1, 8):
                x = torch.randn((N, k), device=device).bfloat16()
                _rel_check(f"{label} {gemv.__name__} {m}x{k} KV={KV} N={N}",
                           gemv(x, *copies[0], tlut, *KV, m, k),
                           plain(x, *copies[0], tlut, *KV, m, k), LUT_TOL)
        cases.append((m, k, KV, calls, gemv, tlut, copies))
    spec, params = _build("flagship", qdict, None, "exact", 16, device)
    turns = []
    for label in ("parent", "new", "new", "parent"):
        tcq_lut._lib = lambda lib=libs[label]: lib
        ms = {"tcq_lut_gemv": 0.0, "tcomb_lut_gemv": 0.0}
        for m, k, KV, calls, gemv, tlut, copies in cases:
            x = torch.randn((1, k), device=device).bfloat16()
            out = torch.empty((1, m), device=device)
            t = _time_ms(lambda i=0: gemv(x, *copies[i % len(copies)], tlut,
                                          *KV, m, k, out=out), 200, graph=True)
            ms[gemv.__name__] += calls * t
            print(f"[ab] {label} {m}x{k} KV={KV}: {t * 1e3:.3f} us a call",
                  flush=True)
        tps = throughput(f"flagship, {label} tcq_lut.cu", spec, params,
                         device, smi)
        turns.append({"lib": label, "tokens_per_s": tps,
                      **{f"{n}_ms_a_forward": v for n, v in ms.items()}})
        print(f"[ab] {label}: K4 {ms['tcq_lut_gemv']:.4f} ms, K5 "
              f"{ms['tcomb_lut_gemv']:.4f} ms a forward, {tps:.2f} tokens/s "
              f"({smi})", flush=True)
    tcq_lut._lib = lib_of
    print(json.dumps({"card": smi, "turns": turns}))


def flagship_path(device, card_label):
    """The 8B model from the 3.25-bit solver output: 194 tcq + 30 tcomb
    dequants in the prefill, 194 + 30 GEMVs in each decode forward."""
    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    spec, params = _build("flagship", qdict, None, "exact", 16, device)
    launches = drive(
        "flagship", spec, params, device, PROMPT_LEN, NEW_TOKENS,
        {"tcq_lut_dequant": FLAGSHIP_TCQ, "tcomb_lut_dequant": FLAGSHIP_TCOMB},
        {"tcq_lut_gemv": FLAGSHIP_TCQ, "tcomb_lut_gemv": FLAGSHIP_TCOMB})
    throughput("flagship", spec, params, device, card_label)
    del params
    torch.cuda.empty_cache()
    return launches


def _vq_words(m, k, bits, vec, device, seed):
    from qpalette_tpu_torch.kernels.vq import row_words
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (m, row_words(k, bits, vec)),
                         generator=gen, dtype=torch.int32, device=device)


def vq_kernel_checks(vq, device):
    """K8 / K9 against their plain versions: ldlq_2_6 at the four 8B
    shapes, every other ldlq (bits, vec) at o and down.  Returns
    ({kernel: max_abs_err}, {kernel: [ms, plain ms, bound ms summed over a
    Path C decode forward's K8 calls (N=1) or its prefill's K9 calls]},
    {(bits, vec, name): (K8 ms, K9 ms)} at every shape)."""
    from qpalette_tpu_torch.ops.codebooks import vq_lut

    err = {f.__name__: 0.0 for f in vq.KERNELS}
    times = {f.__name__: [0.0, 0.0, 0.0] for f in vq.KERNELS}
    per_scheme = {}
    cases = [(6, 2, name, m, k, 32) for name, m, k in SHAPES_8B] + [
        (b, v, name, m, k, 0) for b, v in vq.SUPPORTED if (b, v) != (6, 2)
        for name, m, k in SHAPES_8B[1::2]]
    for bits, vec, name, m, k, calls in cases:
        lut = torch.tensor(vq_lut(bits, vec), device=device)
        words = _vq_words(m, k, bits, vec, device, seed=m + k + bits)
        label = f"vq bits={bits} vec={vec} {name} {m}x{k}"
        for N in (1, 8):
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).bfloat16()
            y = vq.vq_gemv(x, words, lut, bits, vec, m, k)
            torch.cuda.synchronize()
            ref = vq.vq_gemv_plain(x, words, lut, bits, vec, m, k)
            err["vq_gemv"] = max(err["vq_gemv"], _rel_check(
                f"vq_gemv {label} N={N}", y, ref, VQ_TOL))
        w = vq.vq_dequant(words, lut, bits, vec, m, k)
        torch.cuda.synchronize()
        w_ref = vq.vq_dequant_plain(words, lut, bits, vec, m, k)
        same = torch.equal(w.view(torch.int16), w_ref.view(torch.int16))
        print(f"[kernel] vq_dequant {label}: bit-equal={same}", flush=True)
        check(same, f"vq_dequant {label}: not bit-equal")
        del w, w_ref, words

        nbytes = m * vq.row_words(k, bits, vec) * 4 + lut.numel() * 4
        copies = [_vq_words(m, k, bits, vec, device, seed=100 + i)
                  for i in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        x1 = torch.randn((1, k), device=device).bfloat16()
        out = torch.empty((1, m), device=device)
        wout = torch.empty((m, k), dtype=torch.bfloat16, device=device)

        def kern(i=0):
            vq.vq_gemv(x1, copies[i % len(copies)], lut, bits, vec, m, k,
                       out=out)

        def kern_deq(i=0):
            vq.vq_dequant(copies[i % len(copies)], lut, bits, vec, m, k,
                          out=wout)

        def plain(i=0):
            vq.vq_gemv_plain(x1, copies[i % len(copies)], lut, bits, vec, m,
                             k)

        def plain_deq(i=0):
            vq.vq_dequant_plain(copies[i % len(copies)], lut, bits, vec, m,
                                k)

        ms = _time_ms(kern, 200, graph=True)
        dms = _time_ms(kern_deq, 50, graph=True)
        per_scheme[bits, vec, name] = (ms, dms)
        gb, gby = gemv_bound(nbytes, 1, m, k, 2, False)
        db, dby = dequant_bound(nbytes, m, k)
        print(f"[time] {label}: vq_gemv N=1 {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of row-pack, bound "
              f"{gb:.4f} ms), vq_dequant {dms:.4f} ms (bound {db:.4f} ms)",
              flush=True)
        if calls:
            pms, pdms = _time_ms(plain, 5), _time_ms(plain_deq, 5)
            print(f"[time] {label}: plain vq_gemv {pms:.4f} ms, plain "
                  f"vq_dequant {pdms:.4f} ms", flush=True)
            for kname, trio, by in (("vq_gemv", (ms, pms, gb), gby),
                                    ("vq_dequant", (dms, pdms, db), dby)):
                for j, v in enumerate(trio):
                    times[kname][j] += calls * v
                if by == "operations":
                    BOUND_BY[kname] = by
        del copies, wout
    return err, times, per_scheme


def int8_head_checks(ig, device):
    """K10 (bit-equal) and K11 (within 1e-5) against their plain versions
    at the 8B head, N in {1, 8}; times at N=1 beside the plain versions,
    the bound and torch._int_mm on K10's int8 operands (x padded to the 32
    rows it takes).  Returns ({kernel: max_abs_err}, {kernel: [ms, plain
    ms, bound ms]}, {kernel: library ms or None})."""
    m, k = HEAD
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    wq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8,
                       device=device)
    scales = torch.rand(m, generator=gen, device=device) * 1e-3
    err, times = {}, {}
    pairs = ((ig.int8_gemv_a8, ig.int8_gemv_a8_plain, "int8"),
             (ig.int8_gemv, ig.int8_gemv_plain, "float32"))
    for N in (1, 8):
        x = torch.randn((N, k), generator=gen, device=device).bfloat16()
        for fn, plain, _ in pairs:
            y = fn(x, wq, scales)
            torch.cuda.synchronize()
            ref = plain(x, wq, scales)
            e = (y - ref).abs().max().item()
            err[fn.__name__] = max(err.get(fn.__name__, 0.0), e)
            if fn is ig.int8_gemv_a8:
                same = torch.equal(y, ref)
                print(f"[kernel] int8_gemv_a8 {m}x{k} N={N}: bit-equal="
                      f"{same}", flush=True)
                check(same, f"int8_gemv_a8 N={N}: not bit-equal ({e})")
            else:
                _rel_check(f"int8_gemv {m}x{k} N={N}", y, ref, I8_TOL)
    x1 = torch.randn((1, k), generator=gen, device=device).bfloat16()
    out = torch.empty((1, m), device=device)
    nbytes = m * k + m * 4  # weights and scales; the head is 528 MB > L2
    for fn, plain, kind in pairs:
        ms = _time_ms(lambda i=0: fn(x1, wq, scales, out=out), 50,
                      graph=True)
        pms = _time_ms(lambda i=0: plain(x1, wq, scales), 3)
        bms, by = bound_ms(nbytes + 2 * k + 4 * m, 2 * m * k, kind)
        BOUND_BY[fn.__name__] = by
        times[fn.__name__] = [ms, pms, bms]
        print(f"[time] {fn.__name__} {m}x{k} N=1: kernel {ms:.4f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of weights), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    xq = torch.zeros((32, k), dtype=torch.int8, device=device)
    xq[0] = torch.randint(-127, 128, (k,), generator=gen, dtype=torch.int8,
                          device=device)
    acc = torch._int_mm(xq, wq.t())
    check(torch.equal(acc[0].double(), wq.double() @ xq[0].double()),
          "torch._int_mm disagrees with the exact integer dot")
    lib = _time_ms(lambda i=0: torch._int_mm(xq, wq.t()), 50)
    print(f"[time] torch._int_mm (32x{k}) x ({k}x{m}) int8 -> int32: "
          f"{lib:.4f} ms (K10's yardstick; the port never calls it)",
          flush=True)
    return err, times, {"int8_gemv_a8": lib, "int8_gemv": None}


def path_c(device, card_label):
    """Path C: the 8B ldlq_2_6 model, merged qkv / ug, the rotated int8
    head, impl a8; 128 K9 in the 16-token prefill, 128 K8 + 1 K10 each
    decode forward.  Returns (launch counts, tokens/s)."""
    spec, params = _build("pathC", PATH_C_QSTR, [["merge_qkv", "merge_ug"]]
                          * 32, "a8", 8, device)
    kinds = {(ls.kind, ls.bits, ls.vec) for a, m in spec.layers
             for _, ls in a.projs + m.projs}
    check(kinds == {("vq", 6, 2)} and spec.lm_head_spec is None
          and tuple(params["lm_head_q"].shape) == HEAD
          and "lm_head_su" in params, f"pathC model {kinds}")
    launches = drive("pathC", spec, params, device, PROMPT_LEN, NEW_TOKENS,
                     PATH_C_PREFILL, PATH_C_STEP)
    tps = throughput("pathC", spec, params, device, card_label)
    del params
    torch.cuda.empty_cache()
    return launches, tps


def unrotated_int8_head(w):
    """The per-row int8 head without the rotation (the reference's forward
    branch for an int8 head with no lm_head_su): s = max|W|/127 + 1e-12 a
    row, q = round(W / s), the vocab padded to 2048s with scale 1."""
    V, h = w.shape
    VP = -(-V // 2048) * 2048
    q = torch.zeros((VP, h), dtype=torch.int8, device=w.device)
    s = torch.ones(VP, dtype=torch.float32, device=w.device)
    for r0 in range(0, V, 8192):
        wf = w[r0:r0 + 8192].float()
        sr = wf.abs().amax(dim=1) / 127.0 + 1e-12
        q[r0:r0 + wf.shape[0]] = torch.round(wf / sr[:, None]).to(torch.int8)
        s[r0:r0 + wf.shape[0]] = sr
    return q, s


def path_d(device, card_label):
    """Path D: 8 layers of ldlq_1_4 (vec 1), unmerged, with the unrotated
    int8 head; 56 K9 in the prefill, 56 K8 + 1 K11 each decode forward."""
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    t0 = time.perf_counter()
    spec, params = build_quantized_model(
        LlamaConfig.llama31_8b(), PATH_D_QSTR, dummy=True, impl="a8",
        num_layers=PATH_D_LAYERS, lm_head_bits=16, seed=0, device=device)
    params["lm_head_q"], params["lm_head_s"] = unrotated_int8_head(
        params.pop("lm_head"))
    torch.cuda.synchronize()
    print(f"[pathD] 8B ({PATH_D_LAYERS} layers) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = drive("pathD", spec, params, device, PROMPT_LEN, NEW_TOKENS,
                     PATH_D_PREFILL, PATH_D_STEP)
    tps = throughput("pathD", spec, params, device, card_label)
    del params
    torch.cuda.empty_cache()
    return launches, tps


def tcq2mix_qdict(num_layers=32):
    return {f"{i}_{key}": q for i in range(num_layers)
            for key, q in TCQ2MIX.items()}


def path_a_b(device, card_label):
    """Path A (tcq2mix decode at a8 and exact) and Path B (512-token exact
    prefill on tcq2mix and on the 215 config).  Returns (launch counts
    summed over the counted runs, tokens/s by impl, prefill s by config)."""
    spec, params = _build("pathA", tcq2mix_qdict(), [["merge_qkv",
                                                       "merge_ug"]] * 32,
                          "a8", 4, device)
    mix = {}
    for a, m in spec.layers:
        for _, ls in a.projs + m.projs:
            key = (ls.kind, ls.mode, ls.KV[0])
            mix[key] = mix.get(key, 0) + 1
    head = spec.lm_head_spec
    check(mix == PATH_A_MIX and (head.kind, head.mode, head.KV[0],
                                 head.out_features) ==
          ("tcq2", "sum2", 8, 131072), f"tcq2mix projections {mix}, {head}")
    print(f"[pathA] projections per forward {mix} + the sum2 KV8 head "
          f"(131072x4096)", flush=True)
    total = {}
    tps = {}
    for impl in ("a8", "exact"):
        sp = with_impl(spec, impl)
        got = drive(f"pathA {impl}", sp, params, device, PROMPT_LEN,
                    NEW_TOKENS, PATH_A_STEP, PATH_A_STEP)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        tps[impl] = throughput(f"pathA {impl}", sp, params, device,
                               card_label)
    pre = {}
    sp = with_impl(spec, "exact")
    got = drive("pathB tcq2mix", sp, params, device, PREFILL_B, 0,
                PATH_B["tcq2mix"], {})
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    pre["tcq2mix"] = prefill_time("pathB tcq2mix", sp, params, device,
                                  PREFILL_B, card_label)
    del params
    torch.cuda.empty_cache()
    qdict, merge_info = _load_215()
    spec, params = _build("pathB 215", qdict, merge_info, "exact", 4, device)
    got = drive("pathB 215", spec, params, device, PREFILL_B, 0,
                PATH_B["215"], {})
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    pre["215"] = prefill_time("pathB 215", spec, params, device, PREFILL_B,
                              card_label)
    del params
    torch.cuda.empty_cache()
    return total, tps, pre


SMALL_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                 rope_theta=5e5)


def small_model_check(device, what, qdict, merge_info, impl, lm_head_bits,
                      prompt_len, seed):
    """A 2-layer model: CPU (plain versions) vs the same weights on the card
    (kernels), prefill and one decode step."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    cfg = LlamaConfig(**SMALL_CFG)
    spec, p_cpu = build_quantized_model(
        cfg, qdict, merge_info=merge_info, dummy=True, impl=impl,
        lm_head_bits=lm_head_bits, seed=seed, device="cpu")

    def to_dev(p):
        if isinstance(p, dict):
            return {k: to_dev(v) for k, v in p.items()}
        if isinstance(p, list):
            return [to_dev(v) for v in p]
        return p.to(device)

    p_dev = to_dev(p_cpu)
    prompt = np.random.default_rng(5).integers(0, 512, (1, prompt_len))
    out = {}
    for dev, p in (("cpu", p_cpu), (device, p_dev)):
        caches = llama.init_kv_caches(spec, 1, prompt_len + 2, dev)
        tok = torch.as_tensor(prompt, device=dev)
        l1, caches = llama.forward(spec, p, tok, kv_caches=caches,
                                   cache_pos=0)
        nxt = torch.tensor([[17]], device=dev)
        l2, _ = llama.forward(spec, p, nxt, kv_caches=caches,
                              cache_pos=prompt_len)
        out[str(dev)] = (l1.cpu(), l2.cpu())
    for i, step in enumerate((f"prefill {prompt_len}", "decode step")):
        a, b = out["cpu"][i], out[str(device)][i]
        rel = ((a - b).abs().max() / a.abs().max()).item()
        print(f"[small] 2-layer {what} {step}: card vs CPU plain "
              f"rel={rel:.3e} (limit {SMALL_TOL})", flush=True)
        check(rel <= SMALL_TOL, f"small model {what} {step}: rel {rel}")


def small_model_checks(device):
    kvs = [dict(qkv=6, o=4, ug=6, down=8), dict(qkv=8, o=6, ug=4, down=6)]
    group = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
             "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
             "mlp.gate_proj": "ug", "mlp.up_proj": "ug",
             "mlp.down_proj": "down"}
    qdict = {f"{i}_{key}": f"tcq2s_{mix[g]}_none_0.9"
             for i, mix in enumerate(kvs) for key, g in group.items()}
    small_model_check(device, "215 mix (tcq2s, merged, a8)", qdict,
                      [["merge_qkv", "merge_ug"]] * 2, "a8", 4, 6, seed=3)
    # layers 0 and 1 of the flagship: tcq 6/8/10, tcomb 8/9, S 9/10/11;
    # 12 prompt tokens, so the prefill takes the dequant path
    with open(FLAGSHIP_QDICT) as f:
        flagship = json.load(f)
    small_model_check(device, "flagship mix (tcq/tcomb, unmerged, exact)",
                      flagship, None, "exact", 16, 12, seed=4)
    # tcq2mix with a 300-token prompt at exact: K2 (qkv, ug) and K3 (o,
    # down) in the prefill, K1 in the decode step
    small_model_check(device, "tcq2mix (tcq2 dualmad + tcq1 1mad, merged, "
                      "exact)", tcq2mix_qdict(2),
                      [["merge_qkv", "merge_ug"]] * 2, "exact", 4, 300,
                      seed=6)
    # Path C's mix: 12 prompt tokens take K9 and the head's plain product,
    # the decode step K8 and K10
    small_model_check(device, "Path C (ldlq_2_6, merged, rotated int8 head, "
                      "a8)", PATH_C_QSTR, [["merge_qkv", "merge_ug"]] * 2,
                      "a8", 8, 12, seed=7)


REPLACES = "qpalette_tpu/kernels/fused.py:"
KERNEL_INFO = {  # name: (source, the TPU kernel body it replaces)
    "tcq2s_decode_gemv": ("tcq2_gemv.cu", REPLACES + "508"),
    "tcq2_decode_gemv": ("tcq2_gemv.cu", REPLACES + "508"),
    "tcq1_decode_gemv": ("tcq1_gemv.cu", REPLACES + "508"),
    "tcq2_dequant": ("arith_dequant.cu", REPLACES + "902"),
    "tcq1_dequant": ("arith_dequant.cu", REPLACES + "1007"),
    "tcq_lut_gemv": ("tcq_lut.cu", REPLACES + "253"),
    "tcomb_lut_gemv": ("tcq_lut.cu", REPLACES + "314"),
    "tcq_lut_dequant": ("tcq_lut.cu", REPLACES + "1083"),
    "tcomb_lut_dequant": ("tcq_lut.cu", REPLACES + "1089"),
    "vq_gemv": ("vq.cu", REPLACES + "133"),
    "vq_dequant": ("vq.cu", REPLACES + "1179"),
    "int8_gemv_a8": ("int8_gemv.cu", REPLACES + "1401"),
    "int8_gemv": ("int8_gemv.cu", REPLACES + "1394"),
}


def main():
    name, count, smi = card()
    from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                            tcq_lut, vq)
    from qpalette_tpu_torch.models.llama import LlamaConfig

    build_all()
    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    sum2_err, sum2_times = sum2_checks(arith, device)
    err, times, deq215 = arith_checks(arith, arith_dequant, device)
    err["tcq2s_decode_gemv"] = sum2_err
    with open(FLAGSHIP_QDICT) as f:
        shapes = flagship_shapes(LlamaConfig.llama31_8b(), json.load(f))
    check(sum(n for (_, _, KV), n in shapes.items() if len(KV) == 1)
          == FLAGSHIP_TCQ and sum(n for (_, _, KV), n in shapes.items()
                                  if len(KV) == 2) == FLAGSHIP_TCOMB,
          f"flagship shapes {shapes}")
    lut_err, lut_times = lut_kernel_checks(tcq_lut, {**shapes, **LUT_KV3},
                                           device)
    err.update(lut_err)
    times.update(lut_times)
    vq_err, vq_times, vq_schemes = vq_kernel_checks(vq, device)
    i8_err, i8_times, library = int8_head_checks(int8_gemv, device)
    for d, new in ((err, vq_err), (err, i8_err), (times, vq_times),
                   (times, i8_times)):
        d.update(new)
    print(f"[time] kernel checks {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, qdict = main_path(device, smi)
    for k, v in flagship_path(device, smi).items():
        launches[k] += v
    ab, tps, pre = path_a_b(device, smi)
    for k, v in ab.items():
        launches[k] += v
    pc, tps["pathC"] = path_c(device, smi)
    pd, tps["pathD"] = path_d(device, smi)
    for k in launches:
        launches[k] += pc[k] + pd[k]
    small_model_checks(device)
    times["tcq2s_decode_gemv"] = step_ms(sum2_times, qdict)
    ms, pms, bms = times["tcq2s_decode_gemv"]
    print(f"[time] one 215 decode step's 129 sum2 calls: kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms, bound {bms:.3f} ms (a8, N=1; {smi})",
          flush=True)
    for kname in ("tcq2_decode_gemv", "tcq1_decode_gemv"):
        kms, kpms, kbms = times[kname]
        print(f"[time] Path A decode step's 64 calls of {kname}: kernel "
              f"{kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms (a8, "
              f"N=1; {smi})", flush=True)
    for kname in ("tcq2_dequant", "tcq1_dequant"):
        kms, kpms, kbms = times[kname]
        print(f"[time] tcq2mix 512-token prefill's 64 calls of {kname}: "
              f"kernel {kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} "
              f"ms ({smi})", flush=True)
    kms, kpms, kbms = step_ms(deq215, qdict)
    print(f"[time] 215 512-token prefill's 128 calls of tcq2_dequant (sum2): "
          f"kernel {kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms "
          f"({smi})", flush=True)
    for kname in ("tcq_lut_gemv", "tcomb_lut_gemv", "tcq_lut_dequant",
                  "tcomb_lut_dequant"):
        kms, kpms, kbms = times[kname]
        print(f"[time] flagship forward's calls of {kname}: kernel "
              f"{kms:.3f} ms, plain {kpms:.3f} ms, bound {kbms:.3f} ms "
              f"({kbms / kms:.1%} of it; {smi})", flush=True)
    print(f"[time] Path C decode forward's 128 vq_gemv calls (N=1): kernel "
          f"{times['vq_gemv'][0]:.3f} ms, plain {times['vq_gemv'][1]:.3f} ms,"
          f" bound {times['vq_gemv'][2]:.3f} ms; its prefill's 128 vq_dequant"
          f" calls: kernel {times['vq_dequant'][0]:.3f} ms, plain "
          f"{times['vq_dequant'][1]:.3f} ms, bound "
          f"{times['vq_dequant'][2]:.3f} ms ({smi})", flush=True)
    print("[time] vq per scheme, ms per call (vq_gemv N=1, vq_dequant): "
          + json.dumps({f"{b}/{v} {n}": [round(a, 5), round(d, 5)]
                        for (b, v, n), (a, d) in vq_schemes.items()}),
          flush=True)
    print(f"[pathC] tokens/s {tps['pathC']:.2f}; [pathD] tokens/s "
          f"{tps['pathD']:.2f} ({smi})", flush=True)
    print(f"[pathA] tokens/s a8 {tps['a8']:.2f}, exact {tps['exact']:.2f}; "
          f"[pathB] 512-token exact prefill tcq2mix {pre['tcq2mix'] * 1e3:.1f}"
          f" ms, 215 {pre['215'] * 1e3:.1f} ms ({smi})", flush=True)
    kernels = []
    for f in all_kernels():
        kname = f.__name__
        check(launches[kname] > 0, f"{kname} launched no time on a path")
        src, where = KERNEL_INFO[kname]
        kms, kpms, kbms = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"qpalette_tpu_torch/csrc/{src}", "replaces": where,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": kms, "plain_ms": kpms, "bound_ms": kbms,
            "bound_by": BOUND_BY.get(kname, "bytes"),
            "library_ms": library.get(kname)})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an older csrc/tcq_lut.cu: run parent_ab only")
    args = ap.parse_args()
    if args.parent:
        parent_ab(args.parent)
    else:
        main()
