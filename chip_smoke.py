#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

  python chip_smoke.py

Phases (each raises on failure):
  1. card: name, count, power limit; no CUDA device -> exit 1
  2. build both CUDA libraries from qpalette_tpu_torch/csrc, one nvcc each,
     started together (ptxas -v: registers, shared memory, spills)
  3. tcq2s kernel against its plain PyTorch version at every Llama-3.1-8B
     shape of the 215.0thp_cc path (plus KV 4/6/8 at 4096x4096), N in
     {1,4,16}, exact and a8; kernel and plain times at N=1
  4. LUT trellis kernels against their plain versions at every shape of
     the 3.25-bit flagship: tcq/tcomb GEMV (N in {1,4,8}, within 1e-4 of
     max|y|) and dequant (bit-equal), the dequant + product at N=16;
     kernel and plain times: GEMV at N=1, dequant alone, and the
     dequant + product at N=16
  5. the 215 path: the 8B model from the 215.0thp_cc solver output (merged
     qkv/ug, 4-bit tcq2s lm_head, impl a8, dummy weights from seed 0) on
     cuda:0; prefill 16 tokens and decode 64 at temperature 0.6, top-k 5,
     129 tcq2s launches per forward; decode twice for determinism
  6. the flagship path: the 8B model from the 3.25-bit mem-constrained
     solver output (unmerged tcq 6/8/10 and tcomb 8/9, bf16 lm_head, impl
     exact, dummy weights from seed 0); the 16-token prefill launches 194
     tcq + 30 tcomb dequants, each of 64 decode forwards 194 tcq + 30
     tcomb GEMVs; decode twice for determinism
  7. 2-layer models with each path's scheme mix on the CPU (plain
     versions) against the same weights on the card (kernels)
  8. a JSON line of kernels, the nvidia-smi name/power line, and the final
     JSON status line
"""

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
PROMPT_LEN, NEW_TOKENS = 16, 64
TOL = {False: 1e-4, True: 1e-3}  # kernel vs plain, of max|y|
SMALL_TOL = 2e-2  # CPU plain vs card kernel through a 2-layer model
# flagship projections per forward, by (shape m x k, KV): 194 tcq, 30 tcomb
FLAGSHIP_TCQ, FLAGSHIP_TCOMB = 194, 30
LUT_TOL = 1e-4  # LUT GEMV kernel vs plain, of max|y|
# dequant + product at N=16: the kernel's W is bit-equal to the plain one,
# so the two products see the same operands
PRODUCT_TOL = 1e-6
L2_BYTES = 50_000_000


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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


def _words(m, k, KV, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31,
                         ((m // 16) * (k // 16), 4 * KV), generator=gen,
                         dtype=torch.int32, device=device)


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for i in range(reps):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_checks(tcq2s, device):
    """Kernel vs plain at every shape; returns (max_abs_err, times)."""
    max_abs = 0.0
    for name, m, k, KV in SHAPES_215 + EXTRA_KV:
        words = _words(m, k, KV, device, seed=m + k + KV)
        for N in (1, 4, 16):
            # decode rows reach the kernel as the f32 rotation output,
            # prefill rows as bf16 (qlinear_apply)
            x_dtype = torch.float32 if N <= 8 else torch.bfloat16
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
            for a8 in (False, True):
                y = tcq2s.tcq2s_decode_gemv(x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                ref = tcq2s.tcq2s_decode_gemv_plain(x, words, KV, m, k, a8)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{name} non-finite")
                max_abs = max(max_abs, err)
                print(f"[kernel] {name} {m}x{k} KV={KV} N={N} "
                      f"{'a8' if a8 else 'exact'}: max_abs_err={err:.3e} "
                      f"rel={rel:.3e} (limit {TOL[a8]:.0e})", flush=True)
                check(rel <= TOL[a8], f"{name} N={N} a8={a8}: rel {rel}")
    times = {}
    for name, m, k, KV in SHAPES_215:
        # cycle through copies of the weights so that repeated launches
        # stream from device memory, as a decode step does, not from L2
        nbytes = m * k * KV // 16
        copies = [_words(m, k, KV, device, seed=i)
                  for i in range(min(16, -(-150_000_000 // nbytes)))]
        x = torch.randn((1, k), device=device)
        out = torch.empty((1, m), device=device)

        def kern(i=0):
            tcq2s.tcq2s_decode_gemv(x, copies[i % len(copies)], KV, m, k,
                                    True, out=out)

        def plain(i=0):
            tcq2s.tcq2s_decode_gemv_plain(x, copies[i % len(copies)], KV, m,
                                          k, True)

        ms = _time_ms(kern, 200)
        pms = _time_ms(plain, 5)
        gbps = nbytes / (ms * 1e-3) / 1e9
        times[(name, KV)] = (ms, pms)
        print(f"[time] {name} {m}x{k} KV={KV} a8 N=1: kernel {ms:.4f} ms "
              f"({gbps:.0f} GB/s of packed trellis), plain {pms:.4f} ms",
              flush=True)
        del copies
    return max_abs, times


def step_ms(times, qdict):
    """Kernel (or plain) time of one decode step's 129 calls, weighting the
    ug shape by the 215 qdict's KV mix."""
    ug_kv = [int(qdict[f"{i}_mlp.up_proj"][0].split("_")[1])
             for i in range(32)]
    tot = [0.0, 0.0]
    for (name, KV), pair in times.items():
        n = (sum(kv == KV for kv in ug_kv) if name == "ug"
             else CALLS_PER_STEP[name])
        for j in (0, 1):
            tot[j] += n * pair[j]
    return tot


def main_path(tcq2s, device, card_label):
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime import decode
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    with open(os.path.join(QDIR, "215.0thp_cc.json")) as f:
        qdict = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(QDIR, "215.0thp_cc_merge_info.json")) as f:
        merge_info = json.load(f)
    cfg = LlamaConfig.llama31_8b()
    t0 = time.perf_counter()
    spec, params = build_quantized_model(cfg, qdict, merge_info=merge_info,
                                         dummy=True, impl="a8",
                                         lm_head_bits=4, seed=0,
                                         device=device)
    torch.cuda.synchronize()
    print(f"[main] 8B 215.0thp_cc built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    V = cfg.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    T = PROMPT_LEN + NEW_TOKENS + 1

    # the counted run: every forward must launch the kernel 129 times
    caches = llama.init_kv_caches(spec, 1, T, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    tcq2s.tcq2s_decode_gemv.launches = 0
    logits, caches = decode.prefill(spec, params,
                                    torch.as_tensor(prompt, device=device),
                                    caches)
    counts = [tcq2s.tcq2s_decode_gemv.launches]
    finite = bool(torch.isfinite(logits).all())
    cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
    toks = [cur]
    for pos in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS):
        logits, caches = llama.forward(spec, params, cur, kv_caches=caches,
                                       cache_pos=pos)
        counts.append(tcq2s.tcq2s_decode_gemv.launches)
        finite = finite and bool(torch.isfinite(logits).all())
        cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    launches = tcq2s.tcq2s_decode_gemv.launches
    check(logits.shape == (1, 1, V), f"logits shape {tuple(logits.shape)}")
    check(finite, "non-finite logits")
    per_forward = np.diff([0] + counts)
    check(bool((per_forward == LAUNCHES_PER_FORWARD).all()),
          f"launches per forward {sorted(set(per_forward.tolist()))}")
    toks = torch.cat(toks, dim=1).cpu().numpy()
    check(bool(((toks >= 0) & (toks < V)).all()), "token out of vocab")
    print(f"[main] prefill {PROMPT_LEN} + {NEW_TOKENS} decode steps: "
          f"{launches} kernel launches ({LAUNCHES_PER_FORWARD} per forward), "
          f"logits finite, tokens in vocab", flush=True)

    # determinism and throughput through the user-facing generate()
    runs = [decode.generate(spec, params, prompt, NEW_TOKENS + 1,
                            max_seq=T, temperature=0.6, top_k=5, seed=99)
            for _ in range(2)]
    check(np.array_equal(runs[0][0], runs[1][0]),
          "same seed, different tokens")
    tps = runs[1][1]["tokens_per_sec"]
    mbytes = decode.model_bytes(params)
    streamed = mbytes - decode.model_bytes(params["embed"])
    print(f"[main] decode {tps:.2f} tokens/s bs=1 (eager loop, host clock, "
          f"{runs[1][1]['timed_tokens']} steps), model {mbytes / 1e9:.3f} GB, "
          f"streamed {streamed / 1e9:.3f} GB/token, "
          f"{streamed * tps / 1e9:.1f} GB/s; card {card_label}", flush=True)
    del params, caches
    torch.cuda.empty_cache()
    return launches, qdict


def build_all():
    """One nvcc per CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from qpalette_tpu_torch.kernels import _build, tcq2s, tcq_lut

    names = [tcq2s.SOURCE, tcq_lut.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        logs = list(ex.map(_build.build, names))
    print(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in zip(names, logs):
        print(f"[build] {name}.cu\n{log.strip()}", flush=True)


def flagship_shapes(cfg, qdict):
    """{(m, k, KV): projections per forward} of the flagship qdict."""
    from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
    from qpalette_tpu_torch.runtime.loader import proj_shape

    counts = {}
    for key, qstr in qdict.items():
        m, k = proj_shape(cfg, key.split("_", 1)[1])
        q = parse_quantizer_str(qstr)
        check(q.family in ("tcq", "tcomb"), f"{key}: {qstr}")
        counts[m, k, q.KV] = counts.get((m, k, q.KV), 0) + 1
    return counts


def _lut_words(m, k, KV, device, seed):
    return [_words(m, k // len(KV), kv, device, seed + i)
            for i, kv in enumerate(KV)]


def lut_kernel_checks(tcq_lut, shapes, device):
    """K4-K7 against their plain versions at every flagship shape; returns
    ({kernel: max_abs_err}, {kernel: [ms per forward, plain ms]})."""
    from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

    err = {f.__name__: 0.0 for f in tcq_lut.KERNELS}
    times = {f.__name__: [0.0, 0.0] for f in tcq_lut.KERNELS}
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
        for N in (1, 4, 8, 16):
            gen = torch.Generator(device=device)
            gen.manual_seed(N)
            x = torch.randn((N, k), generator=gen, device=device).bfloat16()
            if N <= 8:
                y = gemv(x, *words, tlut, *KV, m, k)
                torch.cuda.synchronize()
                ref = gemv_plain(x, *words, tlut, *KV, m, k)
                e = (y - ref).abs().max().item()
                rel = e / ref.abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{label} non-finite")
                err[gemv.__name__] = max(err[gemv.__name__], e)
                print(f"[lut] {gemv.__name__} {label} N={N}: max_abs_err="
                      f"{e:.3e} rel={rel:.3e} (limit {LUT_TOL:.0e})",
                      flush=True)
                check(rel <= LUT_TOL, f"{gemv.__name__} {label} N={N}: "
                      f"rel {rel}")
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
        for fn, route, reps, plain_route in (
                (gemv, kern, 200, False), (gemv, plain, 5, True),
                (deq, kern_deq, 50, False), (deq, plain_deq, 5, True),
                (None, kern16, 50, False), (None, plain16, 5, True)):
            ms = _time_ms(route, reps)
            if fn is not None:
                times[fn.__name__][plain_route] += count * ms
            gbps = nbytes / (ms * 1e-3) / 1e9
            print(f"[time] {label} {route.__name__}: {ms:.4f} ms"
                  + (f" ({gbps:.0f} GB/s of packed trellis)"
                     if route in (kern, kern_deq) else ""), flush=True)
        del copies, wout
    return err, times


def _counts(tcq_lut):
    return {f.__name__: f.launches for f in tcq_lut.KERNELS}


def flagship_path(tcq_lut, device, card_label):
    """The 8B model from the 3.25-bit solver output: 194 tcq + 30 tcomb
    dequants in the prefill, 194 + 30 GEMVs in each decode forward."""
    from qpalette_tpu_torch.models import llama
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime import decode
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    with open(FLAGSHIP_QDICT) as f:
        qdict = json.load(f)
    cfg = LlamaConfig.llama31_8b()
    t0 = time.perf_counter()
    spec, params = build_quantized_model(cfg, qdict, merge_info=None,
                                         dummy=True, impl="exact",
                                         lm_head_bits=16, seed=0,
                                         device=device)
    torch.cuda.synchronize()
    print(f"[flagship] 8B 3.25bit built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    V = cfg.vocab_size
    prompt = np.random.default_rng(0).integers(0, V, (1, PROMPT_LEN))
    T = PROMPT_LEN + NEW_TOKENS + 1
    gemv = {"tcq_lut_gemv": FLAGSHIP_TCQ, "tcomb_lut_gemv": FLAGSHIP_TCOMB}
    deq = {"tcq_lut_dequant": FLAGSHIP_TCQ,
           "tcomb_lut_dequant": FLAGSHIP_TCOMB}

    # the counted run
    caches = llama.init_kv_caches(spec, 1, T, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    for fn in tcq_lut.KERNELS:
        fn.launches = 0
    logits, caches = decode.prefill(spec, params,
                                    torch.as_tensor(prompt, device=device),
                                    caches)
    seen = [_counts(tcq_lut)]
    finite = bool(torch.isfinite(logits).all())
    cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
    toks = [cur]
    for pos in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS):
        logits, caches = llama.forward(spec, params, cur, kv_caches=caches,
                                       cache_pos=pos)
        seen.append(_counts(tcq_lut))
        finite = finite and bool(torch.isfinite(logits).all())
        cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    launches = _counts(tcq_lut)
    check(seen[0] == {**deq, **{k: 0 for k in gemv}},
          f"prefill launches {seen[0]}")
    for a, b in zip(seen, seen[1:]):
        step = {k: b[k] - a[k] for k in b}
        check(step == {**gemv, **{k: 0 for k in deq}},
              f"decode launches per forward {step}")
    check(logits.shape == (1, 1, V), f"logits shape {tuple(logits.shape)}")
    check(finite, "non-finite logits")
    toks = torch.cat(toks, dim=1).cpu().numpy()
    check(bool(((toks >= 0) & (toks < V)).all()), "token out of vocab")
    print(f"[flagship] prefill {PROMPT_LEN}: {seen[0]}; {NEW_TOKENS} decode "
          f"forwards: {FLAGSHIP_TCQ} tcq + {FLAGSHIP_TCOMB} tcomb GEMVs "
          f"each; total {launches}; logits finite, tokens in vocab",
          flush=True)

    runs = [decode.generate(spec, params, prompt, NEW_TOKENS + 1,
                            max_seq=T, temperature=0.6, top_k=5, seed=99)
            for _ in range(2)]
    check(np.array_equal(runs[0][0], runs[1][0]),
          "same seed, different tokens")
    tps = runs[1][1]["tokens_per_sec"]
    mbytes = decode.model_bytes(params)
    streamed = mbytes - decode.model_bytes(params["embed"])
    print(f"[flagship] decode {tps:.2f} tokens/s bs=1 (eager loop, host "
          f"clock, {runs[1][1]['timed_tokens']} steps), model "
          f"{mbytes / 1e9:.3f} GB, streamed {streamed / 1e9:.3f} GB/token "
          f"(computed from tensor sizes), {streamed * tps / 1e9:.1f} GB/s; "
          f"card {card_label}", flush=True)
    del params, caches
    torch.cuda.empty_cache()
    return launches


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


def main():
    name, count, smi = card()
    from qpalette_tpu_torch.kernels import tcq2s, tcq_lut
    from qpalette_tpu_torch.models.llama import LlamaConfig

    build_all()
    device = torch.device("cuda:0")
    max_abs, times = kernel_checks(tcq2s, device)
    with open(FLAGSHIP_QDICT) as f:
        shapes = flagship_shapes(LlamaConfig.llama31_8b(), json.load(f))
    check(sum(n for (_, _, KV), n in shapes.items() if len(KV) == 1)
          == FLAGSHIP_TCQ and sum(n for (_, _, KV), n in shapes.items()
                                  if len(KV) == 2) == FLAGSHIP_TCOMB,
          f"flagship shapes {shapes}")
    lut_err, lut_times = lut_kernel_checks(tcq_lut, shapes, device)
    launches, qdict = main_path(tcq2s, device, f"{smi}")
    lut_launches = flagship_path(tcq_lut, device, f"{smi}")
    small_model_checks(device)
    ms, pms = step_ms(times, qdict)
    print(f"[time] one decode step's 129 calls: kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms (a8, N=1; {smi})", flush=True)
    for kname, (kms, kpms) in lut_times.items():
        print(f"[time] flagship forward's calls of {kname}: kernel "
              f"{kms:.3f} ms, plain {kpms:.3f} ms ({smi})", flush=True)
    lut_line = "qpalette_tpu/kernels/fused.py:"
    replaces = {"tcq_lut_gemv": lut_line + "253",
                "tcomb_lut_gemv": lut_line + "314",
                "tcq_lut_dequant": lut_line + "1083",
                "tcomb_lut_dequant": lut_line + "1089"}
    kernels = [{
        "name": "tcq2s_decode_gemv", "route": "cuda",
        "source": "qpalette_tpu_torch/csrc/tcq2s_gemv.cu",
        "replaces": "qpalette_tpu/kernels/fused.py:508",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": pms}]
    for kname, where in replaces.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "qpalette_tpu_torch/csrc/tcq_lut.cu",
            "replaces": where, "launches": lut_launches[kname],
            "max_abs_err": lut_err[kname], "ms": lut_times[kname][0],
            "plain_ms": lut_times[kname][1]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
