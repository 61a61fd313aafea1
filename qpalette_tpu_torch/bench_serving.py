"""Continuous-batching throughput of the port (counterpart of
scripts/bench_serving.py).

  python -m qpalette_tpu_torch.bench_serving
  python -m qpalette_tpu_torch.bench_serving --slots 16 --requests 32

Aggregate decode tokens/s of runtime/serving.ContinuousBatcher with
--slots concurrent requests on Llama-3.1-8B quantized as the reference's
benchmark mix (tcq2s_6 on every projection but down, tcq2s_8 on down, qkv
and gate-up merged, impl a8, the rotated int8 lm_head, dummy weights from
seed 0), --layers of its 32 layers, and the chunked admission's share.
It first runs a full pool of requests end to end (the pool step's capture
and the kernels' builds), then times --requests requests of --prompt_len
random tokens and --new_tokens each.  Admission is billed, with a
synchronize, only for scheduler passes that filled a slot.  Prints one
JSON line: the reference's keys plus the card's name and power limit
(nvidia-smi), the SM clock over the timed run and the peak memory.  Runs
on cuda:0 unless --device cpu (a rehearsal, not a device measurement).
"""

import argparse
import json
import time

import numpy as np


def bench_qdict(layers: int):
    """The benchmark mix: {f"{layer}_{key}": quantizer_str}, with its
    merge_info."""
    from qpalette_tpu_torch.runtime.loader import LAYER_KEYS

    qd = {f"{i}_{key}": ("tcq2s_8_none_0.9" if key == "mlp.down_proj"
                         else "tcq2s_6_none_0.9")
          for i in range(layers) for key in LAYER_KEYS}
    return qd, [["merge_qkv", "merge_ug"]] * layers


def main(argv=None, cfg=None):
    """cfg: a LlamaConfig in place of Llama-3.1-8B's (a small rehearsal)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--new_tokens", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill_chunk", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from qpalette_tpu_torch.measure_latency import SmClock, card_label
    from qpalette_tpu_torch.models.llama import LlamaConfig
    from qpalette_tpu_torch.runtime.loader import build_quantized_model
    from qpalette_tpu_torch.runtime.serving import (ContinuousBatcher,
                                                    release_pools)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        dev_name = card_label(device.index or 0)
    else:
        dev_name = "cpu (rehearsal, not a device measurement)"
    cfg = cfg or LlamaConfig.llama31_8b()
    qd, merge_info = bench_qdict(args.layers)
    spec, params = build_quantized_model(
        cfg, qd, merge_info=merge_info, dummy=True, impl="a8",
        num_layers=args.layers, lm_head_bits=8, device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    vocab = min(1000, cfg.vocab_size)
    b = ContinuousBatcher(spec, params, n_slots=args.slots,
                          max_seq=args.prompt_len + args.new_tokens + 8,
                          prefill_chunk=args.prefill_chunk)
    # warm-up: a full pool end to end (the pool step is captured at the
    # batcher's construction; admission runs eagerly, with no program per
    # shape to build)
    for _ in range(args.slots):
        b.submit(list(rng.integers(0, vocab, args.prompt_len)),
                 args.new_tokens)
    b.run()
    b.finished.clear()

    for _ in range(args.requests):
        b.submit(list(rng.integers(0, vocab, args.prompt_len)),
                 args.new_tokens)
    admit_t = [0.0]
    admits = [0]
    admit0 = b._admit

    def timed_admit():
        # a pass that fills no slot does no device work: bill it nothing
        t = time.perf_counter()
        n = admit0()
        if n:
            sync()
            admit_t[0] += time.perf_counter() - t
            admits[0] += 1
        return n
    b._admit = timed_admit
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    clock = SmClock(device.index or 0) if cuda else None
    t0 = time.perf_counter()
    if clock:
        with clock:
            b.run()
            sync()
    else:
        b.run()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    release_pools(params)
    print(f"admission (prefill) time: {admit_t[0]:.2f}s of {dt:.2f}s "
          f"({admits[0]} admissions) on {dev_name}", flush=True)
    toks = sum(len(r.output) for r in b.finished.values())
    scale = cfg.num_layers / args.layers  # extrapolate to the full model
    result = {
        "metric": f"continuous-batching decode tokens/s "
                  f"({args.slots} slots, {args.layers}-layer 8B, "
                  f"extrapolated x{scale:.0f})",
        "value": round(toks / dt / scale, 2),
        "unit": "tokens/s",
        "raw_tokens": toks, "seconds": round(dt, 2),
        "admission_s": round(admit_t[0], 2),
        "prefill_chunk": args.prefill_chunk,
        "admissions": admits[0], "device": dev_name,
        "sm_mhz": clock.mhz if clock else None,
        "peak_gb": peak / 1e9 if peak is not None else None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
