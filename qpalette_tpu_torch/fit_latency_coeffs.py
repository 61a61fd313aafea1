"""Measure the latency table of the latency-constrained MSQ solver on the
card (counterpart of fit_latency_coeffs.py).

  python -m qpalette_tpu_torch.fit_latency_coeffs --full --nodename h100
  python -m qpalette_tpu_torch.fit_latency_coeffs          # sample + fit

Each (group, quantizer) entry is the seconds of one projection call as
the decode step makes it: ``qlinear_apply`` at one row of bf16 x through
the port's kernels at --impl (K1 for tcq1 / tcq2 / tcq2s, K4 / K5 for tcq
/ tcomb, K8 for ldlq), dummy weights of the group's merged shape.  The
``_True`` keys (the solver's second impl, offered to ldlq only) are
timed through impl dequant: K9 and the product.  A time is a CUDA-graph
replay of many calls, read with CUDA events, over copies of the weights
that together exceed the 50 MB L2 three times, so each call streams its
weights from device memory as in a step; a time under the bytes over the
card's 3.35 TB/s is taken again once, then left to the fit.

Without --full it measures the sample grid (QPT_FIT_GROUPS, QPT_FIT_QS:
comma-separated overrides), fits lat = launch + bytes / BW a scheme
family (msq/latmodel.fit_family_model) and fills the rest of the table
from the fit; --full measures every group x quantizer of the palette and
the ldlq ``_True`` keys.  ``constant``, the rest of a step (attention,
norms, rotations, the head, sampling), is measured unless --constant is
given: the device time a step of the 215.0thp_cc model's captured step
(CUDA events over replays) minus its projections' entries in this
table.  Writes assets/{model_key}_latency_coeffs_{nodename}.json (or
--out) with the card's name and power limit and the SM clock.  Runs on
cuda:0; --device cpu is a rehearsal (plain versions; --constant needed).
"""

import argparse
import json
import os
import time

SAMPLE_GROUPS = "q,qkv,o,ug,d"
SAMPLE_QS = ("tcq1_3_none_0.9,tcq1_4_none_0.9,tcq2_6_none_0.9,"
             "tcq2_8_none_0.9,tcq2s_6_none_0.9,tcq2s_8_none_0.9,"
             "tcq_6_none_0.9,ldlq_1_4_none_1.0,ldlq_2_6_none_1.0")
L2_BYTES = 50_000_000
HBM_BYTES_S = 3.35e12  # the H100 SXM's memory rate
QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "msq_results", "3_8b", "lat_constrained", "v5e",
    "default_err")
STEP_PROMPT, STEP_TOKENS = 16, 64


def group_shape(cfg, g):
    """(m, n) of a group: its projections' rows summed, their shared n."""
    from qpalette_tpu_torch.msq.memmodel import layer_shape
    from qpalette_tpu_torch.msq.solver import MERGE_GROUPS, SIMPLE2KEY

    shapes = [layer_shape(cfg, SIMPLE2KEY[b])
              for b in MERGE_GROUPS.get(g, (g,))]
    assert all(s[1] == shapes[0][1] for s in shapes)
    return sum(s[0] for s in shapes), shapes[0][1]


class Timer:
    """Seconds a call of qlinear_apply at one row for (group, quantizer,
    impl), on device."""

    def __init__(self, cfg, device, reps: int):
        self.cfg, self.device, self.reps = cfg, device, reps

    def _copies(self, q, m, n, impl):
        import torch
        from qpalette_tpu_torch.runtime.loader import (_params_from_artifact,
                                                       _spec_from_meta,
                                                       dummy_artifact)
        from qpalette_tpu_torch.ops.codebooks import trellis_tlut

        art = dummy_artifact(q, (m, n), seed=0)
        spec = _spec_from_meta(art["meta"], impl)
        first = _params_from_artifact(art, self.device)
        nbytes = sum(t.numel() * t.element_size() for t in first.values())
        count = 1
        if self.device.type == "cuda":
            count = min(64, -(-3 * L2_BYTES // nbytes))
        copies = [first]
        for i in range(1, count):
            art["__device_dummy__"] = 100 + i
            copies.append(_params_from_artifact(art, self.device))
        luts = {}
        if spec.kind in ("tcq", "tcomb", "comb"):
            luts[spec.tcq_lut_key()] = torch.tensor(
                trellis_tlut(spec.tlut_bits), device=self.device)
        return spec, copies, luts

    def __call__(self, g, q, impl):
        import torch
        from qpalette_tpu_torch.runtime.qlinear import qlinear_apply

        m, n = group_shape(self.cfg, g)
        spec, copies, luts = self._copies(q, m, n, impl)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        x = torch.randn((1, n), generator=gen, device=self.device,
                        dtype=torch.float32).to(torch.bfloat16)
        reps = len(copies) * -(-self.reps // len(copies))

        def run():
            for i in range(reps):
                qlinear_apply(spec, copies[i % len(copies)], x, luts=luts)

        if self.device.type != "cuda":
            run()
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) / reps
        run()  # builds the library, sets kernel attributes
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()
        best = float("inf")
        for _ in range(2):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            graph.replay()
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3 / reps)
        del graph
        return best


def step_seconds(cfg, device, impl):
    """Device seconds a step of the 215.0thp_cc model's captured step (the
    4-bit head, batch 1): CUDA events over STEP_TOKENS replays after a
    16-token prefill.  Returns (seconds, qdict, merge_info)."""
    import numpy as np
    import torch
    from qpalette_tpu_torch.runtime import decode
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    with open(os.path.join(QDIR, "215.0thp_cc.json")) as f:
        qdict = {k: tuple(v) for k, v in json.load(f).items()}
    with open(os.path.join(QDIR, "215.0thp_cc_merge_info.json")) as f:
        merge_info = json.load(f)
    spec, params = build_quantized_model(
        cfg, qdict, merge_info=merge_info, dummy=True, impl=impl,
        lm_head_bits=4, seed=0, device=device)
    T = STEP_PROMPT + 2 * STEP_TOKENS + 1
    step = decode.CapturedStep(spec, params, 1, T, 0.6, 5)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, STEP_PROMPT)), device=device)
    logits, _ = decode.prefill(spec, params, prompt, step.caches)
    step.reset(logits[:, -1].argmax(dim=-1)[:, None], STEP_PROMPT)
    step.replay(STEP_TOKENS)  # warm
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    step.replay(STEP_TOKENS)
    e1.record()
    torch.cuda.synchronize()
    sec = e0.elapsed_time(e1) / 1e3 / STEP_TOKENS
    del step, params
    torch.cuda.empty_cache()
    return sec, qdict, merge_info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--nodename", default="h100")
    ap.add_argument("--qlist", default="lat", choices=["lat", "mem"])
    ap.add_argument("--reps", type=int, default=64,
                    help="calls a timed graph (rounded up to a whole "
                    "number of passes over the weight copies)")
    ap.add_argument("--impl", default="a8", choices=["exact", "a8"],
                    help="impl of the _False keys (the _True keys: dequant)")
    ap.add_argument("--full", action="store_true",
                    help="measure every (group, q) instead of sample+fit")
    ap.add_argument("--constant", type=float, default=None,
                    help="the rest of a step, seconds; default: measured "
                    "on the 215.0thp_cc model's captured step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="default assets/{model_key}_latency_coeffs_"
                    "{nodename}.json")
    args = ap.parse_args(argv)

    import torch
    from qpalette_tpu_torch.measure_latency import SmClock, card_label
    from qpalette_tpu_torch.msq.latmodel import (GROUPS, build_lat_table,
                                                 family_of, fit_family_model,
                                                 packed_bytes, qdict_latency)
    from qpalette_tpu_torch.msq.solver import QDICT_LAT, QDICT_MEM
    from qpalette_tpu_torch.runtime.loader import CONFIGS, MODEL_KEYS

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        dev_name = card_label(device.index or 0)
    else:
        if args.constant is None:
            raise SystemExit("--device cpu needs --constant: the step is "
                             "measured on the card only")
        dev_name = "cpu (rehearsal, not a device measurement)"
    model_key = MODEL_KEYS[args.model]
    cfg = CONFIGS[model_key]()
    qlist = list(QDICT_LAT if args.qlist == "lat" else QDICT_MEM)
    if args.full:
        pairs = [(g, q) for g in GROUPS for q in qlist]
    else:
        groups = os.environ.get("QPT_FIT_GROUPS", SAMPLE_GROUPS).split(",")
        qs = os.environ.get("QPT_FIT_QS", SAMPLE_QS).split(",")
        pairs = [(g, q) for g in groups for q in qs]

    timer = Timer(cfg, device, args.reps)
    samples = []
    measured = {}      # -> `_False` keys (args.impl)
    measured_alt = {}  # -> `_True` keys (impl dequant, ldlq only)
    t_start = time.perf_counter()
    clock = SmClock(device.index or 0) if cuda else None
    if clock:
        clock.__enter__()
    try:
        for g, q in pairs:
            byts = packed_bytes(cfg, g, q)
            floor = byts / HBM_BYTES_S
            dt = timer(g, q, args.impl)
            if dt < floor:  # faster than the card can stream: take again
                dt = timer(g, q, args.impl)
            if dt < floor:
                print(f"{g}_{q}: {dt * 1e6:.1f} us under the bound "
                      f"{floor * 1e6:.1f} us, left to the fit", flush=True)
                continue
            samples.append((family_of(q), byts, dt))
            measured[f"{g}_{q}"] = dt
            line = f"{g}_{q}: {dt * 1e6:.2f} us ({byts / dt / 1e9:.0f} GB/s)"
            if q.startswith("ldlq"):
                measured_alt[f"{g}_{q}"] = timer(g, q, "dequant")
                line += f", dequant {measured_alt[f'{g}_{q}'] * 1e6:.2f} us"
            print(line, flush=True)
    finally:
        if clock:
            clock.__exit__(None, None, None)
    print(f"{len(measured)} + {len(measured_alt)} entries measured in "
          f"{time.perf_counter() - t_start:.1f} s on {dev_name}", flush=True)
    fams = fit_family_model(samples)
    print("family fits (launch_s, s_per_byte):", fams)

    table = build_lat_table(cfg, qlist, fams, constant=0.0)
    # measured entries replace the fit; `_True` keys only by a dequant
    # measurement, never the `_False` one
    for key, dt in measured.items():
        table[f"{key}_False"] = dt
    for key, dt in measured_alt.items():
        table[f"{key}_True"] = dt
    if args.constant is not None:
        constant = args.constant
        origin = "given (--constant)"
    else:
        step_s, qd, mi = step_seconds(cfg, device, args.impl)
        projs = qdict_latency(table, qd, mi, cfg.num_layers)
        constant = step_s - projs
        origin = (f"215.0thp_cc captured step {step_s * 1e3:.4f} ms a step "
                  f"(CUDA events, {STEP_TOKENS} replays) minus its "
                  f"projections' {projs * 1e3:.4f} ms in this table")
        if constant <= 0:
            raise RuntimeError(f"constant {constant}: {origin}")
    print(f"constant {constant * 1e3:.4f} ms: {origin}", flush=True)
    table["constant"] = constant
    table["__source__"] = "measured" if args.full else "measured-sample-fit"
    table["__impl__"] = args.impl
    table["__nodename__"] = args.nodename
    table["__device__"] = dev_name
    table["__sm_mhz__"] = clock.mhz if clock else None
    table["__constant__"] = origin
    out = (args.out or
           f"assets/{model_key}_latency_coeffs_{args.nodename}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"saved {len(table)} coefficients to {out}")
    return table


if __name__ == "__main__":
    main()
