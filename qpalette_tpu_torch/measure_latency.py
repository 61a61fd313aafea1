"""bs=1 decode throughput of the port (counterpart of measure_latency.py).

  python -m qpalette_tpu_torch.measure_latency --dummy
  python -m qpalette_tpu_torch.measure_latency --dummy --impl exact \\
      --num_hidden_layers 4 --max_new_tokens 64

The 3.25-bit memory-constrained flagship (tcq 6/8/10 and tcomb 8/9,
unmerged, bf16 lm_head):

  python -m qpalette_tpu_torch.measure_latency --dummy --impl exact \
      --qdict_path msq_results/3_8b/mem_constrained/default/3.25bit.json \
      --merge_info_path "" --lm_head_bits 16

One scheme for every projection (unmerged unless --merge_info_path is
given; merges take tcq1 / tcq2 / vq only):

  python -m qpalette_tpu_torch.measure_latency --dummy \
      --quantizer_str tcq2_7_none_0.9

A 3-bit 2-D VQ model with the rotated int8 lm_head (K8 and K10 per decode
forward):

  python -m qpalette_tpu_torch.measure_latency --dummy \
      --quantizer_str ldlq_2_6_none_1.0 --lm_head_bits 8

Without --dummy the projections are read from the artifacts either
package's quantizer wrote under --save_dir (default quant_results, as the
reference's; a missing one is quantized on demand from the dense
weights), and the embed, norms and head from the local Hugging Face
checkpoint of --hf_path (a directory or a cached model name; the config
too for a model the loader does not know), or random ones as the
reference takes them when it finds no checkpoint:

  python -m qpalette_tpu_torch.measure_latency --impl dequant \
      --qdict_path my_qdict.json --merge_info_path "" --lm_head_bits 16

--batch_size B decodes B rows at once (a (B, 1) prompt); the bandwidth
divides the streamed bytes x tokens/s by B, as the reference's.
--save_key KEY also writes the result to
eval_results/latency/<hf_path>/<KEY>.json.

Defaults: Llama-3.1-8B, the latency-constrained 215.0thp_cc solver output
with its merge_info, a 4-bit tcq2s lm_head, impl a8, on cuda:0.  Decode
goes through ``runtime.decode.generate``: the step is captured once in a
CUDA graph and replayed a token.  Reports tokens/s and achieved GB/s
(streamed bytes x tokens/s) on the line of the card's name and power limit
(``nvidia-smi``), and how many projections take each route (kind, impl);
a CPU run (``--device cpu``) is for rehearsal only.
"""

import argparse
import json
import os
import statistics
import subprocess

_QDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "msq_results", "3_8b", "lat_constrained", "v5e",
                     "default_err")


HEADS = {4: "tcq2s_8 (4-bit trellis, sum2 K1)",
         8: "rotated int8 (int8_gemv_a8)", 16: "bf16 (f32 product)"}


def card_label(index: int) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


class SmClock:
    """nvidia-smi's SM clock of a card, sampled every 20 ms while the
    block runs: .mhz (the median; NaN without a sample)."""

    def __init__(self, index: int = 0):
        self.index = index

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", str(self.index), "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        log, _ = self.proc.communicate()
        v = [float(t) for t in log.split() if t.isdigit()]
        self.mhz = statistics.median(v) if v else float("nan")
        return False


def route_census(spec) -> dict:
    """{(kind, impl): projections a forward} of a model spec, the lm_head
    included."""
    out = {}
    projs = [ls for a, m in spec.layers for _, ls in a.projs + m.projs]
    if spec.lm_head_spec is not None:
        projs.append(spec.lm_head_spec)
    for ls in projs:
        key = (ls.kind, ls.impl)
        out[key] = out.get(key, 0) + 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf_path", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--qdict_path",
                    default=os.path.join(_QDIR, "215.0thp_cc.json"))
    ap.add_argument("--merge_info_path", default=None,
                    help="default: the 215 merge_info with the default "
                    "qdict, none with --quantizer_str; '' for none")
    ap.add_argument("--quantizer_str", default=None,
                    help="one scheme for every projection, instead of "
                    "--qdict_path")
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--num_samples", type=int, default=3)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--dummy", action="store_true")
    ap.add_argument("--save_dir", default="quant_results",
                    help="where the artifacts are read without --dummy")
    ap.add_argument("--impl", default="a8",
                    choices=["exact", "a8", "dequant"])
    ap.add_argument("--num_hidden_layers", type=int, default=-1)
    ap.add_argument("--lm_head_bits", type=int, default=4,
                    choices=[4, 8, 16],
                    help="4: tcq2s_8 trellis head, 8: rotated per-row int8 "
                    "head, 16: bf16 head")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save_key", default="",
                    help="write the result to eval_results/latency/"
                    "<hf_path>/<save_key>.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from qpalette_tpu_torch.models.hf_weights import (config_from_hf,
                                                      find_local_checkpoint,
                                                      load_dense_params)
    from qpalette_tpu_torch.msq.memmodel import calc_avg_bits
    from qpalette_tpu_torch.runtime.decode import generate, model_bytes
    from qpalette_tpu_torch.runtime.loader import (CONFIGS, MODEL_KEYS,
                                                   build_quantized_model)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        dev_name = card_label(device.index or 0)
    else:
        dev_name = "cpu (rehearsal, not a device measurement)"
    model_key = MODEL_KEYS.get(args.hf_path, "custom")
    known = args.hf_path in MODEL_KEYS
    ckpt = (find_local_checkpoint(args.hf_path)
            if not (args.dummy and known) else None)
    if known:
        cfg = CONFIGS[model_key]()
    elif ckpt is not None:  # the config of a model the loader does not know
        cfg = config_from_hf(ckpt)
    else:
        raise SystemExit(f"{args.hf_path}: not a model the loader knows, "
                         f"and no local checkpoint of it")
    nl = (args.num_hidden_layers if args.num_hidden_layers > 0
          else cfg.num_layers)
    dense = None
    if ckpt is not None and not args.dummy:
        print(f"loading dense weights from {ckpt} ({nl} layers)", flush=True)
        dense = load_dense_params(ckpt, cfg, num_layers=nl)
    if args.quantizer_str is not None:
        qdict = args.quantizer_str
    else:
        with open(args.qdict_path) as f:
            qdict = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in json.load(f).items()}
    mi_path = args.merge_info_path
    if mi_path is None and args.quantizer_str is None:
        mi_path = os.path.join(_QDIR, "215.0thp_cc_merge_info.json")
    merge_info = None
    if mi_path:
        with open(mi_path) as f:
            merge_info = json.load(f)

    spec, params = build_quantized_model(
        cfg, qdict, merge_info=merge_info, dummy=args.dummy, impl=args.impl,
        num_layers=nl, lm_head_bits=args.lm_head_bits, seed=args.seed,
        device=device, model_key=model_key, save_dir=args.save_dir,
        dense_params=dense)
    mbytes = model_bytes(params)
    streamed = mbytes - model_bytes(params["embed"])
    bits = calc_avg_bits(cfg, qdict, num_layers=nl)
    head = HEADS[args.lm_head_bits]
    routes = route_census(spec)
    print(f"device: {dev_name}")
    print("projections by route (kind, impl): " + ", ".join(
        f"{k}/{im} {n}" for (k, im), n in sorted(routes.items())))
    print(f"model size: {mbytes / 1e9:.3f} GB, streamed per token: "
          f"{streamed / 1e9:.3f} GB, {bits:.2f} bits/weight avg, "
          f"{nl} layers, impl {args.impl}, lm_head {head}")

    B = args.batch_size
    prompt = np.ones((B, 1), dtype=np.int64)
    all_tps = []
    for i in range(args.num_samples):
        _, stats = generate(spec, params, prompt,
                            max_new_tokens=args.max_new_tokens,
                            max_seq=2 * args.max_new_tokens, seed=args.seed)
        tps = stats["tokens_per_sec"]
        all_tps.append(tps)
        print(f"sample {i}: {tps:.2f} tokens/sec, "
              f"{streamed * tps / B / 1e9:.1f} GB/s streamed on {dev_name}",
              flush=True)
    avg = float(np.mean(all_tps))
    print(f"Average tokens/sec: {avg:.2f} on {dev_name}")
    result = {"average_tokens_per_sec": avg, "device": dev_name,
              "model_size_gb": mbytes / 1e9,
              "streamed_gb_per_token": streamed / 1e9, "avg_bits": bits,
              "impl": args.impl, "num_layers": nl, "batch_size": B,
              "quantizer_str": args.quantizer_str,
              "qdict_path": (None if args.quantizer_str is not None
                             else args.qdict_path),
              "weights": "dummy" if args.dummy else args.save_dir,
              "dense_params": None if dense is None else ckpt,
              "routes": {f"{k}/{im}": n
                         for (k, im), n in sorted(routes.items())},
              "lm_head_bits": args.lm_head_bits, "lm_head": head}
    print(json.dumps(result))
    if args.save_key:
        out = os.path.join("eval_results", "latency", args.hf_path,
                           f"{args.save_key}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"saved {out}")
    return result


if __name__ == "__main__":
    main()
