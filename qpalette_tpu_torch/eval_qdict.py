"""Perplexity of a quantized model (counterpart of the root eval_qdict.py).

  python -m qpalette_tpu_torch.eval_qdict --model meta-llama/Llama-3.1-8B \\
      --qdict_path msq_results/3_8b/mem_constrained/default/3.25bit.json
  python -m qpalette_tpu_torch.eval_qdict --quantizer_str tcq_8_none_0.9

Builds the model from the artifacts under --save_dir (either package's
quantizer writes them; a missing or stale one is quantized on demand from
the checkpoint's weights, with the calibration Hessians of --hess_path
for the ``_hess_`` schemes) and the embed, norms and head of a local
Hugging Face checkpoint (--model: a directory or a cached model name), then evaluates
the ctx-size perplexity of a dataset from the local cache (WikiText-2 by
default).  --impl takes the reference's names: xla (the port's dequant
route), pallas (exact), pallas_a8 (a8).  The result is cached beside the
qdict as <qdict>_result.json / .txt (msq_results/<model key>/<scheme>_
result with --quantizer_str); --re_eval evaluates again.  Runs on cuda:0
unless --device says otherwise; without a CUDA device it exits.
"""

import argparse
import json
import os


def read_qdict(path: str) -> dict:
    """A solver's qdict file: {key: qstr | (qstr, impl choice)}."""
    with open(path) as f:
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in json.load(f).items()}


def open_device(name: str):
    """(torch.device, its label): the card's name and power limit, or a
    CPU run named as such.  No CUDA device for a cuda name: exit."""
    import torch

    from qpalette_tpu_torch.measure_latency import card_label

    device = torch.device(name)
    if device.type != "cuda":
        return device, f"{device} (not a device measurement)"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (--device cpu runs the plain "
                         "PyTorch versions)")
    return device, card_label(device.index or 0)


def load_quantized(args, qdict, merge_info, device):
    """(spec, params) of --model's checkpoint with qdict's artifacts from
    --save_dir at --impl, on device (--hess_path's Hessians, where the
    args have one, for artifacts quantized on demand)."""
    from qpalette_tpu_torch.models.hf_weights import (config_from_hf,
                                                      find_local_checkpoint,
                                                      load_dense_params)
    from qpalette_tpu_torch.runtime.loader import (IMPL_NAMES, MODEL_KEYS,
                                                   build_quantized_model)

    ckpt = find_local_checkpoint(args.model)
    if ckpt is None:
        raise SystemExit(
            f"no local checkpoint for {args.model}; quantized eval needs "
            f"real weights (measure_latency --dummy runs without them)")
    cfg = config_from_hf(ckpt)
    nl = args.num_layers if args.num_layers > 0 else cfg.num_layers
    print(f"loading dense weights from {ckpt} ({nl} layers)", flush=True)
    dense = load_dense_params(ckpt, cfg, num_layers=nl)
    hess = None
    if getattr(args, "hess_path", None):
        import numpy as np
        hess = dict(np.load(args.hess_path))
    return build_quantized_model(
        cfg, qdict, merge_info=merge_info, dummy=False,
        impl=IMPL_NAMES[args.impl], num_layers=nl, seed=args.seed,
        device=device, model_key=MODEL_KEYS.get(args.model, "custom"),
        save_dir=args.save_dir, dense_params=dense, hess=hess)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qdict_path", default=None)
    ap.add_argument("--merge_info_path", default=None)
    ap.add_argument("--quantizer_str", default=None)
    ap.add_argument("--ctx_size", type=int, default=8192)
    ap.add_argument("--save_dir", default="quant_results")
    ap.add_argument("--impl", default="xla",
                    choices=["xla", "pallas", "pallas_a8"])
    ap.add_argument("--num_layers", type=int, default=-1)
    ap.add_argument("--re_eval", action="store_true")
    ap.add_argument("--hess_path", default=None,
                    help="npz of {i}_{group}: H from collect_hessians")
    ap.add_argument("--dataset", default="wikitext2",
                    choices=["wikitext2", "ptb", "c4"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import time

    from qpalette_tpu_torch.runtime.evaluate import DATASET_LOADERS, eval_ppl
    from qpalette_tpu_torch.runtime.loader import MODEL_KEYS

    device, dev_name = open_device(args.device)
    model_key = MODEL_KEYS.get(args.model, "custom")
    if args.quantizer_str is not None:
        qdict = args.quantizer_str
        result_path = f"msq_results/{model_key}/{args.quantizer_str}_result"
    else:
        qdict = read_qdict(args.qdict_path)
        result_path = args.qdict_path.replace(".json", "_result")
    if os.path.exists(result_path + ".json") and not args.re_eval:
        with open(result_path + ".json") as f:
            print("cached:", json.load(f))
        return

    merge_info = None
    if args.merge_info_path:
        with open(args.merge_info_path) as f:
            merge_info = json.load(f)
    spec, params = load_quantized(args, qdict, merge_info, device)

    toks = DATASET_LOADERS[args.dataset](args.model)
    t0 = time.perf_counter()
    ppl, avg_loss = eval_ppl(spec, params, toks, ctx_size=args.ctx_size)
    dt = time.perf_counter() - t0
    n_tok = (len(toks) // args.ctx_size) * args.ctx_size
    print(f"ppl: {ppl}, avg_loss: {avg_loss}")
    print(f"{n_tok} tokens in {dt:.1f} s ({n_tok / max(dt, 1e-9):.0f} "
          f"tokens/s) on {dev_name}")

    os.makedirs(os.path.dirname(result_path) or ".", exist_ok=True)
    with open(result_path + ".json", "w") as f:
        json.dump({args.dataset: {"ppl": ppl, "avg_loss": avg_loss}}, f,
                  indent=1)
    with open(result_path + ".txt", "w") as f:
        f.write(f"{args.dataset}, {ppl}, {avg_loss}\n")


if __name__ == "__main__":
    main()
