"""Collect calibration Hessians and per-projection sensitivity
coefficients (counterpart of the root collect_hessians.py).

  python -m qpalette_tpu_torch.collect_hessians --model meta-llama/Llama-3.1-8B \\
      --dataset wikitext2 --nsamples 64 --ctx 2048

Runs the dense bf16 model of a local Hugging Face checkpoint over
--nsamples windows of --ctx tokens of a dataset from the local cache
(WikiText-2's train split by default) and writes, under the working
directory:

  hessians/{model_key}_hessians.npz       ({i}_{qkv|o|up|down}: H)
  assets/{model_key}_err_coeffs.json      (per-projection sensitivity)

Runs on cuda:0 unless --device says otherwise; without a CUDA device it
exits.
"""

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--dataset", default="wikitext2",
                    choices=["wikitext2", "ptb", "c4"])
    ap.add_argument("--nsamples", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--num_layers", type=int, default=-1)
    ap.add_argument("--out_dir", default="hessians")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from qpalette_tpu_torch.eval_qdict import open_device
    from qpalette_tpu_torch.models.hf_weights import (config_from_hf,
                                                      find_local_checkpoint,
                                                      load_dense_params)
    from qpalette_tpu_torch.quant.hessian import (collect_hessians,
                                                  err_coeffs_from_hessians)
    from qpalette_tpu_torch.runtime.evaluate import DATASET_LOADERS
    from qpalette_tpu_torch.runtime.loader import (MODEL_KEYS,
                                                   build_dense_model)

    device, dev_name = open_device(args.device)
    model_key = MODEL_KEYS.get(args.model, "custom")
    ckpt = find_local_checkpoint(args.model)
    if ckpt is None:
        raise SystemExit(f"no local checkpoint for {args.model}")
    cfg = config_from_hf(ckpt)
    nl = args.num_layers if args.num_layers > 0 else cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=nl)
    dense = load_dense_params(ckpt, cfg, num_layers=nl)
    spec, params = build_dense_model(cfg, dense, device=device)

    loader = DATASET_LOADERS[args.dataset]
    toks = (loader(args.model, split="train") if args.dataset == "wikitext2"
            else loader(args.model))
    batches = []
    for i in range(args.nsamples // args.batch):
        s = i * args.batch * args.ctx
        e = s + args.batch * args.ctx
        if e > len(toks):
            break
        batches.append(np.asarray(toks[s:e]).reshape(args.batch, args.ctx))
    print(f"collecting over {len(batches)} batches of "
          f"({args.batch}, {args.ctx}) on {dev_name}")

    H = collect_hessians(spec, params, batches)
    os.makedirs(args.out_dir, exist_ok=True)
    hp = os.path.join(args.out_dir, f"{model_key}_hessians.npz")
    np.savez(hp, **H)
    print(f"saved {hp}")

    coeffs = err_coeffs_from_hessians(H, dense, nl)
    os.makedirs("assets", exist_ok=True)
    cp = f"assets/{model_key}_err_coeffs.json"
    with open(cp, "w") as f:
        json.dump(coeffs, f, indent=1)
    print(f"saved {cp}")


if __name__ == "__main__":
    main()
