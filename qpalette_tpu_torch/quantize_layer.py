"""Quantize a model's projections into per-layer artifacts (counterpart
of the root quantize_layer.py).

  python -m qpalette_tpu_torch.quantize_layer --model meta-llama/Llama-3.1-8B \\
      --quantizer_str tcomb_6_7_0.5_none_0.9
  python -m qpalette_tpu_torch.quantize_layer --model DIR \\
      --qdict_path msq_results/3_8b/lat_constrained/h100/default_err/108.5thp_cc.json

Reads the dense weights of a local Hugging Face checkpoint (--model: a
directory or a cached model name) and writes each projection's artifact
to quant_results/{model_key}/left_only_seed{seed}_cache/{quantizer_str}/
{i}_{layer_key}.npz (--save_dir), skipping one that exists (resume at
layer granularity).  Each is the loader's ``projection_artifact``, so the
loader reads these artifacts and quantizes the same ones on demand.
``_hess_`` schemes take --hess_path (an npz of {i}_{group}: H from
collect_hessians).  Runs on cuda:0 unless --device says otherwise;
without a CUDA device it exits.
"""

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--quantizer_str", default=None)
    ap.add_argument("--qdict_path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save_dir", default="quant_results")
    ap.add_argument("--hess_path", default=None)
    ap.add_argument("--num_layers", type=int, default=-1)
    ap.add_argument("--layers", default=None,
                    help="comma list of layer indices (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import time

    import numpy as np

    from qpalette_tpu_torch.eval_qdict import open_device
    from qpalette_tpu_torch.models.hf_weights import (config_from_hf,
                                                      find_local_checkpoint,
                                                      load_dense_params)
    from qpalette_tpu_torch.quant.incoherent import artifact_path
    from qpalette_tpu_torch.runtime.loader import (LAYER_KEYS, MODEL_KEYS,
                                                   projection_artifact)

    device, dev_name = open_device(args.device)
    model_key = MODEL_KEYS.get(args.model, "custom")
    ckpt = find_local_checkpoint(args.model)
    if ckpt is None:
        raise SystemExit(f"no local checkpoint for {args.model}")
    cfg = config_from_hf(ckpt)
    nl = args.num_layers if args.num_layers > 0 else cfg.num_layers
    dense = load_dense_params(ckpt, cfg, num_layers=nl)

    if args.qdict_path:
        with open(args.qdict_path) as f:
            qdict = json.load(f)
    else:
        if not args.quantizer_str:
            raise SystemExit("give --quantizer_str or --qdict_path")
        qdict = {f"{i}_{k}": args.quantizer_str
                 for i in range(nl) for k in LAYER_KEYS}
    hess = dict(np.load(args.hess_path)) if args.hess_path else None

    layer_ids = ([int(x) for x in args.layers.split(",")]
                 if args.layers else range(nl))
    for i in layer_ids:
        for key in LAYER_KEYS:
            v = qdict[f"{i}_{key}"]
            qstr = v[0] if isinstance(v, (list, tuple)) else v
            path = artifact_path(args.save_dir, model_key, args.seed, qstr,
                                 i, key)
            if os.path.exists(path):
                print(f"skip {i}_{key} ({qstr}): exists")
                continue
            print(f"quantizing {i}_{key} with {qstr}", flush=True)
            t0 = time.perf_counter()
            art = projection_artifact(cfg, i, key, qstr, args.save_dir,
                                      model_key, args.seed, dense, hess,
                                      device)
            print(f"  err={art['meta']['err']:.5f} "
                  f"({time.perf_counter() - t0:.2f} s on {dev_name}) "
                  f"-> {path}", flush=True)


if __name__ == "__main__":
    main()
