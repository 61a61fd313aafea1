"""Memory-constrained MSQ solve (counterpart of solve_mem_const.py).

  python -m qpalette_tpu_torch.solve_mem_const \
      --model meta-llama/Llama-3.1-8B --target_bitwidth 3.25

Writes msq_results/{model_key}/mem_constrained/default/{bits}bit.json
under the working directory, as the reference's: {f"{layer}_{key}":
quantizer_str}.  Proxy errors come from assets/quant_err.json, the
per-layer sensitivity from assets/{model_key}_err_coeffs.json when that
file is there (--err_coeffs).  Runs on the CPU.
"""

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--quantizer_type", default="default",
                    choices=["default"])
    ap.add_argument("--imp_key", default="err", choices=["err"])
    ap.add_argument("--target_bitwidth", type=float, default=3.25)
    ap.add_argument("--err_size", type=int, default=4096,
                    help="proxy-error matrix size (4096 = reference)")
    ap.add_argument("--err_coeffs", default="auto",
                    help="per-layer sensitivity JSON "
                    "(assets/{model}_err_coeffs.json schema; 'auto' = that "
                    "path if present, 'none' = uniform sensitivity)")
    args = ap.parse_args(argv)

    from qpalette_tpu_torch.msq.err_tables import build_err_table
    from qpalette_tpu_torch.msq.memmodel import calc_avg_bits
    from qpalette_tpu_torch.msq.solver import QDICT_MEM, solve_mem_constrained
    from qpalette_tpu_torch.runtime.loader import CONFIGS, MODEL_KEYS

    model_key = MODEL_KEYS[args.model]
    cfg = CONFIGS[model_key]()

    qlist = list(QDICT_MEM)
    print(f"reading the proxy-error table ({len(qlist)} quantizers)...")
    errs = build_err_table(qlist, size=args.err_size)

    err_coeffs = None
    coeff_path = (f"assets/{model_key}_err_coeffs.json"
                  if args.err_coeffs == "auto" else args.err_coeffs)
    if args.err_coeffs != "none" and os.path.exists(coeff_path):
        with open(coeff_path) as f:
            err_coeffs = {k: v for k, v in json.load(f).items()
                          if not k.startswith("__")}
        print(f"loaded per-layer sensitivity from {coeff_path}")

    qdict = solve_mem_constrained(cfg, qlist, errs, args.target_bitwidth,
                                  err_coeffs=err_coeffs)
    bits = calc_avg_bits(cfg, qdict)
    print(f"avg_bits: {round(bits, 3)} / {args.target_bitwidth}bit")

    out_dir = f"msq_results/{model_key}/mem_constrained/{args.quantizer_type}"
    os.makedirs(out_dir, exist_ok=True)
    out = f"{out_dir}/{args.target_bitwidth}bit.json"
    with open(out, "w") as f:
        json.dump(qdict, f, indent=1)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
