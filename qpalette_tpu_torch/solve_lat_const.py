"""Latency-constrained fusion-aware MSQ solve (counterpart of
solve_lat_const.py).

  python -m qpalette_tpu_torch.fit_latency_coeffs --full --nodename h100
  python -m qpalette_tpu_torch.solve_lat_const --nodename h100 \
      --target_thp 120 --use_cc [--no_fuse] [--mem_bits B]

Reads the latency table assets/{model_key}_latency_coeffs_{nodename}.json
and writes msq_results/{model_key}/{lat_constrained|
lat_constrained_no_fuse}/{nodename}/default_err/{target}thp[_cc].json
(qdict: {f"{layer}_{key}": [quantizer_str, choice]}) and its
_merge_info.json, under the working directory, as the reference's.
--use_cc offers ldlq quantizers the second impl, choice "1": the dequant
route (the table's ``_True`` keys).  Runs on the CPU.
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
    ap.add_argument("--nodename", default="h100")
    ap.add_argument("--no_fuse", action="store_true")
    ap.add_argument("--target_thp", type=float, default=200)
    ap.add_argument("--use_cc", action="store_true")
    ap.add_argument("--mem_bits", type=float, default=None,
                    help="optional additional memory constraint")
    ap.add_argument("--err_size", type=int, default=4096)
    args = ap.parse_args(argv)

    from qpalette_tpu_torch.msq.err_tables import build_err_table
    from qpalette_tpu_torch.msq.solver import (QDICT_LAT,
                                               solve_lat_constrained)
    from qpalette_tpu_torch.runtime.loader import CONFIGS, MODEL_KEYS

    model_key = MODEL_KEYS[args.model]
    cfg = CONFIGS[model_key]()

    lat_path = f"assets/{model_key}_latency_coeffs_{args.nodename}.json"
    if not os.path.exists(lat_path):
        raise SystemExit(
            f"missing {lat_path}: measure it first with "
            f"python -m qpalette_tpu_torch.fit_latency_coeffs --full "
            f"--nodename {args.nodename}")
    with open(lat_path) as f:
        lat_coeffs = json.load(f)

    qlist = list(QDICT_LAT)
    errs = build_err_table(qlist, size=args.err_size)

    err_coeffs = None
    coeff_path = f"assets/{model_key}_err_coeffs.json"
    if os.path.exists(coeff_path):
        with open(coeff_path) as f:
            err_coeffs = {k: v for k, v in json.load(f).items()
                          if not k.startswith("__")}

    sol = solve_lat_constrained(
        cfg, qlist, errs, lat_coeffs, args.target_thp,
        err_coeffs=err_coeffs, mem_target_bits=args.mem_bits,
        no_fuse=args.no_fuse, use_impl_choice=args.use_cc)

    print(f"estimated step latency {sol.est_latency * 1e3:.3f} ms "
          f"({1.0 / sol.est_latency:.1f} tok/s), err {sol.est_err:.4f}")

    sub = "lat_constrained" if not args.no_fuse else "lat_constrained_no_fuse"
    out_dir = (f"msq_results/{model_key}/{sub}/{args.nodename}/"
               f"{args.quantizer_type}_{args.imp_key}")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{args.target_thp}thp{'_cc' if args.use_cc else ''}"
    with open(f"{out_dir}/{tag}.json", "w") as f:
        json.dump({k: list(v) for k, v in sol.qdict.items()}, f, indent=1)
    with open(f"{out_dir}/{tag}_merge_info.json", "w") as f:
        json.dump(sol.merge_info, f, indent=1)
    print(f"saved {out_dir}/{tag}.json (+_merge_info.json)")
    return sol


if __name__ == "__main__":
    main()
