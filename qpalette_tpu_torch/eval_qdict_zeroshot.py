"""Zero-shot accuracy of a quantized model (counterpart of the root
eval_qdict_zeroshot.py).

  python -m qpalette_tpu_torch.eval_qdict_zeroshot \\
      --qdict_path msq_results/3_8b/mem_constrained/default/3.25bit.json \\
      --tasks arc_easy,piqa --limit 500

arc_easy, arc_challenge, piqa, winogrande and hellaswag, scored by the
loglikelihood harness (runtime/zeroshot.py): acc and acc_norm.  The model
is built as eval_qdict.py builds it (artifacts from --save_dir, the dense
rest from a local checkpoint); the tokenizer and the tasks come from the
local Hugging Face cache.  With --qdict_path the results are written to
<qdict>_zeroshot.json.  Runs on cuda:0 unless --device says otherwise;
without a CUDA device it exits.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="meta-llama/Llama-3.1-8B")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qdict_path", default=None)
    ap.add_argument("--quantizer_str", default=None)
    ap.add_argument("--tasks", default="arc_easy,arc_challenge,piqa,"
                                       "winogrande,hellaswag")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--save_dir", default="quant_results")
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--num_layers", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from qpalette_tpu_torch.eval_qdict import (load_quantized, open_device,
                                               read_qdict)
    from qpalette_tpu_torch.runtime.zeroshot import (eval_multiple_choice,
                                                     task_examples)

    device, dev_name = open_device(args.device)
    qdict = args.quantizer_str
    if qdict is None:
        qdict = read_qdict(args.qdict_path)
    spec, params = load_quantized(args, qdict, None, device)

    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.model)
    results = {}
    for task in args.tasks.split(","):
        examples = task_examples(task, limit=args.limit)
        r = eval_multiple_choice(spec, params, tokenizer, examples)
        results[task] = r
        print(f"{task}: acc={r['acc']:.4f} acc_norm={r['acc_norm']:.4f} "
              f"(n={r['n']}) on {dev_name}", flush=True)

    if args.qdict_path:
        out = args.qdict_path.replace(".json", "_zeroshot.json")
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
