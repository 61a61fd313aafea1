"""The 4-bit head in the program: ``params["lm_head_q4"]`` and
``["lm_head_su"]`` hold the draws of ``reference/heads/q4.py``, and the
spec's ``lm_head_spec`` runs them through K1 in mode sum2 at a8, as the
program's own 4-bit head does."""

import dataclasses

from qpbench import files


def install(spec, params, config, draws):
    from qpalette_tpu_torch.runtime.qlinear import LinearSpec
    ref = files.load("reference/heads", "q4", config["root"])
    sch, padded, h = ref.shape(config)
    if sch["family"] != "tcq2s":
        raise NotImplementedError(f"a 4-bit {sch['family']} head")
    w = ref.weights(config, draws)
    params["lm_head_q4"] = {"trellis": w["words"], "wscale": w["wscale"]}
    params["lm_head_su"] = w["su"]
    return dataclasses.replace(spec, lm_head_spec=LinearSpec(
        "tcq2", h, padded, KV=(sch["kv"],), mode="sum2", impl="a8"))
