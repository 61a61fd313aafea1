"""The system under test: ``qpalette_tpu_torch`` built at a configuration
from the benchmark's draws.

The program's loader assembles the model (its specs, its kernel routes,
its parameter tree) with dummy words; every packed word array, row scale
and sign vector in that tree is then replaced by the benchmark's draw of
the same name and shape, and the embedding and the head are installed
from the draws, so that the program and the reference read the same
inputs.  The loader is asked for a 16-row vocabulary and the real one is
set afterwards: its own embedding and head are numpy draws on the host,
which the benchmark does not use.  The head is installed by the
configuration's head format, ``heads/<head>.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from qpbench import files
from qpbench.reference import decoders
from qpbench.reference.llama import groups

LAYER_KEYS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
              "v": "self_attn.v_proj", "o": "self_attn.o_proj",
              "gate": "mlp.gate_proj", "up": "mlp.up_proj",
              "down": "mlp.down_proj"}


def llama_config(model: dict):
    from qpalette_tpu_torch.models.llama import LlamaConfig
    if model.get("tie_word_embeddings"):
        raise NotImplementedError("tied embeddings")
    return LlamaConfig(vocab_size=model["vocab_size"],
                       hidden_size=model["hidden_size"],
                       intermediate_size=model["intermediate_size"],
                       num_layers=model["num_hidden_layers"],
                       num_heads=model["num_attention_heads"],
                       num_kv_heads=model["num_key_value_heads"],
                       head_dim=model["head_dim"],
                       rope_theta=float(model["rope_theta"]),
                       rms_eps=float(model["rms_norm_eps"]))


def build(config: dict, draws, device):
    """(spec, params) of the program at ``config``, holding ``draws``."""
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    model, quant = config["model"], config["quantization"]
    cfg = llama_config(model)
    layers = model["num_hidden_layers"]
    qdict = {f"{i}_{LAYER_KEYS[p]}": q for i in range(layers)
             for p, q in quant["projections"].items()}
    merge_info = [[f"merge_{m}" for m in quant["merges"]]] * layers
    spec, params = build_quantized_model(
        dataclasses.replace(cfg, vocab_size=16), qdict, merge_info,
        dummy=True, impl=quant["impl"], lm_head_bits=16, device=device)
    spec = dataclasses.replace(spec, config=cfg)
    plan = groups(config)
    for i, lp in enumerate(params["layers"]):
        aspec, mspec = spec.layers[i]
        names = [nm for nm, _ in aspec.projs + mspec.projs]
        if names != [g[0] for g in plan]:
            raise ValueError(f"layer {i}: the program's groups {names}, "
                             f"the configuration's {[g[0] for g in plan]}")
        for name, members, n, scheme, _ in plan:
            m = sum(r for _, r in members)
            p, key = lp[name], scheme["codec"].PROGRAM_WORDS
            if p[key].shape != decoders.word_shape(scheme, m, n):
                raise ValueError(f"layer {i} {name}: words "
                                 f"{tuple(p[key].shape)}")
            p[key], p["wscale"] = draws.group(i, name, scheme, m, n)
        for su in ("su_qkv", "su_o", "su_ug", "su_dp"):
            lp[su] = draws.rotation_signs(i, su).to(lp[su].dtype)
    params["embed"] = draws.embed()
    del params["lm_head"]
    head = files.load("heads", quant["head"], config["root"])
    return head.install(spec, params, config, draws), params


def release(params) -> None:
    """Drop the program's captured steps and pools of params."""
    from qpalette_tpu_torch.runtime.decode import release_captured
    from qpalette_tpu_torch.runtime.serving import release_pools
    release_captured(params)
    release_pools(params)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
