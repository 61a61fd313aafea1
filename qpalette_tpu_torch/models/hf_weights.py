"""Hugging Face checkpoints on local disk -> the loader's dense params.

Counterpart of ``qpalette_tpu/models/hf_weights.py``.  Weights are read
from a checkpoint directory or the local Hugging Face cache's snapshots
(``$HF_HOME``, default ``~/.cache/huggingface``); nothing is downloaded.
``load_dense_params`` returns numpy float32 arrays in the schema of
``runtime.loader.random_dense_params``, which
``build_quantized_model(dense_params=...)`` takes.  ``safetensors`` is
imported when weights are read; shards are read through torch, so bf16
checkpoints load too.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Optional

import numpy as np

from qpalette_tpu_torch.models.llama import LlamaConfig

# (dense_params key, the Hugging Face name after "model.layers.{i}.")
_LAYER_WEIGHTS = (
    ("self_attn.q_proj", "self_attn.q_proj.weight"),
    ("self_attn.k_proj", "self_attn.k_proj.weight"),
    ("self_attn.v_proj", "self_attn.v_proj.weight"),
    ("self_attn.o_proj", "self_attn.o_proj.weight"),
    ("mlp.gate_proj", "mlp.gate_proj.weight"),
    ("mlp.up_proj", "mlp.up_proj.weight"),
    ("mlp.down_proj", "mlp.down_proj.weight"),
    ("ln_attn", "input_layernorm.weight"),
    ("ln_mlp", "post_attention_layernorm.weight"),
)


def find_local_checkpoint(name_or_path: str) -> Optional[str]:
    """A directory as given, else the newest cached snapshot of the model
    that holds ``*.safetensors``; None if there is none."""
    if os.path.isdir(name_or_path):
        return name_or_path
    cache = os.path.expanduser(
        os.environ.get("HF_HOME", "~/.cache/huggingface"))
    pat = os.path.join(cache, "hub",
                       f"models--{name_or_path.replace('/', '--')}",
                       "snapshots", "*")
    for snap in reversed(sorted(glob.glob(pat))):
        if glob.glob(os.path.join(snap, "*.safetensors")):
            return snap
    return None


def config_from_hf(path: str) -> LlamaConfig:
    """The port's LlamaConfig from a checkpoint's config.json."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    return LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim",
                       c["hidden_size"] // c["num_attention_heads"]),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_eps=c.get("rms_norm_eps", 1e-5),
        tie_embeddings=c.get("tie_word_embeddings", False))


def load_dense_params(path: str, cfg: Optional[LlamaConfig] = None,
                      num_layers: Optional[int] = None) -> dict:
    """The first num_layers (default all) decoder layers, embed, final norm
    and lm_head (the embedding when the checkpoint has no lm_head.weight)
    as numpy float32: {"layers": [{proj key or ln_attn / ln_mlp: array}],
    "embed", "lm_head", "ln_f"}."""
    from safetensors import safe_open

    cfg = cfg or config_from_hf(path)
    nl = num_layers or cfg.num_layers
    with contextlib.ExitStack() as stack:
        shard_of = {}
        for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
            # torch, not numpy: numpy has no bfloat16, the dtype of
            # Llama checkpoints
            sf = stack.enter_context(safe_open(f, framework="pt"))
            shard_of.update((k, sf) for k in sf.keys())

        def get(name):
            return shard_of[name].get_tensor(name).float().numpy()

        layers = [{key: get(f"model.layers.{i}.{hf}")
                   for key, hf in _LAYER_WEIGHTS} for i in range(nl)]
        emb = get("model.embed_tokens.weight")
        lm_head = (get("lm_head.weight") if "lm_head.weight" in shard_of
                   else emb)
        return {"layers": layers, "embed": emb, "lm_head": lm_head,
                "ln_f": get("model.norm.weight")}
