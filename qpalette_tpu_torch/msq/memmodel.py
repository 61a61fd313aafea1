"""Analytic memory model: bytes of a quantized projection and average
bits per weight of a qdict.

Counterpart of ``qpalette_tpu/msq/memmodel.py`` (bytes per layer including
LUT overhead, plus 1 bit per input column for the SU sign vectors of the
four rotation groups).
"""

from __future__ import annotations

from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv
from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
from qpalette_tpu_torch.runtime.loader import LAYER_KEYS, proj_shape

SU_KEYS = ["self_attn.q_proj", "self_attn.o_proj", "mlp.up_proj",
           "mlp.down_proj"]  # one SU per rotation group


def layer_shape(cfg: LlamaConfig, key: str):
    """(out_features, in_features) of a projection."""
    return proj_shape(cfg, key)


def layer_mem_bytes(cfg: LlamaConfig, key: str, quantizer_str: str) -> float:
    m, n = layer_shape(cfg, key)
    if quantizer_str == "default":
        return m * n * 2.0  # bf16
    s = parse_quantizer_str(quantizer_str)
    if s.family in ("ldlq", "sq", "vq2"):
        return m * n * s.bits / s.vec / 8 + (1 << s.bits) * s.vec * 2
    if s.family in ("tcq1", "tcq1x2"):
        return m * n * s.KV[0] / 8
    if s.family in ("tcq2", "tcq2s"):
        return m * n * s.KV[0] / 2 / 8
    if s.family == "tcq":
        return (m * n * s.KV[0] / 2 / 8
                + (1 << tlut_bits_for_kv(s.KV[0])) * 2 * 2)
    if s.family in ("tcomb", "comb"):
        return (m * n * (s.KV[0] + s.KV[1]) / 4 / 8
                + (1 << tlut_bits_for_kv(max(s.KV))) * 2 * 2)
    raise ValueError(s.family)


def constant_mem_bytes(cfg: LlamaConfig) -> float:
    """SU sign bits a layer: one bit an input column of each rotation
    group."""
    return sum(layer_shape(cfg, k)[1] / 8 for k in SU_KEYS)


def calc_avg_bits(cfg: LlamaConfig, qdict, num_layers=None) -> float:
    nl = num_layers or cfg.num_layers
    total = 0.0
    default = 0.0
    for i in range(nl):
        for key in LAYER_KEYS:
            v = qdict[f"{i}_{key}"] if not isinstance(qdict, str) else qdict
            if isinstance(v, (tuple, list)):
                v = v[0]
            total += layer_mem_bytes(cfg, key, v)
            default += layer_mem_bytes(cfg, key, "default")
            if key in SU_KEYS:
                total += layer_shape(cfg, key)[1] / 8
    return total / default * 16
