"""The 4-bit head: the trellis of ``quantization.head_qstr`` over the
vocabulary padded to a multiple of 4096 rows, on an input rotated by its
own signs (``lm_head.words``, ``lm_head.wscale``, ``lm_head.su``)."""

from __future__ import annotations

import torch

from qpbench.reference import decoders
from qpbench.reference.precision import round_input, round_weight

PAD = 4096
ROWS = 8192  # head rows decoded at a time


def shape(config: dict) -> tuple:
    """(scheme, padded rows, columns)."""
    md = config["model"]
    sch = decoders.scheme(config["quantization"]["head_qstr"],
                          config["root"])
    return sch, -(-md["vocab_size"] // PAD) * PAD, md["hidden_size"]


def weights(config: dict, draws) -> dict:
    sch, padded, h = shape(config)
    return {"words": draws.words("lm_head.words",
                                 decoders.word_shape(sch, padded, h)),
            "wscale": draws.row_scales("lm_head.wscale", padded),
            "su": draws.signs("lm_head.su", h)}


def logits(ref, hid: torch.Tensor) -> torch.Tensor:
    """hidden rows (P, h) float32 -> (P, vocab) float32."""
    sch, padded, h = shape(ref.config)
    vocab = ref.config["model"]["vocab_size"]
    w = weights(ref.config, ref.weights)
    z = round_input(decoders.rotate(hid, w["su"]), ref.control)
    out = torch.empty((hid.shape[0], vocab), dtype=torch.float32,
                      device=hid.device)
    for r0 in range(0, vocab, ROWS):
        r1 = min(r0 + ROWS, vocab)
        wd = decoders.decode(sch, w["words"], padded, h,
                             rows=slice(r0, -(-r1 // 16) * 16))
        wd = round_weight(wd, ref.control)[:r1 - r0]
        out[:, r0:r1] = (z @ wd.T) * w["wscale"][r0:r1]
    return out


def gemv_calls(config: dict) -> list:
    """[(m, k, word bytes, scheme)]: one GEMV over the padded rows."""
    sch, padded, h = shape(config)
    words = decoders.word_shape(sch, padded, h)
    return [(padded, h, words[0] * words[1] * 4, sch)]


def weight_bytes(config: dict) -> int:
    (m, _, nbytes, _), = gemv_calls(config)
    return nbytes + 4 * m
