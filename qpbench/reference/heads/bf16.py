"""The bf16 head: a (vocab, hidden) bf16 matrix, drawn as ``lm_head``."""

from __future__ import annotations

import torch

from qpbench.reference.precision import round_input, round_weight


def weights(config: dict, draws) -> dict:
    md = config["model"]
    return {"head": draws.normal("lm_head", (md["vocab_size"],
                                             md["hidden_size"]))}


def logits(ref, hid: torch.Tensor) -> torch.Tensor:
    """hidden rows (P, h) float32 -> (P, vocab) float32."""
    head = round_weight(weights(ref.config, ref.weights)["head"].float(),
                        ref.control)
    return round_input(hid, ref.control) @ head.T


def gemv_calls(config: dict) -> list:
    """The head's calls to the port's GEMV kernels a step: none (the
    program multiplies a bf16 head with cuBLAS)."""
    return []


def weight_bytes(config: dict) -> int:
    md = config["model"]
    return 2 * md["vocab_size"] * md["hidden_size"]
