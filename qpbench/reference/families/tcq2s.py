"""The arithmetic trellis in mode sum2, ``tcq2s_<KV>_...``: V = 2,
paired-K-major tiles (state 16*t + row holds (row, 2t), (row, 2t+1)); h =
u*34038481 + 76625530 mod 2^32, weights (b0 + b1, b2 + b3) of its signed
bytes over 147.800537109375."""

from __future__ import annotations

import torch

from qpbench.reference import decoders

SUM2_A, SUM2_B = 34038481, 76625530
SCALE = 147.800537109375
X_BYTES = 4  # the GEMV reads x in float32 (a8 quantizes it in the kernel)
PROGRAM_WORDS = "trellis"  # the program\'s parameter that holds the words


def parse(qstr: str) -> dict:
    return {"kv": int(qstr.split("_")[1])}


def word_shape(scheme: dict, m: int, k: int) -> tuple:
    return decoders.trellis_words(scheme["kv"], 2, m, k)


def state_values(device) -> torch.Tensor:
    """(2^16, 2) float32 values of every state."""
    u = torch.arange(1 << 16, dtype=torch.int64, device=device)
    h = (u * SUM2_A + SUM2_B) & decoders.M32
    b = decoders.signed_bytes(h)
    pairs = torch.stack([b[:, 0] + b[:, 1], b[:, 2] + b[:, 3]], dim=-1)
    return (pairs.to(torch.float64) / SCALE).to(torch.float32)


def decode(scheme: dict, words: torch.Tensor, m: int, k: int) -> torch.Tensor:
    states = decoders.unpack_states(words, scheme["kv"])  # (T, 128)
    vals = state_values(words.device)[states]  # (T, 128, 2)
    tiles = vals.reshape(-1, 8, 16, 2).permute(0, 2, 1, 3)
    return decoders.tiles_to_matrix(tiles.reshape(-1, 16, 16), m, k)
