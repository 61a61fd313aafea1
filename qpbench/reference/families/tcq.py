"""The LUT trellis, ``tcq_<KV>_...``: V = 2, M-major tiles (state 8*row + t
holds (row, 2t) and (row, 2t+1)).  Its (2^S, 2) table is the committed raw
file ``assets/lut_cache/tcq_tlut_<S>.npy``, S = 9 up to KV 8 and KV + 1
above, expanded by h = u*(u+1) mod 2^32: bits [15-S, 15) index it, bit 15
flips the sign of component 0."""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpbench.reference import decoders

ASSETS = decoders.REPO / "assets" / "lut_cache"
X_BYTES = 2  # the GEMV reads x in bf16
PROGRAM_WORDS = "trellis"  # the program\'s parameter that holds the words


def parse(qstr: str) -> dict:
    return {"kv": int(qstr.split("_")[1])}


def word_shape(scheme: dict, m: int, k: int) -> tuple:
    return decoders.trellis_words(scheme["kv"], 2, m, k)


@functools.lru_cache(maxsize=None)
def _table(s: int) -> np.ndarray:
    return np.load(ASSETS / f"tcq_tlut_{s}.npy").astype(np.float32)


def state_values(kv: int, device) -> torch.Tensor:
    """(2^16, 2) float32 values of every state."""
    s = 9 if kv <= 8 else kv + 1
    table = torch.as_tensor(_table(s), device=device)
    u = torch.arange(1 << 16, dtype=torch.int64, device=device)
    h = (u * (u + 1)) & decoders.M32
    vals = table[(h >> (15 - s)) & ((1 << s) - 1)].clone()
    vals[:, 0] = torch.where(((h >> 15) & 1).bool(), -vals[:, 0], vals[:, 0])
    return vals


def decode(scheme: dict, words: torch.Tensor, m: int, k: int) -> torch.Tensor:
    states = decoders.unpack_states(words, scheme["kv"])  # (T, 128)
    vals = state_values(scheme["kv"], words.device)[states]
    return decoders.tiles_to_matrix(vals.reshape(-1, 16, 16), m, k)
