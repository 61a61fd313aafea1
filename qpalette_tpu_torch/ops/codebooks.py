"""Trellis decoders: arithmetic (gather-free) and LUT (quantlut_sym).

Counterpart of ``qpalette_tpu/ops/codebooks.py`` (the MAD constants,
``decode_sum2``, ``trellis_lut_arith("sum2")``, ``tlut_bits_for_kv``,
``trellis_tlut`` from the committed tables and ``trellis_lut``).  The 32-bit modular
arithmetic runs in int64 and is masked with ``& 0xFFFFFFFF``: torch's
uint32 support is partial.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

L = 16

MAD1_A, MAD1_B = 34038481, 76625530
MAD_SCALE = 147.800537109375

_M32 = 0xFFFFFFFF


def sum2_scramble(u: torch.Tensor) -> torch.Tensor:
    """16-bit states (any int dtype) -> h = u*A + B mod 2^32 as int64."""
    return (u.to(torch.int64) * MAD1_A + MAD1_B) & _M32


def signed_bytes(h: torch.Tensor) -> torch.Tensor:
    """int64 h (< 2^32) -> (..., 4) int64 signed bytes, lowest byte first."""
    b = torch.stack([(h >> (8 * i)) & 255 for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b)


def sum2_pairs(u: torch.Tensor) -> torch.Tensor:
    """States -> (..., 2) int64 unscaled weight pairs (sb0+sb1, sb2+sb3)."""
    sb = signed_bytes(sum2_scramble(u))
    return torch.stack([sb[..., 0] + sb[..., 1], sb[..., 2] + sb[..., 3]],
                       dim=-1)


def decode_sum2(x: torch.Tensor) -> torch.Tensor:
    """V=2 sum2 decoder ('tcq2s'): ONE LCG scramble h = u*A + B per weight
    pair; weight 0 = signed bytes b0+b1, weight 1 = b2+b3, both / MAD_SCALE.
    Returns (len(x), 2) float32."""
    u = torch.as_tensor(x).to(torch.int64) & _M32
    out = sum2_pairs(u).to(torch.float64) / MAD_SCALE
    return out.to(torch.float32)


@functools.lru_cache(maxsize=None)
def trellis_lut_arith(mode: str) -> torch.Tensor:
    """State -> value table (2^16, 2) float32 for the arithmetic decode
    modes.  Only ``sum2`` is ported."""
    if mode != "sum2":
        raise NotImplementedError(f"decode mode {mode!r} is not ported")
    return decode_sum2(torch.arange(1 << L, dtype=torch.int64))


# ---------------------------------------------------------------------------
# LUT trellis (quantlut_sym): a 2^S x 2 table expanded to 2^16 states
# ---------------------------------------------------------------------------

_ASSET_DIR = Path(__file__).resolve().parents[2] / "assets" / "lut_cache"


def tlut_bits_for_kv(kv: int) -> int:
    """Table bits S of a KV: KV <= 8 -> 9, else KV + 1."""
    return 9 if kv <= 8 else kv + 1


@functools.lru_cache(maxsize=None)
def trellis_tlut(tlut_bits: int) -> np.ndarray:
    """The committed (2^S, 2) float32 k-means table
    ``assets/lut_cache/tcq_tlut_{S}.npy``.  The port runs no k-means:
    a missing table raises."""
    path = _ASSET_DIR / f"tcq_tlut_{tlut_bits}.npy"
    if not path.exists():
        raise FileNotFoundError(f"{path}: the trellis table for S="
                                f"{tlut_bits} is not committed")
    tlut = np.load(path).astype(np.float32)
    if tlut.shape != (1 << tlut_bits, 2):
        raise ValueError(f"{path}: shape {tlut.shape}")
    tlut.setflags(write=False)
    return tlut


def expand_tlut(tlut: torch.Tensor) -> torch.Tensor:
    """(2^S, 2) table -> (2^16, 2) state values in tlut's dtype (the
    quantlut_sym expansion): h = u*(u+1) mod 2^32 for state u, bits
    [15-S, 15) of h index the table, bit 15 flips the sign of
    component 0."""
    S = tlut.shape[0].bit_length() - 1
    u = torch.arange(1 << L, dtype=torch.int64, device=tlut.device)
    h = (u * (u + 1)) & _M32
    lut = tlut[(h >> (15 - S)) & ((1 << S) - 1)].clone()
    flip = ((h >> 15) & 1).bool()
    lut[:, 0] = torch.where(flip, -lut[:, 0], lut[:, 0])
    return lut


@functools.lru_cache(maxsize=None)
def trellis_lut(tlut_bits: int) -> torch.Tensor:
    """The full (2^16, 2) float32 quantlut_sym table of the committed
    tlut."""
    return expand_tlut(torch.from_numpy(trellis_tlut(tlut_bits).copy()))
