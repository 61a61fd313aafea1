"""Arithmetic (gather-free) trellis decoders.

Counterpart of ``qpalette_tpu/ops/codebooks.py`` (the MAD constants,
``decode_sum2`` and ``trellis_lut_arith("sum2")``).  The 32-bit modular
arithmetic runs in int64 and is masked with ``& 0xFFFFFFFF``: torch's
uint32 support is partial.
"""

from __future__ import annotations

import functools

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
