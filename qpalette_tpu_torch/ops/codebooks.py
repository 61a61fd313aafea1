"""Trellis decoders: arithmetic (gather-free) and LUT (quantlut_sym).

Counterpart of ``qpalette_tpu/ops/codebooks.py`` (the MAD constants, the
arithmetic decoders ``decode_1mad`` / ``decode_2mad`` / ``decode_dualmad`` /
``decode_sum2``, ``decode_3inst`` and ``trellis_lut_arith``,
``tlut_bits_for_kv``, ``trellis_tlut`` and ``trellis_lut``, the SQ/VQ
codebook ``vq_lut`` and ``lut_rms``).  A table that is not committed
under ``assets/lut_cache`` is made by k-means as the reference makes it
and written under ``$QPALETTE_ASSETS/lut_cache`` (the repo's ``assets``
when that is unset), where a later call reads it.  The
32-bit modular arithmetic runs in int64 and is masked with
``& 0xFFFFFFFF``: torch's uint32 support is partial.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch

L = 16

MAD1_A, MAD1_B = 34038481, 76625530
MAD2_A, MAD2_B, MAD2_C = 264435761, 1013904223, 1664525
MAD_SCALE = 147.800537109375

# decode mode -> weights per trellis state (V)
ARITH_V = {"1mad": 1, "2mad": 1, "dualmad": 2, "sum2": 2}

_M32 = 0xFFFFFFFF


def sum2_scramble(u: torch.Tensor) -> torch.Tensor:
    """16-bit states (any int dtype) -> h = u*A + B mod 2^32 as int64."""
    return (u.to(torch.int64) * MAD1_A + MAD1_B) & _M32


def _bytes(h: torch.Tensor) -> torch.Tensor:
    """int64 h (< 2^32) -> (..., 4) int64 unsigned bytes, lowest first."""
    return torch.stack([(h >> (8 * i)) & 255 for i in range(4)], dim=-1)


def signed_bytes(h: torch.Tensor) -> torch.Tensor:
    """int64 h (< 2^32) -> (..., 4) int64 signed bytes, lowest byte first."""
    b = _bytes(h)
    return torch.where(b >= 128, b - 256, b)


def sum2_pairs(u: torch.Tensor) -> torch.Tensor:
    """States -> (..., 2) int64 unscaled weight pairs (sb0+sb1, sb2+sb3)."""
    sb = signed_bytes(sum2_scramble(u))
    return torch.stack([sb[..., 0] + sb[..., 1], sb[..., 2] + sb[..., 3]],
                       dim=-1)


def mad_scramble(u: torch.Tensor, mode: str) -> torch.Tensor:
    """V=1 states -> the scrambled word h (int64 < 2^32) whose unsigned
    byte sum minus 510 is the weight.  1mad: h = u*A1 + B1; 2mad:
    h0 = u*A2 + B2, h = h0 + hi32(h0*C)."""
    u = u.to(torch.int64) & _M32
    if mode == "1mad":
        return (u * MAD1_A + MAD1_B) & _M32
    if mode != "2mad":
        raise ValueError(f"V=1 decode mode {mode!r}")
    h0 = (u * MAD2_A + MAD2_B) & _M32
    return (h0 + ((h0 * MAD2_C) >> 32)) & _M32


def arith_weights_int(u: torch.Tensor, mode: str) -> torch.Tensor:
    """States -> (..., V) int64 unscaled weights (value * MAD_SCALE) of an
    arithmetic decode mode: sum2 and dualmad give a pair per state (V=2),
    1mad and 2mad one weight (V=1)."""
    if mode == "sum2":
        return sum2_pairs(u)
    if mode == "dualmad":
        u = u.to(torch.int64) & _M32
        return torch.stack([signed_bytes((u * a) & _M32).sum(-1)
                            for a in (MAD1_A, MAD2_A)], dim=-1)
    return (_bytes(mad_scramble(u, mode)).sum(-1) - 510)[..., None]


def _scaled(w: torch.Tensor) -> torch.Tensor:
    # the reference's (float64 / MAD_SCALE).astype(float32)
    return (w.to(torch.float64) / MAD_SCALE).to(torch.float32)


def decode_1mad(x: torch.Tensor) -> torch.Tensor:
    """V=1 decoder: one LCG step, (unsigned byte sum - 510) / MAD_SCALE.
    Returns (len(x),) float32."""
    return _scaled(arith_weights_int(torch.as_tensor(x), "1mad")[..., 0])


def decode_2mad(x: torch.Tensor) -> torch.Tensor:
    """V=1 two-stage LCG decoder.  Returns (len(x),) float32."""
    return _scaled(arith_weights_int(torch.as_tensor(x), "2mad")[..., 0])


def decode_dualmad(x: torch.Tensor) -> torch.Tensor:
    """V=2 decoder ('tcq2'): weight i = signed-byte sum of h_i = u*A_i mod
    2^32 (A_1 = MAD1_A, A_2 = MAD2_A, no additive constant), / MAD_SCALE.
    Returns (len(x), 2) float32."""
    return _scaled(arith_weights_int(torch.as_tensor(x), "dualmad"))


def decode_sum2(x: torch.Tensor) -> torch.Tensor:
    """V=2 sum2 decoder ('tcq2s'): ONE LCG scramble h = u*A + B per weight
    pair; weight 0 = signed bytes b0+b1, weight 1 = b2+b3, both / MAD_SCALE.
    Returns (len(x), 2) float32."""
    return _scaled(arith_weights_int(torch.as_tensor(x), "sum2"))


MAD3_A, MAD3_B, MAD3_FPMASK = 89226354, 64248484, 996162400


def _as_fp16(bits: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^16 -> the float16 numbers with those bits."""
    return torch.where(bits >= 1 << 15, bits - (1 << 16),
                       bits).to(torch.int16).view(torch.float16)


def decode_3inst(x: torch.Tensor) -> torch.Tensor:
    """fp16 bit-trick decoder (V=1): h = u*A + B mod 2^32, keep the sign,
    the low exponent bit and the mantissa of each 16-bit half, XOR a
    constant exponent pattern, and sum the two halves as float16 numbers.
    Returns (len(x),) float32.  No kernel decodes it: it is a quantizer
    table only."""
    u = (torch.as_tensor(x).to(torch.int64) * MAD3_A + MAD3_B) & _M32
    half = (1 << 15) + (1 << 12) - 1
    res = (u & ((half << 16) + half)) ^ MAD3_FPMASK
    return (_as_fp16(res >> 16).to(torch.float32)
            + _as_fp16(res & 0xFFFF).to(torch.float32))


@functools.lru_cache(maxsize=None)
def trellis_lut_arith(mode: str) -> torch.Tensor:
    """State -> value table of an arithmetic decode mode, float32:
    (2^16, 1) for 1mad / 2mad / 3inst (V=1), (2^16, 2) for dualmad /
    sum2."""
    s = torch.arange(1 << L, dtype=torch.int64)
    if mode == "3inst":
        return decode_3inst(s)[:, None]
    if mode not in ARITH_V:
        raise NotImplementedError(f"unknown decode mode {mode!r}")
    return _scaled(arith_weights_int(s, mode))


def lut_rms(lut) -> float:
    """RMS of a codebook's values, in float64 (Wscale's divisor)."""
    a = lut.cpu().numpy() if isinstance(lut, torch.Tensor) else lut
    return float(np.sqrt(np.mean(np.asarray(a, dtype=np.float64) ** 2)))


# ---------------------------------------------------------------------------
# k-means tables: the committed ones, or made and cached on first use
# ---------------------------------------------------------------------------

ASSETS = Path(__file__).resolve().parents[2] / "assets"
_COMMITTED = ASSETS / "lut_cache"


def asset_dir() -> Path:
    """Where tables made at run time are written and read:
    ``$QPALETTE_ASSETS``, or the repo's ``assets``."""
    root = os.environ.get("QPALETTE_ASSETS")
    return Path(root) if root else ASSETS


def cache_dir() -> Path:
    """Where a codebook that is not committed is written and read."""
    return asset_dir() / "lut_cache"


def _table(name: str, shape, make) -> np.ndarray:
    """The read-only float32 table ``name``: committed, else cached, else
    ``make()`` written to the cache (through a temporary file, so that a
    reader never sees half of it)."""
    for d in (_COMMITTED, cache_dir()):
        path = d / name
        if path.exists():
            table = np.load(path).astype(np.float32)
            break
    else:
        table = np.asarray(make(), np.float32)
        d = cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".{name}.{os.getpid()}.npy"
        np.save(tmp, table)
        os.replace(tmp, d / name)
    if table.shape != tuple(shape):
        raise ValueError(f"{name}: shape {table.shape}, want {shape}")
    table.setflags(write=False)
    return table


def tlut_bits_for_kv(kv: int) -> int:
    """Table bits S of a KV: KV <= 8 -> 9, else KV + 1."""
    return 9 if kv <= 8 else kv + 1


@functools.lru_cache(maxsize=None)
def trellis_tlut(tlut_bits: int, n_samples: int = 1 << 20,
                 device="cuda") -> np.ndarray:
    """The (2^S, 2) float32 quantlut_sym table ``tcq_tlut_{S}.npy``: a
    k-means codebook of n_samples N(0, 1)^2 draws (numpy seed 1234 + S),
    40 Lloyd steps on ``device``, scaled to std sqrt(15/16)."""
    def make():
        from qpalette_tpu_torch.utils.kmeans import kmeans
        data = np.random.default_rng(1234 + tlut_bits).standard_normal(
            (n_samples, 2)).astype(np.float32)
        c = kmeans(data, 1 << tlut_bits, iters=40, seed=tlut_bits,
                   device=device)
        return c / c.std() * 0.9682458365518543
    return _table(f"tcq_tlut_{tlut_bits}.npy", (1 << tlut_bits, 2), make)


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
    """The full (2^16, 2) float32 quantlut_sym table of trellis_tlut."""
    return expand_tlut(torch.from_numpy(trellis_tlut(tlut_bits).copy()))


@functools.lru_cache(maxsize=None)
def vq_lut(bits: int, vec: int, n_samples: int = 1 << 20,
           device="cuda") -> np.ndarray:
    """The (2^bits, vec) float32 SQ/VQ codebook ``vq_kmeans_{bits}_{vec}
    .npy``: k-means of n_samples N(0, 1)^vec draws (numpy seed
    4321 + 64*bits + vec), 40 Lloyd steps on ``device`` (vec 1: the exact
    1-D solution)."""
    def make():
        from qpalette_tpu_torch.utils.kmeans import kmeans
        data = np.random.default_rng(4321 + 64 * bits + vec).standard_normal(
            (n_samples, vec)).astype(np.float32)
        return kmeans(data, 1 << bits, iters=40, seed=bits * 7 + vec,
                      device=device)
    return _table(f"vq_kmeans_{bits}_{vec}.npy", (1 << bits, vec), make)
