"""Canonical packed formats and their executable-spec decoders.

Counterpart of ``qpalette_tpu/ops/packing.py`` (``pack_trellis``,
``unpack_trellis``, ``tiles_to_mat``, ``mat_to_tiles``, ``dequant_tcq``
for V=2 and V=1, ``dequant_tcq2``, and the SQ/VQ row-pack
``pack_rows``, ``unpack_rows``, ``dequant_lut``).  The
canonical ``trellis`` is (T, 8*KV/V) 32-bit words, T = (m/16)*(k/16) tiles
in tile-row-major order.  Each tile is one tail-biting trellis of 256/V
states (V weights per state); state i is the 16-bit window at bit KV*i of
the tile's *circular* 256*KV/V-bit stream (word indices wrap modulo the
tile's word count).

The canonical row-pack of an SQ/VQ projection is (m, ceil(P*bits/32) + 1)
words, P = k/vec indices a row: index p is the ``bits``-bit window at bit
p*bits of its row, packed LSB-first, and one trailing pad word keeps the
last window's second word in bounds.

The port keeps the words in int32 tensors holding the uint32 bit
pattern (torch's uint32 support is partial); arithmetic on them widens
to int64 and masks with 0xFFFFFFFF.
"""

from __future__ import annotations

import numpy as np
import torch

L = 16  # trellis window length (bits per state)
TD = 16  # weight tile edge
V = 2  # weights per trellis state

_M32 = 0xFFFFFFFF


def words_to_torch(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits."""
    arr = np.array(words, dtype=np.uint32, order="C")  # a writable copy
    return torch.from_numpy(arr.view(np.int32)).to(device)


PACK_TILES = 4096  # tiles a pack_trellis step (bounds its bit matrix)


def pack_trellis(states: torch.Tensor, KV: int, v: int = V) -> torch.Tensor:
    """Tail-biting states (T, 256/v) < 2^16 -> canonical words (T, 8*KV/v)
    int32: the stream is s_0's 16 bits, then the top KV bits (the new
    ones) of each later state, LSB first, cut to 256*KV/v bits (the cut
    tail repeats s_0's low bits when the chain wraps)."""
    T, S = states.shape
    if S != 256 // v:
        raise ValueError(f"{S} states a tile, want {256 // v}")
    dev = states.device
    sh16 = torch.arange(L, dtype=torch.int64, device=dev)
    shk = torch.arange(KV, dtype=torch.int64, device=dev)
    w32 = torch.arange(32, dtype=torch.int64, device=dev)
    out = []
    for t0 in range(0, T, PACK_TILES):
        s = states[t0:t0 + PACK_TILES].to(torch.int64)
        first = (s[:, :1] >> sh16) & 1
        new = ((s[:, 1:, None] >> (L - KV)) >> shk) & 1
        bits = torch.cat([first, new.reshape(s.shape[0], -1)], 1)
        bits = bits[:, :S * KV].reshape(s.shape[0], S * KV // 32, 32)
        out.append(_as_int32((bits << w32).sum(-1)))
    return torch.cat(out)


def unpack_trellis(packed: torch.Tensor, KV: int, v: int = V) -> torch.Tensor:
    """packed (T, 8*KV/v) words -> states (T, 256/v) int64 (circular)."""
    W = packed.shape[-1]
    n_pos = 256 // v
    o = torch.arange(n_pos, dtype=torch.int64, device=packed.device) * KV
    w0 = o >> 5
    w1 = (w0 + 1) % W
    w0 = w0 % W
    sh = o & 31
    u = packed.to(torch.int64) & _M32
    lo = u[..., w0]
    hi = u[..., w1]
    return ((lo >> sh) | (hi << (32 - sh))) & ((1 << L) - 1)


def tiles_to_mat(tiles: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """tiles ((m/16)*(k/16), 16, 16) tile-row-major -> mat (m, k)."""
    t = tiles.reshape(m // TD, k // TD, TD, TD)
    return t.permute(0, 2, 1, 3).reshape(m, k)


def mat_to_tiles(mat: torch.Tensor) -> torch.Tensor:
    """mat (m, k) -> tiles ((m/16)*(k/16), 16, 16), tile-row-major."""
    m, k = mat.shape
    t = mat.reshape(m // TD, TD, k // TD, TD).permute(0, 2, 1, 3)
    return t.reshape(-1, TD, TD)


def dequant_tcq2(packed: torch.Tensor, lut: torch.Tensor, m: int, k: int,
                 KV: int) -> torch.Tensor:
    """V=2 trellis in PAIRED-K-MAJOR order -> weights (m, k): state
    s = 16*t + row covers (row, 2t) and (row, 2t+1) of its 16x16 tile."""
    states = unpack_trellis(packed, KV, 2)  # (T, 128)
    vals = lut[states]  # (T, 128, 2)
    tiles = vals.reshape(-1, TD // 2, TD, 2)  # (T, t, row, c)
    tiles = tiles.permute(0, 2, 1, 3).reshape(-1, TD, TD)
    return tiles_to_mat(tiles, m, k)


def dequant_tcq(packed: torch.Tensor, lut: torch.Tensor, m: int, k: int,
                KV: int, v: int = V) -> torch.Tensor:
    """Trellis -> weights (m, k) in lut's dtype; lut is the full (2^16, v)
    state table.  v=2: M-MAJOR order, state s = 8*row + t covers (row, 2t)
    and (row, 2t+1) of its 16x16 tile (not dequant_tcq2's paired-K-major
    order).  v=1: K-MAJOR order, state p = 16*col + row."""
    states = unpack_trellis(packed, KV, v)  # (T, 256/v)
    tiles = lut[states].reshape(-1, TD, TD)  # (T, row, col) for v=2
    if v == 1:
        tiles = tiles.transpose(1, 2)  # (T, col, row) -> (T, row, col)
    return tiles_to_mat(tiles, m, k)


# ---------------------------------------------------------------------------
# SQ / VQ row-pack
# ---------------------------------------------------------------------------

def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> int32 tensor with the same 32 bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def pack_rows(indices: torch.Tensor, bits: int) -> torch.Tensor:
    """indices (m, P) < 2^bits -> the canonical row-pack (m, W + 1) int32
    words, W = ceil(P*bits/32), the last word zero."""
    m, P = indices.shape
    idx = indices.to(torch.int64)
    shifts = torch.arange(bits, dtype=torch.int64, device=idx.device)
    bitmat = ((idx[:, :, None] >> shifts) & 1).reshape(m, P * bits)
    nwords = -(-(P * bits) // 32)
    bitmat = torch.nn.functional.pad(bitmat, (0, nwords * 32 - P * bits + 32))
    w32 = torch.arange(32, dtype=torch.int64, device=idx.device)
    words = (bitmat.reshape(m, nwords + 1, 32) << w32).sum(-1)
    return _as_int32(words)


def unpack_rows(packed: torch.Tensor, bits: int, n_idx: int) -> torch.Tensor:
    """Row-pack words (m, W + 1) -> indices (m, n_idx) int64."""
    o = torch.arange(n_idx, dtype=torch.int64, device=packed.device) * bits
    w0, sh = o >> 5, o & 31
    u = packed.to(torch.int64) & _M32
    lo, hi = u[..., w0], u[..., w0 + 1]
    return ((lo >> sh) | (hi << (32 - sh))) & ((1 << bits) - 1)


def dequant_lut(packed: torch.Tensor, lut: torch.Tensor, m: int, k: int,
                bits: int, vec: int) -> torch.Tensor:
    """SQ/VQ dequant: row-pack indices into lut (2^bits, vec) -> weights
    (m, k) in lut's dtype; column p*vec + c is component c of index p."""
    idx = unpack_rows(packed, bits, k // vec)  # (m, P)
    return lut[idx].reshape(m, k)
