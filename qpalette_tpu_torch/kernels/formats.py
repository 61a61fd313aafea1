"""Inverses of the reference's kernel-side trellis layouts.

The port keeps the canonical tile-row-major words, (T, 4*KV) for V=2 and
(T, 8*KV) for V=1; these turn what the reference holds for its Pallas
kernels back into them, so that its weights can be carried over exactly
(``convert.py``).

Planar layouts (``qpalette_tpu/kernels/formats.py::tcq2_planar_weights``
and ``tcq1_planar_weights``), with ``sub`` = 8 sublanes a plane for V=2 and
16 for V=1, so a tile holds W = sub*KV/2 words:

- dense even KV: (k/16, KV/2*sub, m/16), row ``j*sub + t`` = the tile's
  raw word ``KV/2*t + j``;
- dense odd KV (k/16 even): (k/32, KV*sub, m/16), a block per two
  k-tiles; row ``j*sub + s`` = tile ``2g + (s&1)``'s raw word
  ``(s>>1)*KV + j``.

Both are pure permutations.  The aligned fallback (odd KV with odd k/16,
tiny shapes only) packs shifted windows and is not inverted here.

The SQ/VQ kernel layout (``formats.py::vq_kernel_weights``) is the row-pack
without its pad word, transposed and grouped by sublane:
(8, nch*g, m), word ``s*g + j`` of k-chunk ``c`` at ``[s, c*g + j]``.  Its
inverse is ``vq_kernel_to_canonical``.  The reference's activation
permutation for that layout (``vq_x_perm``) has no counterpart: the port's
kernels read the canonical row-pack in natural order.
"""

from __future__ import annotations

import numpy as np


def _planar_to_canonical(tr_pl: np.ndarray, m: int, k: int, KV: int,
                         sub: int) -> np.ndarray:
    kt, mt = k // 16, m // 16
    arr = np.asarray(tr_pl)
    W = sub * KV // 2
    if KV % 2 == 0:
        NP = KV // 2
        if arr.shape != (kt, NP * sub, mt):
            raise ValueError(f"planar shape {arr.shape} != "
                             f"{(kt, NP * sub, mt)}")
        # arr[kt, j*sub+t, mt] = word[NP*t + j] -> (mt, kt, t, j)
        words = arr.reshape(kt, NP, sub, mt).transpose(3, 0, 2, 1)
    else:
        if kt % 2:
            raise ValueError(f"odd KV={KV} with odd k/16={kt}: the "
                             f"reference's aligned layout is not inverted")
        if arr.shape != (kt // 2, KV * sub, mt):
            raise ValueError(f"planar shape {arr.shape} != "
                             f"{(kt // 2, KV * sub, mt)}")
        # arr[g, j*sub + 2r + h, mt] = tile (2g+h)'s word[r*KV + j]
        # -> (mt, g, h, r, j)
        words = arr.reshape(kt // 2, KV, sub // 2, 2, mt).transpose(
            4, 0, 3, 2, 1)
    return np.ascontiguousarray(words.reshape(mt * kt, W))


def tcq2_planar_to_canonical(tr_pl: np.ndarray, m: int, k: int,
                             KV: int) -> np.ndarray:
    """V=2 planar (dense even or dense odd KV) -> canonical (T, 4*KV)."""
    return _planar_to_canonical(tr_pl, m, k, KV, 8)


def tcq1_planar_to_canonical(tr_pl: np.ndarray, m: int, k: int,
                             KV: int) -> np.ndarray:
    """V=1 planar (dense even or dense odd KV) -> canonical (T, 8*KV)."""
    return _planar_to_canonical(tr_pl, m, k, KV, 16)


def tcq_kernel_to_canonical(tr_kt: np.ndarray, m: int, k: int,
                            KV: int) -> np.ndarray:
    """Inverse of ``formats.tcq_kernel_weights`` (a transpose):
    (k/16, 4*KV, m/16) -> canonical (T, 4*KV)."""
    kt, mt = k // 16, m // 16
    arr = np.asarray(tr_kt)
    if arr.shape != (kt, 4 * KV, mt):
        raise ValueError(f"kernel shape {arr.shape} != {(kt, 4 * KV, mt)}")
    return np.ascontiguousarray(arr.transpose(2, 0, 1).reshape(mt * kt,
                                                               4 * KV))


def tcomb_kernel_to_canonical(trc: np.ndarray, m: int, n1: int, n2: int,
                              KV1: int, KV2: int):
    """Inverse of ``formats.tcomb_kernel_weights``: the (k/16, 4*KV2, m/16)
    padded concatenation -> canonical (trellis1, trellis2).  The KV1
    half's pad words must be zero."""
    arr = np.asarray(trc)
    if KV2 < KV1 or arr.shape != ((n1 + n2) // 16, 4 * KV2, m // 16):
        raise ValueError(f"tcomb kernel shape {arr.shape} does not fit "
                         f"m={m}, n=({n1}, {n2}), KV=({KV1}, {KV2})")
    a, b = arr[:n1 // 16], arr[n1 // 16:]
    if a[:, 4 * KV1:].any():
        raise ValueError("non-zero pad words in the KV1 half")
    return (tcq_kernel_to_canonical(a[:, :4 * KV1], m, n1, KV1),
            tcq_kernel_to_canonical(b, m, n2, KV2))


def _vq_pick_kb(P: int, bits: int) -> int:
    # the reference's k-chunk: (kb/8)*bits words a sublane must be whole
    for kb in (512, 256, 128):
        if P % kb == 0 and (kb // 8) * bits % 32 == 0:
            return kb
    raise ValueError(f"no k-chunk for P={P}, bits={bits}")


def vq_kernel_to_canonical(qw_t: np.ndarray, bits: int, vec: int, m: int,
                           k: int) -> np.ndarray:
    """Inverse of ``formats.vq_kernel_weights``: (8, W/8, m) -> the
    canonical row-pack (m, W + 1) with a zero pad word, W = P*bits/32."""
    P = k // vec
    arr = np.asarray(qw_t)
    W = P * bits // 32
    if P * vec != k or P * bits % 32 or arr.shape != (8, W // 8, m):
        raise ValueError(f"vq kernel shape {arr.shape} does not fit bits="
                         f"{bits}, vec={vec}, m={m}, k={k}")
    g = _vq_pick_kb(P, bits) * bits // 256
    words = arr.reshape(8, W // (8 * g), g, m).transpose(1, 0, 2, 3)
    out = np.zeros((m, W + 1), dtype=arr.dtype)
    out[:, :W] = words.reshape(W, m).T
    return out
