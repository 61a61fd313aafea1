"""Inverses of the reference's kernel-side trellis layouts.

The port keeps the canonical (T, 4*KV) tile-row-major words; these turn
what the reference holds for its Pallas kernels back into them, so that
its weights can be carried over exactly (``convert.py``).

Dense even-KV planar layout:
``qpalette_tpu/kernels/formats.py::tcq2_planar_weights`` turns the
canonical (T, 4*KV) tile-row-major words into (k/16, NP*8, m/16) with,
for even KV (NP = KV/2), row ``j*8 + t`` = the tile's raw word
``KV/2*t + j``: a pure permutation.  The port keeps no TPU layout; this
inverse lets weights that exist only in that layout (the reference's
quantized lm_head) be carried over exactly.
"""

from __future__ import annotations

import numpy as np


def tcq2_planar_to_canonical(tr_pl: np.ndarray, m: int, k: int,
                             KV: int) -> np.ndarray:
    """planar (k/16, KV/2*8, m/16) uint32 -> canonical (T, 4*KV) uint32."""
    if KV % 2:
        raise ValueError(f"only the dense even-KV planar layout inverts "
                         f"here, got KV={KV}")
    NP = KV // 2
    kt, mt = k // 16, m // 16
    arr = np.asarray(tr_pl)
    if arr.shape != (kt, NP * 8, mt):
        raise ValueError(f"planar shape {arr.shape} != {(kt, NP * 8, mt)}")
    # arr[kt, j*8+t, mt] = word[NP*t + j]  ->  (kt, j, t, mt) -> (mt, kt, t, j)
    words = arr.reshape(kt, NP, 8, mt).transpose(3, 0, 2, 1)
    return np.ascontiguousarray(words.reshape(mt * kt, 4 * KV))


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
