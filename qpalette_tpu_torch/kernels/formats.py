"""Inverse of the reference's dense even-KV planar layout.

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
