"""Coordinate-descent refinement of SQ/VQ quantized weights.

Counterpart of ``qpalette_tpu/quant/refine.py``: after LDLQ, sweep the
column blocks (vec columns each) and re-choose each block's codewords
against the whole Hessian-weighted residual.  It minimises tr(E H E^T),
E = W-hat - W: given every other column, block j's unconstrained optimum
is t_j = W-hat_j - (E H)_j (H_jj)^-1, projected onto the codebook; E is
updated and the next block follows.  A sweep costs one (m, n) x (n, vec)
product a block; the indices are re-packed after.
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.ops import packing
from qpalette_tpu_torch.ops.codebooks import vq_lut
from qpalette_tpu_torch.quant.ldlq import regularize_h
from qpalette_tpu_torch.quant.quantizers import nearest
from qpalette_tpu_torch.utils.precision import full_f32


@torch.inference_mode()
def cd_refine_vq(W, hatW, H, lut, vec: int, sweeps: int = 2):
    """Refine a VQ/SQ quantization of W (m, n) whose estimate is hatW, under
    the Hessian H (n, n) and the codebook lut (2^bits, vec), all on one
    device.  Returns (hatW' (m, n) float32, idx (m, n/vec) int64)."""
    m, n = W.shape
    W = W.to(torch.float32)
    lutf = lut.to(device=W.device, dtype=torch.float32)
    norms = (lutf * lutf).sum(1)
    nb = n // vec
    with full_f32():
        Hn = regularize_h(H.to(device=W.device, dtype=torch.float32))
        Hinv = torch.linalg.inv(
            Hn.reshape(nb, vec, nb, vec)[torch.arange(nb), :,
                                          torch.arange(nb), :])
        E = hatW.to(torch.float32) - W
        idxs = torch.zeros((m, nb), dtype=torch.int64, device=W.device)
        for _ in range(sweeps):
            for j in range(nb):
                c = slice(j * vec, (j + 1) * vec)
                EH = E @ Hn[:, c]  # (m, vec)
                target = (E[:, c] + W[:, c]) - EH @ Hinv[j]
                idx = nearest(target, lutf, norms)
                E[:, c] = lutf[idx] - W[:, c]
                idxs[:, j] = idx
    return E + W, idxs


def refine_artifact_vq(W, art: dict, H, sweeps: int = 2,
                       device="cuda") -> dict:
    """A 'vq'-kind artifact refined (a new dict; the indices re-packed with
    pack_rows, meta err recomputed, ``refined``).  W: the rotated,
    row-normalised weight (m, n) the artifact quantized; H: its rotated
    Hessian."""
    meta = art["meta"]
    if meta["kind"] != "vq":
        raise ValueError(f"refine_artifact_vq takes a vq artifact, not "
                         f"{meta['kind']!r}")
    device = torch.device(device)
    lut = torch.as_tensor(np.asarray(art["lut"] if "lut" in art else
                                     vq_lut(meta["bits"], meta["vec"]),
                                     np.float32), device=device)
    m, n = meta["out_features"], meta["in_features"]
    Wt = torch.as_tensor(np.asarray(W, np.float32) if not isinstance(
        W, torch.Tensor) else W, device=device).to(torch.float32)
    Ht = torch.as_tensor(np.asarray(H, np.float32) if not isinstance(
        H, torch.Tensor) else H, device=device)
    hatW = packing.dequant_lut(packing.words_to_torch(
        np.asarray(art["qweight"], np.uint32), device), lut, m, n,
        meta["bits"], meta["vec"])
    hat2, idxs = cd_refine_vq(Wt, hatW, Ht, lut, meta["vec"], sweeps)
    out = dict(art)
    out["qweight"] = packing.pack_rows(idxs, meta["bits"]).cpu().numpy() \
        .view(np.uint32)
    ws = torch.as_tensor(np.asarray(art["Wscale"], np.float32),
                         device=device)[:, None]
    sw, sh = Wt * ws, hat2 * ws
    err = float(((sw - sh) ** 2).mean() / (sw ** 2).mean())
    out["meta"] = dict(meta, err=err, refined=True)
    return out
