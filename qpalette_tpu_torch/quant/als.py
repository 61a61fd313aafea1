"""Data-dependent SQ/VQ (the ``sq_*`` and ``vq2_*`` families): k-means
on the rotated weights, then with a Hessian alternating least squares.

Counterpart of ``qpalette_tpu/quant/als.py``.  ``_cd_update`` is exact
coordinate descent over assignment positions under tr(D H D^T), D = W-hat
minus W, carrying D and its image D H (choosing a centroid at a position
is a rank-vec update); ``_centroid_solve`` is the closed-form centroid
update from the normal equations, built with one-hot einsums.  The
reference's sample of 2^18 vectors for the k-means is numpy's
(``default_rng(0)``), so it is the same here; a vec-2 k-means is seeded
by a torch.Generator where the reference uses jax.random.
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.ops import packing
from qpalette_tpu_torch.quant.ldlq import regularize_h
from qpalette_tpu_torch.quant.quantizers import nearest
from qpalette_tpu_torch.utils.kmeans import kmeans
from qpalette_tpu_torch.utils.precision import full_f32

# above nc * vec centroid components the C update takes the
# diagonal-weighted estimate instead of the full normal solve
FULL_C_MAX = 1024


def _assign(vecs: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return nearest(vecs, C, (C * C).sum(1))


def _cd_update(W, H, assign, C, vec: int, cycles: int = 2):
    """Coordinate descent on assignments: at position j pick the centroid
    c minimising c Q c^T - 2 c.(w_j Q - r_j), Q = H's (j, j) block,
    r_j = S_j - D_j Q, S = D H kept up to date."""
    m, n = W.shape
    assign = assign.clone()
    delta = C[assign].reshape(m, n) - W
    S = delta @ H
    for _ in range(cycles):
        for j in range(n // vec):
            cols = slice(j * vec, (j + 1) * vec)
            Q = H[cols, cols]
            dj, wj = delta[:, cols], W[:, cols]
            r = S[:, cols] - dj @ Q
            qq = ((C @ Q) * C).sum(1)
            obj = qq[None, :] - 2.0 * ((wj @ Q - r) @ C.T)
            a_new = obj.argmin(1)
            dnew = C[a_new] - wj
            S += (dnew - dj) @ H[cols]
            delta[:, cols] = dnew
            assign[:, j] = a_new
    return assign


def _centroid_solve(W, H, assign, nc: int, vec: int, chunk: int = 16):
    """Least-squares centroids under tr(D H D^T): A vec(C) = b with
    A[(c1,u),(c2,v)] = sum over rows and positions j in c1, k in c2 of
    H[j*vec+u, k*vec+v], b[(c,u)] = sum over j in c of (W H)[row, j*vec+u];
    a ridge of 1e-6 * trace(A)/k for empty clusters."""
    m, n = W.shape
    d, k = n // vec, nc * vec
    WH = W @ H
    b = torch.zeros((nc, vec), dtype=H.dtype, device=H.device)
    b.index_add_(0, assign.reshape(-1), WH.reshape(m * d, vec))
    Hr = H.reshape(d, vec, n)
    A = torch.zeros((k, k), dtype=H.dtype, device=H.device)
    B = chunk if m % chunk == 0 else 1
    for r0 in range(0, m, B):
        P = torch.nn.functional.one_hot(assign[r0:r0 + B], nc).to(H.dtype)
        R = torch.einsum("jun,bjc->bcun", Hr, P).reshape(-1, k, d, vec)
        A += torch.einsum("bkjv,bjc->kcv", R, P).reshape(k, k)
    A += (1e-6 * torch.trace(A) / k) * torch.eye(k, dtype=A.dtype,
                                                 device=A.device)
    return torch.linalg.solve(A, b.reshape(k)).reshape(nc, vec)


def quantize_mat_vq_als(Wr, HRr, bits: int, vec: int, use_hess: bool = False,
                        iters: int = 4, cd_cycles: int = 2):
    """k-means codebook (25 Lloyd steps from 2^18 sampled vectors) of the
    rotated weights, then iters rounds of Lloyd's (no Hessian) or of
    coordinate descent and the centroid solve (Hessian); returns the
    artifact's linear dict (row-pack words and the codebook ``lut``) and
    W-hat."""
    m, n = Wr.shape
    dev = Wr.device
    Wf = Wr.to(torch.float32)
    vecs_np = Wf.cpu().numpy().reshape(-1, vec)
    nc = 1 << bits
    pick = np.random.default_rng(0).choice(
        len(vecs_np), min(len(vecs_np), 1 << 18), replace=False)
    C = torch.as_tensor(kmeans(vecs_np[pick], nc, iters=25, device=dev),
                        device=dev)
    vecs = Wf.reshape(-1, vec)
    with full_f32():
        if use_hess and HRr is not None:
            H = regularize_h(HRr.to(device=dev, dtype=torch.float32))
            assign = _assign(vecs, C).reshape(m, n // vec)
            for _ in range(iters):
                assign = _cd_update(Wf, H, assign, C, vec, cd_cycles)
                if nc * vec <= FULL_C_MAX:
                    C = _centroid_solve(Wf, H, assign, nc, vec)
                else:
                    w = torch.diagonal(H).clamp(min=1e-8).reshape(
                        1, n // vec, vec).expand(m, -1, -1).reshape(-1, vec)
                    a = assign.reshape(-1)
                    num = torch.zeros((nc, vec), device=dev).index_add_(
                        0, a, vecs * w)
                    den = torch.zeros((nc, vec), device=dev).index_add_(
                        0, a, w)
                    C = torch.where(den > 0, num / den.clamp(min=1e-8), C)
            idx = _cd_update(Wf, H, assign, C, vec, cd_cycles).reshape(-1)
        else:
            for _ in range(iters):
                idx = _assign(vecs, C)
                num = torch.zeros((nc, vec), device=dev).index_add_(
                    0, idx, vecs)
                den = torch.zeros((nc, vec), device=dev).index_add_(
                    0, idx, torch.ones_like(vecs))
                C = torch.where(den > 0, num / den.clamp(min=1e-8), C)
            idx = _assign(vecs, C)
    linear = {"kind": "vq", "bits": bits, "vec": vec,
              "qweight": packing.pack_rows(idx.reshape(m, n // vec), bits)
              .cpu().numpy().view(np.uint32),
              "lut": C.cpu().numpy().astype(np.float32),
              "in_features": n, "out_features": m}
    return linear, C[idx].reshape(m, n)
