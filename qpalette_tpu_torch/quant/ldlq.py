"""Block LDL decomposition and the LDLQ feedback recursion.

Counterpart of ``qpalette_tpu/quant/ldlq.py``.  The reference runs the
recursion as two nested reverse ``lax.scan``s; here they are two explicit
right-to-left loops: over 128-column buffers, each fed once by the
columns already quantized to its right through one (m, n) @ (n, 128)
product, and over the blocks inside a buffer.  Codes come out in natural
column order.  (Without a Hessian the feedback is zero and the
quantizers take every block's own columns of W without this recursion.)
"""

from __future__ import annotations

from typing import Callable

import torch

from qpalette_tpu_torch.utils.precision import full_f32

__all__ = ["block_ldl", "ldlq", "regularize_h", "cholesky_damped"]

SIGMAS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0)


def regularize_h(H: torch.Tensor, sigma_reg: float = 0.01) -> torch.Tensor:
    """H + sigma_reg * mean(diag H) * I, computed as the reference does:
    normalised by the diagonal mean, shifted, scaled back."""
    n = H.shape[0]
    diagmean = torch.diagonal(H).mean()
    Hn = H / diagmean + sigma_reg * torch.eye(n, dtype=H.dtype,
                                              device=H.device)
    return Hn * diagmean


def cholesky_damped(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of H; where it fails, of H + sigma * mean(diag
    H) * I for the first sigma of SIGMAS that succeeds (the reference
    retries on NaN; cholesky_ex reports the failure in ``info``).  Raises
    when every sigma fails."""
    L, info = torch.linalg.cholesky_ex(H)
    if int(info) == 0:
        return L
    diagmean = torch.diagonal(H).mean()
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    for sigma in SIGMAS:
        L, info = torch.linalg.cholesky_ex(H + sigma * diagmean * eye)
        if int(info) == 0:
            return L
    raise RuntimeError("Cholesky failed at every damping of SIGMAS")


def block_ldl(H: torch.Tensor, b: int):
    """H = L D L^T with unit block-diagonal L; returns (L_strict, D):
    L with its b x b diagonal blocks zeroed, D (n/b, b, b)."""
    n = H.shape[0]
    if n % b:
        raise ValueError((n, b))
    m = n // b
    with full_f32():
        C = cholesky_damped(H)
        idx = torch.arange(m, device=H.device)
        DL = C.reshape(m, b, m, b)[idx, :, idx, :]  # (m, b, b) lower
        D = DL @ DL.transpose(1, 2)
        DLinv = torch.linalg.inv(DL)
        Lm = torch.einsum("rmb,mbc->rmc", C.reshape(n, m, b), DLinv)
    Lm = Lm.reshape(m, b, m, b)
    Lm[idx, :, idx, :] = 0.0  # strictly block-lower
    return Lm.reshape(n, n), D


def ldlq(W: torch.Tensor, Lmat: torch.Tensor,
         quant_block: Callable[[torch.Tensor, int], tuple],
         block: int, buf: int = 128):
    """LDLQ recursion over W (m, n) with Lmat (n, n) strictly block-lower
    (block size dividing ``block``).

    quant_block(vals (m, block), block_index) -> (hat (m, block), codes).
    Returns (hatW (m, n) float32, [codes of each block, left to right])."""
    m, n = W.shape
    buf = min(buf, n)
    if n % buf or buf % block:
        raise ValueError((n, buf, block))
    steps = buf // block
    W = W.to(torch.float32)
    hatW = torch.zeros((m, n), dtype=torch.float32, device=W.device)
    codes = [None] * (n // block)
    with full_f32():
        for bi in range(n // buf - 1, -1, -1):
            c0 = bi * buf
            Wbuf = W[:, c0:c0 + buf]
            hat_buf = hatW[:, c0:c0 + buf]
            # cross-buffer feedback from the columns right of this buffer
            # (its own rows of L are the inner recursion's)
            Lcross = Lmat[:, c0:c0 + buf].clone()
            Lcross[c0:c0 + buf] = 0.0
            prod = (W - hatW) @ Lcross
            Lbuf = Lmat[c0:c0 + buf, c0:c0 + buf]
            for j in range(steps - 1, -1, -1):
                sl = slice(j * block, (j + 1) * block)
                E = (Wbuf[:, sl] + prod[:, sl]
                     + (Wbuf - hat_buf) @ Lbuf[:, sl])
                hat_blk, c = quant_block(E, bi * steps + j)
                hat_buf[:, sl] = hat_blk
                codes[bi * steps + j] = c
    return hatW, codes
