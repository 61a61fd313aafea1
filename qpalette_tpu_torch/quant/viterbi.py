"""Tail-biting Viterbi encoder for the bitshift trellis (TCQ).

Counterpart of ``qpalette_tpu/quant/viterbi.py``.  The transition is
s_{i+1} = (s_i >> KV) | (new << (L - KV)), so the predecessors of state s
are the contiguous range [(s & mask) << KV, ((s & mask) + 1) << KV) and
the min over them is a min over the last axis of the cost viewed as
(B, 2^(L-KV), 2^KV).  A step is three passes over the (B, 2^16) float32
cost: one ``addmm`` writes |lut[s]|^2 - 2 x.lut[s] into a preallocated
buffer, one ``torch.min`` gives the carried minimum and its argmin (the
backpointer), and an in-place add puts the minimum on each successor.
The two cost buffers are allocated once a call and swapped.  The
products run in full float32 whatever the caller's TF32 setting.
"""

from __future__ import annotations

from typing import Optional

import torch

from qpalette_tpu_torch.utils.precision import full_f32

L = 16
V = 2
NSTATES = 1 << L
BIG = 1e30


def _cross_operands(Xs: torch.Tensor, lutT: torch.Tensor):
    """The float32 operands of the cross term x.lut, unchanged.  A check
    that reproduces a TPU's default-precision float32 dot (bfloat16
    operands) replaces this function (chip_smoke.py's TABLE_CROSS,
    tests/test_torch_viterbi.py)."""
    return Xs, lutT


def _bp_dtype(KV: int) -> torch.dtype:
    # 2^KV predecessor indices: a byte up to KV 8
    return torch.uint8 if KV <= 8 else torch.int32


def state_bytes(B: int, S: int, KV: int) -> int:
    """Device bytes of one viterbi_encode: two (B, 2^16) costs and the
    (S-1, B, 2^(L-KV)) backpointers."""
    bp = 1 if KV <= 8 else 4
    return 2 * B * NSTATES * 4 + (S - 1) * B * (1 << (L - KV)) * bp


def viterbi_encode(X: torch.Tensor, lut: torch.Tensor, KV: int,
                   init_c: Optional[torch.Tensor] = None,
                   final_c: Optional[torch.Tensor] = None,
                   v: int = V) -> torch.Tensor:
    """Encode sequences X (B, S*v) into trellis states (B, S) int64 on X's
    device, lut (2^16, v) the state values.

    init_c / final_c ((B,) ints in [0, 2^(L-KV)) or None) constrain
    s_0 & mask == init_c and s_{S-1} >> KV == final_c (the tail-biting
    junction).  Ties take the lowest index, as jnp.argmin does."""
    B, TV = X.shape
    S = TV // v
    NQ, NR = 1 << (L - KV), 1 << KV
    dev = X.device
    lutf = lut.to(device=dev, dtype=torch.float32)
    norms = (lutf * lutf).sum(1)
    lutT = lutf.T.contiguous()  # (v, 2^16)
    Xs, lutT = _cross_operands(X.to(torch.float32).reshape(B, S, v), lutT)
    cost = torch.empty((B, NSTATES), dtype=torch.float32, device=dev)
    err = torch.empty_like(cost)
    mn = torch.empty((B, NQ), dtype=torch.float32, device=dev)
    arg = torch.empty((B, NQ), dtype=torch.int64, device=dev)
    bps = torch.empty((S - 1, B, NQ), dtype=_bp_dtype(KV), device=dev)
    with full_f32():
        # err = |lut|^2 - 2 x.lut, one rounding after the dot (as
        # norms - 2 * cross: the factor 2 is exact)
        torch.addmm(norms, Xs[:, 0], lutT, alpha=-2.0, out=cost)
        if init_c is not None:
            q = torch.arange(NSTATES, device=dev) & (NQ - 1)
            cost.masked_fill_(q[None, :] != init_c.to(dev)[:, None], BIG)
        for j in range(1, S):
            torch.addmm(norms, Xs[:, j], lutT, alpha=-2.0, out=err)
            torch.min(cost.view(B, NQ, NR), dim=2, out=(mn, arg))
            bps[j - 1].copy_(arg)
            # cost_new[t * NQ + q] = err[t * NQ + q] + mn[q]
            err.view(B, NR, NQ).add_(mn[:, None, :])
            cost, err = err, cost
    if final_c is not None:
        q = torch.arange(NQ, device=dev)
        cost.view(B, NQ, NR).masked_fill_(
            (q[None, :] != final_c.to(dev)[:, None])[:, :, None], BIG)
    s = cost.argmin(1)
    states = torch.empty((B, S), dtype=torch.int64, device=dev)
    states[:, S - 1] = s
    # bps[j] points into time j from time j + 1
    for j in range(S - 2, -1, -1):
        q = s & (NQ - 1)
        r = bps[j].gather(1, q[:, None])[:, 0].to(torch.int64)
        s = (q << KV) | r
        states[:, j] = s
    return states


def tcq_quantize(X: torch.Tensor, lut: torch.Tensor, KV: int, v: int = V):
    """Tail-biting quantization of X (B, 256) -> (hatX (B, 256) float32,
    states (B, 256/v) int64).  Pass A encodes the sequence rolled by half
    to find the wrap state; pass B re-encodes it with both ends held to
    that state's carried bits."""
    B, TV = X.shape
    S = TV // v
    NQ = 1 << (L - KV)
    stA = viterbi_encode(torch.roll(X, (S // 2) * v, dims=1), lut, KV, v=v)
    c = stA[:, S // 2] & (NQ - 1)  # rolled position S/2 is position 0
    states = viterbi_encode(X, lut, KV, init_c=c, final_c=c, v=v)
    hat = lut.to(device=X.device, dtype=torch.float32)[states]
    return hat.reshape(B, TV), states
