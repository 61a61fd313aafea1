"""Scheme-level weight quantizers: TCQ (LUT and arithmetic trellises),
comb / tcomb (fractional TCQ), and SQ/VQ through LDLQ.

Counterpart of ``qpalette_tpu/quant/quantizers.py``.  Each takes an
incoherence-rotated, row-normalised weight Wr (m, n) on its device and an
optional rotated Hessian, and returns (the artifact's linear dict with
uint32 numpy words in the loader's canonical layout, the dequantized
Wr-hat (m, n) float32 on Wr's device).  The tile orders are the
reference's: V=2 row-major within a 16x16 tile (tcq, tcomb, comb), V=1
k-major (tcq1), and tcq2's paired-k-major order.  Without a Hessian every
column block is independent, and several blocks' sequences go through
one Viterbi call (as many as STATE_BYTES allows); with one, LDLQ feeds
each block in turn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qpalette_tpu_torch.ops import packing
from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv, trellis_lut,
                                              trellis_lut_arith, vq_lut)
from qpalette_tpu_torch.quant.ldlq import block_ldl, ldlq, regularize_h
from qpalette_tpu_torch.quant.viterbi import state_bytes, tcq_quantize
from qpalette_tpu_torch.utils.precision import full_f32

TD = 16
# device bytes the Viterbi of one call may hold (sets the blocks encoded
# together without a Hessian), and the nearest-centroid distances of a
# step of the SQ/VQ quantizer
STATE_BYTES = {"cuda": 2 << 30, "cpu": 256 << 20}
DIST_BYTES = 256 << 20


def _words(packed: torch.Tensor) -> np.ndarray:
    return packed.cpu().numpy().view(np.uint32)


def _ldl(H: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    if H is None:
        return None
    L, _ = block_ldl(regularize_h(H.to(torch.float32)), b)
    return L


# within-tile orders: (m, 16) column block <-> (m/16, 256) sequences
def _rows_to_seqs(E: torch.Tensor) -> torch.Tensor:
    """V=2 row-major: position 16*row + col."""
    return E.reshape(-1, TD * TD)


def _seqs_to_rows(hat: torch.Tensor, m: int) -> torch.Tensor:
    return hat.reshape(m, TD)


def _kmajor_to_seqs(E: torch.Tensor) -> torch.Tensor:
    """V=1 k-major: position 16*col + row."""
    return E.reshape(-1, TD, TD).transpose(1, 2).reshape(-1, TD * TD)


def _seqs_to_kmajor(hat: torch.Tensor, m: int) -> torch.Tensor:
    return hat.reshape(-1, TD, TD).transpose(1, 2).reshape(m, TD)


def _pairk_to_seqs(E: torch.Tensor) -> torch.Tensor:
    """tcq2's paired-k-major order: position 32*t + 2*row + c is weight
    (row, 2t + c), so state 16*t + row holds two k-adjacent weights."""
    t = E.reshape(-1, TD, TD // 2, 2).permute(0, 2, 1, 3)
    return t.reshape(-1, TD * TD)


def _seqs_to_pairk(hat: torch.Tensor, m: int) -> torch.Tensor:
    t = hat.reshape(-1, TD // 2, TD, 2).permute(0, 2, 1, 3)
    return t.reshape(m, TD)


ORDERS = {"rows": (_rows_to_seqs, _seqs_to_rows),
          "kmajor": (_kmajor_to_seqs, _seqs_to_kmajor),
          "pairk": (_pairk_to_seqs, _seqs_to_pairk)}


def _stack_tile_codes(states: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Per-block states (n/16, m/16, S) -> (T, S) tile-row-major."""
    return states.transpose(0, 1).reshape((m // TD) * (n // TD), -1)


def _trellis_blocks(Wr, L, lut, kvs, v, order, D=None, beam=0):
    """TCQ of every 16-column block of Wr, block j at KV kvs[j]:
    (hatW (m, n), states (n/16, m/16, 256/v)).  With L, LDLQ feeds each
    block in turn; beam > 0 (with L and the LDL blocks D) then refines
    each block's Viterbi states by the Hessian-weighted beam
    (quant/beam.py) under its within-tile weight, D[j] over a tile's 16
    rows: kron(eye, D[j]) in row-major tile order, kron(D[j], eye)
    k-major."""
    m, n = Wr.shape
    to_seqs, to_block = ORDERS[order]
    nb = n // TD
    if L is not None:
        if beam > 0:
            from qpalette_tpu_torch.quant.beam import tcq_quantize_beam
            eye = torch.eye(TD, dtype=torch.float32, device=Wr.device)

        def qblock(E, idx):
            seqs = to_seqs(E)
            hat, st = tcq_quantize(seqs, lut, kvs[idx], v=v)
            if beam > 0:
                Dt = torch.kron(D[idx], eye) if order == "kmajor" else \
                    torch.kron(eye, D[idx])
                hat, st = tcq_quantize_beam(seqs, lut, Dt, st, kvs[idx],
                                            v=v, beam=beam)
            return to_block(hat, m), st
        hatW, codes = ldlq(Wr, L, qblock, block=TD)
        return hatW, torch.stack(codes)
    hatW = torch.empty((m, n), dtype=torch.float32, device=Wr.device)
    states = torch.empty((nb, m // TD, 256 // v), dtype=torch.int64,
                         device=Wr.device)
    budget = STATE_BYTES["cuda" if Wr.is_cuda else "cpu"]
    j = 0
    while j < nb:
        KV = kvs[j]
        cap = budget // state_bytes(m // TD, 256 // v, KV)
        c = 1
        while c < cap and j + c < nb and kvs[j + c] == KV:
            c += 1
        cols = Wr[:, j * TD:(j + c) * TD].to(torch.float32)
        seqs = torch.cat([to_seqs(cols[:, b * TD:(b + 1) * TD])
                          for b in range(c)])
        hat, st = tcq_quantize(seqs, lut, KV, v=v)
        for b in range(c):
            rows = slice(b * (m // TD), (b + 1) * (m // TD))
            hatW[:, (j + b) * TD:(j + b + 1) * TD] = to_block(hat[rows], m)
            states[j + b] = st[rows]
        j += c
    return hatW, states


def _trellis(Wr, H, lut, KV, v, order, beam=0):
    m, n = Wr.shape
    L = D = None
    if beam > 0:
        # the beam runs inside LDLQ, on the LDL blocks of H (without one,
        # no feedback and identity blocks)
        if H is not None:
            L, D = block_ldl(regularize_h(H.to(torch.float32)), TD)
        else:
            L = torch.zeros((n, n), dtype=torch.float32, device=Wr.device)
            D = torch.eye(TD, dtype=torch.float32,
                          device=Wr.device).expand(n // TD, TD, TD)
    else:
        L = _ldl(H, TD)
    hatW, states = _trellis_blocks(Wr, L, lut, [KV] * (n // TD), v, order,
                                   D, beam)
    return hatW, packing.pack_trellis(_stack_tile_codes(states, m, n), KV,
                                      v=v)


def quantize_mat_tcq(Wr, H, KV: int, use_hess: bool = False, beam: int = 0):
    """quantlut_sym trellis (tcq_{KV}): KV/2 bits a weight, V=2.  beam > 0
    refines each tile's Viterbi states by a Hessian-weighted beam of that
    width (quant/beam.py; the reference's quality tool, slow)."""
    tlut_bits = tlut_bits_for_kv(KV)
    lut = trellis_lut(tlut_bits).to(Wr.device)
    hatW, packed = _trellis(Wr, H if use_hess else None, lut, KV, 2, "rows",
                            beam)
    linear = {"kind": "tcq", "KV": KV, "tlut_bits": tlut_bits,
              "trellis": _words(packed),
              "in_features": Wr.shape[1], "out_features": Wr.shape[0]}
    return linear, hatW


def quantize_mat_tcq1(Wr, H, KV: int, mode: str = "1mad",
                      use_hess: bool = False, beam: int = 0):
    """V=1 arithmetic trellis (1mad / 2mad), KV bits a weight, k-major;
    beam as in quantize_mat_tcq."""
    lut = trellis_lut_arith(mode).to(Wr.device)
    hatW, packed = _trellis(Wr, H if use_hess else None, lut, KV, 1,
                            "kmajor", beam)
    linear = {"kind": "tcq1", "KV": KV, "decode_mode": mode,
              "trellis": _words(packed),
              "in_features": Wr.shape[1], "out_features": Wr.shape[0]}
    return linear, hatW


def quantize_mat_tcq2(Wr, H, KV: int, use_hess: bool = False,
                      mode: str = "dualmad"):
    """V=2 arithmetic trellis (dualmad 'tcq2', sum2 'tcq2s'), KV/2 bits a
    weight, paired-k-major."""
    lut = trellis_lut_arith(mode).to(Wr.device)
    hatW, packed = _trellis(Wr, H if use_hess else None, lut, KV, 2, "pairk")
    linear = {"kind": "tcq2", "KV": KV, "decode_mode": mode,
              "trellis": _words(packed),
              "in_features": Wr.shape[1], "out_features": Wr.shape[0]}
    return linear, hatW


def quantize_mat_combt(Wr, H, KV1: int, KV2: int, use_hess: bool = False):
    """Input-split fractional TCQ (tcomb): columns [0, n/2) at KV1, the
    rest at KV2, one LDLQ recursion switching at the midpoint; each half
    packed at its own rate."""
    m, n = Wr.shape
    tlut_bits = tlut_bits_for_kv(max(KV1, KV2))
    lut = trellis_lut(tlut_bits).to(Wr.device)
    half = (n // 2) // TD
    kvs = [KV1] * half + [KV2] * (n // TD - half)
    hatW, st = _trellis_blocks(Wr, _ldl(H if use_hess else None, TD), lut,
                               kvs, 2, "rows")
    p1 = packing.pack_trellis(_stack_tile_codes(st[:half], m, n // 2), KV1)
    p2 = packing.pack_trellis(_stack_tile_codes(st[half:], m, n - n // 2),
                              KV2)
    linear = {"kind": "tcomb", "KV1": KV1, "KV2": KV2,
              "tlut_bits": tlut_bits,
              "trellis1": _words(p1), "trellis2": _words(p2),
              "in_part": (n // 2, n // 2),
              "in_features": n, "out_features": m}
    return linear, hatW


def quantize_mat_comb(Wr, H, KV1: int, KV2: int, out_part,
                      use_hess: bool = False):
    """Output-split fractional TCQ (comb): rows [0, m0) at KV1, the rest
    at KV2, m0 = out_part[0] rounded down to 16; two independent TCQ
    runs."""
    m0 = out_part[0] - out_part[0] % TD
    l1, hat1 = quantize_mat_tcq(Wr[:m0], H, KV1, use_hess)
    l2, hat2 = quantize_mat_tcq(Wr[m0:], H, KV2, use_hess)
    linear = {"kind": "comb", "KV1": KV1, "KV2": KV2,
              "tlut_bits": l1["tlut_bits"],
              "trellis1": l1["trellis"], "trellis2": l2["trellis"],
              "out_part": (m0, Wr.shape[0] - m0),
              "in_features": Wr.shape[1], "out_features": Wr.shape[0]}
    return linear, torch.cat([hat1, hat2])


def nearest(E: torch.Tensor, lutf: torch.Tensor,
            norms: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codeword of each row of E (rows, vec): argmin
    of |c|^2 - 2 e.c, lowest index on a tie."""
    with full_f32():
        return torch.addmm(norms, E, lutf.T, alpha=-2.0).argmin(1)


def quantize_mat_vq(Wr, H, bits: int, vec: int, use_hess: bool = False):
    """SQ/VQ through LDLQ (ldlq_{vec}_{bits}): the nearest of the 2^bits
    codewords of the committed (or generated) codebook, vec columns at a
    time, packed in the row-pack."""
    m, n = Wr.shape
    lutf = torch.as_tensor(vq_lut(bits, vec, device=Wr.device),
                           device=Wr.device)
    norms = (lutf * lutf).sum(1)
    L = _ldl(H if use_hess else None, vec)
    if L is None:
        vecs = Wr.to(torch.float32).reshape(-1, vec)
        rows = max(1, DIST_BYTES // (4 << bits))
        idx = torch.cat([nearest(vecs[r:r + rows], lutf, norms)
                         for r in range(0, vecs.shape[0], rows)])
        idxs = idx.reshape(m, n // vec)
        hatW = lutf[idx].reshape(m, n)
    else:
        def qblock(E, _idx):
            i = nearest(E, lutf, norms)
            return lutf[i], i
        hatW, codes = ldlq(Wr, L, qblock, block=vec)
        idxs = torch.stack(codes, 1)
    linear = {"kind": "vq", "bits": bits, "vec": vec,
              "qweight": _words(packing.pack_rows(idxs, bits)),
              "in_features": n, "out_features": m}
    return linear, hatW
