"""The decode GEMVs' fragment algebra on the CPU, shared by the rehearsals
of tcq2_gemv.cu's v2_gemv_kernel and tcq1_gemv.cu's v1_gemv_kernel
(test_torch_arith.py) and arith_wide.cuh's wide_gemv_kernel
(wide_fragment.py): a lane's 16-bit state windows in the V=2 and V=1
tile orders, its hash bytes and weights, byte permutes, and the C
fragment's layout."""

import torch

from qpalette_tpu_torch.ops import codebooks

M32 = 0xFFFFFFFF
# a8: per mode, the MMAs of a tile as (the hash of a window u, the byte
# permutes of the x word that give B registers b0 and b1)
S8_MMAS = {
    "sum2": [(lambda u: (u * codebooks.MAD1_A + codebooks.MAD1_B) & M32,
              (0x1100, 0x3322))],
    "dualmad": [(lambda u: (u * codebooks.MAD1_A) & M32, (0x0000, 0x2222)),
                (lambda u: (u * codebooks.MAD2_A) & M32, (0x1111, 0x3333))],
}


def prmt(w, sel):
    """__byte_perm(w, 0, sel): byte i of the result is byte sel[4i..4i+3]
    of w (selectors < 4 here)."""
    return sum(((w >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def sbytes(w):
    """(...) 32-bit words -> (..., 4) signed bytes, byte 0 first."""
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], -1)
    return torch.where(b >= 128, b - 256, b)


def lane_windows(words, KV):
    """(T, 32 lanes, 4 registers) 16-bit windows of v2_gemv_kernel's lane
    states: lane (g, c) cuts states s0 = 16c + 2g and s0+1 from one funnel
    shift of words w0, w0+1, and s0+64, s0+65 from words w0 + 2*KV and the
    next (wrapping the tile's circular stream)."""
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    off = KV * (16 * c + 2 * g)
    w0, sh = off >> 5, off & 31
    w2 = w0 + 2 * KV
    w3 = torch.where(w2 + 1 == 4 * KV, 0, w2 + 1)
    assert bool((w3 == 0).any())  # state 127's window wraps the stream
    u = words.to(torch.int64) & M32

    def funnel(lo, hi):  # __funnelshift_r(lo, hi, sh)
        return ((lo >> sh) | (hi << (32 - sh))) & M32

    f0, f1 = funnel(u[:, w0], u[:, w0 + 1]), funnel(u[:, w2], u[:, w3])
    return torch.stack([f0, f0 >> KV, f1, f1 >> KV], -1) & 0xFFFF


def lane_weights(u, mode):
    """(..., 2) integer weights (w0, w1) of each window, as the exact tile
    function decodes them."""
    if mode == "sum2":
        sb = sbytes(S8_MMAS["sum2"][0][0](u))
        return torch.stack([sb[..., 0] + sb[..., 1],
                            sb[..., 2] + sb[..., 3]], -1)
    # dualmad: each signed byte sum through the f32 bits of 1.5*2^23 + w
    # minus 1.5*2^23, as dual_weight computes it; tf32 (the low 13 bits
    # ignored) holds it
    ws = []
    for hash_fn, _ in S8_MMAS["dualmad"]:
        w = sbytes(hash_fn(u)).sum(-1)
        bits = (0x4B400000 + w).to(torch.int32)
        f = bits.view(torch.float32) - torch.tensor(12582912.0)
        tf32 = (f.view(torch.int32) & ~0x1FFF).view(torch.float32)
        assert torch.equal(tf32, w.to(torch.float32))
        ws.append(tf32.to(torch.int64))
    return torch.stack(ws, -1)


def unpermute(frag):
    """(..., 32 lanes, 4 registers) C fragment -> (..., 16 tile rows, 8):
    the kernel's epilogue, element (row, n) from lane 4*(row/2) + n/2,
    register 2*(row%2) + n%2."""
    row = torch.arange(16)[:, None]
    n = torch.arange(8)[None, :]
    return frag[..., 4 * (row >> 1) + (n >> 1), 2 * (row & 1) + (n & 1)]


def c_frag(C, g, c):
    """(mt, 16, 8) C -> (mt, 32 lanes, 4) fragment registers: c0, c1 row
    g, columns 2c, 2c+1; c2, c3 row g+8."""
    return torch.stack([C[:, g, 2 * c], C[:, g, 2 * c + 1],
                        C[:, g + 8, 2 * c], C[:, g + 8, 2 * c + 1]], -1)


def v1_hash(u, mode):
    if mode == "1mad":
        return (u * codebooks.MAD1_A + codebooks.MAD1_B) & M32
    h0 = (u * codebooks.MAD2_A + codebooks.MAD2_B) & M32
    return (h0 + ((h0 * codebooks.MAD2_C) >> 32)) & M32


def v1_lane_windows(words, KV):
    """(T, 32 lanes, 4 pairs, 2) 16-bit windows of v1_gemv_kernel's lane
    states: lane (g, c) decodes s0 = 64c + 2g plus 16p + i (pair p, state
    i), pair p from one funnel shift of two words.  lane_map1's offsets:
    pairs 0 and 2 at words w0 and w0 + KV, shift sh0; pairs 1 and 3 at o1
    and o1 + KV, shift sh1 (even KV: o1 = w0 + KV/2, sh1 = sh0); only pair
    3's second word is a separate offset, which wraps the stream."""
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    W = 8 * KV
    b0 = KV * (64 * c + 2 * g)
    b1 = b0 + 16 * KV
    w0, sh0 = b0 >> 5, b0 & 31
    w1, sh1 = ((b1 >> 5, b1 & 31) if KV % 2 else (w0 + KV // 2, sh0))
    w3 = (b1 >> 5) + KV + 1
    w3 = torch.where(w3 == W, 0, w3)
    lo, hi = [w0, w1, w0 + KV, w1 + KV], [w0 + 1, w1 + 1, w0 + KV + 1, w3]
    sh = [sh0, sh1, sh0, sh1]
    for p in range(4):  # each pair's words and shift are its first state's
        bits = KV * (64 * c + 2 * g + 16 * p)
        nxt = (bits >> 5) + 1
        assert torch.equal(lo[p], bits >> 5) and torch.equal(sh[p], bits & 31)
        assert torch.equal(hi[p], torch.where(nxt == W, 0, nxt))
        assert p == 3 or bool((nxt < W).all())
        assert bool(((bits & 31) + KV + 16 <= 32 + 31).all())
    assert bool((w3 == 0).any())  # state 254's pair wraps the stream
    u = words.to(torch.int64) & M32

    def funnel(a, b, s):  # __funnelshift_r(word a, word b, s)
        return ((u[:, a] >> s) | (u[:, b] << (32 - s))) & M32

    f = torch.stack([funnel(lo[p], hi[p], sh[p]) for p in range(4)], -1)
    return torch.stack([f & 0xFFFF, (f >> KV) & 0xFFFF], -1)
