"""The fragment algebra of the tensor-core K8 GEMV at vec 1 and 2
(csrc/vq.cu, vq_gemv_kernel), emulated in torch from its lane map and held
to vq_gemv_plain, for the 17 ldlq (bits, vec) pairs it takes (vec 4 has a
kernel of its own: tests/test_torch_vq4_fragment.py):

  - lane (g, c)'s run: positions 32c .. 32c+31 of a 128-position chunk of
    rows g and g+8 of an m-tile, exactly `bits` words of each row (rows
    past m read row m - 1), read from the warp's ring: a stage holds one
    or two chunks of the tile's 16 rows (both are emulated), each row as
    the chunks*bits + 1 16-byte pieces from its 16-byte floor (the lane ->
    piece map of the copies, sizes cut at the pack's end, the stage row
    stride); each window's word and shift, a funnel shift for a window
    across two words;
  - the replicated table: 32-bit entries, entry e's copies at words
    (e << copy_bits) + r, lane l reading copy l mod 2^copy_bits through
    (window << shift) masked, OR the lane's byte offset; vec 2 a bf16x2
    codebook row, vec 1 at bits <= 4 a pair table indexed by two adjacent
    windows, vec 1 at bits 5-8 a bf16 entry (two reads and a PRMT a
    register);
  - MMA j of a chunk: A registers a0/a2 = rows g, a1/a3 = rows g+8, k slots
    (2c, 2c+1) and (2c+8, 2c+9) from run positions 2j and 2j+1 (vec 2) or
    4j, 4j+1 and 4j+2, 4j+3 (vec 1);
    B = x row g at the run's columns
    4j .. 4j+3 of the lane's columns (zero for rows n >= N); one m16n8k16
    product;
  - C element (row, n) in lane 4*(row % 8) + n // 2, register
    2*(row // 8) + n % 2; the 8 warps' contiguous chunk ranges summed in
    warp order.

A mutated emulation (a0 and a2 swapped, or x read in the MMA's natural k
order) must fail.

  python -m pytest tests/test_torch_vq_fragment.py -q    # -k vq_fragment
"""

import numpy as np
import pytest
import torch

from qpalette_tpu_torch.kernels import vq
from qpalette_tpu_torch.ops import codebooks

_M32 = 0xFFFFFFFF
CHUNK = 128  # positions a chunk (vq.ALIGN_P)
M = 37  # three m-tiles, the last with 5 rows
PAIRS = [(b, v) for b, v in vq.SUPPORTED if v < 4]  # vq_gemv_kernel's


def _layout(bits, vec):
    """(pair table?, bits a table read's window, log2 copies, byte shift
    of an entry) as vq_gemv_kernel's table has them."""
    pair = vec == 1 and bits <= 4
    win = 2 * bits if pair else bits
    copy_bits = min(5, vq.GEMV_TABLE_BITS - 2 - win)
    return pair, win, copy_bits, 2 + copy_bits


def _table(lut, bits, vec):
    """The shared-memory table as 32-bit words (int64), (words, 1)."""
    pair, win, copy_bits, shift = _layout(bits, vec)
    b = lut.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    e = torch.arange(1 << win)
    if vec == 2:
        ent = (b[e, 0] | (b[e, 1] << 16))[:, None]
    elif pair:
        ent = (b[e & ((1 << bits) - 1), 0] | (b[e >> bits, 0] << 16))[:, None]
    else:
        ent = b[e, 0][:, None]
    assert (1 << win) << shift <= 1 << vq.GEMV_TABLE_BITS
    return ent.repeat_interleave(1 << copy_bits, dim=0)


def _ring_row_words(bits, pieces):
    """The stage row stride in words: the least-conflicted of the lanes'
    run reads (ring_row_words of csrc/vq.cu)."""
    def conflicts(s):
        return max(max(sum((s * g + (g & 3) + bits * c + i) % 32 == b
                           for g in range(8) for c in range(4))
                       for b in range(32)) for i in range(bits))
    best = 4 * pieces
    for s in range(best + 4, best + 29, 4):
        if conflicts(s) < conflicts(best):
            best = s
    return best


def _ring_runs(words, bits, vec, m, k, chunks):
    """run[h] (mtiles, nc, 32, bits): the words lane (g, c) reads for rows
    g + 8h from its warp's ring stages of `chunks` chunks, built byte by
    byte as the copies fill them."""
    pieces, cols = chunks * bits + 1, CHUNK * vec
    pack = words.numpy().view(np.uint8).reshape(-1)
    total, ldw = pack.size, words.shape[1]
    nc, mtiles = k // cols, -(-m // 16)
    row_bytes = 4 * _ring_row_words(bits, pieces)
    assert row_bytes >= 16 * pieces
    lane = np.arange(32)
    g, c = lane >> 2, lane & 3
    runs = np.zeros((2, mtiles, nc, 32, bits), np.int64)
    for w in range(vq.GEMV_WARPS):
        c0, c1 = nc * w // vq.GEMV_WARPS, nc * (w + 1) // vq.GEMV_WARPS
        for mt in range(mtiles):
            for ich in range(c0, c1, chunks):  # a stage's first chunk
                fast = mt < mtiles - 1 or ich + chunks < nc
                stage = np.zeros(16 * row_bytes, np.uint8)
                for u in range(16 * pieces):  # piece u: lane u % 32
                    r, p = divmod(u, pieces)
                    row = min(16 * mt + r, m - 1)
                    src = 4 * row * ldw - 4 * (row & 3) + 16 * p + 16 * bits * ich
                    assert src % 16 == 0 and (not fast or src + 16 <= total)
                    n = max(0, min(16, total - src))
                    stage[r * row_bytes + 16 * p:][:n] = pack[src:src + n]
                for ch in range(ich, min(ich + chunks, c1)):
                    for h in (0, 1):
                        row = np.minimum(16 * mt + g + 8 * h, m - 1)
                        off = ((g + 8 * h) * row_bytes + 4 * (row & 3)
                               + 4 * c * bits + 16 * bits * (ch - ich))
                        for i in range(bits):
                            b = off + 4 * i
                            runs[h, mt, ch, :, i] = (
                                stage[b].astype(np.int64)
                                | stage[b + 1].astype(np.int64) << 8
                                | stage[b + 2].astype(np.int64) << 16
                                | stage[b + 3].astype(np.int64) << 24)
    return [torch.from_numpy(r) for r in runs]


def _bf16(bits16):
    b = bits16 & 0xFFFF
    return torch.where(b >= 1 << 15, b - (1 << 16), b).to(
        torch.int16).view(torch.bfloat16).float()


def _emulate(x, words, lut, bits, vec, m, k, mutate=None):
    """y (N, m) as vq_gemv_kernel computes it, from the lane's view."""
    N = x.shape[0]
    pair, win, copy_bits, shift = _layout(bits, vec)
    table = _table(lut, bits, vec)
    cols = CHUNK * vec  # x columns a chunk
    nc, mtiles = k // cols, -(-m // 16)
    mmas = 8 * vec  # 16 columns an MMA
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    u = words.to(torch.int64) & _M32
    # run[h]: (mtiles, nc, 32, bits) words of rows g + 8h, lane c's run
    mt = torch.arange(mtiles)
    wcol = (torch.arange(nc)[:, None, None] * 4 * bits
            + c[None, :, None] * bits + torch.arange(bits))
    run = [u[torch.clamp(16 * mt[:, None] + g + 8 * h, max=m - 1)[
        :, None, :, None], wcol[None]] for h in (0, 1)]
    assert int(wcol.max()) < words.shape[1] - 1  # the pad word is not read
    for chunks in (1, 2):
        ring = _ring_runs(words, bits, vec, m, k, chunks)
        assert all(torch.equal(a, b) for a, b in zip(ring, run)), chunks
    run = ring
    lo = (lane & ((1 << copy_bits) - 1)) << (shift - copy_bits)

    def look(w, q):  # the entry of the window at run position q
        o = q * bits
        i, sh = o >> 5, o & 31
        if sh + win > 32:  # __funnelshift_r(w[i], w[i + 1], sh - shift)
            v = ((w[..., i] >> (sh - shift))
                 | (w[..., i + 1] << (32 - sh + shift))) & _M32
        elif sh >= shift:
            v = w[..., i] >> (sh - shift)
        else:
            v = (w[..., i] << (shift - sh)) & _M32
        off = (v & (((1 << win) - 1) << shift)) | lo
        return table[off >> (shift - copy_bits), 0]

    def reg(w, j, hi):  # k slots 2c, 2c+1 (hi 0) or 2c+8, 2c+9 (hi 1)
        if vec == 2:
            return look(w, 2 * j + hi)
        q = 4 * j + 2 * hi
        if pair:
            return look(w, q)
        return (look(w, q) & 0xFFFF) | ((look(w, q + 1) & 0xFFFF) << 16)

    xp = torch.zeros((8, k))
    xp[:N] = x.to(torch.bfloat16).float()  # lanes g >= N hold B = 0
    D = torch.zeros((mtiles, nc, 16, 8))
    for j in range(mmas):
        a = [reg(run[0], j, 0), reg(run[1], j, 0), reg(run[0], j, 1),
             reg(run[1], j, 1)]
        if mutate == "swap_a02":
            a[0], a[2] = a[2], a[0]
        A = torch.zeros((mtiles, nc, 16, 16))
        for r, (row, col) in enumerate(((g, 2 * c), (g + 8, 2 * c),
                                        (g, 2 * c + 8), (g + 8, 2 * c + 8))):
            A[:, :, row, col] = _bf16(a[r])
            A[:, :, row, col + 1] = _bf16(a[r] >> 16)
        # B for lane (g, c): x row g at the columns of its two k-slot pairs
        base = torch.arange(nc)[:, None] * cols
        if mutate == "natural_x":
            x0, x1 = base + 16 * j + 2 * c, base + 16 * j + 2 * c + 8
        else:
            x0 = base + (cols // 4) * c + 4 * j
            x1 = x0 + 2
        B = torch.zeros((nc, 16, 8))
        for i in (0, 1):
            B[:, 2 * c + i, g] = xp[g, x0 + i]
            B[:, 2 * c + 8 + i, g] = xp[g, x1 + i]
        D += A @ B
    # lane (g, c)'s C fragment: (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)
    frag = torch.stack([D[:, :, g, 2 * c], D[:, :, g, 2 * c + 1],
                        D[:, :, g + 8, 2 * c], D[:, :, g + 8, 2 * c + 1]],
                       -1)  # (mtiles, nc, 32, 4)
    warps = vq.GEMV_WARPS
    red = torch.stack([frag[:, nc * w // warps:nc * (w + 1) // warps].sum(1)
                       for w in range(warps)])  # (warps, mtiles, 32, 4)
    row = torch.arange(16)[:, None]
    n = torch.arange(8)[None]
    src, comp = 4 * (row & 7) + (n >> 1), 2 * (row >> 3) + (n & 1)
    y = torch.zeros((mtiles, 16, 8))
    for w in range(warps):  # in warp order
        y += red[w][:, src, comp]
    return y.permute(2, 0, 1).reshape(8, 16 * mtiles)[:N, :m]


def _case(bits, vec, chunks, N, seed):
    rng = np.random.default_rng(seed)
    k = chunks * CHUNK * vec
    words = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (M, vq.row_words(k, bits, vec))).astype(
            np.int32))
    x = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    return x, words, torch.tensor(codebooks.vq_lut(bits, vec)), k


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("bits,vec", PAIRS)
def test_vq_fragment_matches_plain(bits, vec):
    """Every scheme, N = 1 and 8, k of two and three chunks, m = 37: the
    emulated kernel gives vq_gemv_plain's y up to the order of the f32
    sums."""
    for chunks in (2, 3):
        for N in (1, 8):
            x, words, lut, k = _case(bits, vec, chunks, N,
                                     seed=1000 * bits + 10 * vec + chunks + N)
            got = _emulate(x, words, lut, bits, vec, M, k)
            want = vq.vq_gemv_plain(x, words, lut, bits, vec, M, k)
            assert got.shape == want.shape == (N, M)
            assert _rel(got, want) < 1e-6, (chunks, N)


@pytest.mark.parametrize("mutate", ["swap_a02", "natural_x"])
@pytest.mark.parametrize("bits,vec", [(6, 2), (4, 1), (7, 1), (11, 2)])
def test_vq_fragment_mutation_fails(bits, vec, mutate):
    """The check has teeth: a0 and a2 swapped, or B taken from x in the
    MMA's natural k order, is far from the plain version."""
    x, words, lut, k = _case(bits, vec, 2, 8, seed=7 * bits + vec)
    got = _emulate(x, words, lut, bits, vec, M, k, mutate=mutate)
    want = vq.vq_gemv_plain(x, words, lut, bits, vec, M, k)
    assert _rel(got, want) > 1e-2
