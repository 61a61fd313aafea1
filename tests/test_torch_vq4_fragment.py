"""The vec-4 K8 GEMV (csrc/vq.cu, vq4_gemv_kernel) emulated in torch from
its lane map and held to vq_gemv_plain, for bits 4-12 (ldlq_4_{4-12}):

  - the table: 8-byte entries (the bf16x2 of a codebook row's values 0, 1
    and of 2, 3), 2^gemv4_copy_bits(bits) copies, copy r of entry e at
    byte 8 * ((e << copy_bits) + r); lane l reads copy l mod copies
    through (window << shift) masked, OR the lane's byte offset;
  - a stage: one chunk (128 positions, 4*bits words) of an m-tile's 16
    rows, each row as the bits + 1 16-byte pieces from its 16-byte floor
    (4*(row & 3) bytes before its first word), piece u = 32t + lane of a
    lane's copies, the sizes cut at the pack's end (the last tile's last
    chunk), the rows a stride of the ring's row words apart; rows past m
    read row m - 1;
  - lane (g, c)'s run: positions 32c .. 32c+31 of rows g and g+8, `bits`
    words of each row from the stage; MMA j takes run position j: A
    registers a0 / a1 = word 0 of rows g / g+8 (values 0, 1 at k slots 2c,
    2c+1), a2 / a3 their word 1 (k slots 2c+8, 2c+9); B column g = x row g
    at the lane's columns 128c + 4j .. 128c + 4j + 3 (columns past N read
    row N - 1 and are never stored);
  - the k-split and its sum order: warp w of the GEMV_WARPS that share a
    tile takes the chunks [nc*w/8, nc*(w+1)/8) (none where nc < 8); MMA j
    of each of them into accumulator j % GEMV4_ACC, chunk by chunk; the
    accumulators summed in order, then the warps' C fragments in warp order
    (C element (row, n) in lane 4*(row % 8) + n // 2, register 2*(row //
    8) + n % 2).

Each MMA's products are exact (float64, summed in a fixed order) and its
sum is rounded to float32 onto its accumulator, so every step is
elementwise and a row's result depends only on the order that k and the
kernel's constants give it: the rows of a slice of the row-pack come out
bit-equal to the same rows of the whole.  Mutated emulations (a0 and a2
swapped, x in the MMA's natural k order, the lanes' copy offsets a bit too
far, a stage without its rows' 4*(row & 3) byte offset, a k-split chosen
from the m-tiles) must fail.

  python -m pytest tests/test_torch_vq4_fragment.py -q
"""

import numpy as np
import pytest
import torch

from qpalette_tpu_torch.kernels import vq

_M32 = 0xFFFFFFFF
CHUNK = 128  # positions a chunk (vq.ALIGN_P)
COLS = 4 * CHUNK  # x columns a chunk
M = 37  # three m-tiles, the last with 5 rows
BITS = range(4, 13)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: parallel test workers, each with a thread a
    core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _table(lut, copy_bits):
    """The shared-memory table as (entries << copy_bits, 2) words (int64):
    an 8-byte entry's two words, its copies adjacent."""
    b = lut.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    ent = torch.stack([b[:, 0] | (b[:, 1] << 16), b[:, 2] | (b[:, 3] << 16)],
                      1)
    assert ent.shape[0] << (3 + copy_bits) <= 1 << vq.GEMV_TABLE_BITS
    return ent.repeat_interleave(1 << copy_bits, dim=0)


def _stages(words, bits, m, k):
    """(mtiles, nc, 16 * row bytes) uint8: every (m-tile, chunk) stage as
    a warp's copies fill it, and the stage row stride in bytes."""
    pieces = bits + 1
    row_bytes = 4 * _ring_row_words(bits, pieces)
    assert row_bytes >= 16 * pieces
    pack = words.numpy().view(np.uint8).reshape(-1)
    total, ldw = pack.size, words.shape[1]
    nc, mtiles = k // COLS, -(-m // 16)
    copies = -(-16 * pieces // 32)  # a lane's
    out = np.zeros((mtiles, nc, 16 * row_bytes), np.uint8)
    for mt in range(mtiles):
        for ch in range(nc):
            fast = mt < mtiles - 1 or ch + 1 < nc
            for t in range(copies):
                for lane in range(32):
                    u = 32 * t + lane
                    if u >= 16 * pieces:
                        continue
                    r, p = divmod(u, pieces)
                    row = min(16 * mt + r, m - 1)
                    src = 4 * row * ldw - 4 * (row & 3) + 16 * (p + bits * ch)
                    assert src % 16 == 0 and (not fast or src + 16 <= total)
                    n = max(0, min(16, total - src))
                    out[mt, ch, r * row_bytes + 16 * p:][:n] = pack[src:
                                                                    src + n]
    return out, row_bytes


def _runs(words, bits, m, k, mutate):
    """run[h] (mtiles, nc, 32, bits): the words lane (g, c) reads for rows
    g + 8h from the stages."""
    stages, row_bytes = _stages(words, bits, m, k)
    mtiles, nc = stages.shape[:2]
    lane = np.arange(32)
    g, c = lane >> 2, lane & 3
    runs = []
    for h in (0, 1):
        row = np.minimum(16 * np.arange(mtiles)[:, None] + g + 8 * h, m - 1)
        off = (g + 8 * h) * row_bytes + 4 * c * bits  # (32,)
        if mutate != "stage_floor":
            off = off + 4 * (row & 3)  # (mtiles, 32)
        off = np.broadcast_to(off, (mtiles, 32))
        b = off[:, None, :, None] + 4 * np.arange(bits)  # (mt, 1, 32, bits)
        st = stages.astype(np.int64)
        mi = np.arange(mtiles)[:, None, None, None]
        ci = np.arange(nc)[None, :, None, None]
        runs.append(torch.from_numpy(st[mi, ci, b] | st[mi, ci, b + 1] << 8
                                     | st[mi, ci, b + 2] << 16
                                     | st[mi, ci, b + 3] << 24))
    return runs


def _bf16(bits16):
    b = bits16 & 0xFFFF
    return torch.where(b >= 1 << 15, b - (1 << 16), b).to(
        torch.int16).view(torch.bfloat16).double()


def _emulate(x, words, lut, bits, m, k, mutate=None):
    """y (N, m) as vq4_gemv_kernel computes it, from the lane's view."""
    N = x.shape[0]
    copy_bits = vq.gemv4_copy_bits(bits)
    shift = 3 + copy_bits  # entry e at byte e << shift
    table = _table(lut, copy_bits)
    nc, mtiles = k // COLS, -(-m // 16)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    run = _runs(words, bits, m, k, mutate)
    if mutate != "stage_floor":  # the stages hold each row's words
        u = words.to(torch.int64) & _M32
        wcol = (torch.arange(nc)[:, None, None] * 4 * bits
                + c[None, :, None] * bits + torch.arange(bits))
        assert int(wcol.max()) < words.shape[1] - 1  # never the pad word
        for h in (0, 1):
            rows = torch.clamp(16 * torch.arange(mtiles)[:, None] + g + 8 * h,
                               max=m - 1)
            assert torch.equal(run[h], u[rows[:, None, :, None], wcol[None]])
    lo = (lane & ((1 << copy_bits) - 1)) << (4 if mutate == "copy_shift"
                                             else 3)

    def look(w, q, word):  # a word of the entry of run position q
        o = q * bits
        i, sh = o >> 5, o & 31
        if sh + bits > 32:  # __funnelshift_r(w[i], w[i + 1], sh - shift)
            v = ((w[..., i] >> (sh - shift))
                 | (w[..., i + 1] << (32 - sh + shift))) & _M32
        elif sh >= shift:
            v = w[..., i] >> (sh - shift)
        else:
            v = (w[..., i] << (shift - sh)) & _M32
        off = (v & (((1 << bits) - 1) << shift)) | lo
        return table[(off >> 3) % table.shape[0], word]

    xp = x.to(torch.bfloat16).double()[torch.clamp(g, max=N - 1)]  # (32, k)
    prods = []  # MMA j's exact products, (mtiles, nc, 16, 8)
    for j in range(COLS // 16):
        a = [look(run[0], j, 0), look(run[1], j, 0), look(run[0], j, 1),
             look(run[1], j, 1)]
        if mutate == "swap_a02":
            a[0], a[2] = a[2], a[0]
        A = torch.zeros((mtiles, nc, 16, 16), dtype=torch.float64)
        for r, (row, col) in enumerate(((g, 2 * c), (g + 8, 2 * c),
                                        (g, 2 * c + 8), (g + 8, 2 * c + 8))):
            A[:, :, row, col] = _bf16(a[r])
            A[:, :, row, col + 1] = _bf16(a[r] >> 16)
        base = torch.arange(nc)[:, None] * COLS
        if mutate == "natural_x":
            x0, x1 = base + 16 * j + 2 * c, base + 16 * j + 2 * c + 8
        else:
            x0 = base + CHUNK * c + 4 * j
            x1 = x0 + 2
        B = torch.zeros((nc, 16, 8), dtype=torch.float64)
        for i in (0, 1):
            B[:, 2 * c + i, g] = xp[lane, x0 + i]
            B[:, 2 * c + 8 + i, g] = xp[lane, x1 + i]
        P = torch.zeros((mtiles, nc, 16, 8), dtype=torch.float64)
        for kk in range(16):  # a fixed order: elementwise, exact
            P = P + A[..., :, kk, None] * B[None, :, kk, None, :]
        prods.append(P)
    S = (min(vq.GEMV_WARPS, 2 * mtiles) if mutate == "split_from_m"
         else vq.GEMV_WARPS)
    red = []  # each warp's C fragments (mtiles, 32, 4), in warp order
    for s in range(S):
        acc = [torch.zeros((mtiles, 16, 8)) for _ in range(vq.GEMV4_ACC)]
        for ch in range(nc * s // S, nc * (s + 1) // S):
            for j, P in enumerate(prods):
                a = j % vq.GEMV4_ACC
                acc[a] = (acc[a].double() + P[:, ch]).float()
        D = acc[0]
        for a in acc[1:]:
            D = D + a
        red.append(torch.stack([D[:, g, 2 * c], D[:, g, 2 * c + 1],
                                D[:, g + 8, 2 * c], D[:, g + 8, 2 * c + 1]],
                               -1))
    row = torch.arange(16)[:, None]
    n = torch.arange(8)[None]
    src, comp = 4 * (row & 7) + (n >> 1), 2 * (row >> 3) + (n & 1)
    y = torch.zeros((mtiles, 16, 8))
    for r in red:  # in warp order
        y = y + r[:, src, comp]
    return y.permute(2, 0, 1).reshape(8, 16 * mtiles)[:N, :m]


def _case(bits, nc, N, seed, m=M):
    rng = np.random.default_rng(seed)
    k = nc * COLS
    words = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (m, vq.row_words(k, bits, 4))).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    # a seeded stand-in codebook (no vec-4 codebook is committed; the
    # layout does not depend on the values)
    lut = torch.from_numpy(rng.standard_normal((1 << bits, 4)).astype(
        np.float32))
    return x, words, lut, k


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("bits", BITS)
def test_vq4_fragment_matches_plain(bits):
    """Every vec-4 bits, N = 1 and 8, k of three and eleven chunks (five
    warps of the eight without one, and warps of one and two chunks), m =
    37: the emulated kernel gives vq_gemv_plain's y up to the order of the
    f32 sums."""
    for nc in (3, 11):
        for N in (1, 8):
            x, words, lut, k = _case(bits, nc, N, seed=1000 * bits + 10 * nc
                                     + N)
            got = _emulate(x, words, lut, bits, M, k)
            want = vq.vq_gemv_plain(x, words, lut, bits, 4, M, k)
            assert got.shape == want.shape == (N, M)
            assert _rel(got, want) < 1e-6, (nc, N)


@pytest.mark.parametrize("mutate", ["swap_a02", "natural_x", "copy_shift",
                                    "stage_floor"])
def test_vq4_fragment_mutation_fails(mutate):
    """The check has teeth: a0 and a2 swapped, B taken from x in the MMA's
    natural k order, the lanes' copies read a bit too far, or a stage read
    without its rows' 4*(row & 3) byte offset is far from the plain
    version (bits 8, N = 8)."""
    x, words, lut, k = _case(8, 3, 8, seed=7 * 8 + 4)
    got = _emulate(x, words, lut, 8, M, k, mutate=mutate)
    want = vq.vq_gemv_plain(x, words, lut, 8, 4, M, k)
    assert _rel(got, want) > 1e-2


def _slices_equal(bits, mutate=None):
    """The rows of slices of the row-pack (whole m-tiles and not) against
    the same rows of the whole, k of eight chunks (one a warp)."""
    x, words, lut, k = _case(bits, 8, 8, seed=31 * bits)
    whole = _emulate(x, words, lut, bits, M, k, mutate=mutate)
    same = []
    for r0, r1 in ((16, 32), (5, 30), (0, 21)):
        part = _emulate(x, words[r0:r1].contiguous(), lut, bits, r1 - r0, k,
                        mutate=mutate)
        same.append(torch.equal(part.view(torch.int32),
                                whole[:, r0:r1].contiguous().view(
                                    torch.int32)))
    return same


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_vq4_sum_order_is_fixed_by_k(bits):
    """A row's sum order depends on k alone: a column-parallel rank's rows
    (a slice of the row-pack) are bit-equal to the whole's."""
    assert all(_slices_equal(bits))


def test_vq4_sum_order_mutation_fails():
    """A k-split chosen from the m-tiles gives a slice other bits."""
    assert not all(_slices_equal(8, mutate="split_from_m"))
