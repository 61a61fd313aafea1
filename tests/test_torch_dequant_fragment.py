"""The dequant kernels on csrc/dequant.cuh's walk (arith_dequant.cu's K3;
tcq_lut.cu's K6, K7) emulated byte for byte in numpy from their lane maps
and held bit-equal to the plain versions:

  - the walk: a persistent grid of WARPS-warp blocks, warp w of nw taking
    groups w, w + nw, ... (a group: up to 4 k-tiles of one m-tile, 16 x 64
    of W_hat), stepped as DqCursor does, without a division: every group
    exactly once at every grid size;
  - the ring: each warp's SLOTS slots, group i of the warp in slot i %
    SLOTS as one copy of its ntile tiles' contiguous words, the rest of the
    slot stale (earlier groups' words, or garbage before);
  - K3 (V=1): lane (g, c) cuts states s, s+1 = 16*col + 8h + 2c (+1), col =
    8*((g/2)%2) + g%2 + 2j of tile 2p + g/4, from one funnel shift at the
    byte offsets V1Lane gives (the second word at j = 3 wrapping the tile's
    circular stream), packs their bf16 weights (via the float32 bits of
    1.5 * 2^23 + w) and movmatrix.trans hands it row 8h + g, columns 32p +
    8c + 2j, +1; j = 0..3 make one 16-byte store, skipped for a last
    group's missing tile;
  - K6 / K7 (LUT): lane l cuts states 8*row + 4*(l%2) + i, i = 0..3, of
    row 4*rg + l/8 of tile (l/2)%4 from two funnel shifts (LutLane's
    offsets, the second words at rg = 3 wrapping), looks each up in the
    32 KB table of 2^(13-S) copies at (h & tmask) | the lane's copy, and
    flips bit 15 by bit 15 of h; tcomb's groups of a tile-row are the
    first half's, then the second's, each copied from its own array.

Mutations that must fail: a walk that skips or repeats groups (a carry
dropped, a stride one warp too long), K7's halves swapped, a window one
bit off, the wrap dropped, the rows of a stage shifted.

  python -m pytest tests/test_torch_dequant_fragment.py -q
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpalette_tpu_torch.kernels import arith, arith_dequant, tcq_lut
from qpalette_tpu_torch.kernels.arith import MAD_INV

WARPS, SLOTS, TILES = 8, 4, 4  # csrc/dequant.cuh kDqWarps, kDqSlots, kDqTiles
TAB_BITS = 15  # csrc/tcq_lut.cu kTabBits
M32 = 0xFFFFFFFF
LANE = np.arange(32)
RAGGED = [(16, 272), (48, 4128)]  # k/16 = 17 and 258: a last group of 1, 2
GRIDS = (1, 3, 64)  # blocks: fewer, and more, warps than groups


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: parallel test workers, each with a thread a
    core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk(mtiles, gr, grid, mutate=None):
    """Each warp's groups [(mt, q), ...] as DqCursor steps them."""
    nw = grid * WARPS
    step = nw + 1 if mutate == "stride" else nw
    out = []
    for w in range(nw):
        mt, q = divmod(w, gr)
        dmt, dq = divmod(step, gr)
        seq = []
        while mt < mtiles:
            seq.append((mt, q))
            mt, q = mt + dmt, q + dq
            if q > gr if mutate == "carry" else q >= gr:
                mt, q = mt + 1, q - gr
        out.append(seq)
    return out


def run_walk(words, tile_bytes, halves, m, grid, mutate=None, seed=0):
    """Every warp's groups through its ring, in walk order.  words: the
    arrays (T, W) int32 of each half, tile_bytes and halves [(its k-tiles,
    ...)] alike; a tile-row's groups are the first half's, then the
    second's.  Returns the slot each group is decoded from, (G, bytes)
    uint8 (its words, then what the slot held before), and each group's
    m-tile, tiles, first column and half, (G,) each."""
    rng = np.random.default_rng(seed)
    packs = [np.ascontiguousarray(w.numpy()).view(np.uint8).reshape(-1)
             for w in words]
    gs = [-(-kt // TILES) for kt in halves]
    slot_bytes = TILES * max(tile_bytes)
    stages, meta = [], []
    for seq in walk(m // 16, sum(gs), grid, mutate):
        ring = rng.integers(0, 256, (SLOTS, slot_bytes + 64), np.uint8)
        for it, (mt, q) in enumerate(seq):
            if q >= sum(gs):  # a mutated walk's group past the row
                continue
            half = int(q >= gs[0])
            src = 1 - half if mutate == "halves" else half
            kt, tb = halves[half], tile_bytes[half]
            j0 = TILES * (q - gs[0] * half)
            ntile = min(TILES, kt - j0)
            got = packs[src][(mt * kt + j0) * tb:][:ntile * tb]
            ring[it % SLOTS, :got.size] = got
            stages.append(ring[it % SLOTS].copy())
            meta.append((mt, ntile, 16 * (halves[0] * half + j0), half))
    return (np.stack(stages),) + tuple(np.array(meta).T)


def store(out, rows, cols, vals, ok):
    """out[rows, cols] = vals where ok: rows, ok (G, 32); cols, vals
    (G, 32, n)."""
    out[rows[ok][:, None], cols[ok]] = vals[ok]


def words_at(st, off):
    """The 32-bit little-endian words at byte offsets off (32,) of each
    stage st (G, bytes): (G, 32)."""
    idx = np.asarray(off)[..., None] + np.arange(4)
    b = st[np.arange(st.shape[0])[:, None, None], idx].astype(np.uint64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def funnel(a, b, sh):
    return ((b << np.uint64(32) | a) >> np.asarray(sh, np.uint64)) & M32


def bf16_bits(f32):
    return (torch.from_numpy(np.asarray(f32, np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy().astype(np.uint64) & 0xFFFF)


def v1_weights(u, mode):
    """Unscaled integer weights of the 16-bit windows in bits [0, 16) of u
    (1mad, 2mad): the unsigned byte sum of the hash - 510."""
    u = u & 0xFFFF
    if mode == "1mad":
        h = (u * 34038481 + 76625530) & M32
    else:
        h0 = (u * 264435761 + 1013904223) & M32
        h = (h0 + ((h0 * 1664525) >> np.uint64(32))) & M32
    return sum(((h >> np.uint64(8 * i)) & 0xFF).astype(np.int64)
               for i in range(4)) - 510


def scaled_bf16(w):
    """float32(w) * float32(1/147.8...), rounded to bf16: its bits."""
    return bf16_bits(np.asarray(w, np.float32) * np.float32(MAD_INV))


def v1_lane(KV, mutate=None):
    """V1Lane: (o, o3, sh), each two arrays of 32 lanes (h = 0, 1)."""
    W = 8 * KV
    g, c = LANE >> 2, LANE & 3
    tile = (g >> 2) * 4 * W
    col = 8 * ((g >> 1) & 1) + (g & 1)
    o, o3, sh = [], [], []
    for h in (0, 1):
        off = KV * (16 * col + 8 * h + 2 * c) + (mutate == "window")
        w0 = off >> 5
        w3 = w0 + 3 * KV + 1
        o.append(tile + 4 * w0)
        o3.append(tile + 4 * (w3 if mutate == "wrap" else
                              np.where(w3 == W, 0, w3)))
        sh.append(off & 31)
    return o, o3, sh


def halves16(words):
    """(G, 32, 2n): the 16-bit halves of n words (G, 32) a lane, low half
    first."""
    return np.stack([w >> np.uint64(16 * i) & 0xFFFF for w in words
                     for i in (0, 1)], axis=2)


def movm_trans(words):
    """movmatrix.sync.aligned.m8n8.trans.b16 of the 32 lanes' words (G,
    32): lane (g, c) holds row g, columns 2c, 2c+1 of an 8x8 matrix before,
    of its transpose after."""
    g, c = LANE >> 2, LANE & 3
    mat = np.zeros((words.shape[0], 8, 8), np.uint64)
    mat[:, g, 2 * c] = words & 0xFFFF
    mat[:, g, 2 * c + 1] = words >> np.uint64(16)
    t = mat.transpose(0, 2, 1)
    return t[:, g, 2 * c] | t[:, g, 2 * c + 1] << np.uint64(16)


def emulate_k3(words, mode, KV, m, k, grid, mutate=None):
    out = np.full((m, k), 0x7FC1, np.uint64)  # never a decoded weight
    o, o3, sh = v1_lane(KV, mutate)
    g, c = LANE >> 2, LANE & 3
    st, mt, ntile, col0, _ = run_walk([words], [32 * KV], [k // 16], m, grid,
                                      mutate)
    for p in range(2):  # tiles 2p, 2p+1 (a group of fewer skips them)
        sp = st[:, 2 * p * 32 * KV:]
        for h in (0, 1):
            r = []
            for j in range(4):
                a = words_at(sp, o[h] + 4 * KV * j)
                b = words_at(sp, o3[h] if j == 3 else o[h] + 4 * KV * j + 4)
                f = funnel(a, b, sh[h])
                lo = scaled_bf16(v1_weights(f, mode))
                hi = scaled_bf16(v1_weights(f >> np.uint64(KV), mode))
                r.append(movm_trans(lo | hi << np.uint64(16)))
            rows = (16 * mt[:, None] + 8 * h
                    + (g + (mutate == "rows")) % 8)
            cols = col0[:, None, None] + 32 * p + 8 * c[:, None] + np.arange(8)
            store(out, rows, cols, halves16(r),
                  2 * p + (c >> 1) < ntile[:, None])
    return out


def table(tlut):
    """The 32 KB shared table as words: 2^(13-S) copies of each entry."""
    S = tlut.shape[0].bit_length() - 1
    b = bf16_bits(tlut.numpy())
    return np.repeat(b[:, 0] | b[:, 1] << np.uint64(16), 1 << (13 - S))


def lut_lane(KV, mutate=None):
    """LutLane: (a, b, a3, b3, sa, sb) of the 32 lanes."""
    W = 4 * KV
    tile = ((LANE >> 1) & 3) * 4 * W
    offa = KV * (8 * (LANE >> 3) + 4 * (LANE & 1)) + (mutate == "window")
    offb = offa + 2 * KV
    wa, wb = offa >> 5, offb >> 5
    wrap = (lambda x: x) if mutate == "wrap" else (
        lambda x: np.where(x == W, 0, x))
    return (tile + 4 * wa, tile + 4 * wb, tile + 4 * wrap(wa + 3 * KV + 1),
            tile + 4 * wrap(wb + 3 * KV + 1), offa & 31, offb & 31)


def emulate_lut(words, tlut, KVs, m, k, grid, mutate=None):
    """K6 (one half) or K7 (two)."""
    out = np.full((m, k), 0x7FC1, np.uint64)
    S = tlut.shape[0].bit_length() - 1
    tab = table(tlut)
    tmask = np.uint64(((1 << S) - 1) << (TAB_BITS - S))
    lcb = ((LANE & ((1 << (TAB_BITS - 2 - S)) - 1)) << 2).astype(np.uint64)
    lanes = [lut_lane(kv, mutate) for kv in KVs]
    col = 16 * ((LANE >> 1) & 3) + 8 * (LANE & 1)
    kh = k // len(KVs)

    def pair(f):
        h = (f * (f + 1)) & M32
        e = tab[((h & tmask) | lcb) >> np.uint64(2)]
        return e ^ (h & 0x8000)

    st, mt, ntile, col0, half = run_walk(words, [16 * kv for kv in KVs],
                                         [kh // 16] * len(KVs), m, grid,
                                         mutate)
    for i, KV in enumerate(KVs):
        a, b, a3, b3, sa, sb = lanes[i]
        sel = half == i
        for rg in range(4):
            d = 4 * KV * rg
            fa = funnel(words_at(st[sel], a + d),
                        words_at(st[sel], a3 if rg == 3 else a + d + 4), sa)
            fb = funnel(words_at(st[sel], b + d),
                        words_at(st[sel], b3 if rg == 3 else b + d + 4), sb)
            e = [pair(fa), pair(fa >> np.uint64(KV)), pair(fb),
                 pair(fb >> np.uint64(KV))]
            rows = 16 * mt[sel, None] + (4 * rg + (LANE >> 3)
                                         + (mutate == "rows")) % 16
            cols = col0[sel, None, None] + col[:, None] + np.arange(8)
            store(out, rows, cols, halves16(e),
                  ((LANE >> 1) & 3) < ntile[sel, None])
    return out


def seeded_words(m, k, W, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                         ((m // 16) * (k // 16), W),
                                         dtype=np.int64).astype(np.int32))


def seeded_tlut(S, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((1 << S, 2))
                            .astype(np.float32))


def bits(w):
    return w.view(torch.int16).numpy().astype(np.uint64) & 0xFFFF


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("m,k", RAGGED + [(4096, 4096)])
def test_walk_takes_every_group_once(m, k, grid):
    for gr in (-(-(k // 16) // TILES), 2 * -(-(k // 32) // TILES)):
        taken = [g for seq in walk(m // 16, gr, grid) for g in seq]
        assert sorted(taken) == [(mt, q) for mt in range(m // 16)
                                 for q in range(gr)]


@pytest.mark.parametrize("mutate", ["carry", "stride"])
def test_walk_mutations_fail(mutate):
    m, k, grid = 48, 4128, 3
    gr = -(-(k // 16) // TILES)
    taken = [g for seq in walk(m // 16, gr, grid, mutate) for g in seq]
    assert sorted(taken) != [(mt, q) for mt in range(m // 16)
                             for q in range(gr)]


@pytest.mark.parametrize("KV", range(1, 17))
@pytest.mark.parametrize("mode", ["1mad", "2mad"])
def test_k3_emulation_bit_equal_to_plain(mode, KV):
    for i, (m, k) in enumerate(RAGGED):
        words = seeded_words(m, k, 8 * KV, seed=KV + 17 * i)
        got = emulate_k3(words, mode, KV, m, k, GRIDS[(KV + i) % 3])
        want = bits(arith_dequant.arith_dequant_plain(words, mode, KV, m, k))
        np.testing.assert_array_equal(got, want, err_msg=f"{m}x{k}")


TCOMB = [(kv, kv + 1) for kv in range(3, 10)] + [(5, 7), (2, 16), (8, 8)]


@pytest.mark.parametrize("KVs", TCOMB + [(2,), (6,), (10,), (16,)])
def test_lut_emulation_bit_equal_to_plain(KVs):
    S = tcq_lut.SUPPORTED_S[0] if max(KVs) <= 8 else min(11, max(KVs) + 1)
    tlut = seeded_tlut(S, seed=sum(KVs))
    for i, (m, k) in enumerate([(16, 544), (48, 4128)]):
        words = [seeded_words(m, k // len(KVs), 4 * kv, seed=kv + 7 * j + i)
                 for j, kv in enumerate(KVs)]
        got = emulate_lut(words, tlut, KVs, m, k, GRIDS[i])
        if len(KVs) == 2:
            ref = tcq_lut.tcomb_lut_dequant_plain(*words, tlut, *KVs, m, k)
        else:
            ref = tcq_lut.tcq_lut_dequant_plain(*words, tlut, *KVs, m, k)
        np.testing.assert_array_equal(got, bits(ref), err_msg=f"{m}x{k}")


@pytest.mark.parametrize("mutate", ["carry", "stride", "window", "wrap",
                                    "rows"])
def test_k3_mutations_fail(mutate):
    # KV 1: states 224.. wrap the stream, so the j = 3 window at h = 0
    # wraps too
    m, k, KV = 48, 4128, 1
    words = seeded_words(m, k, 8 * KV, seed=5)
    got = emulate_k3(words, "1mad", KV, m, k, 3, mutate)
    want = bits(arith_dequant.arith_dequant_plain(words, "1mad", KV, m, k))
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("mutate", ["halves", "window", "wrap", "rows"])
def test_k7_mutations_fail(mutate):
    m, k, KVs = 48, 4128, (5, 7)
    tlut = seeded_tlut(9, seed=3)
    words = [seeded_words(m, k // 2, 4 * kv, seed=kv) for kv in KVs]
    got = emulate_lut(words, tlut, KVs, m, k, 3, mutate)
    want = tcq_lut.tcomb_lut_dequant_plain(*words, tlut, *KVs, m, k)
    assert not np.array_equal(got, bits(want))


def test_words_per_group_are_whole_bulk_copies():
    """A group's words are a multiple of 16 bytes at every KV and tile
    count, so one cp.async.bulk moves it."""
    for KV in range(1, 17):
        for mode in ("1mad", "sum2"):
            tb = 4 * arith.words_per_tile(mode, KV)
            assert all(n * tb % 16 == 0 for n in range(1, TILES + 1))
        assert all(n * 16 * KV % 16 == 0 for n in range(1, TILES + 1))


CSRC = Path(__file__).resolve().parents[1] / "qpalette_tpu_torch" / "csrc"
KERNEL_DEF = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                        r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")


def _chip_smoke():
    sys.path.insert(0, str(CSRC.parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_constants_match_the_walk():
    """WARPS, SLOTS and TILES are csrc/dequant.cuh's, and both kernels on
    the walk are launched with its kDqThreads."""
    text = (CSRC / "dequant.cuh").read_text()
    for name, want in (("kDqWarps", WARPS), ("kDqSlots", SLOTS),
                       ("kDqTiles", TILES)):
        assert re.search(rf"constexpr int {name} = {want};", text), name
    for src, kern in (("arith_dequant.cu", "v1_dequant_kernel"),
                      ("tcq_lut.cu", "lut_ring_kernel")):
        text = (CSRC / src).read_text()
        assert re.search(rf"__launch_bounds__\(kDqThreads\)\s+{kern}\(",
                         text), kern
        assert re.search(rf"{kern}<[^>]*><<<grid, kDqThreads,", text), kern


def test_every_kernel_is_named_by_the_step_profile():
    """Each __global__ kernel of csrc is a GEMV or a dequant of
    chip_smoke's profile, not both, by its name as the profiler prints it,
    and each of DEQUANT_KERNELS is defined: a renamed kernel fails here,
    not as its time moved to the profile's glue."""
    cs = _chip_smoke()
    kernels = {name for f in sorted(CSRC.glob("*.cu*"))
               for name in KERNEL_DEF.findall(f.read_text())}
    assert set(cs.DEQUANT_KERNELS) <= kernels
    for name in kernels:
        shown = f"void (anonymous namespace)::{name}<8, 9>(int const*)"
        hits = (bool(cs.PORT_GEMV.search(shown)),
                bool(cs.PORT_DEQUANT.search(shown)))
        assert sum(hits) == 1, (name, hits)


def test_dequant_ops_check_counts_each_kernel():
    """dequant_ops_check holds the traced ops of each dequant kernel to
    the launches of its wrappers (Path E's step, two replays), and fails
    on a missing op or a kernel it does not know by name."""
    cs = _chip_smoke()
    want = {"tcq2_dequant": 13, "tcq1_dequant": 7, "tcq_lut_dequant": 8,
            "tcomb_lut_dequant": 8, "vq_dequant": 8, "tcq_lut_gemv": 22}

    def ops(counts):
        return [f"void (anonymous namespace)::{kern}<6, 7>(unsigned int "
                f"const*)" for kern, c in counts.items()
                for _ in range(2 * c)] + ["void gemv2T_kernel_val<int>()"] * 4

    step = {"arith_dequant_kernel": 13, "v1_dequant_kernel": 7,
            "lut_ring_kernel": 16, "vq_dequant_kernel": 8,
            "lut_gemv_kernel": 22}
    assert cs.dequant_ops_check("step", ops(step), want, 2) == {
        k: v for k, v in step.items() if k in cs.DEQUANT_KERNELS}
    with pytest.raises(RuntimeError, match="dequant kernels traced"):
        cs.dequant_ops_check("step", ops({**step, "v1_dequant_kernel": 6}),
                             want, 2)
    renamed = {k: v for k, v in step.items() if k != "lut_ring_kernel"}
    with pytest.raises(RuntimeError, match="dequant kernels traced"):
        cs.dequant_ops_check("step", ops({**renamed, "lut_dq_kernel": 16}),
                             want, 2)
