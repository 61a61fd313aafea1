"""Port parity for the arithmetic trellis family (tcq2 dualmad, tcq1
1mad/2mad, tcq2s at odd KV) and its large-row dequants: the decoders, the
V=1 K-major dequant, the planar-layout inverses, the plain versions of K1
(tcq{1,2}_decode_matmul), K2 (tcq2_dequant) and K3 (tcq1_dequant) and the
qlinear cutoffs, against the JAX reference on the same numpy inputs.  The
2-layer tcq2mix model is in test_torch_arith_model.py.

The reference's Pallas kernels run in interpret mode (``QPALETTE_INTERPRET``
from conftest), which costs ~1 s a call at k=32 and grows with the tiles
a block unrolls, so the shapes are tiny."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import fused
from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.ops import packing as jpk
from qpalette_tpu.runtime import qlinear as jqlinear

from arith_fragment import M32 as _M32
from arith_fragment import S8_MMAS as _S8_MMAS
from arith_fragment import c_frag as _c_frag
from arith_fragment import lane_weights as _lane_weights
from arith_fragment import lane_windows as _lane_windows
from arith_fragment import prmt as _prmt
from arith_fragment import sbytes as _sbytes
from arith_fragment import unpermute as _unpermute
from arith_fragment import v1_hash as _v1_hash
from arith_fragment import v1_lane_windows as _v1_lane_windows
from qpalette_tpu_torch.kernels import arith, arith_dequant, formats
from qpalette_tpu_torch.ops import codebooks, packing
from qpalette_tpu_torch.ops.packing import words_to_torch
from qpalette_tpu_torch.runtime.qlinear import (LinearSpec, can_fuse_rot,
                                                qlinear_apply)

V = {"1mad": 1, "2mad": 1, "dualmad": 2, "sum2": 2}
FAMILY = {"1mad": "tcq1", "2mad": "tcq1", "dualmad": "tcq2", "sum2": "tcq2"}
M, K = 32, 32  # kernel-level shape: k/16 = 2, the dense planar layouts
# K1 against the reference kernel: tcq1 at KV 3/4, tcq2 and tcq2s at 5/6/7
# (tcq2s KV 6 is in test_torch_tcq2s.py)
K1_CASES = [("1mad", 3), ("1mad", 4), ("2mad", 3), ("2mad", 4),
            ("dualmad", 5), ("dualmad", 6), ("dualmad", 7), ("sum2", 5),
            ("sum2", 7)]
# a8 against pallas_a8 at one k-chunk on both sides.  The int8 activations
# agree except at exact ties (|x/s| = j + 1/2), which XLA may round the
# other way; and for tcq1 the reference adds 2*sum(x) of the unquantized x
# to a dot of quantized x with XOR'd bytes where the port takes the exact
# integer weight (unsigned byte sum - 510) against quantized x: that moves
# y by 2*sum(x - q*s)/147.8, under 1e-3 of max|y| at these sizes.
A8_TOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _words(rng, mode, KV, m=M, k=K):
    return rng.integers(0, 1 << 32, ((m // 16) * (k // 16), 8 * KV // V[mode]),
                        dtype=np.uint32)


def _planar(words, mode, KV, m=M, k=K):
    f = kf.tcq1_planar_weights if V[mode] == 1 else kf.tcq2_planar_weights
    return f(jnp.asarray(words), m, k, KV)


# --- codebooks and packing ---------------------------------------------------

@pytest.mark.parametrize("mode", ["1mad", "2mad", "dualmad"])
def test_decoders_bit_exact(mode):
    """Every 16-bit state, and 32-bit inputs (the decoders mask to 32
    bits), equal the reference's decoders and tables bit for bit."""
    states = np.concatenate([np.arange(1 << 16, dtype=np.uint64),
                             np.random.default_rng(1).integers(
                                 0, 1 << 32, 4096, dtype=np.uint64)])
    ref = getattr(jcb, f"decode_{mode}")(states)
    got = getattr(codebooks, f"decode_{mode}")(
        torch.from_numpy(states.astype(np.int64))).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    lut = codebooks.trellis_lut_arith(mode).numpy()
    assert lut.shape == ((1 << 16, 1) if V[mode] == 1 else (1 << 16, 2))
    assert np.array_equal(lut, jcb.trellis_lut_arith(mode))


@pytest.mark.parametrize("KV,k", [(3, 32), (3, 48), (4, 32), (5, 48)])
def test_dequant_tcq_v1_bit_exact(KV, k):
    rng = np.random.default_rng(10 + KV + k)
    words = _words(rng, "1mad", KV, k=k)
    lut = jcb.trellis_lut_arith("2mad")
    ref = np.asarray(jpk.dequant_tcq(jnp.asarray(words), jnp.asarray(lut),
                                     M, k, KV, v=1))
    got = packing.dequant_tcq(words_to_torch(words), torch.from_numpy(lut),
                              M, k, KV, v=1).numpy()
    assert np.array_equal(got, ref)


def _unique_state(states, s):
    assert (states == states[s]).sum() == 1, "pick another seed"
    return states[s]


def test_one_hot_pins_tile_orders():
    """A one-hot state table shows where each state lands: V=1 state
    p = 16*col + row covers (row, col) (K-major); V=2 state s = 16t + row
    covers (row, 2t) and (row, 2t+1) (paired-K-major)."""
    rng = np.random.default_rng(5)
    w1 = words_to_torch(_words(rng, "1mad", 3, 16, 16))
    st1 = packing.unpack_trellis(w1, 3, 1)[0]
    lut1 = torch.zeros((1 << 16, 1))
    lut1[_unique_state(st1, 16 * 9 + 4)] = 1.0  # col 9, row 4
    w = packing.dequant_tcq(w1, lut1, 16, 16, 3, v=1)
    assert w[4, 9] == 1.0 and w.sum() == 1.0
    w2 = words_to_torch(_words(rng, "dualmad", 7, 16, 16))
    st2 = packing.unpack_trellis(w2, 7, 2)[0]
    lut2 = torch.zeros((1 << 16, 2))
    lut2[_unique_state(st2, 16 * 5 + 3)] = torch.tensor([1.0, 2.0])
    w = packing.dequant_tcq2(w2, lut2, 16, 16, 7)  # pair 5, row 3
    assert w[3, 10] == 1.0 and w[3, 11] == 2.0 and w.sum() == 3.0
    # the plain kernels decode in the same order as these spec decoders
    for words, mode, KV in ((w1, "1mad", 3), (w2, "dualmad", 7)):
        ints = codebooks.arith_weights_int(torch.arange(1 << 16), mode)
        spec = (packing.dequant_tcq(words, ints, 16, 16, KV, v=1)
                if V[mode] == 1 else
                packing.dequant_tcq2(words, ints, 16, 16, KV))
        assert torch.equal(arith.arith_weights_mat(words, mode, KV, 16, 16),
                           spec)


@pytest.mark.parametrize("mode,KV", [("1mad", 2), ("1mad", 3), ("1mad", 4),
                                     ("1mad", 5), ("dualmad", 4),
                                     ("dualmad", 5), ("dualmad", 7),
                                     ("dualmad", 9)])
def test_planar_round_trip(mode, KV):
    """canonical -> the reference's planar layout -> the port's inverse,
    for even KV and for odd KV with an even k/16; odd KV with an odd k/16
    (the reference's aligned fallback) raises."""
    inverse = (formats.tcq1_planar_to_canonical if V[mode] == 1
               else formats.tcq2_planar_to_canonical)
    rng = np.random.default_rng(20 + KV)
    for m, k in ((32, 64), (48, 128)):
        words = _words(rng, mode, KV, m, k)
        back = inverse(np.asarray(_planar(words, mode, KV, m, k)), m, k, KV)
        assert back.dtype == np.uint32 and np.array_equal(back, words)
    if KV % 2:
        words = _words(rng, mode, KV, 32, 48)
        with pytest.raises(ValueError):
            inverse(np.asarray(_planar(words, mode, KV, 32, 48)), 32, 48, KV)


# --- K1, K2, K3 against the reference kernels ------------------------------

def _ref_k1(x, tr_pl, mode, KV, m, k, a8):
    if V[mode] == 1:
        return np.asarray(fused.tcq1_decode_matmul(x, tr_pl, KV, mode, m, k,
                                                   a8=a8))
    return np.asarray(fused.tcq2_decode_matmul(x, tr_pl, KV, m, k, a8=a8,
                                               mode=mode))


@pytest.mark.parametrize("mode,KV", K1_CASES)
def test_k1_plain_matches_reference_kernel(mode, KV):
    rng = np.random.default_rng(100 + 10 * KV + len(mode))
    words = _words(rng, mode, KV)
    tr_pl = _planar(words, mode, KV)
    tw = words_to_torch(words)
    for N in (1, 5):
        x = rng.standard_normal((N, K)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        ref = _ref_k1(xb, tr_pl, mode, KV, M, K, False)
        got = arith.decode_gemv(mode, xt, tw, KV, M, K, False).numpy()
        # exact: the same bf16 x and integer weights, f32 sums in another
        # order
        assert _rel(got, ref) < 1e-5, (N, "exact")
        ref_a8 = _ref_k1(xb, tr_pl, mode, KV, M, K, True)
        got_a8 = arith.decode_gemv(mode, xt, tw, KV, M, K, True).numpy()
        assert _rel(got_a8, ref_a8) < A8_TOL, (N, "a8")
        # and the a8 path stays close to exact (the reference's own bound)
        assert _rel(got_a8, ref) < 0.05, (N, "a8 vs exact")


@pytest.mark.parametrize("mode,KV,k", [("sum2", 7, 32), ("dualmad", 5, 32),
                                       ("dualmad", 7, 48), ("1mad", 3, 32),
                                       ("2mad", 3, 48), ("2mad", 4, 32)])
def test_k2_k3_plain_bit_equal_to_reference(mode, KV, k):
    """tcq2_dequant / tcq1_dequant (natural order) bit for bit, on the
    dense planar layouts (k/16 even) and the aligned one (k/16 odd)."""
    rng = np.random.default_rng(200 + KV + k)
    words = _words(rng, mode, KV, k=k)
    tr_pl = _planar(words, mode, KV, k=k)
    if V[mode] == 1:
        ref = fused.tcq1_dequant(tr_pl, KV, M, k, mode=mode)
    else:
        ref = fused.tcq2_dequant(tr_pl, KV, M, k, mode=mode)
    ref = np.asarray(ref.astype(jnp.float32)).T
    got = arith_dequant.dequant(mode, words_to_torch(words), KV, M, k)
    assert got.dtype == torch.bfloat16 and got.shape == (M, k)
    assert np.array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("mode,KV", [("1mad", 3), ("dualmad", 7),
                                     ("dualmad", 9), ("sum2", 9)])
@pytest.mark.parametrize("k", [48, 64])
def test_k1_plain_matches_spec_at_odd_and_even_tile_counts(mode, KV, k):
    """Odd-KV windows straddle words at other places: the plain K1 at
    k/16 odd and even against the reference's executable spec (its dequant
    through the f32 state table, then an f32 product)."""
    rng = np.random.default_rng(300 + KV + k)
    words = _words(rng, mode, KV, k=k)
    lut = jnp.asarray(jcb.trellis_lut_arith(mode))
    w = (jpk.dequant_tcq(jnp.asarray(words), lut, M, k, KV, v=1)
         if V[mode] == 1 else jpk.dequant_tcq2(jnp.asarray(words), lut, M, k,
                                                KV))
    x = rng.standard_normal((3, k)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ref = xb @ np.asarray(w).T
    got = arith.decode_gemv(mode, torch.from_numpy(x), words_to_torch(words),
                            KV, M, k, False).numpy()
    # the table holds w / 147.8 rounded to f32; the port scales the sum
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("mode,KV", [("dualmad", 7), ("1mad", 3)])
def test_qlinear_large_rows_match_reference(mode, KV):
    """300 rows: exact through K2/K3 and an f32 product against the
    reference's impl pallas (dequant_matmul); a8 through 256-row K1 chunks
    against pallas_a8 (256-row chunks of its kernel)."""
    rng = np.random.default_rng(400 + KV)
    words = _words(rng, mode, KV)
    wscale = rng.uniform(0.5, 1.5, M).astype(np.float32)
    z = rng.standard_normal((300, K)).astype(np.float32)
    zb = jnp.asarray(z).astype(jnp.bfloat16)
    jp = {"trellis_pl": _planar(words, mode, KV),
          "wscale": jnp.asarray(wscale)}
    p = {"trellis": words_to_torch(words), "wscale": torch.from_numpy(wscale)}
    fam = FAMILY[mode]
    for impl, jimpl, tol in (("exact", "pallas", 1e-5),
                             ("a8", "pallas_a8", A8_TOL)):
        jspec = jqlinear.LinearSpec(fam, K, M, KV=(KV,), mode=mode,
                                    impl=jimpl)
        want = np.asarray(jqlinear.qlinear_apply(jspec, jp, zb,
                                                 out_dtype=jnp.float32))
        spec = LinearSpec(fam, K, M, KV=(KV,), mode=mode, impl=impl)
        got = qlinear_apply(spec, p, torch.from_numpy(z).to(torch.bfloat16),
                            out_dtype=torch.float32).numpy()
        assert _rel(got, want) < tol, impl


@pytest.mark.parametrize("kind,mode,KV,n,fuse", [
    ("tcq1", "1mad", 3, 512, True),    # dense odd, last factor 256
    ("tcq1", "2mad", 4, 1792, True),   # dense even
    ("tcq1", "1mad", 3, 1792, True),   # dense odd, last factor 64
    ("tcq2", "sum2", 7, 4096, True),
    ("tcq2", "dualmad", 6, 512, False),
    ("tcq1", "1mad", 5, 448, False),   # dense odd, last factor 16
    ("tcq1", "1mad", 5, 80, True),     # odd k/16: the aligned layout
])
def test_can_fuse_rot_matches_reference(kind, mode, KV, n, fuse):
    for rows in (1, 8, 9):
        spec = LinearSpec(kind, n, 64, KV=(KV,), mode=mode, impl="a8")
        jspec = jqlinear.LinearSpec(kind, n, 64, KV=(KV,), mode=mode,
                                    impl="pallas_a8")
        got = can_fuse_rot(spec, rows)
        assert got == jqlinear.can_fuse_rot(jspec, rows)
        assert got == (fuse and rows <= 8)


def test_wrappers_reject_unsupported_input():
    tw = words_to_torch(_words(np.random.default_rng(6), "1mad", 3))
    x = torch.zeros((1, K))
    with pytest.raises(ValueError):  # tcq1 beyond KV 5
        arith.tcq1_decode_gemv(x, torch.zeros((4, 48), dtype=torch.int32), 6,
                               "1mad", M, K, False)
    with pytest.raises(ValueError):  # V=2 word count for a V=1 mode
        arith.tcq1_decode_gemv(x, tw[:, :12].contiguous(), 3, "1mad", M, K,
                               False)
    with pytest.raises(ValueError):  # mode of another family
        arith.tcq1_decode_gemv(x, tw, 3, "dualmad", M, K, False)
    with pytest.raises(ValueError):
        arith_dequant.tcq2_dequant(tw, 3, M, K, "1mad")
    with pytest.raises(ValueError):  # more than 256 rows
        arith.tcq1_decode_gemv(torch.zeros((257, K)), tw, 3, "1mad", M, K,
                               False)


# --- the V=2 decode GEMV's fragment algebra, rehearsed on the CPU ----------

_SLOT_TILES, _WARPS, _CHUNK_TILES = 16, 8, arith.CHUNK // 16


@pytest.mark.parametrize("mode,KV", [
    pytest.param("sum2", kv, id=str(kv)) for kv in range(4, 11)] + [
    pytest.param("dualmad", kv, id=f"dualmad{kv}") for kv in range(4, 11)])
def test_sum2_fragment_map_matches_plain(mode, KV):
    """csrc/tcq2_gemv.cu's V=2 GEMV (N <= 8, sum2 and dualmad) from the
    lane's point of view, on the plain words: the lane -> states map with
    its word offsets and wrap, the hash bytes as the s8 A registers (one
    MMA for sum2, one per hash for dualmad), the quantized x word under
    the mode's byte permutes as the B registers, the int32 m16n8k32
    products, the un-permuted C rows, and the per-chunk descale over the
    kernel's warp split (k = 2576: 11 slots of 16 tiles, the last warp's
    range straddles a chunk boundary into a partial chunk and slot).
    exact: sum2's bf16 pairs (one m16n8k16), dualmad's tf32 weights (two
    m16n8k8, one per column parity, with x from the bf16x2 words) give
    arith_weights_mat's integers.  a8: each chunk's int32 sums equal the
    plain integer dot; both variants' y match arith_gemv_plain within f32
    sum order."""
    m, k, N = 32, 2576, 3
    mt, kt = m // 16, k // 16
    rng = np.random.default_rng(110 + KV + 100 * (mode == "dualmad"))
    words = words_to_torch(_words(rng, mode, KV, m, k))
    x = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    u = _lane_windows(words, KV).reshape(mt, kt, 32, 4)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3

    # a8 A: register r of lane (g, c) is fragment row g + 8*(r%2), its s8
    # bytes at columns 4c + 16*(r/2) + byte; one (mt, kt, 16, 32) a MMA
    a8 = []
    for hash_fn, _ in _S8_MMAS[mode]:
        a = torch.zeros((mt, kt, 16, 32), dtype=torch.int64)
        for r in range(4):
            sb = _sbytes(hash_fn(u[..., r]))  # (mt, kt, 32, 4)
            for b in range(4):
                col = 4 * c + 16 * (r >> 1) + b
                a[:, :, g + 8 * (r & 1), col] = sb[..., b]
        a8.append(a)
    # exact A: register r holds the state's (w0, w1) at tile columns
    # 2c + 8*(r/2) + (0, 1): sum2 as one bf16x2 register at k = 2c +
    # 8*(r/2) of the m16n8k16, dualmad w0 (MMA 1) and w1 (MMA 2) at k = c
    # + 4*(r/2) of an m16n8k8
    wl = _lane_weights(u, mode)  # (mt, kt, 32, 4 registers, 2)
    if mode == "dualmad":
        assert int(wl.abs().max()) > 256  # beyond what bf16 holds
    aw = torch.zeros((mt, kt, 16, 16), dtype=torch.int64)
    for r in range(4):
        for p in (0, 1):
            aw[:, :, g + 8 * (r & 1), 2 * c + 8 * (r >> 1) + p] = wl[..., r, p]
    tile_row = 2 * (torch.arange(16) % 8) + torch.arange(16) // 8
    w_frag = torch.zeros((m, k), dtype=torch.int64)
    w_frag.view(mt, 16, kt, 16)[:, tile_row] = aw.permute(0, 2, 1, 3)
    w_ref = arith.arith_weights_mat(words, mode, KV, m, k)
    assert torch.equal(w_frag, w_ref)

    # the kernel's split: whole slots a warp, chunk scales over all rows
    nsl = -(-kt // _SLOT_TILES)
    scales = [(x[:, c0:c0 + arith.CHUNK].abs().amax() / 127.0 + 1e-30)
              .to(torch.float32) for c0 in range(0, k, arith.CHUNK)]
    qs = torch.cat([torch.round(x[:, c0:c0 + arith.CHUNK] * (1.0 / s))
                    for c0, s in zip(range(0, k, arith.CHUNK), scales)],
                   1).to(torch.int64)
    qp = torch.cat([qs, torch.zeros((8 - N, k), dtype=torch.int64)])
    chunk_sums = torch.zeros((len(scales), mt, 16, 8), dtype=torch.int64)
    y8 = torch.zeros((mt, 16, 8))
    yx = torch.zeros((mt, 16, 8))
    xb = torch.cat([x.to(torch.bfloat16), torch.zeros((8 - N, k),
                                                      dtype=torch.bfloat16)])
    xbits = xb.view(torch.int16).to(torch.int64) & 0xFFFF
    straddles = 0
    for w in range(_WARPS):
        ta = min(kt, nsl * w // _WARPS * _SLOT_TILES)
        tb = min(kt, nsl * (w + 1) // _WARPS * _SLOT_TILES)
        straddles += ta < tb and ta // _CHUNK_TILES != (tb - 1) // _CHUNK_TILES
        acc = torch.zeros((mt, 32, 4))
        accx = torch.zeros((mt, 32, 4))
        di = torch.zeros((mt, 32, 4), dtype=torch.int64)
        ch = -1
        for t in range(ta, tb):
            if t // _CHUNK_TILES != ch:
                if ch >= 0:
                    acc = acc + di.to(torch.float32) * scales[ch]
                ch, di = t // _CHUNK_TILES, torch.zeros_like(di)
            # the x buffer word of lane (g, c): row g, columns 2c, 2c+1,
            # 8+2c, 9+2c of the tile; B registers under byte permutes
            q = qp[g][:, 16 * t:16 * t + 16] & 0xFF  # (32, 16)
            cols = torch.stack([2 * c, 2 * c + 1, 8 + 2 * c, 9 + 2 * c], 1)
            word = sum(q.gather(1, cols)[:, i] << (8 * i) for i in range(4))
            C = torch.zeros((mt, 16, 8), dtype=torch.int64)
            for a, (_, sels) in zip(a8, _S8_MMAS[mode]):
                B = torch.zeros((32, 8), dtype=torch.int64)
                for reg, sel in enumerate(sels):
                    sb = _sbytes(_prmt(word, sel))  # (32 lanes, 4)
                    for b in range(4):
                        B[4 * c + 16 * reg + b, g] = sb[:, b]
                C = C + a[:, t] @ B  # int32 in the kernel
            frag = _c_frag(C, g, c)
            di = di + frag
            assert int(di.abs().max()) < 1 << 25  # a chunk's partial
            chunk_sums[ch] += _unpermute(frag)
            # exact: lane (g, c)'s bf16x2 words of x row g at columns
            # (2c, 2c+1) and (8+2c, 9+2c), the lower column in the low half
            xr = xbits[g][:, 16 * t:16 * t + 16]  # (32, 16)
            bw = [xr.gather(1, (2 * c + 8 * i)[:, None])[:, 0]
                  | xr.gather(1, (2 * c + 8 * i + 1)[:, None])[:, 0] << 16
                  for i in (0, 1)]
            if mode == "sum2":  # one m16n8k16.bf16 in natural column order
                Bx = torch.zeros((16, 8))
                for i, wd in enumerate(bw):
                    for p in (0, 1):
                        Bx[2 * c + 8 * i + p, g] = (
                            ((wd >> (16 * p)) & 0xFFFF) << 16
                        ).to(torch.int32).view(torch.float32)
                Cx = aw[:, t].float() @ Bx
            else:  # two m16n8k8.tf32, column parity p: A k = c + 4*(r/2)
                Cx = torch.zeros((mt, 16, 8))
                for p in (0, 1):
                    A = torch.zeros((mt, 16, 8))
                    for r in range(4):
                        A[:, g + 8 * (r & 1), c + 4 * (r >> 1)] = (
                            wl[:, t, :, r, p].float())
                    Bx = torch.zeros((8, 8))
                    for i, wd in enumerate(bw):  # b.x / b.y << 16 or masked
                        bits = (wd << 16) if p == 0 else (wd & 0xFFFF0000)
                        Bx[c + 4 * i, g] = (bits & _M32).to(
                            torch.int32).view(torch.float32)
                    Cx = Cx + A @ Bx
            accx = accx + _c_frag(Cx, g, c)
        if ch >= 0:
            acc = acc + di.to(torch.float32) * scales[ch]
        y8 = y8 + _unpermute(acc)
        yx = yx + _unpermute(accx)
    assert straddles >= 1
    for ci, c0 in enumerate(range(0, k, arith.CHUNK)):
        want = qs[:, c0:c0 + arith.CHUNK] @ w_ref[:, c0:c0 + arith.CHUNK].T
        got = chunk_sums[ci].permute(2, 0, 1).reshape(8, m)[:N]
        assert torch.equal(got, want)
    got8 = y8.permute(2, 0, 1).reshape(8, m)[:N] * arith.MAD_INV
    gotx = yx.permute(2, 0, 1).reshape(8, m)[:N] * arith.MAD_INV
    for got, a8_ in ((got8, True), (gotx, False)):
        want = arith.arith_gemv_plain(x, words, mode, KV, m, k, a8_)
        # the same integer chunk sums (a8) or exact products (bf16 x
        # integer weights); only the order of the f32 sums differs
        assert _rel(got.numpy(), want.numpy()) < 1e-5, a8_


# --- the V=1 decode GEMV's fragment algebra, rehearsed on the CPU ----------

_V1_WARPS = 16  # v1_gemv_kernel's warps a block (csrc/tcq1_gemv.cu)
_V1_BIAS = 510  # the V=1 weight is its hash's unsigned byte sum - 510
# a8: the byte permutes of the lane's x word that give the B registers b0,
# b1 of MMA 1 (columns 4c, 4c+1) and MMA 2 (4c+2, 4c+3)
_V1_PERMS = ((0x0000, 0x1111), (0x2222, 0x3333))


def _v1_warp_split(kt):
    """[(first tile, end tile)] of each warp of an m-tile: whole 16-tile
    slots, as arith_tc.cuh's tc_gemv splits them."""
    nsl = -(-kt // _SLOT_TILES)
    return [(min(kt, nsl * w // _V1_WARPS * _SLOT_TILES),
             min(kt, nsl * (w + 1) // _V1_WARPS * _SLOT_TILES))
            for w in range(_V1_WARPS)]


@pytest.mark.parametrize("mode,KV", [
    pytest.param(mode, kv, id=f"{mode}{kv}") for mode in ("1mad", "2mad")
    for kv in (2, 3, 4, 5)])
def test_v1_fragment_map_matches_plain(mode, KV):
    """csrc/tcq1_gemv.cu's V=1 GEMV (N <= 8, 1mad and 2mad) from the lane's
    point of view, on the plain words: the lane -> states map with its
    word offsets, shifts and the circular wrap; the hashes' unsigned bytes
    as the u8 A registers of two m16n8k32 MMAs a tile; the lane's x word
    under byte permutes as the s8 B registers; the int32 products; the
    sum of each lane's q bytes (a __dp4a a tile), shuffled to the lanes of
    its rows' C columns at the chunk's end, and -510 times it added to
    the chunk's fragment once; the per-chunk descale over the
    kernel's 16-warp split (k = 4112: 17 slots, the last warp's range
    straddles a chunk boundary into a partial chunk and slot); exact's
    tf32 weights (unsigned __dp4a onto 1.5*2^23, minus 1.5*2^23 + 510) in
    two m16n8k8 MMAs against bf16 x; the un-permuted C rows.  Both
    variants at N = 1 and 8 match arith_gemv_plain within f32 sum order,
    and a8's chunk sums equal the plain integer dot exactly."""
    m, k = 32, 4112
    mt, kt = m // 16, k // 16
    rng = np.random.default_rng(210 + KV + 10 * (mode == "2mad"))
    words = words_to_torch(_words(rng, mode, KV, m, k))
    u = _v1_lane_windows(words, KV).reshape(mt, kt, 32, 4, 2)
    h = _v1_hash(u, mode)
    ub = torch.stack([(h >> (8 * b)) & 0xFF for b in range(4)], -1)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3

    # A of MMA q: register r of lane (g, c) is the hash of pair 2q + r/2,
    # state r%2: fragment row g + 8*(r%2), its u8 bytes at k = 4c +
    # 16*(r/2) + byte; pair p of the lane is tile column 4c + p
    a8 = []
    for q in (0, 1):
        a = torch.zeros((mt, kt, 16, 32), dtype=torch.int64)
        for r in range(4):
            for b in range(4):
                a[:, :, g + 8 * (r & 1), 4 * c + 16 * (r >> 1) + b] = (
                    ub[:, :, :, 2 * q + (r >> 1), r & 1, b])
        a8.append(a)
    # the weights they stand for, and exact's tf32 A registers of MMA q:
    # register r at k = c + 4*(r/2), the same states
    wsum = ub.sum(-1) - _V1_BIAS  # (mt, kt, 32, 4 pairs, 2)
    bits = (0x4B400000 + ub.sum(-1)).to(torch.int32)
    wf = bits.view(torch.float32) - torch.tensor(12583422.0)
    tf32 = (wf.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert torch.equal(tf32, wsum.to(torch.float32))
    ax = []
    for q in (0, 1):
        a = torch.zeros((mt, kt, 16, 8))
        for r in range(4):
            a[:, :, g + 8 * (r & 1), c + 4 * (r >> 1)] = (
                tf32[:, :, :, 2 * q + (r >> 1), r & 1])
        ax.append(a)
    tile_row = 2 * (torch.arange(16) % 8) + torch.arange(16) // 8
    w_frag = torch.zeros((mt, 16, kt, 16), dtype=torch.int64)
    for q in (0, 1):
        for hh in (0, 1):  # k-block hh of MMA q is tile column 4c + 2q + hh
            blk = a8[q][..., 16 * hh:16 * hh + 16].reshape(mt, kt, 16, 4, 4)
            w_frag[:, tile_row, :, 2 * q + hh::4] = (
                blk.sum(-1) - _V1_BIAS).permute(0, 2, 1, 3)
            kx = ax[q][..., 4 * hh:4 * hh + 4].to(torch.int64)
            assert torch.equal(kx, blk.sum(-1) - _V1_BIAS)
    w_ref = arith.arith_weights_mat(words, mode, KV, m, k)
    assert torch.equal(w_frag.reshape(m, k), w_ref)

    split = _v1_warp_split(kt)
    assert sum(ta < tb and ta // _CHUNK_TILES != (tb - 1) // _CHUNK_TILES
               and tb - ta < _SLOT_TILES * 2 and tb % _SLOT_TILES
               for ta, tb in split) >= 1  # a straddle into a partial slot
    for N in (1, 8):
        x = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
        scales = [(x[:, c0:c0 + arith.CHUNK].abs().amax() / 127.0 + 1e-30)
                  .to(torch.float32) for c0 in range(0, k, arith.CHUNK)]
        qs = torch.cat([torch.round(x[:, c0:c0 + arith.CHUNK] * (1.0 / s))
                        for c0, s in zip(range(0, k, arith.CHUNK), scales)],
                       1).to(torch.int64)
        qp = torch.cat([qs, torch.zeros((8 - N, k), dtype=torch.int64)])
        # the lane's x word of tile t: row g, columns 4c..4c+3, byte i =
        # q(16t + 4c + i); B of MMA q under its two permutes
        col = 16 * torch.arange(kt)[:, None] + 4 * c[None, :]  # (kt, 32)
        xw = sum((qp[g[None, :], col + i] & 0xFF) << (8 * i)
                 for i in range(4))
        C = torch.zeros((mt, kt, 16, 8), dtype=torch.int64)
        for q in (0, 1):
            B = torch.zeros((kt, 32, 8), dtype=torch.int64)
            for reg, sel in enumerate(_V1_PERMS[q]):
                sb = _sbytes(_prmt(xw, sel))  # (kt, 32 lanes, 4)
                for b in range(4):
                    B[:, 4 * c + 16 * reg + b, g] = sb[..., b]
            C = C + torch.einsum("mtik,tkn->mtin", a8[q], B)
        # exact: lane (g, c)'s bf16x2 words of x row g at columns (4c,
        # 4c+1) and (4c+2, 4c+3); MMA q's b0 is word q << 16, b1 word q
        # masked (the lower column is the low half)
        xb = torch.cat([x.to(torch.bfloat16), torch.zeros(
            (8 - N, k), dtype=torch.bfloat16)]).view(torch.int16)
        xbits = xb.to(torch.int64) & 0xFFFF
        Cx = torch.zeros((mt, kt, 16, 8))
        for q in (0, 1):
            wd = (xbits[g[None, :], col + 2 * q]
                  | xbits[g[None, :], col + 2 * q + 1] << 16)  # (kt, 32)
            B = torch.zeros((kt, 8, 8))
            for reg, bb in enumerate(((wd << 16) & _M32,
                                      wd & 0xFFFF0000)):
                B[:, c + 4 * reg, g] = bb.to(torch.int32).view(
                    torch.float32)
            Cx = Cx + torch.einsum("mtik,tkn->mtin", ax[q], B)

        chunk_sums = torch.zeros((len(scales), mt, 16, 8), dtype=torch.int64)
        y8 = torch.zeros((mt, 16, 8))
        yx = torch.zeros((mt, 16, 8))
        for ta, tb in split:
            acc = torch.zeros((mt, 32, 4))
            for ch in range(ta // _CHUNK_TILES, -(-tb // _CHUNK_TILES)):
                t0, t1 = max(ta, ch * _CHUNK_TILES), min(tb, (ch + 1)
                                                         * _CHUNK_TILES)
                if t0 >= t1:
                    continue
                # each lane adds up its x words' q bytes (a __dp4a a
                # tile); at the chunk's end row g's sum over lanes 4g..4g+3
                # (two xor shuffles), rows 2c and 2c+1 from lanes 8c and
                # 8c+4 for C columns n = 2c, 2c+1 (registers r%2 = 0, 1)
                qsum = _sbytes(xw[t0:t1]).sum((0, 2))  # (32 lanes)
                srow = qsum.view(8, 4).sum(1)[g]  # lane's row g
                s0, s1 = srow[8 * c], srow[8 * c + 4]
                assert torch.equal(s0, qp[2 * c, 16 * t0:16 * t1].sum(1))
                part = C[:, t0:t1].sum(1)  # the MMAs' int32 sums
                assert int(part.abs().max()) < 1 << 27
                di = _c_frag(part, g, c) - _V1_BIAS * torch.stack(
                    [s0, s1, s0, s1], -1)
                assert int(di.abs().max()) < 1 << 31
                chunk_sums[ch] += _unpermute(di)
                acc = acc + di.to(torch.float32) * scales[ch]
            y8 = y8 + _unpermute(acc)
            if ta < tb:
                yx = yx + _unpermute(_c_frag(Cx[:, ta:tb].double().sum(1),
                                             g, c).float())
        for ci, c0 in enumerate(range(0, k, arith.CHUNK)):
            want = (qs[:, c0:c0 + arith.CHUNK]
                    @ w_ref[:, c0:c0 + arith.CHUNK].T)
            got = chunk_sums[ci].permute(2, 0, 1).reshape(8, m)
            assert torch.equal(got[:N], want)
            assert not got[N:].any()
        for y, a8_ in ((y8, True), (yx, False)):
            got = y.permute(2, 0, 1).reshape(8, m) * arith.MAD_INV
            want = arith.arith_gemv_plain(x, words, mode, KV, m, k, a8_)
            assert not got[N:].any()
            # the same integer chunk sums (a8) or exact products (bf16 x
            # integer weights); only the order of the f32 sums differs
            assert _rel(got[:N].numpy(), want.numpy()) < 1e-5, (N, a8_)
