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
