"""Port parity for the quantizers' building blocks against the JAX
package on the CPU: the trellis pack and tile order (``ops/packing``,
also against the reference's native codecs), the Viterbi DP and its
two-pass tail-biting encode (``quant/viterbi``), block LDL and the
damped Cholesky (``quant/ldlq``), ``lut_rms`` and the 3inst decoder
(``ops/codebooks``), k-means (``utils/kmeans``: Lloyd's by distortion,
the exact 1-D solution value for value through ``ops/native_pack``,
built from ``native/kmeans1d.cpp`` with the host compiler), and tcq's
proxy error at 256^2 (``msq/err_tables``: the whole no-Hessian trellis
path of 16 column blocks).

The Viterbi runs on the same numpy sequences on both sides; its float32
costs are the reference's (|lut|^2 - 2 x.lut, one rounding after the
dot), so the states agree.  Where a near-tie could flip a path the test
counts the sequences that differ and holds their squared error to the
reference's (VITERBI_TIE_TOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.msq import err_tables as jerr
from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.ops import native_pack as jnative
from qpalette_tpu.ops import packing as jpk
from qpalette_tpu.quant import ldlq as jldlq
from qpalette_tpu.quant import viterbi as jvit
from qpalette_tpu.utils import kmeans as jkm

from qpalette_tpu_torch.msq import err_tables
from qpalette_tpu_torch.ops import codebooks, packing
from qpalette_tpu_torch.quant import ldlq, viterbi
from qpalette_tpu_torch.utils import kmeans

L = 16
# sequences of a case whose states may differ from the reference's (a
# float32 near-tie), and how much worse their squared error may be
VITERBI_FLIPS = 1
VITERBI_TIE_TOL = 1e-5
LDL_TOL = 1e-5  # block_ldl, max abs difference over max |L|
KMEANS_TOL = 0.01  # Lloyd's distortion over the reference's, at most
PROXY_TOL = 1e-3  # quantizer_proxy_err, relative


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops (as
    tests/test_torch_decode.py): parallel test workers, each with a
    thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _chain_states(rng, T, KV, v):
    """Tail-biting state chains: the circular windows of random words."""
    words = rng.integers(0, 1 << 32, (T, 8 * KV // v), dtype=np.uint32)
    return np.asarray(jpk.unpack_trellis(jnp.asarray(words), KV, v)), words


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("KV", range(2, 11))
def test_pack_trellis_bit_equal(KV, v):
    """pack_trellis of tail-biting chains gives back their words, as the
    reference's does; of arbitrary states it gives the reference's
    words."""
    rng = np.random.default_rng(KV * 10 + v)
    states, words = _chain_states(rng, 37, KV, v)
    got = packing.pack_trellis(torch.from_numpy(states.copy()), KV, v=v)
    assert got.dtype == torch.int32 and got.shape == (37, 8 * KV // v)
    assert np.array_equal(_u32(got), words)
    assert np.array_equal(np.asarray(jpk.pack_trellis(jnp.asarray(states),
                                                      KV, v=v)), words)
    free = rng.integers(0, 1 << L, (9, 256 // v)).astype(np.int32)
    assert np.array_equal(
        _u32(packing.pack_trellis(torch.from_numpy(free), KV, v=v)),
        np.asarray(jpk.pack_trellis(jnp.asarray(free), KV, v=v)))
    assert np.array_equal(packing.unpack_trellis(got, KV, v=v).numpy(),
                          states)


def test_mat_to_tiles_bit_equal():
    mat = np.random.default_rng(0).standard_normal((48, 80)).astype(
        np.float32)
    got = packing.mat_to_tiles(torch.from_numpy(mat))
    assert np.array_equal(got.numpy(), np.asarray(jpk.mat_to_tiles(mat)))
    assert np.array_equal(packing.tiles_to_mat(got, 48, 80).numpy(), mat)


@pytest.mark.parametrize("KV", [3, 6, 10])
def test_native_codecs_match_reference(KV):
    """The port's torch codecs (ops/packing) against the reference's
    native ones (its binding of the committed native library): V=2
    trellis words and row-packs, both ways."""
    rng = np.random.default_rng(KV)
    states, words = _chain_states(rng, 300, KV, 2)
    assert np.array_equal(jnative.pack_trellis(states, KV), words)
    assert np.array_equal(
        _u32(packing.pack_trellis(torch.from_numpy(states.copy()), KV, v=2)),
        jnative.pack_trellis(states, KV))
    tw = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(packing.unpack_trellis(tw, KV, v=2).numpy(),
                          jnative.unpack_trellis(words, KV))
    for bits, P in ((KV, 96), (KV + 1, 33)):
        idx = rng.integers(0, 1 << bits, (5, P)).astype(np.int32)
        packed = jnative.pack_rows(idx, bits)
        got = packing.pack_rows(torch.from_numpy(idx), bits)
        assert np.array_equal(_u32(got), packed)
        assert np.array_equal(packing.unpack_rows(got, bits, P).numpy(),
                              jnative.unpack_rows(packed, bits, P))


def _lut(KV, v):
    return (jcb.trellis_lut(jcb.tlut_bits_for_kv(KV)) if v == 2
            else jcb.trellis_lut_arith("1mad"))


CASES = [(3, 2), (4, 2), (6, 2), (10, 2), (2, 1), (3, 1)]


def _sq_err(hat, x):
    return ((np.asarray(hat, np.float64) - x) ** 2).sum(1)


def _same_or_tie(got_states, want_states, got_hat, want_hat, x):
    """States equal, or at most VITERBI_FLIPS sequences differ and none of
    them is worse than the reference's by more than VITERBI_TIE_TOL."""
    rows = ~(got_states == want_states).all(1)
    assert rows.sum() <= VITERBI_FLIPS, rows.sum()
    g, w = _sq_err(got_hat, x)[rows], _sq_err(want_hat, x)[rows]
    assert (g <= w * (1 + VITERBI_TIE_TOL) + 1e-12).all(), (g, w)
    assert np.array_equal(np.asarray(got_hat)[~rows],
                          np.asarray(want_hat)[~rows])


@pytest.mark.parametrize("KV,v", CASES)
def test_viterbi_encode_matches_reference(KV, v):
    """8 sequences, unconstrained and with init/final junction states."""
    rng = np.random.default_rng(100 + KV * 3 + v)
    lut = _lut(KV, v)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    c = rng.integers(0, 1 << (L - KV), 8).astype(np.int32)
    for kw in ({}, {"init_c": c}, {"final_c": c},
               {"init_c": c, "final_c": c}):
        want = np.asarray(jvit.viterbi_encode(
            jnp.asarray(x), jnp.asarray(lut), KV, v=v,
            **{k: jnp.asarray(a) for k, a in kw.items()}))
        got = viterbi.viterbi_encode(
            torch.from_numpy(x), torch.from_numpy(lut), KV, v=v,
            **{k: torch.from_numpy(a) for k, a in kw.items()}).numpy()
        _same_or_tie(got, want, lut[got].reshape(8, -1),
                     lut[want].reshape(8, -1), x)
        if "init_c" in kw:
            assert ((got[:, 0] & ((1 << (L - KV)) - 1)) == c).all()
        if "final_c" in kw:
            assert ((got[:, -1] >> KV) == c).all()


@pytest.mark.parametrize("KV,v", CASES)
def test_tcq_quantize_matches_reference(KV, v):
    """The two-pass tail-biting encode: states and W-hat as the
    reference's, each sequence a tail-biting chain (s_{i+1}'s low bits
    are s_i >> KV, and s_0's low bits are s_{S-1} >> KV), so that its
    words unpack to it."""
    rng = np.random.default_rng(200 + KV * 3 + v)
    lut = _lut(KV, v)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    jhat, jst = jvit.tcq_quantize(jnp.asarray(x), jnp.asarray(lut), KV, v=v)
    hat, st = viterbi.tcq_quantize(torch.from_numpy(x),
                                   torch.from_numpy(lut), KV, v=v)
    st = st.numpy()
    _same_or_tie(st, np.asarray(jst), hat.numpy(), jhat, x)
    mask = (1 << (L - KV)) - 1
    assert ((st[:, 1:] & mask) == (st[:, :-1] >> KV)).all()
    assert ((st[:, 0] & mask) == (st[:, -1] >> KV)).all()
    words = packing.pack_trellis(torch.from_numpy(st), KV, v=v)
    assert np.array_equal(packing.unpack_trellis(words, KV, v=v).numpy(), st)
    assert np.array_equal(hat.numpy(), lut[st].reshape(8, 256))


def test_viterbi_high_kv_backtrace():
    """KV above 8 keeps int32 backpointers (2^KV predecessor indices)."""
    assert viterbi._bp_dtype(8) == torch.uint8
    assert viterbi._bp_dtype(9) == torch.int32
    lut = _lut(10, 2)
    x = np.random.default_rng(7).standard_normal((4, 256)).astype(np.float32)
    got = viterbi.viterbi_encode(torch.from_numpy(x), torch.from_numpy(lut),
                                 10).numpy()
    assert got.max() >= 1 << 8
    want = np.asarray(jvit.viterbi_encode(jnp.asarray(x), jnp.asarray(lut),
                                          10))
    _same_or_tie(got, want, lut[got].reshape(4, -1),
                 lut[want].reshape(4, -1), x)


def _pd(n, rank, seed):
    a = np.random.default_rng(seed).standard_normal((rank, n))
    return (a.T @ a / rank).astype(np.float32)


@pytest.mark.parametrize("n,b", [(64, 16), (48, 2), (32, 1)])
def test_block_ldl_matches_reference(n, b):
    H = np.asarray(jldlq.regularize_h(jnp.asarray(_pd(n, 4 * n, n))))
    got = ldlq.regularize_h(torch.from_numpy(_pd(n, 4 * n, n)))
    assert np.allclose(got.numpy(), H, rtol=1e-6, atol=0)
    JL, JD = jldlq.block_ldl(jnp.asarray(H), b)
    Lm, D = ldlq.block_ldl(torch.from_numpy(H), b)
    JL, JD = np.asarray(JL), np.asarray(JD)
    assert np.abs(Lm.numpy() - JL).max() <= LDL_TOL * np.abs(JL).max()
    assert np.abs(D.numpy() - JD).max() <= LDL_TOL * np.abs(JD).max()
    for blk in range(n // b):  # strictly block-lower
        s = slice(blk * b, (blk + 1) * b)
        assert not Lm[s, s].any() and not Lm[s, (blk + 1) * b:].any()


def test_damped_cholesky_takes_reference_sigma():
    """On a singular H both take the same damping sigma * mean(diag H):
    cholesky_ex reports the failure where the reference sees NaN."""
    H = _pd(32, 8, 1)  # rank 8
    assert int(torch.linalg.cholesky_ex(torch.from_numpy(H))[1]) != 0
    C = ldlq.cholesky_damped(torch.from_numpy(H)).numpy()
    JC = np.asarray(jldlq._cholesky_damped(jnp.asarray(H)))
    dm = np.mean(np.diag(H))
    sig = np.mean(np.diag(C @ C.T - H)) / dm
    jsig = np.mean(np.diag(JC @ JC.T - H)) / dm
    assert np.isfinite(JC).all()
    assert np.isclose(sig, jsig, rtol=1e-3) and sig > 0
    assert min(ldlq.SIGMAS, key=lambda s: abs(s - sig)) == pytest.approx(
        sig, rel=1e-3)
    assert np.abs(C - JC).max() <= 1e-4 * np.abs(JC).max()
    Hpd = _pd(32, 64, 2)  # positive definite: no damping
    assert np.allclose(ldlq.cholesky_damped(torch.from_numpy(Hpd)).numpy(),
                       np.linalg.cholesky(Hpd), rtol=1e-4, atol=1e-5)


def test_lut_rms_and_3inst_match_reference():
    for lut in (jcb.trellis_lut(9), jcb.trellis_lut_arith("sum2"),
                jcb.vq_lut(6, 2)):
        assert codebooks.lut_rms(lut) == jcb.lut_rms(lut)
        assert codebooks.lut_rms(torch.from_numpy(np.asarray(lut))) == \
            jcb.lut_rms(lut)
    s = np.arange(1 << L, dtype=np.uint64)
    assert np.array_equal(codebooks.decode_3inst(torch.arange(1 << L))
                          .numpy(), jcb.decode_3inst(s))
    assert np.array_equal(codebooks.trellis_lut_arith("3inst").numpy(),
                          jcb.trellis_lut_arith("3inst"))


def _distortion(x, c):
    d = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return d.min(1).mean()


def test_kmeans_distortion_within_reference():
    """Lloyd's from another seeding (torch.Generator, the reference's
    jax.random): the distortion of 2-D codebooks at most KMEANS_TOL above
    the reference's (another local optimum may be lower)."""
    x = np.random.default_rng(0).standard_normal((8192, 2)).astype(
        np.float32)
    for k in (16, 64):
        got = kmeans.kmeans(x, k, iters=40, seed=3, device="cpu")
        want = jkm.kmeans(x, k, iters=40, seed=3)
        assert got.shape == (k, 2) and got.dtype == np.float32
        assert np.array_equal(got, got[np.lexsort(got.T[::-1])])
        dg, dw = _distortion(x, got), _distortion(x, want)
        assert dg <= (1 + KMEANS_TOL) * dw, (dg, dw)


@pytest.mark.parametrize("n,k,max_bins", [(5000, 8, 1 << 16),
                                          (20000, 16, 4096)])
def test_kmeans1d_exact_matches_reference(n, k, max_bins):
    """The same optimum, binned the same way above max_bins."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = kmeans.kmeans1d_exact(x, k, max_bins=max_bins)
    assert np.array_equal(got, jkm.kmeans1d_exact(x, k, max_bins=max_bins))
    assert np.array_equal(kmeans.kmeans(x[:, None], k, device="cpu")[:, 0],
                          jkm.kmeans(x[:, None], k)[:, 0])


def test_trellis_proxy_err_matches_reference():
    got = err_tables.quantizer_proxy_err("tcq_6_none_0.9", size=256,
                                         device="cpu")
    want = jerr.quantizer_proxy_err("tcq_6_none_0.9", size=256)
    assert abs(got - want) <= PROXY_TOL * want, (got, want)


def test_bf16_cross_term_matches_reference_on_a_tpu_dot(monkeypatch):
    """viterbi._cross_operands replaced by a bf16 rounding (as
    chip_smoke.py does for TABLE_CROSS) rounds the cross term's operands
    as a TPU's default-precision float32 dot does: the proxy error of
    tcq2s_6 at 256^2 equals the reference's with its cross term so
    rounded (here by replacing its _state_err), 1.5% above the float32
    one: the precision of the table entry (0.019748) that the float32
    quantizer misses by 1.6% at 4096^2."""
    def bf16_err(x_step, lutf, norms):
        cross = jax.lax.dot_general(
            x_step.astype(jnp.bfloat16), lutf.T.astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        return norms[None, :] - 2.0 * cross

    def bf16_operands(Xs, lutT):
        return (Xs.to(torch.bfloat16).to(torch.float32),
                lutT.to(torch.bfloat16).to(torch.float32))

    q = "tcq2s_6_none_0.9"
    f32 = err_tables.quantizer_proxy_err(q, size=256, device="cpu")
    monkeypatch.setattr(viterbi, "_cross_operands", bf16_operands)
    monkeypatch.setattr(jvit, "_state_err", bf16_err)
    jax.clear_caches()
    try:
        got = err_tables.quantizer_proxy_err(q, size=256, device="cpu")
        want = jerr.quantizer_proxy_err(q, size=256)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    assert abs(got - want) <= PROXY_TOL * want, (got, want)
    assert got > f32 * 1.01
