"""Port parity for the quantizers against the JAX package on the CPU:
every ``quantize_mat_*`` (tcq, tcq1 1mad/2mad, tcq2 dualmad/sum2, tcomb,
comb, ldlq) at 64x256 without a Hessian (the same words) and with one
(the same error), ``quantize_linear`` for every quantizer_str family
(tcq, tcq1, tcq1x2, tcq2, tcq2s, tcomb, comb, ldlq, sq, vq2, rotfp16)
with the same SU (the artifact's arrays and meta), the ALS families with
a Hessian, and ``quantizer_proxy_err`` at 256^2 (ldlq here, tcq in
test_torch_viterbi.py).

The reference jit-compiles each core once per shape and scheme (seconds
each), so the cases share one shape, but for the V=1 trellis (tcq1,
tcq1x2; a core of its own): 32x128, because its 256-step DP over
(sequences, 2^16) costs a quarter of the time there (the min over the
2^KV predecessors runs at ~0.2 G elements/s on one CPU thread)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.msq import err_tables as jerr
from qpalette_tpu.quant import incoherent as jinc
from qpalette_tpu.quant import quantizers as jq

from qpalette_tpu_torch.msq import err_tables
from qpalette_tpu_torch.quant import incoherent, quantizers

M, N = 64, 256
# relative difference of the error with a Hessian (the same words, or a
# float32 near-tie in LDLQ's feedback)
HESS_TOL = 1e-4
# vq2's k-means is seeded by a torch.Generator, the reference's by
# jax.random: another codebook, whose error may be this much higher
VQ2_TOL = 0.05
META_RTOL, META_ATOL = 1e-4, 1e-6  # err, orig_err, kurtosis, skewness
PROXY_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(m, n):
    rng = np.random.default_rng(0)
    Wr = rng.standard_normal((m, n)).astype(np.float32)
    a = rng.standard_normal((4 * n, n)).astype(np.float32)
    H = a.T @ a / (4 * n) + np.diag(rng.uniform(0, 1, n)).astype(np.float32)
    W = (rng.standard_normal((m, n)) * 0.02).astype(np.float32)
    SU = ((rng.standard_normal(n) > 0) * 2.0 - 1.0).astype(np.float32)
    return Wr, H.astype(np.float32), W, SU


DATA = {False: _data(M, N), True: _data(32, 128)}  # keyed by V=1

# (name, the reference's call, the port's call) over (Wr, H, use_hess)
MATS = {
    "tcq_6": (lambda w, h, u: jq.quantize_mat_tcq(w, h, 6, u),
              lambda w, h, u: quantizers.quantize_mat_tcq(w, h, 6, u)),
    "tcq1_1mad_3": (
        lambda w, h, u: jq.quantize_mat_tcq1(w, h, 3, "1mad", u),
        lambda w, h, u: quantizers.quantize_mat_tcq1(w, h, 3, "1mad", u)),
    "tcq1_2mad_3": (
        lambda w, h, u: jq.quantize_mat_tcq1(w, h, 3, "2mad", u),
        lambda w, h, u: quantizers.quantize_mat_tcq1(w, h, 3, "2mad", u)),
    "tcq2_dualmad_7": (
        lambda w, h, u: jq.quantize_mat_tcq2(w, h, 7, u, "dualmad"),
        lambda w, h, u: quantizers.quantize_mat_tcq2(w, h, 7, u,
                                                     "dualmad")),
    "tcq2_sum2_6": (
        lambda w, h, u: jq.quantize_mat_tcq2(w, h, 6, u, "sum2"),
        lambda w, h, u: quantizers.quantize_mat_tcq2(w, h, 6, u, "sum2")),
    "tcomb_6_7": (lambda w, h, u: jq.quantize_mat_combt(w, h, 6, 7, u),
                  lambda w, h, u: quantizers.quantize_mat_combt(w, h, 6, 7,
                                                                u)),
    "comb_6_7": (
        lambda w, h, u: jq.quantize_mat_comb(w, h, 6, 7, (40, 24), u),
        lambda w, h, u: quantizers.quantize_mat_comb(w, h, 6, 7, (40, 24),
                                                     u)),
    "ldlq_2_6": (lambda w, h, u: jq.quantize_mat_vq(w, h, 6, 2, u),
                 lambda w, h, u: quantizers.quantize_mat_vq(w, h, 6, 2, u)),
    "ldlq_1_4": (lambda w, h, u: jq.quantize_mat_vq(w, h, 4, 1, u),
                 lambda w, h, u: quantizers.quantize_mat_vq(w, h, 4, 1, u)),
}


def _arrays(linear):
    return {k: np.asarray(v) for k, v in linear.items()
            if isinstance(v, np.ndarray)}


def _rel_err(hat, Wr, Hm=None):
    E = np.asarray(hat, np.float64) - Wr
    if Hm is None:
        return (E ** 2).mean() / (Wr.astype(np.float64) ** 2).mean()
    return np.trace(E @ Hm @ E.T) / np.trace(Wr @ Hm @ Wr.T)


@pytest.mark.parametrize("name", sorted(MATS))
def test_quantize_mat_words_match_reference(name):
    """Without a Hessian: the same canonical words and meta, and W-hat."""
    jfn, fn = MATS[name]
    WR = DATA[name.startswith("tcq1")][0]
    jlin, jhat = jfn(jnp.asarray(WR), None, False)
    lin, hat = fn(torch.from_numpy(WR), None, False)
    ja, a = _arrays(jlin), _arrays(lin)
    assert ja.keys() == a.keys() and ja
    for k in ja:
        assert a[k].dtype == np.uint32 and np.array_equal(a[k], ja[k]), k
    assert {k: v for k, v in lin.items() if k not in a} == \
        {k: v for k, v in jlin.items() if k not in ja}
    assert np.array_equal(hat.numpy(), np.asarray(jhat))


# one case a tile order and quantizer path (tcq2 dualmad, tcq1 2mad and
# comb take the same recursion as sum2, 1mad and tcq)
@pytest.mark.parametrize("name", ["tcq_6", "tcq1_1mad_3", "tcq2_sum2_6",
                                  "tcomb_6_7", "ldlq_2_6", "ldlq_1_4"])
def test_quantize_mat_with_hessian_matches_reference(name):
    """With a Hessian (LDLQ feedback): the error tr(E H E^T) within
    HESS_TOL of the reference's, and below the error without one."""
    jfn, fn = MATS[name]
    WR, H = DATA[name.startswith("tcq1")][:2]
    _, jhat = jfn(jnp.asarray(WR), jnp.asarray(H), True)
    lin, hat = fn(torch.from_numpy(WR), torch.from_numpy(H), True)
    e, je = _rel_err(hat.numpy(), WR, H), _rel_err(jhat, WR, H)
    assert abs(e - je) <= HESS_TOL * je, (e, je)
    _, hat0 = fn(torch.from_numpy(WR), None, False)
    assert e < _rel_err(hat0.numpy(), WR, H)


FAMILIES = ["tcq_6_none_0.9", "tcq1_3_none_0.9", "tcq1x2_3_none_0.9",
            "tcq2_7_none_0.9", "tcq2s_6_none_0.9", "tcomb_6_7_0.5_none_0.9",
            "comb_6_7_0.5_none_0.9", "ldlq_2_6_none_1.0",
            "ldlq_1_4_none_1.0", "sq_4_none_1.0", "vq2_6_none_1.0",
            "rotfp16", "tcq_6_hess_0.9", "ldlq_2_6_hess_1.0",
            "sq_3_hess_1.0", "vq2_4_hess_1.0"]
FLOAT_META = ("err", "orig_err", "kurtosis", "skewness")


@pytest.mark.parametrize("qstr", FAMILIES)
def test_quantize_linear_artifact_matches_reference(qstr):
    """The same SU and Hessian: SU, Wscale (within an ulp-level rtol: the
    row RMS sums in another order), the words and tables, and the meta.
    vq2's codebook comes from another k-means seeding, so its words and
    codebook differ: its error is held within VQ2_TOL."""
    _, H, W, SU = DATA[qstr.startswith("tcq1")]
    ja = jinc.quantize_linear(W, qstr, SU=SU, H=H)
    art = incoherent.quantize_linear(W, qstr, SU=SU, H=H, device="cpu")
    assert art.keys() == ja.keys()
    assert np.array_equal(art["SU"], ja["SU"])
    assert np.allclose(art["Wscale"], ja["Wscale"], rtol=1e-6, atol=0)
    vq2 = qstr.startswith("vq2")
    for k in ja:
        if k in ("meta", "SU", "Wscale"):
            continue
        got, want = np.asarray(art[k]), np.asarray(ja[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "w":  # rotfp16: the rotated weight, float32 sums
            assert np.allclose(got, want, rtol=1e-5, atol=1e-6)
        elif k == "lut" and qstr.startswith("sq_"):
            assert np.allclose(got, want, rtol=1e-4, atol=1e-6)
        elif not vq2:
            assert np.array_equal(got, want), k
    meta, jmeta = art["meta"], ja["meta"]
    assert meta.keys() == jmeta.keys()
    for k in jmeta:
        if k in FLOAT_META:
            if vq2 and k in ("err", "orig_err"):
                assert meta[k] <= jmeta[k] * (1 + VQ2_TOL), (k, meta[k])
            else:
                assert np.isclose(meta[k], jmeta[k], rtol=META_RTOL,
                                  atol=META_ATOL), (k, meta[k], jmeta[k])
        else:
            assert meta[k] == jmeta[k], k


def test_proxy_err_matches_reference():
    """ldlq at 256^2 (the trellis case is in test_torch_viterbi.py, where
    its time balances this file's)."""
    got = err_tables.quantizer_proxy_err("ldlq_2_8_none_1.0", size=256,
                                         device="cpu")
    want = jerr.quantizer_proxy_err("ldlq_2_8_none_1.0", size=256)
    assert abs(got - want) <= PROXY_TOL * want, (got, want)
