"""Port parity for the quality tools of quant/: the Hessian-weighted beam
over trellis tiles (quant/beam.py, quantize_mat_tcq / quantize_mat_tcq1's
``beam``) and coordinate-descent refinement of SQ/VQ codes
(quant/refine.py), against the JAX package on the same numpy-seeded
inputs.

The beam keeps its candidates by a stable sort of their scores, so ties
break toward the lower candidate index as lax.top_k breaks them: the
states must be equal wherever the float32 scores agree, and the result is
held by seq_objective too (never worse than the Viterbi seed, equal to the
reference's within 1e-5 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.quant import beam as jbeam
from qpalette_tpu.quant import quantizers as jq
from qpalette_tpu.quant import refine as jrefine

from qpalette_tpu_torch.ops import codebooks
from qpalette_tpu_torch.quant import beam, quantizers, refine, viterbi
from qpalette_tpu_torch.quant.ldlq import regularize_h

OBJ_TOL = 1e-5  # relative, seq_objective of the two packages' results


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, n, scale=1.0, ridge=0.1):
    A = rng.standard_normal((n, n)).astype(np.float32)
    return (scale * A @ A.T / n + ridge * np.eye(n)).astype(np.float32)


def _luts(v):
    if v == 2:
        return codebooks.trellis_lut(9), jnp.asarray(jcb.trellis_lut(9))
    return (codebooks.trellis_lut_arith("1mad"),
            jnp.asarray(jcb.trellis_lut_arith("1mad")))


@pytest.mark.parametrize("KV,v,width", [(6, 2, 8), (4, 2, 32), (2, 1, 64),
                                        (3, 1, 16)])
def test_beam_matches_reference(KV, v, width):
    """8 tiles, a within-tile weight kron(eye, D) (v = 2, row-major) or
    kron(D, eye) (v = 1, k-major) of a random SPD D: the beam from the
    port's Viterbi seed is never worse than the seed by seq_objective,
    equals the reference's beam from the same seed in objective and, tie
    for tie, in states, and keeps s0 and the tail-biting wrap."""
    rng = np.random.default_rng(KV * 100 + width)
    lut, jlut = _luts(v)
    D = _spd(rng, 16, scale=3.0)
    eye = np.eye(16, dtype=np.float32)
    Dt = np.kron(eye, D) if v == 2 else np.kron(D, eye)
    X = rng.standard_normal((8, 256)).astype(np.float32)
    hat0, st0 = viterbi.tcq_quantize(torch.from_numpy(X), lut, KV, v=v)
    hat, st = beam.tcq_quantize_beam(torch.from_numpy(X), lut,
                                     torch.from_numpy(Dt), st0, KV, v=v,
                                     beam=width)
    jh, js = jbeam.tcq_quantize_beam(
        jnp.asarray(X), jlut, jnp.asarray(Dt),
        jnp.asarray(st0.numpy().astype(np.int32)), KV, v=v, beam=width)
    Xt, Dtt = torch.from_numpy(X), torch.from_numpy(Dt)
    obj = beam.seq_objective(hat, Xt, Dtt).numpy()
    obj0 = beam.seq_objective(hat0, Xt, Dtt).numpy()
    jobj = np.asarray(jbeam.seq_objective(jh, jnp.asarray(X),
                                          jnp.asarray(Dt)))
    assert (obj <= obj0).all()
    assert np.abs(obj - jobj).max() <= OBJ_TOL * jobj.max()
    assert np.array_equal(st.numpy(), np.asarray(js))
    assert torch.equal(st[:, 0], st0[:, 0])
    # the refined states form a tail-biting stream: each state's carried
    # bits are its predecessor's, the first's the last's
    nxt = torch.roll(st, -1, dims=1)
    assert torch.equal(nxt & ((1 << (16 - KV)) - 1), st >> KV)


def test_wrap_constraints_match_reference():
    s0 = np.random.default_rng(1).integers(0, 1 << 16, 6)
    for S, KV in ((128, 6), (256, 2), (128, 9)):
        fm, fv = beam._wrap_constraints(torch.from_numpy(s0), S, KV)
        jfm, jfv = jbeam._wrap_constraints(jnp.asarray(s0, jnp.int32), S, KV)
        assert np.array_equal(fm.numpy(), np.asarray(jfm))
        assert np.array_equal(fv.numpy(), np.asarray(jfv))


@pytest.mark.parametrize("fn,KV,args", [
    ("quantize_mat_tcq", 4, {}),
    ("quantize_mat_tcq1", 3, {"mode": "1mad"})])
def test_quantize_mat_beam_matches_reference(fn, KV, args):
    """quantize_mat_tcq / quantize_mat_tcq1 with beam = 8 and a Hessian on
    a 32 x 64 weight: the same words and W-hat as the reference's, and a
    proxy error tr(E H E^T) no larger than without the beam."""
    rng = np.random.default_rng(KV)
    W = rng.standard_normal((32, 64)).astype(np.float32)
    H = _spd(rng, 64, ridge=0.5)
    lin, hat = getattr(quantizers, fn)(torch.from_numpy(W),
                                       torch.from_numpy(H), KV,
                                       use_hess=True, beam=8, **args)
    jlin, jhat = getattr(jq, fn)(jnp.asarray(W), jnp.asarray(H), KV,
                                 use_hess=True, beam=8, **args)
    assert np.array_equal(lin["trellis"], np.asarray(jlin["trellis"]))
    assert np.abs(hat.numpy() - np.asarray(jhat)).max() < 1e-6
    _, hat_v = getattr(quantizers, fn)(torch.from_numpy(W),
                                       torch.from_numpy(H), KV,
                                       use_hess=True, **args)

    def proxy(h):
        E = h.numpy() - W
        return float(np.trace(E @ H @ E.T))
    assert proxy(hat) <= proxy(hat_v) * (1 + 1e-6)


@pytest.mark.parametrize("bits,vec", [(4, 1), (6, 2)])
def test_refine_artifact_vq_matches_reference(bits, vec):
    """refine_artifact_vq on an LDLQ artifact (64 x 128, ldlq with a
    Hessian): tr(E H E^T) lowered or kept, as the reference's, the same
    words, and the meta's err and ``refined``."""
    rng = np.random.default_rng(bits + vec)
    W = rng.standard_normal((64, 128)).astype(np.float32)
    H = _spd(rng, 128, ridge=0.2)
    lin, _ = quantizers.quantize_mat_vq(torch.from_numpy(W),
                                        torch.from_numpy(H), bits, vec,
                                        use_hess=True)
    art = {"meta": {k: v for k, v in lin.items() if k != "qweight"},
           "qweight": lin["qweight"],
           "lut": np.asarray(codebooks.vq_lut(bits, vec)),
           "Wscale": rng.uniform(0.5, 1.5, 64).astype(np.float32)}
    out = refine.refine_artifact_vq(W, art, H, device="cpu")
    jout = jrefine.refine_artifact_vq(jnp.asarray(W), art, jnp.asarray(H))
    assert np.array_equal(out["qweight"], np.asarray(jout["qweight"]))
    assert out["meta"]["refined"] and jout["meta"]["refined"]
    assert abs(out["meta"]["err"] - jout["meta"]["err"]) <= 1e-5 * abs(
        jout["meta"]["err"])
    Hn = regularize_h(torch.from_numpy(H)).numpy()

    def obj(words):
        from qpalette_tpu_torch.ops.packing import dequant_lut, words_to_torch
        h = dequant_lut(words_to_torch(words), torch.from_numpy(art["lut"]),
                        64, 128, bits, vec).numpy()
        E = h - W
        return float(np.trace(E @ Hn @ E.T))
    assert obj(out["qweight"]) <= obj(art["qweight"]) * (1 + 1e-6)
