"""Port parity for the int8 lm_head (``lm_head_bits=8``): the plain
versions of K10 (int8_gemv_a8, the rotated head with int8 activations) and
K11 (int8_gemv, the head without the rotation) against the reference's
Pallas kernels in interpret mode, the head the loader builds, and a 2-layer
Llama (ldlq_1_4 everywhere, unmerged) with the rotated head, and with
``lm_head_su`` removed on both sides, carried over from the reference with
params_from_jax: decode steps (K10 / K11) and a 12-token prefill (the plain
product of q * s).

Inputs come from numpy seeds and go to both sides.  The reference model is
built once per file, at impl xla; its head runs the int8 Pallas kernels in
interpret mode at up to 8 rows."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import fused
from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.kernels import int8_gemv as ig
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import decode, loader
from qpalette_tpu_torch.runtime.loader import build_quantized_model

QSTR = "ldlq_1_4_none_1.0"
CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
VP = 2048  # the vocab padded to a multiple of 2048
PROMPT = np.random.default_rng(21).integers(0, 512, (1, 6)).astype(np.int32)
LONG = np.random.default_rng(22).integers(0, 512, (1, 12)).astype(np.int32)
N_NEW = 6
# The decoder layers agree as in the VQ slice's test: the same bf16
# weights, f32 sums in another order (the hidden state before the head
# within 7.6e-3 of its max).  Given the same hidden state the head agrees
# bit for bit (test_head_on_reference_hidden_state).  Through the model,
# the rotated head's one absmax over all rows (a quantization step of
# ~max|x|/127) turns those differences into flipped int8 roundings of x:
# measured 1.8e-2 for the 6-row prefill and below 1e-2 elsewhere.  The
# unrotated head and the 12-row product stay within the VQ slice's bound.
LOGIT_TOL = 1.5e-2
A8_LOGIT_TOL = 3e-2


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


def _head_case(N, k=512, m=VP, seed=0):
    rng = np.random.default_rng(seed + N)
    x = rng.standard_normal((N, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    s = (rng.random(m) * 1e-3).astype(np.float32)
    return x, wq, s


@pytest.mark.parametrize("N", [1, 3, 8])
def test_plain_a8_bit_equal_to_reference_kernel(N):
    """int8_gemv_a8_plain against fused.int8_gemv_a8 (interpret mode),
    bit for bit: one absmax over all rows, a true division, round half to
    even, an exact integer dot, float(acc) * (scales * sx)."""
    x, wq, s = _head_case(N)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(fused.int8_gemv_a8(xb, jnp.asarray(wq.T),
                                         jnp.asarray(s[None, :]), VP, 512))
    got = ig.int8_gemv_a8(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(wq), torch.from_numpy(s))
    assert got.shape == (N, VP)
    assert np.array_equal(got.numpy(), want)


def test_plain_a8_rounds_ties_as_the_reference():
    """x = max|x|/2 against a scale from a true division, 2.25 / sx, lies
    just below 63.5 and quantizes to 63; with the scale from a multiply by
    the reciprocal of 127 it would land just above and give 64."""
    x = np.zeros((2, 512), np.float32)
    x[0, :4] = [4.5, 2.25, -2.25, 1.0]
    wq = np.zeros((VP, 512), np.int8)
    wq[0, :4] = [0, 1, 0, 0]
    wq[1, :4] = [0, 0, 1, 0]
    s = np.ones(VP, np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(fused.int8_gemv_a8(xb, jnp.asarray(wq.T),
                                         jnp.asarray(s[None, :]), VP, 512))
    got = ig.int8_gemv_a8(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(wq), torch.from_numpy(s))
    assert np.array_equal(got.numpy(), want)
    sx = np.float32(np.float32(4.5) / np.float32(127.0)) + np.float32(1e-30)
    sx_recip = np.float32(4.5) * np.float32(1 / 127) + np.float32(1e-30)
    assert np.float32(2.25) / sx < 63.5 < np.float32(2.25) / sx_recip
    assert got[0, 0].item() == np.float32(63.0) * sx
    assert got[0, 1].item() == np.float32(-63.0) * sx


@pytest.mark.parametrize("N", [1, 8])
def test_plain_bf16_matches_reference_kernel(N):
    """int8_gemv_plain against fused.int8_gemv (interpret mode): the same
    bf16 x and exact int8 weights, f32 sums in another order."""
    x, wq, s = _head_case(N, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(fused.int8_gemv(xb, jnp.asarray(wq.T),
                                      jnp.asarray(s[None, :]), VP, 512))
    got = ig.int8_gemv(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(wq), torch.from_numpy(s))
    assert _rel(got.numpy(), want) < 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, wq, s = (torch.from_numpy(a) for a in _head_case(1))
    xb = x.to(torch.bfloat16)
    ig.int8_gemv(xb, wq, s)  # what they take
    with pytest.raises(ValueError):  # x dtype
        ig.int8_gemv_a8(x, wq, s)
    with pytest.raises(ValueError):  # more than 8 rows
        ig.int8_gemv(torch.zeros((9, 512), dtype=torch.bfloat16), wq, s)
    with pytest.raises(ValueError):  # k not a multiple of 16
        ig.int8_gemv(xb[:, :504].contiguous(), wq[:, :504].contiguous(), s)
    with pytest.raises(ValueError):  # scales of another length
        ig.int8_gemv_a8(xb, wq, s[:100])
    with pytest.raises(ValueError):  # weights not int8
        ig.int8_gemv_a8(xb, wq.float(), s)


# --- the 2-layer model with the int8 head against the reference ------------

@pytest.fixture(scope="module")
def ref():
    spec, params = jbuild(JConfig(**CFG), QSTR, dummy=True, impl="xla",
                          lm_head_bits=8)
    return spec, params, jax.tree.map(np.asarray, params)


def _port(ref, np_params=None):
    spec, _ = build_quantized_model(LlamaConfig(**CFG), QSTR, impl="a8",
                                    lm_head_bits=16, device="cpu")
    return spec, params_from_jax(ref[2] if np_params is None else np_params,
                                 spec, device="cpu")


def _unrotated(ref):
    """The reference's params without lm_head_su (its K11 branch)."""
    params = {k: v for k, v in ref[1].items() if k != "lm_head_su"}
    return params, {k: v for k, v in ref[2].items() if k != "lm_head_su"}


def test_loader_builds_the_reference_head():
    """build_quantized_model(lm_head_bits=8) on the CPU: the reference's
    su, and its q and s up to the f32 sum order of the Hadamard rotation
    (a scale within 1e-6, a weight at most one step apart, and rarely)."""
    jspec, jparams = jbuild(JConfig(**CFG), QSTR, dummy=True, impl="xla",
                            lm_head_bits=8)
    spec, params = build_quantized_model(LlamaConfig(**CFG), QSTR,
                                         impl="a8", lm_head_bits=8,
                                         device="cpu")
    assert spec.lm_head_spec is None and "lm_head" not in params
    q, s = params["lm_head_q"], params["lm_head_s"]
    assert q.dtype == torch.int8 and q.shape == (VP, 512)
    assert s.dtype == torch.float32 and s.shape == (VP,)
    assert np.array_equal(params["lm_head_su"].numpy(),
                          np.asarray(jparams["lm_head_su"]))
    jq = np.asarray(jparams["lm_head_q"]).T
    js = np.asarray(jparams["lm_head_s"])[0]
    assert _rel(s.numpy(), js) < 1e-6
    dq = np.abs(q.numpy().astype(np.int32) - jq)
    assert dq.max() <= 1 and dq.mean() < 1e-3
    assert not q[512:].any() and (s[512:] == 1.0).all()
    with pytest.raises(NotImplementedError):
        build_quantized_model(LlamaConfig(**CFG), QSTR, lm_head_bits=2,
                              device="cpu")


def test_params_from_jax_takes_the_int8_head(ref):
    spec, params = _port(ref)
    assert params["lm_head_q"].shape == (VP, 512)
    assert np.array_equal(params["lm_head_q"].numpy(),
                          np.asarray(ref[2]["lm_head_q"]).T)
    assert np.array_equal(params["lm_head_s"].numpy(),
                          np.asarray(ref[2]["lm_head_s"])[0])
    assert "lm_head_su" in params and "lm_head" not in params
    _, unrot = _port(ref, _unrotated(ref)[1])
    assert "lm_head_su" not in unrot


def _decode(spec, params, jspec, jparams):
    """A 6-token prefill and one step on both sides (up to 8 rows: the
    int8 GEMV)."""
    caches = jllama.init_kv_caches(jspec, 1, PROMPT.shape[1] + 2)
    want, caches = jdecode.prefill(jspec, jparams, jnp.asarray(PROMPT),
                                   caches)
    nxt = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want2, _ = jllama.forward(jspec, jparams, nxt, kv_caches=caches,
                              cache_pos=jnp.int32(PROMPT.shape[1]))
    tcaches = llama.init_kv_caches(spec, 1, PROMPT.shape[1] + 2, "cpu")
    got, tcaches = decode.prefill(spec, params,
                                  torch.as_tensor(PROMPT).long(), tcaches)
    got2, _ = llama.forward(spec, params,
                            torch.tensor(np.asarray(nxt)).long(),
                            kv_caches=tcaches, cache_pos=PROMPT.shape[1])
    return (got, want), (got2, want2)


@pytest.mark.parametrize("rotated", [True, False])
def test_head_on_reference_hidden_state(ref, rotated):
    """The port's head on the reference's own final hidden state: bit for
    bit through int8_gemv_a8 (6 rows, rotated); through int8_gemv (6 rows)
    and the f32 product (12 rows), f32 sums in another order."""
    jparams, np_params = (ref[1], ref[2]) if rotated else _unrotated(ref)
    _, params = _port(ref, np_params)
    for toks in (PROMPT, LONG):
        h = np.asarray(jllama.forward(ref[0], jparams, jnp.asarray(toks),
                                      return_hidden=True), np.float32)
        want = np.asarray(jllama.forward(ref[0], jparams, jnp.asarray(toks)))
        got = llama.int8_head(params, torch.from_numpy(h.reshape(-1, 512))
                              .to(torch.bfloat16))
        assert got.shape == (toks.shape[1], VP)
        got = got[:, :512].numpy().reshape(want.shape)
        if rotated and toks is PROMPT:
            assert np.array_equal(got, want)
        else:
            assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("rotated", [True, False])
def test_decode_logits_match_reference(ref, rotated):
    """Rotated (int8_gemv_a8, K10) and with lm_head_su removed on both
    sides (int8_gemv, K11): the logits of a 6-token prefill and a decode
    step, sliced back to the vocab; the CPU run launches no kernel."""
    jparams, np_params = (ref[1], ref[2]) if rotated else _unrotated(ref)
    spec, params = _port(ref, np_params)
    before = [f.launches for f in ig.KERNELS]
    tol = A8_LOGIT_TOL if rotated else LOGIT_TOL
    for got, want in _decode(spec, params, ref[0], jparams):
        assert got.shape == want.shape and got.shape[-1] == 512
        assert _rel(got.numpy(), want) < tol, rotated
    assert [f.launches for f in ig.KERNELS] == before == [0, 0]


def test_prefill_above_8_rows_matches_reference(ref):
    """12 rows: the head is the plain f32 product of q * s, rotated or
    not, as the reference's XLA branch."""
    for jparams, np_params in ((ref[1], ref[2]), _unrotated(ref)):
        spec, params = _port(ref, np_params)
        got = llama.forward(spec, params, torch.as_tensor(LONG).long())
        want = np.asarray(jllama.forward(ref[0], jparams, jnp.asarray(LONG)))
        assert got.shape == want.shape == (1, 12, 512)
        assert _rel(got.numpy(), want) < LOGIT_TOL


def test_greedy_tokens_match_reference(ref):
    """6 greedy tokens with the rotated head equal the reference's; a step
    may differ only where the reference's top-2 margin is below the logit
    tolerance."""
    spec, params = _port(ref)
    want, _ = jdecode.generate(ref[0], ref[1], PROMPT, N_NEW,
                               temperature=0.0)
    got, _ = decode.generate(spec, params, PROMPT, N_NEW, temperature=0.0)
    assert got.shape == want.shape
    diff = np.nonzero(got[0] != want[0])[0]
    if diff.size:
        i = diff[0]
        logits = np.asarray(jllama.forward(ref[0], ref[1],
                                           jnp.asarray(want[:, :i])))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < A8_LOGIT_TOL * np.abs(logits).max(), i


def test_int8_head_build_defaults_to_the_card():
    """build_quantized_model with lm_head_bits=8 runs on the card unless
    the caller asks for the CPU; measure_latency offers the head."""
    sig = inspect.signature(loader.build_quantized_model)
    assert sig.parameters["device"].default == "cuda"
    src = inspect.getsource(__import__(
        "qpalette_tpu_torch.measure_latency", fromlist=["main"]).main)
    assert "choices=[4, 8, 16]" in src
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_quantized_model(LlamaConfig(**CFG), QSTR, lm_head_bits=8)
