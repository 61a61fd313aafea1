"""Port parity for perplexity evaluation: ce_loss against the reference's
for each head branch (bf16, the rotated int8 head, the 4-bit tcq2s
trellis head) with a chunk smaller than the sequence, so that full
chunks and the tail run; the 4-bit head's logits rounded to bf16 before
the log-softmax, as in the reference's ce_loss; eval_ppl over a 3-window
synthetic stream against exp of the mean ce_loss and the reference's
eval_ppl.

The model is LlamaConfig.tiny() (2 layers, hidden 128) with tcq2s_6
everywhere, built by the reference with dummy weights at impl xla and
carried over with params_from_jax; the port runs it at impl dequant (its
xla).  Tokens come from numpy seeds and go to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import evaluate as jevaluate
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import evaluate
from qpalette_tpu_torch.runtime.loader import build_quantized_model
from qpalette_tpu_torch.runtime.qlinear import qlinear_apply

QSTR = "tcq2s_6_none_0.9"
TOKENS = np.random.default_rng(1).integers(0, 256, (2, 20))
CHUNK = 8  # chunks of positions 0-7, 8-15 and the tail 16-18
# The mean CE of port and reference: the same weights, f32 sums in
# another order in the layers (bf16 roundings of the hidden state may
# flip), and for the 4-bit head int8 ties of its a8 activations.
# Measured 6.7e-5 (bf16 head), 9.2e-5 (int8), 2.6e-4 (4-bit).
CE_TOL = 1e-3
# the port's ce_loss against the test's own CE of its head logits
# rounded to bf16: the same operations, measured 7.5e-8; the CE of the
# unrounded float32 logits is 3.7e-5 away, so this bound tells them apart
ROUND_TOL = 1e-6
CTX, N_WINDOWS = 16, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{lm_head_bits: (reference spec, reference params, port spec, port
    params)}, each reference model built once."""
    out = {}
    for bits in (16, 8, 4):
        jspec, jparams = jbuild(JConfig.tiny(), QSTR, dummy=True,
                                impl="xla", lm_head_bits=bits)
        spec, _ = build_quantized_model(LlamaConfig.tiny(), QSTR, dummy=True,
                                        impl="dequant", lm_head_bits=bits,
                                        device="cpu")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                                 device="cpu")
        out[bits] = (jspec, jparams, spec, params)
    return out


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_ce_loss_matches_reference(models, bits):
    jspec, jparams, spec, params = models[bits]
    # the branch this case is about
    assert (spec.lm_head_spec is not None) == (bits == 4)
    assert ("lm_head_q" in params) == (bits == 8)
    if bits == 8:
        assert "lm_head_su" in params  # the rotated int8 head
    want = float(jevaluate.ce_loss(jspec, jparams,
                                   jnp.asarray(TOKENS, jnp.int32),
                                   chunk=CHUNK))
    got = evaluate.ce_loss(spec, params, torch.as_tensor(TOKENS),
                           chunk=CHUNK)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.isfinite(float(got))
    assert abs(float(got) - want) < CE_TOL, (float(got), want)


def test_ce_loss_chunks_agree_with_one_chunk(models):
    """The chunked head (bf16 and int8) gives the loss of one chunk over
    the whole sequence: the pad columns and the targets line up."""
    for bits in (16, 8):
        _, _, spec, params = models[bits]
        toks = torch.as_tensor(TOKENS)
        a = float(evaluate.ce_loss(spec, params, toks, chunk=CHUNK))
        b = float(evaluate.ce_loss(spec, params, toks, chunk=1024))
        assert abs(a - b) < ROUND_TOL, (bits, a, b)


def test_4bit_head_logits_rounded_to_bf16(models):
    """The 4-bit head's logits reach the log-softmax rounded to bf16, as
    the reference's ce_loss leaves them (qlinear_apply at the hidden
    state's dtype), though forward asks the head for float32."""
    _, _, spec, params = models[4]
    toks = torch.as_tensor(TOKENS)
    B, S = TOKENS.shape
    vocab = spec.config.vocab_size
    h = llama.forward(spec, params, toks, return_hidden=True)
    rounded = unrounded = 0.0
    for c0 in range(0, S - 1, CHUNK):
        c1 = min(c0 + CHUNK, S - 1)
        y = qlinear_apply(spec.lm_head_spec, params["lm_head_q4"],
                          h[:, c0:c1].reshape(-1, h.shape[-1]),
                          pre_rot=params["lm_head_su"],
                          out_dtype=torch.float32)
        tgt = toks[:, c0 + 1:c1 + 1, None]
        for logits, acc in ((y.to(torch.bfloat16).float(), "r"), (y, "u")):
            logp = torch.log_softmax(
                logits[:, :vocab].reshape(B, c1 - c0, vocab), dim=-1)
            nll = float(-logp.gather(-1, tgt).sum())
            if acc == "r":
                rounded += nll
            else:
                unrounded += nll
    got = float(evaluate.ce_loss(spec, params, toks, chunk=CHUNK))
    n = B * (S - 1)
    assert abs(got - rounded / n) < ROUND_TOL
    assert abs(got - unrounded / n) > ROUND_TOL


def test_eval_ppl_matches_mean_ce_and_reference(models):
    jspec, jparams, spec, params = models[16]
    # three windows and a remainder that is dropped
    stream = np.random.default_rng(2).integers(0, 256, CTX * N_WINDOWS + 5)
    ppl, avg = evaluate.eval_ppl(spec, params, stream, ctx_size=CTX,
                                 progress=False)
    losses = [float(evaluate.ce_loss(
        spec, params, torch.as_tensor(stream[i * CTX:(i + 1) * CTX][None])))
        for i in range(N_WINDOWS)]
    assert isinstance(ppl, float) and isinstance(avg, float)
    assert abs(avg - np.mean(losses)) < 1e-6
    assert abs(ppl - np.exp(np.mean(losses))) < 1e-6 * ppl
    jppl, javg = jevaluate.eval_ppl(jspec, jparams, stream, ctx_size=CTX,
                                    progress=False)
    assert abs(avg - javg) < CE_TOL, (avg, javg)
    assert abs(ppl / jppl - 1) < np.expm1(CE_TOL), (ppl, jppl)
