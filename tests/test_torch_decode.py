"""Port parity for the decode engine's device-side state: cache positions
as a 0-d tensor and per row (B,), the int8 KV cache, return_hidden, and
the captured step's generate_fast / generate_scan (run eagerly here, on
the CPU), against the JAX reference.

The model is test_torch_model.py's 2-layer tcq2s mix (merged qkv/ug),
built by the reference at impl xla (no Pallas interpret calls) and carried
over exactly with params_from_jax; the port runs it at impl exact.  Its
lm_head is bf16: the reference's 4-bit trellis head costs ~12 s of XLA
compile in every program that reaches the logits, and the decode engine
does not depend on the head's kind."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime import loader as jloader
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import decode, loader
from qpalette_tpu_torch.runtime.loader import build_quantized_model

from test_torch_dense import CFG as DENSE_CFG, SEED as DENSE_SEED
from test_torch_model import CFG, LOGIT_TOL, MERGE, QDICT

PROMPT = np.random.default_rng(11).integers(0, 512, (1, 6)).astype(np.int32)
# teacher-forced decode tokens after PROMPT (the same on both sides)
STEPS = np.random.default_rng(12).integers(0, 512, (1, 4)).astype(np.int32)
N_NEW = 8
# the reference forward, compiled once per shape (eager JAX dispatches
# every op)
jforward = jax.jit(jllama.forward, static_argnames=("spec", "return_hidden"))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: parallel
    test workers, each with a thread a core, oversubscribe the cores (a
    position test took 78 s beside five other workers, 1.5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jspec, jparams = jbuild(JConfig(**CFG), QDICT, merge_info=MERGE,
                            dummy=True, impl="xla", lm_head_bits=16)
    spec, _ = build_quantized_model(LlamaConfig(**CFG), QDICT,
                                    merge_info=MERGE, dummy=True,
                                    impl="exact", lm_head_bits=16,
                                    device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                             device="cpu")
    return jspec, jparams, spec, params


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


def _port_run(spec, params, caches, pos_of):
    """Prefill PROMPT, then the STEPS tokens one at a time at the
    positions pos_of(int) gives; the logits of each call."""
    out = []
    logits, caches = llama.forward(spec, params, _t(PROMPT),
                                   kv_caches=caches, cache_pos=pos_of(0))
    out.append(logits)
    for i in range(STEPS.shape[1]):
        logits, caches = llama.forward(
            spec, params, _t(STEPS[:, i:i + 1]), kv_caches=caches,
            cache_pos=pos_of(PROMPT.shape[1] + i))
        out.append(logits)
    return out, caches


def _ref_run(jspec, jparams, caches):
    out = []
    logits, caches = jforward(jspec, jparams, jnp.asarray(PROMPT),
                                    kv_caches=caches, cache_pos=jnp.int32(0))
    out.append(np.asarray(logits))
    for i in range(STEPS.shape[1]):
        logits, caches = jllama.forward(
            jspec, jparams, jnp.asarray(STEPS[:, i:i + 1]), kv_caches=caches,
            cache_pos=jnp.int32(PROMPT.shape[1] + i))
        out.append(np.asarray(logits))
    return out, caches


T = PROMPT.shape[1] + STEPS.shape[1] + 2


@pytest.mark.parametrize("quantized", [False, True])
def test_tensor_position_bit_equal_to_int(models, quantized):
    """(a) a 0-d tensor cache_pos gives the int's logits and caches bit for
    bit, over a prefill and 4 steps, bf16 and int8 caches."""
    _, _, spec, params = models
    got = [_port_run(spec, params,
                     llama.init_kv_caches(spec, 1, T, "cpu", quantized),
                     pos_of) for pos_of in (int, torch.tensor)]
    (la, ca), (lb, cb) = got
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for x, y in zip(ca, cb)
               for a, b in zip(x, y))


def test_per_row_positions_match_reference(models):
    """(b) B = 2 at different positions: a 6-token forward at (0, 3) (its
    final hidden state compared: the reference compiles the lm_head once
    less), then a step at (6, 9), whose logits are within LOGIT_TOL of the
    reference's with the same (B,) positions; each row's cache is written
    only at its own positions."""
    jspec, jparams, spec, params = models
    toks = np.random.default_rng(13).integers(0, 512, (2, 6)).astype(
        np.int32)
    nxt = np.array([[5], [77]], np.int32)
    pos0, pos1 = np.array([0, 3], np.int32), np.array([6, 9], np.int32)
    Tb = 12
    jc = jllama.init_kv_caches(jspec, 2, Tb)
    want0, jc = jforward(jspec, jparams, jnp.asarray(toks), kv_caches=jc,
                         cache_pos=jnp.asarray(pos0), return_hidden=True)
    want1, _ = jforward(jspec, jparams, jnp.asarray(nxt), kv_caches=jc,
                        cache_pos=jnp.asarray(pos1))
    pc = llama.init_kv_caches(spec, 2, Tb, "cpu")
    got0, pc = llama.forward(spec, params, _t(toks), kv_caches=pc,
                             cache_pos=_t(pos0), return_hidden=True)
    got1, pc = llama.forward(spec, params, _t(nxt), kv_caches=pc,
                             cache_pos=_t(pos1))
    assert got1.shape == (2, 1, 512)
    assert _rel(got0.float().numpy(), want0) < LOGIT_TOL
    assert _rel(got1.numpy(), want1) < LOGIT_TOL
    for ck, cv in pc:
        for c in (ck, cv):
            written = c.abs().sum(dim=(2, 3)) != 0  # (B, T)
            assert written[0].nonzero().flatten().tolist() == list(range(7))
            assert written[1].nonzero().flatten().tolist() == list(
                range(3, 10))


def test_int8_kv_cache_matches_reference(models):
    """(c) the int8 KV cache.  The port's quantizer on the reference's own
    layer-0 k/v of the prefill (they depend on the tokens alone, so the
    bf16 cache holds the values the int8 path quantized) gives the
    reference's int8 values except at ties, each listed, and its scales
    within 1e-6 relative.  Logits of a prefill and 4 steps with
    quantized=True are within LOGIT_TOL of the reference's on the bf16
    baseline of test_torch_dense.py, whose k/v agree with the reference's
    to a bf16 rounding: on this tcq2s model the exact-vs-xla weights move
    k/v enough to flip int8 roundings, and the gap reaches 2.2e-2."""
    jspec, jparams, spec, params = models
    n = PROMPT.shape[1]
    ties = []
    caches = {}
    for quantized in (False, True):
        _, caches[quantized] = jforward(
            jspec, jparams, jnp.asarray(PROMPT),
            kv_caches=jllama.init_kv_caches(jspec, 1, n, quantized),
            cache_pos=jnp.int32(0), return_hidden=True)
    (k_bf, v_bf), (k8, ks, v8, vs) = caches[False][0], caches[True][0]
    for src, q_ref, s_ref in ((k_bf, k8, ks), (v_bf, v8, vs)):
        q, s = llama._q8(torch.from_numpy(np.asarray(src, np.float32))
                         .to(torch.bfloat16))
        q, q_ref, s_ref = q.numpy(), np.asarray(q_ref), np.asarray(s_ref)
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6, atol=0)
        r = np.asarray(src, np.float64) / s_ref.astype(np.float64)
        for idx in zip(*np.nonzero(q != q_ref)):
            ties.append((idx, float(r[idx]), int(q[idx]), int(q_ref[idx])))
            assert (abs(abs(r[idx]) % 1.0 - 0.5) < 1e-5
                    and abs(int(q[idx]) - int(q_ref[idx])) == 1), ties[-1]
    print(f"int8 ties (index, x/s, port, reference): {ties}")
    dcfg = DENSE_CFG
    dense = jloader.random_dense_params(JConfig(**dcfg), seed=DENSE_SEED)
    jdspec, jdparams = jloader.build_dense_model(JConfig(**dcfg), dense)
    dspec, dparams = loader.build_dense_model(
        LlamaConfig(**dcfg), loader.random_dense_params(LlamaConfig(**dcfg),
                                                        seed=DENSE_SEED),
        device="cpu")
    want, _ = _ref_run(jdspec, jdparams,
                       jllama.init_kv_caches(jdspec, 1, T, quantized=True))
    got, _ = _port_run(dspec, dparams,
                       llama.init_kv_caches(dspec, 1, T, "cpu", True), int)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < LOGIT_TOL


def test_return_hidden_matches_reference(models):
    """(d) the final-norm hidden state, with and without caches, within
    LOGIT_TOL of max|h| of the reference's (the same exact-vs-xla weight
    rounding as the logits': 1.1e-2 here), and exactly the lm_head's
    input."""
    jspec, jparams, spec, params = models
    want = np.asarray(jforward(jspec, jparams, jnp.asarray(PROMPT),
                               return_hidden=True), np.float32)
    got = llama.forward(spec, params, _t(PROMPT), return_hidden=True)
    assert got.shape == (1, PROMPT.shape[1], CFG["hidden_size"])
    assert _rel(got.float().numpy(), want) < LOGIT_TOL
    h, caches = llama.forward(spec, params, _t(PROMPT),
                              kv_caches=llama.init_kv_caches(spec, 1, T,
                                                             "cpu"),
                              return_hidden=True)
    assert torch.equal(h, got) and len(caches) == CFG["num_layers"]
    head = h.float() @ params["lm_head"].float().T
    logits = llama.forward(spec, params, _t(PROMPT))
    assert torch.equal(head.reshape(logits.shape), logits)


def _assert_greedy_equal(jspec, jparams, got, want):
    """Equal tokens, or a first difference where the reference's top-2
    margin is below the logit tolerance (then the continuations may
    legitimately part ways)."""
    assert got.shape == want.shape
    diff = np.nonzero(got[0] != want[0])[0]
    if diff.size:
        i = diff[0]
        logits = np.asarray(jforward(jspec, jparams,
                                           jnp.asarray(want[:, :i])))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL * np.abs(logits).max(), i


def test_greedy_generate_fast_and_scan_match_reference(models):
    """(e) port generate_fast and generate_scan at temperature 0 against
    the reference's generate_fast on the same prompt."""
    jspec, jparams, spec, params = models
    want, _ = jdecode.generate_fast(jspec, jparams, PROMPT, N_NEW,
                                    temperature=0.0)
    got, _ = decode.generate_fast(spec, params, PROMPT, N_NEW,
                                  temperature=0.0)
    _assert_greedy_equal(jspec, jparams, got, want)
    S = PROMPT.shape[1]
    caches = llama.init_kv_caches(spec, 1, S + N_NEW, "cpu")
    logits, caches = decode.prefill(spec, params, _t(PROMPT), caches)
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks, _ = decode.generate_scan(spec, params, cur, caches, S,
                                   torch.Generator(), N_NEW - 1,
                                   temperature=0.0)
    assert toks.shape == (1, N_NEW - 1)
    scan = np.concatenate([PROMPT, cur.numpy(), toks.numpy()], axis=1)
    assert np.array_equal(scan, got)


def test_generate_fast_times_a_warm_second_call(models):
    """(f) generate_fast reports one untimed call before the timed one,
    reuses its step, and its sampled tokens equal generate's (same seed,
    same generator draws)."""
    _, _, spec, params = models
    n = 4
    before = len(decode._CAPTURED)
    seq, stats = decode.generate_fast(spec, params, PROMPT, n, seed=5)
    seq2, _ = decode.generate_fast(spec, params, PROMPT, n, seed=5)
    assert len(decode._CAPTURED) <= before + 1
    assert stats["untimed_calls"] == 1
    assert stats["timed_tokens"] == n - 1
    assert stats["tokens_per_sec"] > 0 and not stats["captured"]
    ref, _ = decode.generate(spec, params, PROMPT, n, seed=5)
    assert np.array_equal(seq, seq2) and np.array_equal(seq, ref)
    decode.release_captured(params)
    assert all(k[0] != id(params) for k in decode._CAPTURED)


@pytest.mark.parametrize("quantized", [False, True])
def test_generate_scan_steps_as_eager_decode_step(models, quantized):
    """generate_scan (the captured step, run eagerly here) samples the
    tokens of an eager decode_step loop at int positions from the same
    seeded generator, over bf16 and int8 caches, and leaves the caller's
    generator where that loop leaves its own."""
    _, _, spec, params = models
    S, n = PROMPT.shape[1], 5
    out = []
    for scan in (True, False):
        caches = llama.init_kv_caches(spec, 1, S + n, "cpu", quantized)
        gen = torch.Generator().manual_seed(21)
        logits, caches = decode.prefill(spec, params, _t(PROMPT), caches)
        cur = decode.sample_logits(logits[:, -1], gen, 0.6, 5)[:, None]
        if scan:
            toks, _ = decode.generate_scan(spec, params, cur, caches, S, gen,
                                           n)
        else:
            steps = []
            for i in range(n):
                cur, caches = decode.decode_step(spec, params, cur, caches,
                                                 S + i, gen)
                steps.append(cur)
            toks = torch.cat(steps, dim=1)
        out.append((toks, gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    decode.release_captured(params)
