"""Port parity for serving (runtime/serving.py and bench_serving) against
the JAX reference's runtime/serving.py, on the CPU, where the pool step
runs eagerly.

(a) The pool step and (b) admission on the tiny f32 dense config of the
reference's tests/test_serving.py, its weights carried over as float32
(params_from_jax would round them to bf16); (c) the ContinuousBatcher
against the reference's at temperature 0, 3 requests through 2 slots, at
burst 16 and 1; (d) a burst of n against n single steps, EOS inside a
burst, a full cache and max_new_tokens; (e) a 2-layer tcq2s model
(merged qkv/ug, the 4-bit head) at 10 slots, which takes K1's path above
8 rows; (f) bench_serving.main() on a tiny config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import loader as jloader
from qpalette_tpu.runtime import serving as jserving

from qpalette_tpu_torch import bench_serving
from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import serving
from qpalette_tpu_torch.runtime.loader import build_quantized_model

from test_torch_model import CFG as Q_CFG, MERGE as Q_MERGE, QDICT as Q_QDICT

# the reference's tests/test_serving.py model: decisive logits (weight
# scale 0.35), float32
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            rope_theta=10000.0)
# float32 on both sides; the sums run in another order: caches and logits
# agree to ~1e-6 of their max
F32_TOL = 1e-4
# the teacher-forced near-tie gap of the reference's test_serving.py
# (absolute, on these decisive logits)
NEAR_TIE = 0.3
# Port exact vs reference impl xla (test_torch_model.py's LOGIT_TOL: the
# xla path rounds decoded weights to bf16)
Q_LOGIT_TOL = 2e-2
# a8 against exact on the same pool buffers: int8 activations under one
# absmax a 512-column chunk over all rows (the reference's a8 numerics)
# move the 2-layer tcq2s model's logits by 1.7e-2 to 2.2e-2 of max|logit|
# in a pool of one row, and by 2.3e-2 to 6.1e-2 in a pool of 10, where a
# row's scale is set by its pool-mates (three seeds each)
A8_TOL = 1e-1
Q_SLOTS = 10


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
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    dense = jloader.random_dense_params(jcfg, seed=0, scale=0.35)
    jspec, jparams = jloader.build_dense_model(jcfg, dense)
    spec, _ = _port_dense(dense)
    params = jax.tree.map(lambda a: torch.as_tensor(np.array(a,
                                                             np.float32)),
                          jparams)
    return jspec, jparams, spec, params


def _port_dense(dense):
    from qpalette_tpu_torch.runtime.loader import build_dense_model
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    return build_dense_model(cfg, dense, device="cpu")


def _filled(spec, params, B, T, seed):
    """Caches of B rows whose first 8 positions hold a prefill of random
    tokens (the same on both sides); returns (port caches, jax caches)."""
    toks = np.random.default_rng(seed).integers(0, 256, (B, 8))
    caches = llama.init_kv_caches(spec, B, T, "cpu")
    llama.forward(spec, params, torch.as_tensor(toks), kv_caches=caches,
                  cache_pos=0)
    return caches, toks


def _jax_filled(jspec, jparams, toks, T):
    caches = jllama.init_kv_caches(jspec, toks.shape[0], T)
    _, caches = jllama.forward(jspec, jparams, jnp.asarray(toks, jnp.int32),
                               kv_caches=caches, cache_pos=jnp.int32(0))
    return caches


def test_pool_step_matches_reference(tiny):
    """(a) per-row positions [3, 5, 0], the last row inactive: the same
    next tokens at temperature 0 (0 in the inactive row), caches within
    F32_TOL; each row's token lands at its own position + 1 of the
    history and every position advances."""
    jspec, jparams, spec, params = tiny
    T = 16
    pos = np.array([3, 5, 0])
    active = np.array([True, True, False])
    tok = np.array([[7], [11], [13]])
    pool = serving.PoolStep(spec, params, 3, T, 0.0, None)
    caches, toks = _filled(spec, params, 3, T, seed=1)
    for mine, src in zip(pool.caches, caches):
        for a, b in zip(mine, src):
            a.copy_(b)
    pool.load(tok, pos, active)
    pool.replay(1)
    jcaches = _jax_filled(jspec, jparams, toks, T)
    jnxt, jcaches = jserving._pool_step(
        jspec, jparams, jnp.asarray(tok, jnp.int32), jcaches,
        jnp.asarray(pos, jnp.int32), jnp.asarray(active),
        jax.random.PRNGKey(0), temperature=0.0, top_k=None)
    np.testing.assert_array_equal(pool.token.numpy(), np.asarray(jnxt))
    assert pool.token[2, 0] == 0
    assert pool.pos.tolist() == (pos + 1).tolist()
    assert pool.read(pos, 1)[:, 0].tolist() == pool.token[:, 0].tolist()
    for mine, ref in zip(pool.caches, jcaches):
        for a, b in zip(mine, ref):
            assert _rel(a.numpy(), b) < F32_TOL


def test_prefill_slots_matches_reference(tiny):
    """(b) admission of slots [2, 0] with 4-token chunks at start positions
    [1, 3]: the written rows within F32_TOL of the reference's, slot 1's
    rows bit-unchanged."""
    jspec, jparams, spec, params = tiny
    T = 16
    caches, toks = _filled(spec, params, 3, T, seed=2)
    before = [tuple(c.clone() for c in kv) for kv in caches]
    slots = np.array([2, 0])
    chunk = np.random.default_rng(3).integers(0, 256, (2, 4))
    pos0 = np.array([1, 3])
    serving.prefill_slots(spec, params, caches, torch.as_tensor(slots),
                          torch.as_tensor(chunk), torch.as_tensor(pos0))
    jcaches = jserving._prefill_slots(
        jspec, jparams, _jax_filled(jspec, jparams, toks, T),
        jnp.asarray(slots, jnp.int32), jnp.asarray(chunk, jnp.int32),
        jnp.asarray(pos0, jnp.int32))
    for mine, old, ref in zip(caches, before, jcaches):
        for a, b, r in zip(mine, old, ref):
            assert torch.equal(a[1], b[1])
            assert _rel(a[slots].numpy(), np.asarray(r)[slots]) < F32_TOL
            assert not torch.equal(a[slots], b[slots])


def _near_greedy(spec, params, prompt, out, gap=NEAR_TIE):
    """Teacher-forced: every token is the argmax of a B=1 forward over its
    prefix, or within gap of it; returns how many are the argmax."""
    seq, agree = list(prompt), 0
    for tok in out:
        lg = llama.forward(spec, params, torch.as_tensor([seq]))[0, -1]
        best = int(torch.argmax(lg))
        agree += tok == best
        assert tok == best or float(lg[best] - lg[tok]) < gap, (tok, best)
        seq.append(tok)
    return agree


PROMPTS = [[1, 2], [2, 3, 4, 5, 6], [3, 4, 5]]


@pytest.fixture(scope="module")
def reference_runs(tiny):
    jspec, jparams, _, _ = tiny
    runs = {}
    for burst in (16, 1):
        cb = jserving.ContinuousBatcher(jspec, jparams, n_slots=2,
                                        max_seq=32, temperature=0.0)
        rids = [cb.submit(p, max_new_tokens=3 + 2 * i)
                for i, p in enumerate(PROMPTS)]
        done = cb.run(burst=burst)
        runs[burst] = [done[r].output for r in rids]
    return runs


@pytest.mark.parametrize("burst", [16, 1])
def test_batcher_matches_reference(tiny, reference_runs, burst):
    """(c) 3 requests through 2 slots: every request finishes with
    max_new_tokens tokens, as the reference's, each token the
    reference's or a near-tie of the teacher-forced argmax."""
    _, _, spec, params = tiny
    cb = serving.ContinuousBatcher(spec, params, n_slots=2, max_seq=32,
                                   temperature=0.0)
    rids = [cb.submit(p, max_new_tokens=3 + 2 * i)
            for i, p in enumerate(PROMPTS)]
    done = cb.run(burst=burst)
    assert set(done) == set(rids)
    for i, (rid, ref) in enumerate(zip(rids, reference_runs[burst])):
        out = done[rid].output
        assert len(out) == len(ref) == 3 + 2 * i
        if out != ref:
            assert _near_greedy(spec, params, PROMPTS[i], out) >= len(out) - 2


def _batcher(tiny, **kw):
    _, _, spec, params = tiny
    return serving.ContinuousBatcher(spec, params, n_slots=2, **kw)


def test_burst_equals_steps(tiny):
    """(d) step_burst(n) gives the tokens, positions and caches of n
    step() calls from the same state: sampled (temperature 0.6, top-k 5)
    from one seed, since a burst is n draws of the same generator."""
    outs = []
    for use_burst in (True, False):
        cb = _batcher(tiny, max_seq=32, temperature=0.6, top_k=5, seed=3)
        rids = [cb.submit(p, max_new_tokens=20) for p in PROMPTS[:2]]
        cb._admit()
        if use_burst:
            cb.step_burst(6)
        else:
            for _ in range(6):
                cb.step()
        outs.append(([cb.slot_req[s].output for s in range(2)],
                     cb.positions.copy(),
                     [tuple(c.clone() for c in kv) for kv in cb.caches]))
        assert [r.rid for r in cb.slot_req] == rids
    (ta, pa, ca), (tb, pb, cb_) = outs
    assert ta == tb and all(len(t) == 6 for t in ta)
    assert pa.tolist() == pb.tolist()
    assert all(torch.equal(a, b) for x, y in zip(ca, cb_)
               for a, b in zip(x, y))


@pytest.mark.parametrize("burst", [16, 1])
def test_eos_full_cache_and_budget(tiny, burst):
    """(d) EOS inside a burst trims the output after it and frees the
    slot; a full cache stops a request at max_seq - 1 positions; every
    other request ends with max_new_tokens tokens."""
    cb = _batcher(tiny, max_seq=32, temperature=0.0)
    rid = cb.submit(PROMPTS[0], max_new_tokens=12)
    free = cb.run(burst=burst)[rid].output
    eos = free[4]
    cut = free.index(eos) + 1
    cb = _batcher(tiny, max_seq=32, temperature=0.0, eos_id=eos)
    rids = [cb.submit(PROMPTS[0], max_new_tokens=12),
            cb.submit(PROMPTS[1], max_new_tokens=12)]
    done = cb.run(burst=burst)
    assert done[rids[0]].output == free[:cut] and done[rids[0]].done
    assert len(done[rids[1]].output) <= 12
    assert (len(done[rids[1]].output) == 12
            or done[rids[1]].output[-1] == eos)
    cb = _batcher(tiny, max_seq=10, temperature=0.0)
    rids = [cb.submit(PROMPTS[1], max_new_tokens=100),
            cb.submit(PROMPTS[0], max_new_tokens=3)]
    done = cb.run(burst=burst)
    # ctx of 4 tokens at positions 0-3; done when position + 1 reaches 10
    assert len(done[rids[0]].output) == 10 - len(PROMPTS[1])
    assert len(done[rids[1]].output) == 3
    with pytest.raises(ValueError):
        cb.submit(list(range(11)))


@pytest.fixture(scope="module")
def qmodel():
    """The 2-layer tcq2s model (merged qkv/ug, 4-bit tcq2s_8 head): the
    reference at impl xla (its head pallas_a8, as the reference always
    builds it), carried over to the port at impl exact and a8."""
    jspec, jparams = jloader.build_quantized_model(
        JConfig(**Q_CFG), Q_QDICT, merge_info=Q_MERGE, dummy=True,
        impl="xla", lm_head_bits=4)
    npp = jax.tree.map(np.asarray, jparams)
    out = {"jax": (jspec, jparams)}
    for impl in ("exact", "a8"):
        spec, _ = build_quantized_model(
            LlamaConfig(**Q_CFG), Q_QDICT, merge_info=Q_MERGE, dummy=True,
            impl=impl, lm_head_bits=4, device="cpu")
        out[impl] = (spec, params_from_jax(npp, spec, device="cpu"))
    return out


Q_PROMPTS = [list(np.random.default_rng(20 + i).integers(0, 512, 6))
             for i in range(Q_SLOTS)]


def test_wide_pool_exact_matches_reference(qmodel):
    """(e) 10 requests of 6 tokens in 10 slots (the step at 10 rows: K1
    above 8 rows, the head's too), temperature 0, burst 1 on both
    sides (a burst moves the inactive rows' positions, and the a8 head's
    one absmax a chunk sees every row): the same output lengths, each
    token the reference's or a near-tie of a B=1 port forward (within
    Q_LOGIT_TOL of max|logit|)."""
    jspec, jparams = qmodel["jax"]
    spec, params = qmodel["exact"]
    outs = []
    for mod, sp, pp in ((jserving, jspec, jparams),
                        (serving, spec, params)):
        cb = mod.ContinuousBatcher(sp, pp, n_slots=Q_SLOTS, max_seq=16,
                                   temperature=0.0)
        rids = [cb.submit(p, max_new_tokens=4) for p in Q_PROMPTS]
        done = cb.run(burst=1)
        outs.append([done[r].output for r in rids])
    for prompt, ref, out in zip(Q_PROMPTS, *outs):
        assert len(out) == len(ref) == 4
        if out != ref:
            seq = list(prompt)
            for tok in out:
                lg = llama.forward(spec, params, torch.as_tensor([seq]))[0, -1]
                gap = float(lg.max() - lg[tok]) / float(lg.abs().max())
                assert gap < Q_LOGIT_TOL, (tok, gap)
                seq.append(tok)


def test_wide_pool_a8_within_bound(qmodel):
    """(e) the 10-row pool step at a8 against exact on the same buffers
    (per-row positions, two rows inactive): logits within A8_TOL of
    max|logit|."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (Q_SLOTS, 8))
    pos = rng.integers(0, 9, Q_SLOTS)
    active = np.arange(Q_SLOTS) < Q_SLOTS - 2
    tok = rng.integers(0, 512, (Q_SLOTS, 1))
    logits = {}
    for impl in ("exact", "a8"):
        spec, params = qmodel[impl]
        pool = serving.PoolStep(spec, params, Q_SLOTS, 12, 0.0, None)
        llama.forward(spec, params, torch.as_tensor(toks),
                      kv_caches=pool.caches, cache_pos=0)
        pool.load(tok, pos, active)
        pool.replay(1)
        logits[impl] = pool.logits.numpy()
    assert _rel(logits["a8"], logits["exact"]) < A8_TOL


def test_bench_serving_cpu(capsys):
    """(f) bench_serving.main() on the CPU with a 2-layer config: its JSON
    line carries the reference's keys, and admission is billed for the
    passes that filled a slot only (4 requests through 2 slots: 2)."""
    import json
    cfg = LlamaConfig(**Q_CFG)
    res = bench_serving.main(["--layers", "2", "--slots", "2",
                              "--prompt_len", "6", "--new_tokens", "3",
                              "--requests", "4", "--device", "cpu"], cfg=cfg)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    for key in ("metric", "value", "unit", "raw_tokens", "seconds",
                "admission_s", "prefill_chunk", "device", "sm_mhz",
                "peak_gb"):
        assert key in line
    assert line["raw_tokens"] == 4 * 3 and line["value"] > 0
    assert line["admissions"] == 2
    assert 0 < line["admission_s"] <= line["seconds"]
    assert line["device"].startswith("cpu")
