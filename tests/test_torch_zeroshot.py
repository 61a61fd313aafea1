"""Port parity for the zero-shot harness: loglikelihood and
eval_multiple_choice against the reference's on the bf16 tiny model
(random_dense_params, seed 0) carried over with params_from_jax, with
tests/test_zeroshot.py's character tokenizer.  The questions come from a
numpy seed; among them are questions whose raw and byte-normalised
argmax differ, and a tie (the same answer twice), which goes to the
first choice as np.argmax has it."""

import jax
import numpy as np
import pytest
import torch

from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import loader as jloader
from qpalette_tpu.runtime import zeroshot as jzeroshot

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import loader, zeroshot

# Summed log-probabilities of 2-25 continuation tokens: both sides take
# bf16 products into float32 in another order (tests/test_torch_dense.py:
# logits within ~4e-3 of max|logit|); measured up to 7.1e-3 on sums of
# -17 to -95.  The questions' top-2 margins are held above the two
# scores' bounds, so acc and acc_norm must agree exactly.
LL_TOL = 2e-2
WORDS = ["a", "bb", "ccc", "dog", "emu", "fig", "grape", "honey", "ice",
         "jungle", "kiwi", "lemonade", "mango", "nut"]


class MockTok:
    """tests/test_zeroshot.py's tokenizer: character ids (mod 200) after
    2, a BOS of 1 with special tokens."""

    class _Out(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text, add_special_tokens=True):
        ids = [1] if add_special_tokens else []
        ids += [2 + (ord(c) % 200) for c in text]
        return self._Out(ids)


def _examples():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(12):
        query = " ".join(rng.choice(WORDS, 5))
        choices = [" " + " ".join(rng.choice(WORDS, rng.integers(1, 4)))
                   for _ in range(4)]
        out.append({"query": query, "choices": choices,
                    "gold": int(rng.integers(0, 4))})
    # a tie: the second choice repeats the first, and it is gold
    out.append({"query": "dog emu", "choices": [" fig", " fig", " a"],
                "gold": 1})
    return out


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
    cfg = JConfig.tiny()
    jspec, jparams = jloader.build_dense_model(
        cfg, jloader.random_dense_params(cfg, seed=0))
    pcfg = LlamaConfig.tiny()
    spec, _ = loader.build_dense_model(
        pcfg, loader.random_dense_params(pcfg, seed=0), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                             device="cpu")
    return jspec, jparams, spec, params


@pytest.fixture(scope="module")
def scores(models):
    """{(question, choice): (reference score, port score, reference token
    count, port token count)}."""
    jspec, jparams, spec, params = models
    tok = MockTok()
    out = {}
    for i, ex in enumerate(_examples()):
        for j, ch in enumerate(ex["choices"]):
            js, jn = jzeroshot.loglikelihood(jspec, jparams, tok,
                                             ex["query"], ch)
            ps, pn = zeroshot.loglikelihood(spec, params, tok, ex["query"],
                                            ch)
            out[i, j] = (js, ps, jn, pn)
    return out


def test_loglikelihood_matches_reference(scores):
    for (i, j), (js, ps, jn, pn) in scores.items():
        assert isinstance(ps, float) and pn == jn
        assert ps < 0
        assert abs(ps - js) < LL_TOL, (i, j, ps, js)


def test_loglikelihood_truncates_to_max_len(models):
    """max_len keeps the last tokens of context + continuation."""
    jspec, jparams, spec, params = models
    tok = MockTok()
    q, ch = "honey mango jungle kiwi", " lemonade nut"
    for max_len in (9, 14, 1024):
        js, jn = jzeroshot.loglikelihood(jspec, jparams, tok, q, ch,
                                         max_len=max_len)
        ps, pn = zeroshot.loglikelihood(spec, params, tok, q, ch,
                                        max_len=max_len)
        assert pn == jn == len(ch)
        assert abs(ps - js) < LL_TOL, (max_len, ps, js)


def test_eval_multiple_choice_matches_reference(models, scores):
    jspec, jparams, spec, params = models
    examples = _examples()
    raw_ne_norm = 0
    for i, ex in enumerate(examples):
        nbytes = np.array([len(c.encode()) for c in ex["choices"]])
        ps = np.array([scores[i, j][1] for j in range(len(nbytes))])
        raw_ne_norm += int(np.argmax(ps)) != int(np.argmax(ps / nbytes))
        if i < len(examples) - 1:  # the tie has no margin
            # each score within LL_TOL (LL_TOL / bytes normalised): the
            # best one stays ahead on both sides
            for s, err in ((ps, np.full_like(ps, LL_TOL)),
                           (ps / nbytes, LL_TOL / nbytes)):
                a, b = np.argsort(s)[-2:][::-1]
                assert s[a] - s[b] > err[a] + err[b], (i, s, err)
    assert raw_ne_norm >= 3
    want = jzeroshot.eval_multiple_choice(jspec, jparams, MockTok(), examples)
    got = zeroshot.eval_multiple_choice(spec, params, MockTok(), examples)
    assert got == want
    assert got["n"] == len(examples)
    # the tie goes to the first choice, so the gold second one is missed
    tie = zeroshot.eval_multiple_choice(spec, params, MockTok(),
                                        examples[-1:])
    assert tie == {"acc": 0.0, "acc_norm": 0.0, "n": 1}
