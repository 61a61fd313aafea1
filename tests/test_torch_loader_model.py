"""Port parity for the loader, (d) and the model half of (e) of
test_torch_loader.py (split from it so that each file's worker takes about
half the time): a 4-layer model that the JAX package quantized on demand
and wrote to disk at impl xla, loaded by the port from the same directory
at impl dequant: its spec, its params against params_from_jax of the
reference's, logits and greedy tokens; a stale or missing artifact is
quantized on demand, a foreign one raises.  The cases (CFG, QDICT,
MERGE, ...) are test_torch_loader.py's."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.ops.hadamard import get_had_factors as j_had_factors
from qpalette_tpu.quant import incoherent as jinc
from qpalette_tpu.runtime import loader as jloader

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.quant import incoherent
from qpalette_tpu_torch.runtime import decode, loader

from test_torch_loader import (CFG, JIMPL, KD, KQ, KV_, LOGIT_TOL, MERGE,
                               MODEL_KEY, N_STEPS, PROMPT, QDICT, _rel)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops (as
    test_torch_decode.py): parallel workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- (d) a model quantized and written by the reference ------------------

def _write_head_artifact(save_dir):
    """The 4-bit head's artifact: random tcq2s_8 words, the head's SU (seed
    0 * 7 + 99) and Hadamard stamp, in the reference's meta schema."""
    h, VP = CFG["hidden_size"], 4096
    rng = np.random.default_rng(5)
    su = (np.random.default_rng(99).standard_normal(h) > 0) * 2.0 - 1.0
    art = {"meta": {"quantizer_str": loader.LM_HEAD_QSTR, "kind": "tcq2",
                    "KV": 8, "decode_mode": "sum2", "in_features": h,
                    "out_features": VP, "rot_info": "skip_r",
                    "rot_blocks": 1, "had_factors": list(j_had_factors(h))},
           "SU": su.astype(np.float32),
           "Wscale": rng.uniform(0.01, 0.03, VP).astype(np.float32),
           "trellis": rng.integers(0, 1 << 32, ((VP // 16) * (h // 16), 32),
                                   dtype=np.uint32)}
    jinc.save_artifact(art, jinc.artifact_path(
        save_dir, MODEL_KEY, 0, loader.LM_HEAD_QSTR, *loader.LM_HEAD_LAYER))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The reference model, quantized on demand into save_dir, and the
    port's, loaded from it."""
    save_dir = str(tmp_path_factory.mktemp("quant_results"))
    _write_head_artifact(save_dir)
    dense = jloader.random_dense_params(JConfig(**CFG), seed=3)
    jspec, jparams = jloader.build_quantized_model(
        JConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=save_dir, dense_params=dense, dummy=False, impl="xla",
        lm_head_bits=4)
    spec, params = loader.build_quantized_model(
        LlamaConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=save_dir, dense_params=dense, dummy=False, impl="dequant",
        lm_head_bits=4, device="cpu")
    return jspec, jparams, spec, params, save_dir, dense


def _ref_greedy(jspec, jparams):
    """Eager reference prefill + N_STEPS greedy steps: (tokens (1,
    N_STEPS + 1), [logits of each forward's last position])."""
    caches = jllama.init_kv_caches(jspec, 1, PROMPT.shape[1] + N_STEPS)
    logits, caches = jllama.forward(jspec, jparams, jnp.asarray(PROMPT),
                                    kv_caches=caches, cache_pos=jnp.int32(0))
    outs, toks = [np.asarray(logits)], []
    for s in range(N_STEPS):
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(int(nxt[0, 0]))
        logits, caches = jllama.forward(
            jspec, jparams, nxt, kv_caches=caches,
            cache_pos=jnp.int32(PROMPT.shape[1] + s))
        outs.append(np.asarray(logits))
    toks.append(int(jnp.argmax(logits[0, -1])))
    return np.array([toks]), outs


def test_model_spec_matches_reference(model):
    """Every merge, kind and resolved impl of the reference's spec."""
    jspec, _, spec, _, _, _ = model
    for (ja, jm), (a, m) in zip(jspec.layers, spec.layers, strict=True):
        assert a.merge == ja.merge
        for (jn, jls), (n, ls) in zip(ja.projs + jm.projs, a.projs + m.projs,
                                      strict=True):
            assert (n, ls.kind, ls.split, ls.out_features) == (
                jn, jls.kind, tuple(jls.split), jls.out_features)
            assert JIMPL[ls.impl] == jls.impl, n
    merges = [a.merge for a, _ in spec.layers]
    assert merges == ["qkv", "qk", "kv", "qv"]
    assert {ls.impl for a, m in spec.layers
            for _, ls in a.projs + m.projs} == {"exact", "dequant"}
    assert spec.lm_head_spec.impl == "a8"


def test_model_params_equal_converted_reference(model):
    """The port's params, read from the reference's files, are bit-equal to
    params_from_jax of the reference's params.  One exception: the
    reference holds the codebook of a vq projection at impl xla in bf16;
    the port keeps the artifact's float32 codebook, equal after the bf16
    rounding that every vq kernel and plain version applies first."""
    jspec, jparams, spec, params, _, _ = model
    want = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                           device="cpu")
    assert params.keys() == want.keys()
    assert params["luts"].keys() == want["luts"].keys()

    def same(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif path.endswith(".lut") and a.dtype != b.dtype:
            raise AssertionError(path)
        elif path.endswith(".lut"):
            assert torch.equal(a.to(torch.bfloat16), b.to(torch.bfloat16))
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    for i, (lp, wp) in enumerate(zip(params["layers"], want["layers"],
                                     strict=True)):
        same(lp, wp, f"layers[{i}]")
    for key in set(params) - {"layers"}:
        same(params[key], want[key], key)


def test_model_logits_and_greedy_tokens_match_reference(model):
    """A 6-token prefill and 4 greedy decode steps: the port's logits,
    teacher-forced on the reference's tokens, within LOGIT_TOL of max|logit|
    at every forward, and the port's own greedy generate gives the
    reference's tokens up to a step where the reference's top-2 margin is
    below the tolerance (measured here: rel 0.7-1.4e-2, and a 0.37% margin
    at the second token, where the two part ways)."""
    jspec, jparams, spec, params, _, _ = model
    want_toks, want = _ref_greedy(jspec, jparams)
    caches = llama.init_kv_caches(spec, 1, PROMPT.shape[1] + N_STEPS, "cpu")
    logits, caches = llama.forward(spec, params, torch.as_tensor(PROMPT),
                                   kv_caches=caches, cache_pos=0)
    rels = [_rel(logits.numpy(), want[0])]
    for s in range(N_STEPS):
        tok = torch.tensor([[want_toks[0, s]]])
        logits, caches = llama.forward(spec, params, tok, kv_caches=caches,
                                       cache_pos=PROMPT.shape[1] + s)
        rels.append(_rel(logits.numpy(), want[s + 1]))
    assert max(rels) < LOGIT_TOL, rels
    got, _ = decode.generate(spec, params, PROMPT, N_STEPS + 1,
                             temperature=0.0)
    diff = np.nonzero(got[0, PROMPT.shape[1]:] != want_toks[0])[0]
    if diff.size:
        # a step may differ only where the reference's top-2 margin is
        # below the logit tolerance (then the continuations legitimately
        # part ways), as in test_torch_model.py
        i = diff[0]
        top2 = np.sort(want[i][0, -1])[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL * np.abs(want[i]).max(), i


# --- (e) what the port refuses --------------------------------------------

def test_stale_missing_and_foreign_artifacts_raise(model, tmp_path):
    """A missing artifact, and one whose had_factors stamp is stale, are
    quantized on demand from the dense weights and written back, as the
    reference does: the reference's own words (near-ties aside: Wscale
    differs from the reference's by an ulp in some rows) and meta; without
    dense weights a missing one raises; a tlut that is not the committed
    table raises."""
    _, _, _, _, save_dir, dense = model
    cfg = LlamaConfig(**CFG)

    def build(where, dp=dense):
        return loader.build_quantized_model(
            cfg, QDICT, merge_info=MERGE, model_key=MODEL_KEY,
            save_dir=where, dense_params=dp, dummy=False, impl="dequant",
            lm_head_bits=4, device="cpu")

    work = str(tmp_path / "work")
    shutil.copytree(save_dir, work)

    def path(where, i, key):
        return incoherent.artifact_path(where, MODEL_KEY, 0,
                                        QDICT[f"{i}_{key}"][0], i, key)

    missing, stale = [(0, KD), (1, KV_)], (2, KQ)
    for i, key in missing:
        os.remove(path(work, i, key))
    art = incoherent.load_artifact(path(work, *stale))
    incoherent.save_artifact(
        dict(art, meta=dict(art["meta"], had_factors=[2, 64])),
        path(work, *stale))
    with pytest.raises(RuntimeError, match="missing"):
        build(work, dp=None)
    build(work)
    for i, key in missing + [stale]:
        got = incoherent.load_artifact(path(work, i, key))
        want = jinc.load_artifact(path(save_dir, i, key))
        assert got["meta"]["had_factors"] == want["meta"]["had_factors"] \
            == list(j_had_factors(got["meta"]["in_features"]))
        assert got.keys() == want.keys()
        for k in want:
            if k == "meta":
                assert got[k].keys() == want[k].keys()
            elif k == "Wscale":
                assert np.allclose(got[k], want[k], rtol=1e-6, atol=0)
            elif k in ("trellis", "qweight"):
                assert (got[k] != want[k]).mean() <= 1e-3, (i, key)
            elif k == "lut":  # sq_4's Lloyd's steps sum in another order
                assert np.allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
            else:
                assert np.array_equal(got[k], want[k]), (i, key, k)
    foreign = dict(art, tlut=art["tlut"] * 2)
    with pytest.raises(ValueError, match="tlut"):
        loader._params_from_artifact(foreign, "cpu")
    with pytest.raises(ValueError, match="tlut"):
        loader.merge_artifacts([art, foreign])
