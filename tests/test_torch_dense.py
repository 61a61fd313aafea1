"""The bf16 baseline, every projection ``dense`` and unmerged: the port's
random_dense_params and build_dense_model against the reference's, and a
2-layer forward (a prefill and one cached decode step) against the JAX
forward on the same weights carried over with params_from_jax.  Neither
side rotates a dense group's activations: its weights are not rotated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import loader as jloader

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import loader

CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
SEED = 3
PROMPT = np.random.default_rng(9).integers(0, 512, (1, 6)).astype(np.int32)
NEXT = np.array([[17]], np.int32)
# Both sides take bf16 x bf16 products into float32 and round each
# projection's output to bf16; the sums run in another order, which can
# flip a bf16 rounding, and through 2 layers that moves the logits by
# ~3e-3 to 4e-3 of max|logit|.  A rotation of a dense group (the fault
# this file guards against) moves them by more than max|logit| itself.
LOGIT_TOL = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def ref():
    cfg = JConfig(**CFG)
    dense = jloader.random_dense_params(cfg, seed=SEED)
    spec, params = jloader.build_dense_model(cfg, dense)
    caches = jllama.init_kv_caches(spec, 1, PROMPT.shape[1] + 1)
    logits, caches = jllama.forward(spec, params, jnp.asarray(PROMPT),
                                    kv_caches=caches, cache_pos=jnp.int32(0))
    logits2, _ = jllama.forward(spec, params, jnp.asarray(NEXT),
                                kv_caches=caches,
                                cache_pos=jnp.int32(PROMPT.shape[1]))
    return (dense, jax.tree.map(np.asarray, params), np.asarray(logits),
            np.asarray(logits2))


def test_random_dense_params_match_reference(ref):
    got = loader.random_dense_params(LlamaConfig(**CFG), seed=SEED)
    want = ref[0]
    assert set(got) == set(want)
    for name in ("embed", "lm_head", "ln_f"):
        assert np.array_equal(got[name], want[name]), name
    for lg, lw in zip(got["layers"], want["layers"], strict=True):
        assert set(lg) == set(lw)
        for key in lw:
            assert np.array_equal(lg[key], lw[key]), key


def test_dense_logits_match_reference(ref):
    """The port's own bf16 baseline equals the reference's carried over,
    and its logits match the JAX forward's."""
    cfg = LlamaConfig(**CFG)
    spec, own = loader.build_dense_model(
        cfg, loader.random_dense_params(cfg, seed=SEED), device="cpu")
    assert all(ls.kind == "dense" for a, m in spec.layers
               for _, ls in a.projs + m.projs)
    params = params_from_jax(ref[1], spec, device="cpu")
    for lo, lp in zip(own["layers"], params["layers"], strict=True):
        for key, val in lo.items():
            got = val["w"] if isinstance(val, dict) else val
            want = lp[key]["w"] if isinstance(val, dict) else lp[key]
            assert torch.equal(got, want), key
    for name in ("embed", "lm_head", "ln_f"):
        assert torch.equal(own[name], params[name]), name
    caches = llama.init_kv_caches(spec, 1, PROMPT.shape[1] + 1, "cpu")
    logits, caches = llama.forward(spec, params,
                                   torch.as_tensor(PROMPT).long(),
                                   kv_caches=caches, cache_pos=0)
    logits2, _ = llama.forward(spec, params, torch.as_tensor(NEXT).long(),
                               kv_caches=caches, cache_pos=PROMPT.shape[1])
    assert logits.shape == ref[2].shape == (1, PROMPT.shape[1], 512)
    assert _rel(logits.numpy(), ref[2]) < LOGIT_TOL
    assert _rel(logits2.numpy(), ref[3]) < LOGIT_TOL
