"""Port parity for the whole slice: a 2-layer Llama with merged qkv/ug, a
tcq2s_4/6/8 mix and a 4-bit tcq2s lm_head, built by the reference with
dummy weights and carried over exactly with params_from_jax.

Hidden 512 factors as (2, 256) and intermediate 1792 as (28, 64): the
same two-factor and Paley rotation paths as the 8B's (16, 256) and
(56, 256)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.kernels.arith import tcq2s_decode_gemv
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import decode
from qpalette_tpu_torch.runtime.loader import build_quantized_model

CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
MIX = [dict(qkv=6, o=4, ug=6, down=8), dict(qkv=8, o=6, ug=4, down=6)]
GROUP = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
         "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
         "mlp.gate_proj": "ug", "mlp.up_proj": "ug", "mlp.down_proj": "down"}
QDICT = {f"{i}_{key}": (f"tcq2s_{mix[g]}_none_0.9", "0")
         for i, mix in enumerate(MIX) for key, g in GROUP.items()}
MERGE = [["merge_qkv", "merge_ug"]] * 2
PROMPT = np.random.default_rng(7).integers(0, 512, (1, 6)).astype(np.int32)
# Port exact vs reference impl xla: the xla path rounds the decoded weights
# to bf16 before its matmul (loader.py luts / qlinear.py dequant), the
# exact kernel keeps them exact; through 2 layers that moves the logits by
# up to ~1.5e-2 of max|logit|.  Both sides run the lm_head through a8 with
# one 512-column chunk, so the head adds only its int8 ties.
LOGIT_TOL = 2e-2
N_NEW = 8
T_CACHE = PROMPT.shape[1] + N_NEW  # the reference generate's cache length


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


def _build_ref():
    """The reference model: impl xla (canonical trellis) plus the same
    weights in its pallas_a8 form (planar words)."""
    spec, params = jbuild(JConfig(**CFG), QDICT, merge_info=MERGE,
                          dummy=True, impl="xla", lm_head_bits=4)

    def a8_proj(ls):
        return dataclasses.replace(ls, impl="pallas_a8")

    layers, layers_p = [], []
    for (a, m), lp in zip(spec.layers, params["layers"]):
        layers.append((dataclasses.replace(a, projs=tuple(
            (n, a8_proj(ls)) for n, ls in a.projs)),
            dataclasses.replace(m, projs=tuple(
                (n, a8_proj(ls)) for n, ls in m.projs))))
        specs = dict(a.projs + m.projs)
        lp2 = dict(lp)
        for n, ls in specs.items():
            lp2[n] = {"wscale": lp[n]["wscale"],
                      "trellis_pl": kf.tcq2_planar_weights(
                          lp[n]["trellis"], ls.out_features, ls.in_features,
                          ls.KV[0])}
        layers_p.append(lp2)
    spec_a8 = dataclasses.replace(spec, layers=tuple(layers))
    params_a8 = dict(params, layers=layers_p)
    np_params = jax.tree.map(np.asarray, params)
    return spec, params, spec_a8, params_a8, np_params


@pytest.fixture(scope="module")
def ref():
    return _build_ref()


def _port(ref, impl):
    spec, _ = build_quantized_model(LlamaConfig(**CFG), QDICT,
                                    merge_info=MERGE, dummy=True, impl=impl,
                                    lm_head_bits=4, device="cpu")
    return spec, params_from_jax(ref[4], spec, device="cpu")


def _ref_prefill_and_step(spec, params, T):
    caches = jllama.init_kv_caches(spec, 1, T)
    logits, caches = jdecode.prefill(spec, params, jnp.asarray(PROMPT),
                                     caches)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    step = jax.jit(jllama.forward, static_argnames=("spec",))
    logits2, _ = step(spec, params, nxt, kv_caches=caches,
                      cache_pos=jnp.int32(PROMPT.shape[1]))
    return np.asarray(logits), np.asarray(nxt), np.asarray(logits2)


def _port_prefill_and_step(spec, params, T, nxt):
    caches = llama.init_kv_caches(spec, 1, T, "cpu")
    logits, caches = decode.prefill(spec, params,
                                    torch.as_tensor(PROMPT).long(), caches)
    logits2, _ = llama.forward(spec, params, torch.tensor(nxt).long(),
                               kv_caches=caches, cache_pos=PROMPT.shape[1])
    return logits.numpy(), logits2.numpy()


def test_exact_logits_match_reference_xla(ref):
    spec, params = _port(ref, "exact")
    want, nxt, want2 = _ref_prefill_and_step(ref[0], ref[1], T_CACHE)
    got, got2 = _port_prefill_and_step(spec, params, T_CACHE, nxt)
    assert got.shape == want.shape == (1, PROMPT.shape[1], 512)
    assert _rel(got, want) < LOGIT_TOL
    assert _rel(got2, want2) < LOGIT_TOL


def test_greedy_tokens_match_reference(ref):
    """8 greedy tokens equal the reference's generate.  A step may differ
    only where the reference's top-2 margin is below the logit tolerance
    (then the two continuations legitimately part ways)."""
    spec, params = _port(ref, "exact")
    want, _ = jdecode.generate(ref[0], ref[1], PROMPT, N_NEW,
                               temperature=0.0)
    got, _ = decode.generate(spec, params, PROMPT, N_NEW, temperature=0.0)
    assert got.shape == want.shape == (1, T_CACHE)
    diff = np.nonzero(got[0] != want[0])[0]
    if diff.size:
        i = diff[0]
        logits = np.asarray(jllama.forward(ref[0], ref[1],
                                           jnp.asarray(want[:, :i])))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL * np.abs(logits).max(), i


def _first_layer(spec, params):
    cfg = dataclasses.replace(spec.config, num_layers=1)
    return (dataclasses.replace(spec, config=cfg, layers=spec.layers[:1]),
            dict(params, layers=params["layers"][:1]))


def test_a8_logits_match_reference_pallas_a8(ref):
    """Prefill logits through layer 0 (KV 6/4/6/8) and the KV-8 lm_head:
    every reference kernel shape compiles in interpret mode, so the second
    layer's shapes would double the cost without a new code path."""
    spec, params = _first_layer(*_port(ref, "a8"))
    jspec, jparams = _first_layer(ref[2], ref[3])
    want = np.asarray(jllama.forward(jspec, jparams, jnp.asarray(PROMPT)))
    got = llama.forward(spec, params, torch.as_tensor(PROMPT).long())
    # int8 activations on both sides; chunk widths differ where the
    # reference's tuned k-chunk is not 512 columns (down_proj at k=1792)
    assert _rel(got.numpy(), want) < 0.05


def test_cpu_path_launches_no_kernel(ref):
    spec, params = _port(ref, "a8")
    before = tcq2s_decode_gemv.launches
    logits = llama.forward(spec, params, torch.as_tensor(PROMPT).long())
    assert torch.isfinite(logits).all()
    assert tcq2s_decode_gemv.launches == before == 0
