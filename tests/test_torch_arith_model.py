"""Port parity for the whole arithmetic-trellis slice: a 2-layer Llama
with bench.py's tcq2mix scheme mix (merged qkv tcq2_6 and gate/up tcq2_7
in mode dualmad, o/down tcq1_3 in mode 1mad, a 4-bit tcq2s_8 lm_head),
built by the reference with dummy weights and carried over exactly with
params_from_jax: logits and greedy tokens under exact (vs the reference's
xla) and a8 (vs its pallas_a8), and a 300-token exact prefill, which takes
the dequant kernels' route.  Also: the entry points default to the card.

The model is 64 wide (k/16 = 4 and 8, even): the reference's pallas_a8
kernels run in interpret mode at a few seconds a shape."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime import loader as jloader

from qpalette_tpu_torch import convert
from qpalette_tpu_torch.kernels import arith, arith_dequant
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import decode, loader


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


def _planar(words, mode, KV, m, k):
    f = (kf.tcq1_planar_weights if mode in ("1mad", "2mad")
         else kf.tcq2_planar_weights)
    return f(jnp.asarray(words), m, k, KV)


CFG = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=2, num_kv_heads=1, head_dim=32,
           rope_theta=5e5)
QSTR = {"self_attn.q_proj": "tcq2_6_none_0.9",
        "self_attn.k_proj": "tcq2_6_none_0.9",
        "self_attn.v_proj": "tcq2_6_none_0.9",
        "self_attn.o_proj": "tcq1_3_none_0.9",
        "mlp.gate_proj": "tcq2_7_none_0.9", "mlp.up_proj": "tcq2_7_none_0.9",
        "mlp.down_proj": "tcq1_3_none_0.9"}  # bench.py's tcq2mix
QDICT = {f"{i}_{key}": q for i in range(2) for key, q in QSTR.items()}
MERGE = [["merge_qkv", "merge_ug"]] * 2
PROMPT = np.random.default_rng(7).integers(0, 512, (1, 6)).astype(np.int32)
LONG = np.random.default_rng(8).integers(0, 512, (1, 300)).astype(np.int32)
N_NEW = 6
# Port exact vs reference xla: the xla path rounds decoded weights to bf16,
# the exact K1 keeps them exact (up to ~1.5e-2 of max|logit| through 2
# layers; the dequant route above 256 rows rounds as xla does).  Port a8 vs
# pallas_a8: int8 ties and tcq1's 2*sum(x) epilogue (see A8_TOL in
# test_torch_arith.py), spread by the rotations.  Both sides run the 4-bit
# head through a8 with one k-chunk.
LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def ref():
    """The reference model at impl xla (canonical trellis) and the same
    weights in its pallas_a8 form (planar words)."""
    spec, params = jloader.build_quantized_model(
        JConfig(**CFG), QDICT, merge_info=MERGE, dummy=True, impl="xla",
        lm_head_bits=4)

    def a8(ls):
        return dataclasses.replace(ls, impl="pallas_a8")

    layers, layers_p = [], []
    for (a, m), lp in zip(spec.layers, params["layers"]):
        layers.append((dataclasses.replace(a, projs=tuple(
            (n, a8(ls)) for n, ls in a.projs)),
            dataclasses.replace(m, projs=tuple(
                (n, a8(ls)) for n, ls in m.projs))))
        lp2 = dict(lp)
        for n, ls in a.projs + m.projs:
            mode = ls.mode
            lp2[n] = {"wscale": lp[n]["wscale"],
                      "trellis_pl": _planar(np.asarray(lp[n]["trellis"]),
                                            mode, ls.KV[0], ls.out_features,
                                            ls.in_features)}
        layers_p.append(lp2)
    spec_a8 = dataclasses.replace(spec, layers=tuple(layers))
    params_a8 = dict(params, layers=layers_p)
    return (spec, params, spec_a8, params_a8,
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, params_a8))


def _port(ref, impl, np_params=None):
    spec, _ = loader.build_quantized_model(
        LlamaConfig(**CFG), QDICT, merge_info=MERGE, dummy=True, impl=impl,
        lm_head_bits=4, device="cpu")
    return spec, convert.params_from_jax(
        ref[4] if np_params is None else np_params, spec, device="cpu")


def test_tcq2mix_builds_with_reference_specs(ref):
    """Merged qkv tcq2_6 and ug tcq2_7 (dualmad), o/down tcq1_3 (1mad),
    the tcq2s_8 head; the planar (pallas) params carry over to the same
    canonical words as the xla ones."""
    spec, params = _port(ref, "exact")
    for (a, m), (ja, jm) in zip(spec.layers, ref[0].layers):
        for (n, ls), (jn, jls) in zip(a.projs + m.projs, ja.projs + jm.projs):
            assert (n, ls.kind, ls.mode, ls.KV, ls.in_features,
                    ls.out_features) == (jn, jls.kind, jls.mode, jls.KV,
                                         jls.in_features, jls.out_features)
    kinds = {(n, ls.kind, ls.mode, ls.KV) for n, ls in
             spec.layers[0][0].projs + spec.layers[0][1].projs}
    assert kinds == {("qkv", "tcq2", "dualmad", (6,)),
                     ("o", "tcq1", "1mad", (3,)),
                     ("ug", "tcq2", "dualmad", (7,)),
                     ("down", "tcq1", "1mad", (3,))}
    assert params["layers"][0]["o"]["trellis"].shape == (16, 24)
    _, params_pl = _port(ref, "exact", np_params=ref[5])
    for lp, lp2 in zip(params["layers"], params_pl["layers"]):
        for n in ("qkv", "o", "ug", "down"):
            assert torch.equal(lp[n]["trellis"], lp2[n]["trellis"]), n


def _ref_greedy(spec, params):
    """Prefill, then N_NEW - 1 greedy steps through the reference's eager
    forward (each kernel shape compiles once); logits of every forward."""
    caches = jllama.init_kv_caches(spec, 1, PROMPT.shape[1] + N_NEW)
    logits, caches = jdecode.prefill(spec, params, jnp.asarray(PROMPT),
                                     caches)
    out = [np.asarray(logits)]
    for i in range(N_NEW - 1):
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        logits, caches = jllama.forward(
            spec, params, nxt, kv_caches=caches,
            cache_pos=jnp.int32(PROMPT.shape[1] + i))
        out.append(np.asarray(logits))
    return out


def _port_step(spec, params, toks, caches, pos):
    return llama.forward(spec, params, torch.as_tensor(toks).long(),
                         kv_caches=caches, cache_pos=pos)


@pytest.mark.parametrize("impl", ["exact", "a8"])
def test_tcq2mix_logits_and_greedy_tokens_match_reference(ref, impl):
    """exact vs the reference's xla, a8 vs its pallas_a8: the prefill's and
    every greedy step's logits, and the greedy tokens.  Each side feeds
    back its own argmax; a token may differ only where the reference's
    top-2 margin is below the logit tolerance (then the continuations
    legitimately part ways, and the comparison stops there)."""
    jspec, jparams = (ref[0], ref[1]) if impl == "exact" else (ref[2],
                                                               ref[3])
    spec, params = _port(ref, impl)
    want = _ref_greedy(jspec, jparams)
    caches = llama.init_kv_caches(spec, 1, PROMPT.shape[1] + N_NEW, "cpu")
    got, caches = _port_step(spec, params, PROMPT, caches, 0)
    assert got.shape == want[0].shape == (1, PROMPT.shape[1], 512)
    for i, w in enumerate(want):
        assert _rel(got.numpy(), w) < LOGIT_TOL, i
        tok, wtok = int(got[0, -1].argmax()), int(w[0, -1].argmax())
        if tok != wtok:
            top2 = np.sort(w[0, -1])[-2:]
            assert top2[1] - top2[0] < LOGIT_TOL * np.abs(w).max(), i
            break
        if i + 1 < len(want):
            got, caches = _port_step(spec, params, [[tok]], caches,
                                     PROMPT.shape[1] + i)


def test_tcq2mix_300_token_exact_prefill_matches_reference(ref):
    """Above 256 rows impl exact takes K2 (qkv, ug) and K3 (o, down) and
    an f32 product; the 4-bit head runs two 256-row a8 chunks.  On the CPU
    no kernel is launched."""
    spec, params = _port(ref, "exact")
    counted = arith.KERNELS + arith_dequant.KERNELS
    before = [f.launches for f in counted]
    got = llama.forward(spec, params, torch.as_tensor(LONG).long()).numpy()
    want = np.asarray(jllama.forward(ref[0], ref[1], jnp.asarray(LONG)))
    assert got.shape == want.shape == (1, 300, 512)
    assert np.isfinite(got).all()
    assert _rel(got, want) < LOGIT_TOL
    assert [f.launches for f in counted] == before


def test_entry_points_default_to_the_card():
    """build_quantized_model, params_from_jax and measure_latency run on
    the card unless the caller asks for the CPU."""
    for fn in (loader.build_quantized_model, convert.params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    src = inspect.getsource(__import__(
        "qpalette_tpu_torch.measure_latency", fromlist=["main"]).main)
    assert 'ap.add_argument("--device", default="cuda")' in src
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            loader.build_quantized_model(LlamaConfig(**CFG), QDICT,
                                         merge_info=MERGE, dummy=True)
