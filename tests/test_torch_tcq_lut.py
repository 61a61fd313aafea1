"""Port parity for the LUT trellis slice (tcq + input-split tcomb, the
3.25-bit memory-constrained flagship): codebooks, the m-major dequant, the
plain versions of the four kernels (tcq/tcomb GEMV and dequant), the
dispatch, the conversion of the reference's kernel layouts, and a 2-layer
model with the flagship's scheme mix against the reference at impl xla.

Inputs come from numpy seeds and go to both sides.  The reference model is
built once per file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import fused
from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.msq.memmodel import calc_avg_bits as j_avg_bits
from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime import qlinear as jqlinear
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.kernels import formats, tcq_lut
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq.memmodel import calc_avg_bits
from qpalette_tpu_torch.ops import codebooks, packing
from qpalette_tpu_torch.ops.packing import words_to_torch
from qpalette_tpu_torch.runtime import decode
from qpalette_tpu_torch.runtime.loader import build_quantized_model
from qpalette_tpu_torch.runtime.qlinear import LinearSpec, qlinear_apply

QDICT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "msq_results", "3_8b", "mem_constrained",
    "default", "3.25bit.json")
with open(QDICT_PATH) as _f:
    FLAGSHIP = json.load(_f)

# layers 0 and 1 of the flagship: q tcq_8 / tcomb_8_9, k/v tcq_10,
# o tcomb_8_9 / tcq_8, gate/up/down tcq_6 -> S = 9, 10 and 11
CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
PROMPT = np.random.default_rng(11).integers(0, 512, (1, 12)).astype(np.int32)
N_NEW = 8
T_CACHE = PROMPT.shape[1] + N_NEW
# Both sides round weights and activations to bf16 at the same places and
# sum in float32.  What is left is the order of the f32 sums in the
# 12-row products (torch's CPU GEMM against XLA's dot): where it flips the
# bf16 rounding of one activation, the next Hadamard rotation spreads that
# flip over the whole row.  Measured 7.5e-3 (prefill) and 7.9e-3 (decode
# step, which reads the prefill's cache) of max|logit|, for both impls; a
# 1-token forward, whose products sum in the same order, agrees within
# 4e-7.  (The tcq2s slice's model test allows 2e-2: there the reference
# rounds decoded weights to bf16 and the port does not.)
LOGIT_TOL = 1.5e-2
M, K = 64, 256  # projection shape of the kernel-level tests


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _words(rng, m, k, KV):
    return rng.integers(0, 1 << 32, ((m // 16) * (k // 16), 4 * KV),
                        dtype=np.uint32)


def _tlut(S):
    return torch.tensor(codebooks.trellis_tlut(S))


def _jluts(*bits):
    return {f"tcq{S}": jnp.asarray(jcb.trellis_lut(S), jnp.bfloat16)
            for S in bits}


# (kind, KV) cases: every KV of the flagship plus KV 9 (tcomb's second half
# alone: odd, 36 words per tile, windows wrap at other places), and KV 3
# (tcq_3 and tcomb_3_4 of the memory palette: 12-word tiles)
CASES = [("tcq", (6,)), ("tcq", (9,)), ("tcq", (10,)), ("tcomb", (8, 9)),
         ("tcq", (3,)), ("tcomb", (3, 4))]


def _case(kind, KV, seed, m=M, k=K):
    """Canonical words (numpy, per array name), the LinearSpec of both
    sides and the table bits."""
    rng = np.random.default_rng(seed)
    S = codebooks.tlut_bits_for_kv(max(KV))
    if kind == "tcq":
        words = {"trellis": _words(rng, m, k, KV[0])}
        split = ()
    else:
        words = {"trellis1": _words(rng, m, k // 2, KV[0]),
                 "trellis2": _words(rng, m, k // 2, KV[1])}
        split = (k // 2, k // 2)
    common = dict(in_features=k, out_features=m, KV=KV, tlut_bits=S,
                  split=split)
    return (words, LinearSpec(kind, impl="exact", **common),
            jqlinear.LinearSpec(kind, impl="xla", **common), S)


@pytest.mark.parametrize("S", [9, 10, 11])
def test_trellis_lut_matches_reference(S):
    assert np.array_equal(codebooks.trellis_lut(S).numpy(),
                          jcb.trellis_lut(S))
    for kv in range(1, 12):
        assert codebooks.tlut_bits_for_kv(kv) == jcb.tlut_bits_for_kv(kv)


@pytest.mark.parametrize("kind,KV", CASES)
def test_dequant_bit_equal_to_reference(kind, KV):
    """The port's dequant_tcq and the plain K6/K7 against the reference's
    xla dequant (packing.dequant_tcq with the lut in bf16), bit for bit."""
    words, spec, jspec, S = _case(kind, KV, seed=30 + sum(KV))
    jp = {n: jnp.asarray(w) for n, w in words.items()}
    want = np.asarray(jqlinear.dequant_weight(jspec, jp, _jluts(S)))
    want = want.view(np.uint16)  # bf16 bits
    tw = {n: words_to_torch(w) for n, w in words.items()}
    if kind == "tcq":
        lut = codebooks.trellis_lut(S).to(torch.bfloat16)
        got_ops = packing.dequant_tcq(tw["trellis"], lut, M, K, KV[0])
        assert np.array_equal(got_ops.view(torch.int16).numpy()
                              .view(np.uint16), want)
        got = tcq_lut.tcq_lut_dequant(tw["trellis"], _tlut(S), KV[0], M, K)
    else:
        got = tcq_lut.tcomb_lut_dequant(tw["trellis1"], tw["trellis2"],
                                        _tlut(S), *KV, M, K)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want)


def test_dequant_tcq_is_m_major():
    """State s = 8*row + t covers (row, 2t), (row, 2t+1): a one-hot state
    table shows where each state lands (tcq2's order would transpose)."""
    KV = 8
    words = words_to_torch(_words(np.random.default_rng(5), 16, 16, KV))
    states = packing.unpack_trellis(words, KV, 2)[0]  # (128,)
    lut = torch.zeros((1 << 16, 2))
    lut[states[8 * 3 + 5], :] = torch.tensor([1.0, 2.0])
    w = packing.dequant_tcq(words, lut, 16, 16, KV)
    assert w[3, 10] == 1.0 and w[3, 11] == 2.0


@pytest.mark.parametrize("kind,KV", CASES)
def test_dispatch_matches_reference_xla(kind, KV):
    """qlinear_apply through the plain K4/K5 (1 and 8 rows) and K6/K7 +
    product (12 rows), Wscale included, against the reference's
    qlinear_apply at impl xla."""
    words, spec, jspec, S = _case(kind, KV, seed=50 + sum(KV))
    rng = np.random.default_rng(60 + sum(KV))
    wscale = rng.uniform(0.5, 1.5, M).astype(np.float32)
    jp = {n: jnp.asarray(w) for n, w in words.items()}
    jp["wscale"] = jnp.asarray(wscale)
    p = {n: words_to_torch(w) for n, w in words.items()}
    p["wscale"] = torch.from_numpy(wscale)
    luts = {f"tcq{S}": _tlut(S)}
    before = [fn.launches for fn in tcq_lut.KERNELS]
    for rows in (1, 8, 12):
        z = rng.standard_normal((rows, K)).astype(np.float32)
        zb = jnp.asarray(z).astype(jnp.bfloat16)
        want = np.asarray(jqlinear.qlinear_apply(jspec, jp, zb, _jluts(S),
                                                 out_dtype=jnp.float32))
        got = qlinear_apply(spec, p, torch.from_numpy(z).to(torch.bfloat16),
                            out_dtype=torch.float32, luts=luts)
        assert got.shape == (rows, M)
        # the same bf16 operands, float32 sums in another order
        assert _rel(got.numpy(), want) < 1e-5, rows
    assert [fn.launches for fn in tcq_lut.KERNELS] == before


def test_plain_gemv_matches_reference_kernel_interpret():
    """The plain K4 against fused.tcq_decode_matmul in interpret mode.
    KV 4 and m 128 as in the reference's own fast-tier test, but k 32 (two
    tile-columns, one k-block of the kernel): its k 64 costs ~52 s in
    interpret mode on one CPU process, k 32 ~12 s."""
    KV, m, k = 4, 128, 32
    S = codebooks.tlut_bits_for_kv(KV)
    rng = np.random.default_rng(KV)
    words = _words(rng, m, k, KV)
    x = rng.standard_normal((1, k)).astype(np.float32)
    want = np.asarray(fused.tcq_decode_matmul(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(kf.tcq_kernel_weights(words, m, k)),
        jnp.asarray(jcb.trellis_tlut(S)), KV, S, m, k))
    got = tcq_lut.tcq_lut_gemv(torch.from_numpy(x).to(torch.bfloat16),
                               words_to_torch(words), _tlut(S), KV, m, k)
    # the same bf16 weights and activations; f32 sums in another order
    assert _rel(got.numpy(), want) < 1e-5


# --- the CUDA GEMV's fragment algebra, rehearsed on the CPU -----------------

_M32 = 0xFFFFFFFF


def _bf16_bits_to_float(bits):
    b = bits & 0xFFFF
    return torch.where(b >= 1 << 15, b - (1 << 16), b).to(
        torch.int16).view(torch.bfloat16).float()


def _fragment_gemv_half(x, words, tlut, KV, m, k):
    """y (N, m) of one canonical array as lut_gemv_kernel computes it,
    written from the lane's point of view: the table with 2^(13-S) copies
    of each bf16x2 entry, lane (g, c)'s four words and one funnel
    shift per pair of states, the A fragment a0..a3 = states s0, s0+64,
    s0+1, s0+65, the B fragment x[g][4c..4c+3], one m16n8k16 product a
    tile."""
    N = x.shape[0]
    S = tlut.shape[0].bit_length() - 1
    tab_bits = tcq_lut.GEMV_TABLE_BITS
    rb = tab_bits - 2 - S
    bits = tlut.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    table = (bits[:, 0] | (bits[:, 1] << 16)).repeat_interleave(1 << rb)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    off = KV * (8 * g + 2 * c)
    w0, sh = off >> 5, off & 31
    w2 = w0 + 2 * KV
    w3 = torch.where(w2 + 1 == 4 * KV, 0, w2 + 1)
    assert bool((w3 == 0).any())  # state 127's window wraps the stream
    u = words.to(torch.int64) & _M32  # (T, 4*KV)

    def funnel(lo, hi):  # __funnelshift_r(lo, hi, sh)
        return ((lo >> sh) | (hi << (32 - sh))) & _M32

    f0, f1 = funnel(u[:, w0], u[:, w0 + 1]), funnel(u[:, w2], u[:, w3])
    tmask = ((1 << S) - 1) << (tab_bits - S)
    lcb = (lane & ((1 << rb) - 1)) << 2

    def pair(f):  # bits [15-S, 15) of h are the entry's byte offset
        h = (f * (f + 1)) & _M32
        return table[((h & tmask) | lcb) >> 2] ^ (h & 0x8000)

    T = words.shape[0]
    A = torch.zeros((T, 16, 16))
    for reg, f, row, col in ((0, f0, g, 2 * c), (1, f1, g + 8, 2 * c),
                             (2, f0 >> KV, g, 8 + 2 * c),
                             (3, f1 >> KV, g + 8, 8 + 2 * c)):
        e = pair(f)
        A[:, row, col] = _bf16_bits_to_float(e)
        A[:, row, col + 1] = _bf16_bits_to_float(e >> 16)
    # B[kf][n] in lane (n, c): kf 2c+j is tile column 4c+j, 8+2c+j is 4c+2+j
    xt = x.to(torch.bfloat16).float().reshape(N, k // 16, 16)
    xt = torch.cat([xt, torch.zeros((8 - N, k // 16, 16))])  # n >= N: 0
    B = torch.zeros((k // 16, 16, 8))
    for j in (0, 1):
        B[:, 2 * c + j, g] = xt[g, :, 4 * c + j].T
        B[:, 8 + 2 * c + j, g] = xt[g, :, 4 * c + 2 + j].T
    D = A.reshape(m // 16, k // 16, 16, 16) @ B  # (mt, kt, row, n)
    return D.sum(1).permute(2, 0, 1).reshape(8, m)[:N]


@pytest.mark.parametrize("KV", [(3,), (4,), (5,), (6,), (7,), (8,), (9,),
                                (10,), (3, 4), (8, 9), (9, 10)])
def test_gemv_fragment_map_matches_plain(KV):
    """The lane -> (states, x columns) map of csrc/tcq_lut.cu's GEMV,
    emulated on the plain words and table, gives tcq_lut_gemv_plain's y
    (tcomb: both halves) within f32 sum order, at every KV, across the
    circular wrap of state 127."""
    m, k, N = 32, 64 * len(KV), 3
    rng = np.random.default_rng(90 + sum(KV))
    S = codebooks.tlut_bits_for_kv(max(KV))
    tl = _tlut(S)
    x = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    halves = [words_to_torch(_words(rng, m, k // len(KV), kv)) for kv in KV]
    kh = k // len(KV)
    got = sum(_fragment_gemv_half(x[:, i * kh:(i + 1) * kh], w, tl, kv, m,
                                  kh)
              for i, (w, kv) in enumerate(zip(halves, KV)))
    want = (tcq_lut.tcq_lut_gemv_plain(x, halves[0], tl, KV[0], m, k)
            if len(KV) == 1 else
            tcq_lut.tcomb_lut_gemv_plain(x, *halves, tl, *KV, m, k))
    # the same bf16 products; only the order of the f32 sums differs
    assert _rel(got.numpy(), want.numpy()) < 1e-6


@pytest.mark.parametrize("kind,KV", [("tcq", (10,)), ("tcomb", (8, 9))])
def test_kernel_layouts_invert(kind, KV):
    """formats' inverses undo kf.tcq_kernel_weights /
    kf.tcomb_kernel_weights exactly; a non-zero tcomb pad word raises."""
    words, spec, _, _ = _case(kind, KV, seed=70)
    if kind == "tcq":
        kt = kf.tcq_kernel_weights(words["trellis"], M, K)
        back = formats.tcq_kernel_to_canonical(kt, M, K, KV[0])
        assert np.array_equal(back, words["trellis"])
        return
    trc = kf.tcomb_kernel_weights(words["trellis1"], words["trellis2"], M,
                                  K // 2, K // 2, *KV)
    t1, t2 = formats.tcomb_kernel_to_canonical(trc, M, K // 2, K // 2, *KV)
    assert np.array_equal(t1, words["trellis1"])
    assert np.array_equal(t2, words["trellis2"])
    trc = np.array(trc)
    trc[0, 4 * KV[0], 0] = 1
    with pytest.raises(ValueError):
        formats.tcomb_kernel_to_canonical(trc, M, K // 2, K // 2, *KV)


def test_wrappers_reject_what_the_kernels_do_not_take():
    words, _, _, S = _case("tcq", (6,), seed=80)
    tw = words_to_torch(words["trellis"])
    x = torch.zeros((1, K), dtype=torch.bfloat16)
    tl = _tlut(S)
    with pytest.raises(ValueError):  # KV
        tcq_lut.tcq_lut_gemv(x, tw, tl, 11, M, K)
    with pytest.raises(ValueError):  # words of another KV
        tcq_lut.tcq_lut_gemv(x, tw, tl, 8, M, K)
    with pytest.raises(ValueError):  # x dtype
        tcq_lut.tcq_lut_gemv(x.float(), tw, tl, 6, M, K)
    with pytest.raises(ValueError):  # more than 8 rows
        tcq_lut.tcq_lut_gemv(torch.zeros((9, K), dtype=torch.bfloat16), tw,
                             tl, 6, M, K)
    with pytest.raises(ValueError):  # S outside {9, 10, 11}
        tcq_lut.tcq_lut_dequant(tw, torch.zeros((256, 2)), 6, M, K)
    with pytest.raises(ValueError):  # tcomb pair
        tcq_lut.tcomb_lut_gemv(x, tw, tw, tl, 6, 8, M, K)


def test_flagship_qdict_builds_unmerged_with_shared_tables():
    """3.25bit.json (plain-string values, no merge_info): 7 projections a
    layer, tables held once per S, the analytic size the reference's."""
    cfg = LlamaConfig(**CFG)
    spec, params = build_quantized_model(cfg, FLAGSHIP, dummy=True,
                                         impl="exact", lm_head_bits=16,
                                         device="cpu")
    assert sorted(params["luts"]) == ["tcq10", "tcq11", "tcq9"]
    for S in (9, 10, 11):
        assert params["luts"][f"tcq{S}"].shape == (1 << S, 2)
    kinds = {}
    for (a, m), lp in zip(spec.layers, params["layers"]):
        assert a.merge is None and not m.merge_ug
        for name, ls in a.projs + m.projs:
            kinds[name, ls.kind, ls.KV, ls.tlut_bits] = True
            assert set(lp[name]) == ({"wscale", "trellis1", "trellis2"}
                                     if ls.kind == "tcomb"
                                     else {"wscale", "trellis"})
    assert set(kinds) == {
        ("q", "tcq", (8,), 9), ("k", "tcq", (10,), 11),
        ("v", "tcq", (10,), 11), ("o", "tcomb", (8, 9), 10),
        ("q", "tcomb", (8, 9), 10), ("o", "tcq", (8,), 9),
        ("up", "tcq", (6,), 9), ("gate", "tcq", (6,), 9),
        ("down", "tcq", (6,), 9)}
    cfg8 = LlamaConfig.llama31_8b()
    assert calc_avg_bits(cfg8, FLAGSHIP) == j_avg_bits(JConfig(), FLAGSHIP)


# --- the 2-layer flagship-mix model against the reference ------------------

@pytest.fixture(scope="module")
def ref():
    spec, params = jbuild(JConfig(**CFG), FLAGSHIP, dummy=True, impl="xla",
                          lm_head_bits=16)
    return spec, params, jax.tree.map(np.asarray, params)


def _port(ref, impl="exact", np_params=None):
    spec, _ = build_quantized_model(LlamaConfig(**CFG), FLAGSHIP,
                                    dummy=True, impl=impl, lm_head_bits=16,
                                    device="cpu")
    return spec, params_from_jax(ref[2] if np_params is None else np_params,
                                 spec, device="cpu")


def test_params_from_jax_takes_kernel_layouts(ref):
    """The reference's pallas layouts (trellis_kt / trellisc_kt + clut)
    carry over to the same canonical words as its xla layout."""
    spec, params = _port(ref)
    jspec, np_params = ref[0], ref[2]
    layers = []
    for (a, m), lp in zip(jspec.layers, np_params["layers"]):
        lp = dict(lp)
        for name, ls in a.projs + m.projs:
            S = ls.tlut_bits
            if ls.kind == "tcq":
                lp[name] = {"wscale": lp[name]["wscale"],
                            "trellis_kt": kf.tcq_kernel_weights(
                                lp[name]["trellis"], ls.out_features,
                                ls.in_features),
                            "clut": jcb.trellis_tlut(S)}
            else:
                lp[name] = {"wscale": lp[name]["wscale"],
                            "trellisc_kt": kf.tcomb_kernel_weights(
                                lp[name]["trellis1"], lp[name]["trellis2"],
                                ls.out_features, *ls.split, *ls.KV),
                            "clut": jcb.trellis_tlut(S)}
        layers.append(lp)
    _, params_kt = _port(ref, np_params=dict(np_params, layers=layers))
    for lp, lpk in zip(params["layers"], params_kt["layers"]):
        assert lp.keys() == lpk.keys()
        for name in lp:
            a, b = lp[name], lpk[name]
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                assert all(torch.equal(a[n], b[n]) for n in a)
            else:
                assert torch.equal(a, b)
    bad = dict(layers[0], q=dict(layers[0]["q"]))
    bad["q"]["clut"] = bad["q"]["clut"] * 2
    with pytest.raises(ValueError):
        _port(ref, np_params=dict(np_params, layers=[bad] + layers[1:]))


def test_prefill_and_step_match_reference_xla(ref):
    """12-token prefill (the dequant path) and one decode step (the GEMV
    path) against the reference at impl xla; both impls of the port take
    the same bf16 kernels, and the CPU run launches none."""
    jspec, jparams, _ = ref
    caches = jllama.init_kv_caches(jspec, 1, T_CACHE)
    want, caches = jdecode.prefill(jspec, jparams, jnp.asarray(PROMPT),
                                   caches)
    nxt = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want2, _ = jax.jit(jllama.forward, static_argnames=("spec",))(
        jspec, jparams, nxt, kv_caches=caches,
        cache_pos=jnp.int32(PROMPT.shape[1]))
    before = [fn.launches for fn in tcq_lut.KERNELS]
    for impl in ("exact", "a8"):
        spec, params = _port(ref, impl)
        caches = llama.init_kv_caches(spec, 1, T_CACHE, "cpu")
        got, caches = decode.prefill(spec, params,
                                     torch.as_tensor(PROMPT).long(), caches)
        got2, _ = llama.forward(spec, params,
                                torch.tensor(np.asarray(nxt)).long(),
                                kv_caches=caches, cache_pos=PROMPT.shape[1])
        assert got.shape == (1, PROMPT.shape[1], 512)
        assert _rel(got.numpy(), want) < LOGIT_TOL, impl
        assert _rel(got2.numpy(), want2) < LOGIT_TOL, impl
    assert [fn.launches for fn in tcq_lut.KERNELS] == before == [0] * 4


def test_greedy_tokens_match_reference(ref):
    """8 greedy tokens equal the reference's generate; a step may differ
    only where the reference's top-2 margin is below the logit tolerance."""
    spec, params = _port(ref)
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
