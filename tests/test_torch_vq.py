"""Port parity for the SQ/VQ row-pack slice (ldlq, sq, vq2): the committed
codebooks, the row-pack, the inverse of the reference's kernel layout, the
plain versions of K8 (vq_gemv) and K9 (vq_dequant) against the reference's
Pallas kernels in interpret mode, the dispatch, and a 2-layer Llama with
ldlq_2_6 everywhere (3 bits/weight, a 64 x 2 k-means codebook, merged qkv
and gate/up) carried over from the reference with params_from_jax.

Inputs come from numpy seeds and go to both sides.  The reference model is
built once per file, at impl xla (no interpret-mode kernel in it)."""

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
from qpalette_tpu.ops import packing as jpk
from qpalette_tpu.runtime import decode as jdecode
from qpalette_tpu.runtime import qlinear as jqlinear
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.kernels import formats, vq
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq.memmodel import calc_avg_bits
from qpalette_tpu_torch.ops import codebooks, packing
from qpalette_tpu_torch.runtime import decode
from qpalette_tpu_torch.runtime.loader import build_quantized_model
from qpalette_tpu_torch.runtime.qlinear import LinearSpec, qlinear_apply

QSTR = "ldlq_2_6_none_1.0"
CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
MERGE = [["merge_qkv", "merge_ug"]] * 2
PROMPT = np.random.default_rng(12).integers(0, 512, (1, 12)).astype(np.int32)
N_NEW = 8
T_CACHE = PROMPT.shape[1] + N_NEW
# Both sides decode the same bf16 weights and round activations to bf16 at
# the same places; what is left is the order of the f32 sums in the
# products, whose flipped bf16 roundings the next rotation spreads over a
# row (as in the LUT slice's test, whose bound this is).
LOGIT_TOL = 1.5e-2
# (bits, vec, P): vec 1 and 2, odd bits (windows straddle two words),
# index counts that are not a multiple of 32 (a partial last word)
PACK_CASES = [(2, 1, 100), (3, 1, 256), (5, 1, 77), (7, 1, 128),
              (8, 1, 64), (3, 2, 64), (6, 2, 512), (9, 2, 33), (11, 2, 300),
              (12, 2, 256)]
# (bits, vec, k, N) of the interpret-mode kernel checks: the reference's
# kernel wants P a multiple of kb with (kb/8)*bits = 0 mod 32, so odd bits
# take 1024 columns
KERNEL_CASES = [(6, 2, 512, 8), (5, 1, 1024, 1), (3, 2, 1024, 1)]
M = 128


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


def _packed(rng, bits, m, P):
    """Random indices -> the reference's row-pack (numpy uint32) and the
    same words as the port's int32 tensor."""
    idx = rng.integers(0, 1 << bits, (m, P))
    packed = np.array(jpk.pack_rows(jnp.asarray(idx), bits))
    return idx, packed, torch.from_numpy(packed.view(np.int32))


def _lut(bits, vec):
    return torch.tensor(codebooks.vq_lut(bits, vec))


@pytest.mark.parametrize("bits,vec", [p for p in vq.SUPPORTED if p[1] < 4])
def test_vq_lut_matches_reference(bits, vec):
    """The 17 committed codebooks of the ldlq palette (vec 1 and 2; no vec-4
    codebook is committed: the port's k-means for d > 1 is not the
    reference's, and both packages read the committed directory)."""
    lut = codebooks.vq_lut(bits, vec)
    assert lut.dtype == np.float32 and lut.shape == (1 << bits, vec)
    assert np.array_equal(lut, jcb.vq_lut(bits, vec))
    assert not lut.flags.writeable


@pytest.mark.parametrize("bits,vec", [(4, 4), (13, 2), (1, 1)])
def test_vq_lut_raises_when_not_committed(bits, vec, tmp_path, monkeypatch):
    """A codebook that is not committed is made by k-means (here from 2^14
    samples) and written under $QPALETTE_ASSETS/lut_cache, never into the
    repo; a second call reads it.  Against the reference's (its own
    k-means seeding, jax.random): the distortion of the same samples at
    most 1% above; vec 1 is the exact 1-D optimum on both sides."""
    n = 1 << 14
    monkeypatch.setenv("QPALETTE_ASSETS", str(tmp_path / "port"))
    monkeypatch.setattr(jcb, "_ASSET_DIR", str(tmp_path / "ref"))
    name = f"vq_kmeans_{bits}_{vec}.npy"
    assert not (codebooks._COMMITTED / name).exists()
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()
    try:
        lut = codebooks.vq_lut(bits, vec, n_samples=n, device="cpu")
        ref = jcb.vq_lut(bits, vec, n_samples=n)
    finally:
        for f in (codebooks.vq_lut, jcb.vq_lut):
            f.cache_clear()
    assert lut.shape == (1 << bits, vec) and lut.dtype == np.float32
    assert not lut.flags.writeable
    assert np.array_equal(np.load(tmp_path / "port" / "lut_cache" / name),
                          lut)
    assert not (codebooks._COMMITTED / name).exists()
    data = np.random.default_rng(4321 + 64 * bits + vec).standard_normal(
        (n, vec)).astype(np.float32)
    dist = [np.mean(np.min(((data[:, None, :] - c[None]) ** 2).sum(-1)
                           if len(c) < 64 else _min_dist(data, c), axis=1))
            for c in (lut, ref)]
    assert dist[0] <= 1.01 * dist[1], dist
    if vec == 1:
        assert np.array_equal(lut, ref)
    again = codebooks.vq_lut(bits, vec, n_samples=n, device="cpu")
    codebooks.vq_lut.cache_clear()
    assert np.array_equal(again, lut)


def _min_dist(data, c, rows=1024):
    """(n, 1) squared distance of each point to its nearest codeword."""
    return np.concatenate([
        ((data[r:r + rows, None, :] - c[None]) ** 2).sum(-1).min(1)[:, None]
        for r in range(0, len(data), rows)])


@pytest.mark.parametrize("bits,vec,P", PACK_CASES)
def test_row_pack_bit_exact_to_reference(bits, vec, P):
    """pack_rows, unpack_rows and dequant_lut against qpalette_tpu.ops:
    the same words (pad word included), indices and weights."""
    rng = np.random.default_rng(bits * 100 + P)
    idx, packed, words = _packed(rng, bits, 6, P)
    got = packing.pack_rows(torch.from_numpy(idx), bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), packed)
    assert packed.shape == (6, -(-(P * bits) // 32) + 1)
    assert not packed[:, -1].any()
    assert np.array_equal(packing.unpack_rows(words, bits, P).numpy(), idx)
    assert np.array_equal(np.asarray(jpk.unpack_rows(jnp.asarray(packed),
                                                     bits, P)), idx)
    lut = codebooks.vq_lut(bits, vec)
    k = P * vec
    want = np.asarray(jpk.dequant_lut(jnp.asarray(packed), jnp.asarray(lut),
                                      6, k, bits, vec))
    got = packing.dequant_lut(words, torch.from_numpy(lut.copy()), 6, k,
                              bits, vec)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,vec,k", [(3, 1, 1024), (4, 1, 512),
                                        (6, 2, 512), (9, 2, 1024)])
def test_vq_kernel_layout_inverts(bits, vec, k):
    """vq_kernel_to_canonical undoes kf.vq_kernel_weights, pad word zero;
    a shape that does not fit raises."""
    _, packed, _ = _packed(np.random.default_rng(bits), bits, 32, k // vec)
    qt = kf.vq_kernel_weights(packed, bits, vec, 32, k)
    back = formats.vq_kernel_to_canonical(qt, bits, vec, 32, k)
    assert back.shape == packed.shape and np.array_equal(back, packed)
    with pytest.raises(ValueError):
        formats.vq_kernel_to_canonical(qt, bits, vec, 32, 2 * k)


@pytest.mark.parametrize("bits,vec,k,N", KERNEL_CASES)
def test_plain_gemv_matches_reference_kernel_interpret(bits, vec, k, N):
    """The plain K8 against fused.vq_decode_matmul (interpret mode): the
    same bf16 weights and activations, f32 sums in another order."""
    rng = np.random.default_rng(bits + vec + k)
    _, packed, words = _packed(rng, bits, M, k // vec)
    lut = codebooks.vq_lut(bits, vec)
    x = rng.standard_normal((N, k)).astype(np.float32)
    want = np.asarray(fused.vq_decode_matmul(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(kf.vq_kernel_weights(packed, bits, vec, M, k)),
        jnp.asarray(lut), bits, vec, M, k))
    got = vq.vq_gemv(torch.from_numpy(x).to(torch.bfloat16), words,
                     _lut(bits, vec), bits, vec, M, k)
    assert got.shape == (N, M)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("bits,vec,k,N", KERNEL_CASES)
def test_plain_dequant_bit_equal_to_reference_kernel(bits, vec, k, N):
    """The plain K9 against fused.vq_dequant (interpret mode), which
    returns W_hat transposed: bit for bit."""
    rng = np.random.default_rng(bits + vec + k + 1)
    _, packed, words = _packed(rng, bits, M, k // vec)
    lut = codebooks.vq_lut(bits, vec)
    want = np.asarray(fused.vq_dequant(
        jnp.asarray(kf.vq_kernel_weights(packed, bits, vec, M, k)),
        jnp.asarray(lut), bits, vec, M, k)).T
    got = vq.vq_dequant(words, _lut(bits, vec), bits, vec, M, k)
    assert got.dtype == torch.bfloat16 and got.shape == (M, k)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          np.ascontiguousarray(want).view(np.uint16))


@pytest.mark.parametrize("bits,vec", [(6, 2), (4, 1), (7, 2)])
def test_dispatch_matches_reference_xla(bits, vec):
    """qlinear_apply through the plain K8 (1 and 8 rows) and K9 + product
    (12 rows), Wscale included, against the reference's qlinear_apply at
    impl xla (a bf16 codebook there); no launch on the CPU."""
    k = 256 * vec
    rng = np.random.default_rng(bits * vec)
    _, packed, words = _packed(rng, bits, M, k // vec)
    lut = codebooks.vq_lut(bits, vec)
    wscale = rng.uniform(0.5, 1.5, M).astype(np.float32)
    common = dict(in_features=k, out_features=M, bits=bits, vec=vec)
    jspec = jqlinear.LinearSpec("vq", impl="xla", **common)
    jp = {"qweight": jnp.asarray(packed), "wscale": jnp.asarray(wscale),
          "lut": jnp.asarray(lut, jnp.bfloat16)}
    p = {"qweight": words, "lut": _lut(bits, vec),
         "wscale": torch.from_numpy(wscale)}
    before = [f.launches for f in vq.KERNELS]
    for impl in ("exact", "a8"):
        spec = LinearSpec("vq", impl=impl, **common)
        for rows in (1, 8, 12):
            z = rng.standard_normal((rows, k)).astype(np.float32)
            want = np.asarray(jqlinear.qlinear_apply(
                jspec, jp, jnp.asarray(z).astype(jnp.bfloat16), {},
                out_dtype=jnp.float32))
            got = qlinear_apply(spec, p,
                                torch.from_numpy(z).to(torch.bfloat16),
                                out_dtype=torch.float32)
            assert got.shape == (rows, M)
            assert _rel(got.numpy(), want) < 1e-5, (impl, rows)
    assert [f.launches for f in vq.KERNELS] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, _, words = _packed(np.random.default_rng(1), 6, 64, 128)
    lut = _lut(6, 2)
    x = torch.zeros((1, 256), dtype=torch.bfloat16)
    vq.vq_gemv(x, words, lut, 6, 2, 64, 256)  # what they take
    with pytest.raises(ValueError):  # vec 4: no codebook, no kernel
        vq.vq_gemv(x, words, lut, 6, 4, 64, 256)
    with pytest.raises(ValueError):  # P = 64, not a multiple of 128
        vq.vq_gemv(x[:, :128].contiguous(), words[:, :13].contiguous(), lut,
                   6, 2, 64, 128)
    with pytest.raises(ValueError):  # k = 132, not a multiple of 8
        vq.vq_dequant(words, lut, 6, 2, 64, 132)
    with pytest.raises(ValueError):  # words of another bits
        vq.vq_gemv(x, words, _lut(5, 2), 5, 2, 64, 256)
    with pytest.raises(ValueError):  # a codebook of another shape
        vq.vq_gemv(x, words, _lut(6, 1), 6, 2, 64, 256)
    with pytest.raises(ValueError):  # x dtype
        vq.vq_gemv(x.float(), words, lut, 6, 2, 64, 256)
    with pytest.raises(ValueError):  # more than 8 rows
        vq.vq_gemv(torch.zeros((9, 256), dtype=torch.bfloat16), words, lut,
                   6, 2, 64, 256)


def test_ldlq_builds_merged_with_own_codebooks():
    """ldlq_2_6 with merged qkv / ug: vq specs of bits 6, vec 2, the
    row-pack shapes, a codebook per projection; ldlq_1_4 unmerged; the
    analytic size the reference's."""
    cfg = LlamaConfig(**CFG)
    spec, params = build_quantized_model(cfg, QSTR, merge_info=MERGE,
                                         impl="a8", lm_head_bits=16,
                                         device="cpu")
    assert params["luts"] == {}
    (a, m), lp = spec.layers[0], params["layers"][0]
    shapes = {n: (ls.kind, ls.bits, ls.vec, ls.out_features, ls.in_features)
              for n, ls in a.projs + m.projs}
    assert shapes == {"qkv": ("vq", 6, 2, 1024, 512),
                      "o": ("vq", 6, 2, 512, 512),
                      "ug": ("vq", 6, 2, 3584, 512),
                      "down": ("vq", 6, 2, 512, 1792)}
    assert lp["qkv"]["qweight"].shape == (1024, 256 * 6 // 32 + 1)
    assert lp["down"]["qweight"].shape == (512, 896 * 6 // 32 + 1)
    assert np.array_equal(lp["o"]["lut"].numpy(), jcb.vq_lut(6, 2))
    spec1, params1 = build_quantized_model(cfg, "ldlq_1_4_none_1.0",
                                           impl="a8", lm_head_bits=16,
                                           device="cpu")
    names = [n for n, _ in spec1.layers[0][0].projs + spec1.layers[0][1].projs]
    assert names == ["q", "k", "v", "o", "up", "gate", "down"]
    assert params1["layers"][0]["k"]["qweight"].shape == (256, 512 * 4 // 32
                                                          + 1)
    cfg8 = LlamaConfig.llama31_8b()
    for q in (QSTR, "ldlq_1_4_none_1.0", "vq2_9_none_1.0"):
        assert calc_avg_bits(cfg8, q) == j_avg_bits(JConfig(), q)


# --- the 2-layer ldlq_2_6 model against the reference ----------------------

@pytest.fixture(scope="module")
def ref():
    spec, params = jbuild(JConfig(**CFG), QSTR, merge_info=MERGE, dummy=True,
                          impl="xla", lm_head_bits=16)
    return spec, params, jax.tree.map(np.asarray, params)


def _port(ref, impl="a8", np_params=None):
    spec, _ = build_quantized_model(LlamaConfig(**CFG), QSTR,
                                    merge_info=MERGE, impl=impl,
                                    lm_head_bits=16, device="cpu")
    return spec, params_from_jax(ref[2] if np_params is None else np_params,
                                 spec, device="cpu")


def test_params_from_jax_takes_the_kernel_layout(ref):
    """The reference's pallas layout (qweight_t + an f32 clut) carries over
    to the same row-pack as its xla one (qweight + a bf16 lut), but for
    the pad word, which the kernel layout does not keep."""
    jspec, np_params = ref[0], ref[2]
    spec, params = _port(ref)
    layers = []
    for (a, m), lp in zip(jspec.layers, np_params["layers"]):
        lp = dict(lp)
        for name, ls in a.projs + m.projs:
            assert ls.kind == "vq" and (ls.bits, ls.vec) == (6, 2)
            lp[name] = {"wscale": lp[name]["wscale"],
                        "qweight_t": kf.vq_kernel_weights(
                            lp[name]["qweight"], 6, 2, ls.out_features,
                            ls.in_features),
                        "clut": jcb.vq_lut(6, 2)}
        layers.append(lp)
    _, params_kt = _port(ref, np_params=dict(np_params, layers=layers))
    for lp, lpk in zip(params["layers"], params_kt["layers"]):
        for name in ("qkv", "o", "ug", "down"):
            a, b = lp[name], lpk[name]
            assert torch.equal(a["qweight"][:, :-1], b["qweight"][:, :-1])
            assert not b["qweight"][:, -1].any()
            assert torch.equal(a["lut"], b["lut"].bfloat16().float())
            assert torch.equal(a["wscale"], b["wscale"])


def test_prefill_and_step_match_reference_xla(ref):
    """12-token prefill (K9 + product) and one decode step (K8) against
    the reference at impl xla, for both impls of the port; the CPU run
    launches no kernel."""
    jspec, jparams, _ = ref
    caches = jllama.init_kv_caches(jspec, 1, T_CACHE)
    want, caches = jdecode.prefill(jspec, jparams, jnp.asarray(PROMPT),
                                   caches)
    nxt = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want2, _ = jax.jit(jllama.forward, static_argnames=("spec",))(
        jspec, jparams, nxt, kv_caches=caches,
        cache_pos=jnp.int32(PROMPT.shape[1]))
    before = [f.launches for f in vq.KERNELS]
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
    assert [f.launches for f in vq.KERNELS] == before == [0, 0]


def test_greedy_tokens_match_reference(ref):
    """8 greedy tokens equal the reference's generate; a step may differ
    only where the reference's top-2 margin is below the logit
    tolerance."""
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
