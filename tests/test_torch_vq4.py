"""Port parity for K8 (vq_gemv) and K9 (vq_dequant) at vec 4, ldlq_4_{bits}
(1-3 bits a weight): their plain versions against the reference's Pallas
kernels in interpret mode, the loader's vec-4 artifacts, and a 2-layer
ldlq_4_8 Llama carried over from the reference with params_from_jax.

No vec-4 codebook is committed (the port's k-means for d > 1 is not the
reference's, and both packages read the committed directory): each test
that needs one writes a seeded stand-in into a temporary asset directory
that both packages read (QPALETTE_ASSETS for the port, the reference's
_ASSET_DIR), never into the repo."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import fused
from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.ops import packing as jpk
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.kernels import vq
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.ops import codebooks
from qpalette_tpu_torch.runtime import loader
from qpalette_tpu_torch.runtime.loader import build_quantized_model

M = 64
# (bits, k, N): the reference's kernel takes P = k/4 a multiple of kb with
# (kb/8)*bits = 0 mod 32, so odd bits take 1024 columns (kb 256)
# (interpret mode grows with the reference's 2^bits-entry gather tables:
# bits 11-12 take ~2 min a case, so the card's check covers them)
KERNEL_CASES = [(4, 512, 1), (6, 512, 8), (8, 1024, 3), (5, 1024, 1),
                (7, 1024, 2)]
CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=2048,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           rope_theta=5e5)
QSTR = "ldlq_4_8_none_1.0"
# as tests/test_torch_vq.py: the same bf16 weights on both sides, the f32
# sums of the products in another order
LOGIT_TOL = 1.5e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(bits):
    return np.random.default_rng(400 + bits).standard_normal(
        (1 << bits, 4)).astype(np.float32)


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """A temporary asset directory for both packages, holding the
    vec-4 stand-ins of bits 4-12."""
    d = tmp_path / "assets"
    (d / "lut_cache").mkdir(parents=True)
    for bits in range(4, 13):
        np.save(d / "lut_cache" / f"vq_kmeans_{bits}_4.npy", _stand_in(bits))
    monkeypatch.setenv("QPALETTE_ASSETS", str(d))
    monkeypatch.setattr(jcb, "_ASSET_DIR", str(d))
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()
    yield d
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()


def _packed(rng, bits, m, P):
    idx = rng.integers(0, 1 << bits, (m, P))
    packed = np.array(jpk.pack_rows(jnp.asarray(idx), bits))
    return packed, torch.from_numpy(packed.view(np.int32))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("bits,k,N", KERNEL_CASES)
def test_vec4_kernels_match_reference_interpret(bits, k, N):
    """The plain K8 within 1e-4 of max|y| of fused.vq_decode_matmul, and
    the plain K9 bit for bit fused.vq_dequant (which returns W-hat
    transposed), both in interpret mode, on the same words and codebook."""
    rng = np.random.default_rng(bits * 10 + N)
    packed, words = _packed(rng, bits, M, k // 4)
    lut = _stand_in(bits)
    qt = jnp.asarray(kf.vq_kernel_weights(packed, bits, 4, M, k))
    x = rng.standard_normal((N, k)).astype(np.float32)
    want = np.asarray(fused.vq_decode_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), qt, jnp.asarray(lut), bits, 4,
        M, k))
    got = vq.vq_gemv(torch.from_numpy(x).to(torch.bfloat16), words,
                     torch.from_numpy(lut), bits, 4, M, k)
    assert got.shape == (N, M)
    assert _rel(got.numpy(), want) < 1e-4
    wt = np.asarray(fused.vq_dequant(qt, jnp.asarray(lut), bits, 4, M, k)).T
    w = vq.vq_dequant(words, torch.from_numpy(lut), bits, 4, M, k)
    assert w.dtype == torch.bfloat16 and w.shape == (M, k)
    assert np.array_equal(w.view(torch.int16).numpy().view(np.uint16),
                          np.ascontiguousarray(wt).view(np.uint16))


def test_vec4_outside_bits_4_to_12_raises():
    """vec 4 at bits 3 or 13 is refused by the wrappers (and so by the
    loader's spec) with NotImplementedError; the GEMV's k must be a
    multiple of 512."""
    x = torch.zeros((1, 512), dtype=torch.bfloat16)
    for bits in (3, 13):
        words = torch.zeros((M, vq.row_words(512, bits, 4)), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="bits 4-12"):
            vq.vq_gemv(x, words, torch.zeros((1 << bits, 4)), bits, 4, M, 512)
        with pytest.raises(NotImplementedError):
            loader._spec_from_meta({"kind": "vq", "bits": bits, "vec": 4,
                                    "in_features": 512, "out_features": M},
                                   "exact")
    words = torch.zeros((M, vq.row_words(256, 8, 4)), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        vq.vq_gemv(torch.zeros((1, 256), dtype=torch.bfloat16), words,
                   torch.zeros((256, 4)), 8, 4, M, 256)


def test_vec4_dummy_artifact_and_spec(assets):
    """dummy_artifact and _spec_from_meta take ldlq_4_{bits}: the spec's
    (bits, vec), the row-pack's shape, the codebook read from the asset
    directory."""
    for bits in (4, 8, 12):
        art = loader.dummy_artifact(f"ldlq_4_{bits}_none_1.0", (M, 1024))
        ls = loader._spec_from_meta(art["meta"], "exact")
        assert (ls.kind, ls.bits, ls.vec) == ("vq", bits, 4)
        p = loader._params_from_artifact(art, "cpu")
        assert tuple(p["qweight"].shape) == (M, vq.row_words(1024, bits, 4))
        assert np.array_equal(p["lut"].numpy(), _stand_in(bits))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The reference's dummy 2-layer ldlq_4_8 model (impl xla, merged qkv
    and ug) and the port's spec and params of the same weights."""
    d = tmp_path_factory.mktemp("assets")
    (d / "lut_cache").mkdir()
    np.save(d / "lut_cache" / "vq_kmeans_8_4.npy", _stand_in(8))
    mp = pytest.MonkeyPatch()
    mp.setenv("QPALETTE_ASSETS", str(d))
    mp.setattr(jcb, "_ASSET_DIR", str(d))
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()
    try:
        merge = [["merge_qkv", "merge_ug"]] * 2
        jspec, jparams = jbuild(JConfig(**CFG), QSTR, merge_info=merge,
                                dummy=True, impl="xla", model_key="vq4",
                                save_dir=str(d))
        spec, own = build_quantized_model(LlamaConfig(**CFG), QSTR,
                                          merge_info=merge, dummy=True,
                                          impl="exact", device="cpu")
        params = params_from_jax(_np(jparams), spec, "cpu")
    finally:
        for f in (codebooks.vq_lut, jcb.vq_lut):
            f.cache_clear()
        mp.undo()
    return jspec, jparams, spec, params, own


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def test_ldlq_4_8_model_logits_match_reference(models):
    """The 2-layer ldlq_4_8 model: every projection vq (8, 4), the
    forward's logits over 12 tokens and a cached decode step (K8's plain
    version at 1 row, K9's plus a product at 12) against the reference's
    forward (xla)."""
    jspec, jparams, spec, params, own = models
    # the port's own dummy build reads the same codebook (the reference's
    # xla params hold it in bf16, the rounding K8 / K9 apply)
    assert torch.equal(own["layers"][0]["o"]["lut"].bfloat16().float(),
                       params["layers"][0]["o"]["lut"])
    kinds = {(ls.kind, ls.bits, ls.vec) for a, m in spec.layers
             for _, ls in a.projs + m.projs}
    assert kinds == {("vq", 8, 4)}
    toks = np.random.default_rng(3).integers(0, 512, (1, 12))
    want = np.asarray(jllama.forward(jspec, jparams, jnp.asarray(toks)))
    got = llama.forward(spec, params, torch.from_numpy(toks))
    assert _rel(got.numpy(), want) < LOGIT_TOL
    caches = llama.init_kv_caches(spec, 1, 13, "cpu")
    _, caches = llama.forward(spec, params, torch.from_numpy(toks),
                              kv_caches=caches, cache_pos=0)
    nxt = got[:, -1].argmax(-1)[:, None]
    step, _ = llama.forward(spec, params, nxt, kv_caches=caches,
                            cache_pos=12)
    full = np.concatenate([toks, nxt.numpy()], 1)
    want = np.asarray(jllama.forward(jspec, jparams, jnp.asarray(full)))
    assert _rel(step[:, -1].numpy(), want[:, -1]) < LOGIT_TOL
