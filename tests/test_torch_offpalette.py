"""Port parity for schemes outside the palette's GEMV kernel sets: impl
dequant runs them through the dequant kernels (K2, K3, K6, K7, K9), whose
instances take every trellis KV from 1 to 16, any tcomb pair and vq bits
1-12, as the reference's xla route does; the GEMV impls refuse them.

Six schemes, one 1-layer tiny model each (every projection the scheme,
dummy words): tcq at KV 2 (K4 / K6 take KV 3-10), tcomb (5, 7) (K5 / K7
take (KV, KV+1)), tcq2s at KV 3 and tcq1 1mad at KV 6 (K1 takes 4-10 and
2-5), ldlq at (bits 9, vec 1) and (bits 2, vec 2) (K8 takes bits 2-8 at
vec 1 and 3-12 at vec 2).  On the CPU the dequant wrappers run their
plain versions.  Each reference model (impl xla) is built
once and carried over with params_from_jax; the port's forward at impl
dequant is held to the reference's forward.

No codebook of (9, 1) or (2, 2) is committed (the port's k-means is not
the reference's for d > 1, and both packages read the committed
directory): a seeded stand-in of each is written into a temporary asset
directory that both packages read, never into the repo, beside copies
of the committed trellis tables (the reference reads its tables only
from that directory)."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch import kernels
from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.ops import codebooks
from qpalette_tpu_torch.kernels import arith, arith_dequant, tcq_lut, vq
from qpalette_tpu_torch.runtime import loader, qlinear
from qpalette_tpu_torch.runtime.loader import build_quantized_model

SCHEMES = ("tcq_2_none_0.9", "tcomb_5_7_0.5_none_0.9", "tcq2s_3_none_0.9",
           "tcq1_6_none_0.9", "ldlq_1_9_none_1.0", "ldlq_2_2_none_1.0")
STAND_INS = ((9, 1), (2, 2))  # (bits, vec) of the codebooks not committed
# tests/test_torch_arith_model.py's LOGIT_TOL: the same bf16 W-hat on both
# sides, the f32 sums of the products in another order
LOGIT_TOL = 2e-2
TOKENS = np.random.default_rng(11).integers(0, 256, (2, 7))
_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    (d / "lut_cache").mkdir()
    for path in (codebooks.ASSETS / "lut_cache").glob("tcq_tlut_*.npy"):
        shutil.copy(path, d / "lut_cache" / path.name)
    for bits, vec in STAND_INS:
        table = np.random.default_rng(500 + 16 * bits + vec).standard_normal(
            (1 << bits, vec)).astype(np.float32)
        np.save(d / "lut_cache" / f"vq_kmeans_{bits}_{vec}.npy", table)
    mp = pytest.MonkeyPatch()
    mp.setenv("QPALETTE_ASSETS", str(d))
    mp.setattr(jcb, "_ASSET_DIR", str(d))
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()
    yield d
    for f in (codebooks.vq_lut, jcb.vq_lut):
        f.cache_clear()
    mp.undo()


def _model(qstr, assets):
    """The reference's 1-layer model of qstr (impl xla) and the port's spec
    (impl dequant) and params of the same weights, built once a file."""
    if qstr not in _MODELS:
        cfg = dict(LlamaConfig.tiny().__dict__, num_layers=1)
        cfg.pop("dtype")
        jspec, jparams = jbuild(JConfig(**cfg), qstr, dummy=True, impl="xla",
                                model_key="offpalette", save_dir=str(assets))
        spec, _ = build_quantized_model(LlamaConfig(**cfg), qstr, dummy=True,
                                        impl="dequant", device="cpu")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                                 "cpu")
        _MODELS[qstr] = (jspec, jparams, spec, params)
    return _MODELS[qstr]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("qstr", SCHEMES)
def test_dequant_forward_matches_reference_xla(qstr, assets):
    """Every projection of the scheme is outside the GEMVs' sets and inside
    the dequant kernels', so impl dequant runs it (on the CPU the
    wrappers' plain versions: no launch); the logits within LOGIT_TOL of
    max|logit| of the reference's xla forward."""
    jspec, jparams, spec, params = _model(qstr, assets)
    projs = [ls for a, m in spec.layers for _, ls in a.projs + m.projs]
    assert all(qlinear.kernel_gap(dataclasses.replace(ls, impl=impl))
               is not None for ls in projs for impl in ("exact", "a8"))
    assert all(qlinear.kernel_gap(ls) is None for ls in projs)
    want = np.asarray(jllama.forward(jspec, jparams, jnp.asarray(TOKENS)))
    kernels.reset_launches()
    got = llama.forward(spec, params, torch.from_numpy(TOKENS))
    assert not any(kernels.launch_counts().values())
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), want) < LOGIT_TOL


@pytest.mark.parametrize("impl", ["exact", "a8"])
@pytest.mark.parametrize("qstr", SCHEMES)
def test_gemv_impls_refuse_with_the_palette(qstr, impl, assets):
    """The GEMV impls take only the palette's GEMV sets: building the
    scheme raises NotImplementedError naming the palette's kernel sets and
    impl dequant, which runs it."""
    cfg = LlamaConfig(**dict(LlamaConfig.tiny().__dict__, num_layers=1))
    with pytest.raises(NotImplementedError,
                       match=r"outside the palette's kernel sets.*dequant"):
        build_quantized_model(cfg, qstr, dummy=True, impl=impl, device="cpu")


def test_in_palette_schemes_keep_their_kernels():
    """The palette's own schemes have no gap under any impl: the GEMVs and
    the dequant kernels both take them."""
    cfg = LlamaConfig(**dict(LlamaConfig.tiny().__dict__, num_layers=1))
    for qstr in ("tcq_3_none_0.9", "tcomb_5_6_0.5_none_0.9",
                 "tcq2s_4_none_0.9", "tcq1_5_none_0.9"):
        spec, params = build_quantized_model(cfg, qstr, dummy=True,
                                             impl="dequant", device="cpu")
        projs = [ls for a, m in spec.layers for _, ls in a.projs + m.projs]
        assert all(qlinear.kernel_gap(dataclasses.replace(ls, impl=impl))
                   is None for ls in projs for impl in qlinear.IMPLS)
        out = llama.forward(spec, params, torch.from_numpy(TOKENS[:1]))
        assert bool(torch.isfinite(out).all())


def test_dequant_sets_cover_the_gemv_sets():
    """The dequant kernels take every scheme the GEMVs take, and more:
    K2 / K3 and K6 / K7 every KV from 1 to 16 (tcomb any pair), K9 bits
    1-12 at vec 1, 2 and 4."""
    for mode, kvs in arith_dequant.DEQUANT_KV.items():
        assert set(arith.SUPPORTED_KV[mode]) <= set(kvs)
        assert kvs == tuple(range(1, 17))
    assert set(tcq_lut.SUPPORTED_KV) <= set(tcq_lut.DEQUANT_KV)
    assert all(a in tcq_lut.DEQUANT_KV and b in tcq_lut.DEQUANT_KV
               for a, b in tcq_lut.SUPPORTED_TCOMB)
    assert set(vq.SUPPORTED) <= set(vq.DEQUANT) and len(vq.DEQUANT) == 36


@pytest.mark.parametrize("meta", [
    {"kind": "vq", "bits": 13, "vec": 2},
    {"kind": "vq", "bits": 4, "vec": 8},
    {"kind": "tcq2", "decode_mode": "sum2", "KV": 17},
], ids=["vq_13_2", "vq_4_8", "tcq2s_17"])
def test_beyond_the_dequant_kernels_refused_at_build(meta):
    """A scheme no dequant kernel takes is refused when it is built under
    every impl, the dequant kernels' sets named."""
    meta = dict(meta, in_features=512, out_features=64)
    with pytest.raises(NotImplementedError,
                       match="outside the dequant kernels' sets"):
        loader._spec_from_meta(meta, "dequant")
    with pytest.raises(NotImplementedError, match="nor can impl 'dequant'"):
        loader._spec_from_meta(meta, "exact")
