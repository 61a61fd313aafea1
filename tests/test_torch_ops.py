"""Port parity: qpalette_tpu_torch.ops / quant against the JAX reference
ops on the same numpy inputs."""

import json
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.ops import codebooks as jcb
from qpalette_tpu.ops import hadamard as jhad
from qpalette_tpu.ops import packing as jpk
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.msq.memmodel import calc_avg_bits as j_avg_bits
from qpalette_tpu.quant.incoherent import parse_quantizer_str as j_parse
from qpalette_tpu.runtime import loader as jloader

from qpalette_tpu_torch.ops import codebooks as tcb
from qpalette_tpu_torch.ops import hadamard as thad
from qpalette_tpu_torch.ops import packing as tpk
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq.memmodel import calc_avg_bits
from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
from qpalette_tpu_torch.runtime import loader

QDICT_215 = "msq_results/3_8b/lat_constrained/v5e/default_err/215.0thp_cc.json"


def test_decode_sum2_all_states_bit_exact():
    states = np.arange(1 << 16, dtype=np.uint64)
    ref = jcb.decode_sum2(states)
    got = tcb.decode_sum2(torch.arange(1 << 16)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(tcb.trellis_lut_arith("sum2").numpy(),
                          jcb.trellis_lut_arith("sum2"))


@pytest.mark.parametrize("KV", [4, 6, 8])
def test_dequant_tcq2_bit_exact(KV):
    m, k = 48, 64
    rng = np.random.default_rng(100 + KV)
    words = rng.integers(0, 1 << 32, ((m // 16) * (k // 16), 4 * KV),
                         dtype=np.uint32)
    lut = jcb.trellis_lut_arith("sum2")
    ref = np.asarray(jpk.dequant_tcq2(jnp.asarray(words), jnp.asarray(lut),
                                      m, k, KV))
    tw = tpk.words_to_torch(words)
    got = tpk.dequant_tcq2(tw, torch.from_numpy(lut), m, k, KV).numpy()
    assert np.array_equal(got, ref)
    states = np.asarray(jpk.unpack_trellis(jnp.asarray(words), KV, 2))
    assert np.array_equal(tpk.unpack_trellis(tw, KV, 2).numpy(), states)
    assert np.array_equal(tw.numpy().view(np.uint32), words)


@pytest.mark.parametrize("n", [128, 512, 1792, 4096, 14336])
def test_hadamard_factor_matrices_equal(n):
    assert thad.get_had_factors(n) == jhad.get_had_factors(n)
    for tr in (False, True):
        facs, mats = thad._factor_mats(n, tr)
        jfacs, jmats = jhad._factor_mats(n, tr, "float64")
        assert facs == jfacs
        for a, b in zip(mats, jmats):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n,blocks", [(512, 1), (512, 2), (1792, 1),
                                      (1792, 2), (4096, 1), (14336, 2)])
def test_hadamard_transform_t_matches(n, blocks):
    rng = np.random.default_rng(n + blocks)
    x = rng.standard_normal((3, n)).astype(np.float32)
    ref = np.asarray(jhad.hadamard_transform_t(jnp.asarray(x), blocks=blocks))
    got = thad.hadamard_transform_t(torch.from_numpy(x), blocks=blocks)
    assert got.dtype == torch.float32
    # f32 contractions summed in another order: 1e-5 of max|y|
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_parse_quantizer_str_matches_on_215_qdict():
    with open(QDICT_215) as f:
        qd = json.load(f)
    qstrs = sorted({v[0] if isinstance(v, list) else v for v in qd.values()})
    qstrs += ["tcq2s_8_none_0.9", "tcq_6_hess_0.9", "tcomb_6_7_0.5_none_0.9",
              "ldlq_2_6_hess_1.0", "sq_4_none_1.0", "vq2_6_none_1.0",
              "rotfp16"]
    for q in qstrs:
        a, b = parse_quantizer_str(q), j_parse(q)
        assert a.__dict__ == b.__dict__, q
        assert a.avg_bits == b.avg_bits, q


def test_calc_avg_bits_matches_on_215_qdict():
    with open(QDICT_215) as f:
        qd = {k: tuple(v) for k, v in json.load(f).items()}
    assert calc_avg_bits(LlamaConfig.llama31_8b(), qd) == \
        j_avg_bits(JConfig.llama31_8b(), qd)


def test_loader_host_helpers_match():
    """su_for seeds, dummy artifact metadata and the row-concat merge of
    host artifacts equal the reference's."""
    cfg, jcfg = LlamaConfig.tiny(), JConfig.tiny()
    for key in loader.LAYER_KEYS:
        assert loader.proj_shape(cfg, key) == jloader.proj_shape(jcfg, key)
        assert np.array_equal(loader.su_for(cfg, 1, key, 3),
                              jloader.su_for(jcfg, 1, key, 3))
    a = loader.dummy_artifact("tcq2s_6_none_0.9", (64, 128), seed=5)
    b = jloader.dummy_artifact("tcq2s_6_none_0.9", (64, 128), seed=5)
    assert a["meta"] == b["meta"] and np.array_equal(a["SU"], b["SU"])
    rng = np.random.default_rng(0)
    arts = []
    for m in (64, 32, 32):
        art = loader.dummy_artifact("tcq2s_6_none_0.9", (m, 128))
        del art["__device_dummy__"]
        art["trellis"] = rng.integers(0, 1 << 32, ((m // 16) * 8, 24),
                                      dtype=np.uint32)
        arts.append(art)
    got, want = loader.merge_artifacts(arts), jloader.merge_artifacts(arts)
    assert got["meta"] == want["meta"]
    for key in ("SU", "Wscale", "trellis"):
        assert np.array_equal(got[key], want[key]), key
    p = loader._params_from_artifact(got, "cpu")
    assert np.array_equal(p["trellis"].numpy().view(np.uint32),
                          want["trellis"])


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    import qpalette_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        qpalette_tpu_torch.__path__, "qpalette_tpu_torch.")]
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "assert not any(k.startswith('qpalette_tpu.') or k == "
            "'qpalette_tpu' for k in sys.modules)\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    for mod in ("kernels.arith", "kernels.arith_dequant", "runtime.loader", "runtime.decode",
                "models.llama", "convert", "measure_latency"):
        assert f"qpalette_tpu_torch.{mod}" in names, mod
