"""Port parity for model-level quantization against the JAX package on
the CPU: calibration Hessians and sensitivity coefficients over the dense
model (weights carried over by ``convert.params_from_jax``), the loader's
quantize-on-demand (a mixed qdict of ``_hess_`` and plain schemes under
every merge, qkv / qk / kv / qv / ug) writing artifacts that the
reference reads and reading the reference's, their logits, the 4-bit
head quantized from the dense head, and the two entry points
``quantize_layer.main`` and ``collect_hessians.main`` on a local
checkpoint with a synthetic token stream in place of WikiText-2.

Every reference compile is per (shape, scheme), so the trellis schemes
here are few (tcq_6 and tcq2s_6 with a Hessian) and the rest are ldlq /
sq, which compile in well under a second."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.quant import hessian as jhess
from qpalette_tpu.quant import incoherent as jinc
from qpalette_tpu.runtime import evaluate as jevaluate
from qpalette_tpu.runtime import loader as jloader

from qpalette_tpu_torch import collect_hessians, quantize_layer
from qpalette_tpu_torch.convert import params_from_jax
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.quant import hessian, incoherent
from qpalette_tpu_torch.runtime import evaluate, loader

from test_torch_hf_weights import (HF_CONFIG, _write_checkpoint,  # noqa: F401
                                   reference_reader)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# widths where every vq projection's k/vec is a multiple of the SQ/VQ
# kernels' 128-index chunk
CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_layers=4, num_heads=4, num_kv_heads=2, head_dim=64,
           rope_theta=10000.0)
MODEL_KEY = "tiny"
# the Hessians: the same bf16 forward, whose activations (x + attention,
# the norms' outputs) may round to a neighbouring bf16 value (2^-8
# apart) where the float32 sums before the cast differ in order; a
# product z_i z_j moves by up to twice that
HESS_TOL = 1e-2  # max |H - H_ref| over max |H_ref|
COEFF_RTOL = 1e-2
# logits of the two models over max |logit| (chip_smoke.py's SMALL_TOL:
# the port's dequant route against the reference's xla path)
SMALL_TOL = 2e-2
META_RTOL, META_ATOL = 1e-4, 1e-6
# with a Hessian from real activations, LDLQ's feedback carries the
# float32 differences of the rotation, Wscale and the Cholesky into the
# next blocks, where a near-tie may pick the other code: at most this
# share of the words differs, and the error moves by at most HESS_ERR_RTOL
# (measured: up to 1.1% of the words, each holding several codes, in a
# few of the 20 _hess_ artifacts; the error within 0.2%)
HESS_WORDS = 0.05
HESS_ERR_RTOL = 1e-2
# without one, Wscale differs from the reference's by an ulp in ~30% of
# the rows (the row RMS sums in another order), so a weight within an
# ulp of a decision boundary may take the other code (measured: 1 word
# of 4224 in one of 14 artifacts)
WORDS = 1e-3
FLOAT_META = ("err", "orig_err", "kurtosis", "skewness")
KQ, KK, KV, KO, KG, KU, KD = loader.LAYER_KEYS
TOKENS = [np.random.default_rng(s).integers(0, 256, (2, 16)).astype(np.int32)
          for s in (1, 2)]

# every merge over four layers, _hess_ and plain schemes mixed
MERGE = [["merge_qkv", "merge_ug"], ["merge_qk"], ["merge_kv", "merge_ug"],
         ["merge_qv"]]
LAYER_QSTRS = [
    {KQ: "ldlq_2_6_hess_1.0", KK: "ldlq_2_6_hess_1.0",
     KV: "ldlq_2_6_hess_1.0", KO: "tcq_6_hess_0.9",
     KG: "ldlq_2_8_hess_1.0", KU: "ldlq_2_8_hess_1.0",
     KD: "ldlq_1_4_hess_1.0"},
    {KQ: "tcq2s_6_hess_0.9", KK: "tcq2s_6_hess_0.9",
     KV: "ldlq_2_6_none_1.0", KO: "ldlq_2_6_hess_1.0",
     KG: "ldlq_1_4_none_1.0", KU: "ldlq_2_6_hess_1.0",
     KD: "sq_4_hess_1.0"},
    {KQ: "ldlq_1_4_hess_1.0", KK: "ldlq_2_6_hess_1.0",
     KV: "ldlq_2_6_hess_1.0", KO: "ldlq_1_4_hess_1.0",
     KG: "ldlq_2_6_none_1.0", KU: "ldlq_2_6_none_1.0",
     KD: "ldlq_2_6_hess_1.0"},
    {KQ: "ldlq_2_6_none_1.0", KK: "ldlq_1_4_hess_1.0",
     KV: "ldlq_2_6_none_1.0", KO: "ldlq_2_8_hess_1.0",
     KG: "ldlq_2_6_hess_1.0", KU: "ldlq_2_6_hess_1.0",
     KD: "ldlq_1_4_none_1.0"}]
QDICT = {f"{i}_{k}": q for i, layer in enumerate(LAYER_QSTRS)
         for k, q in layer.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def dense():
    """The dense model on both sides (the port's params carried over from
    the reference's) and both sides' Hessians over TOKENS."""
    dp = jloader.random_dense_params(JConfig(**CFG), seed=3)
    jspec, jparams = jloader.build_dense_model(JConfig(**CFG), dp)
    spec, _ = loader.build_dense_model(LlamaConfig(**CFG), dp, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), spec,
                             device="cpu")
    jH = jhess.collect_hessians(jspec, jparams, TOKENS)
    H = hessian.collect_hessians(spec, params, TOKENS)
    return dp, jspec, jparams, spec, params, jH, H


def test_collect_hessians_matches_reference(dense):
    dp, jspec, jparams, spec, params, jH, H = dense
    assert H.keys() == jH.keys() and len(H) == 4 * CFG["num_layers"]
    for k in jH:
        assert H[k].dtype == np.float32 and H[k].shape == jH[k].shape, k
        assert _rel(H[k], jH[k]) <= HESS_TOL, (k, _rel(H[k], jH[k]))
    assert H["0_down"].shape == (512, 512)
    for got, want in (
            (hessian.err_coeffs_from_hessians(H, dp, 4),
             jhess.err_coeffs_from_hessians(jH, dp, 4)),
            (hessian.err_coeffs_from_energy(
                hessian.collect_group_energy(spec, params, TOKENS), dp, 4),
             jhess.err_coeffs_from_energy(
                 jhess.collect_group_energy(jspec, jparams, TOKENS), dp, 4))):
        assert got.keys() == want.keys() and len(got) == 28
        for k in want:
            assert np.isclose(got[k], want[k], rtol=COEFF_RTOL), k


def _same_artifact(path_a, path_b):
    a, b = incoherent.load_artifact(path_a), jinc.load_artifact(path_b)
    assert a.keys() == b.keys(), path_a
    assert np.array_equal(a["SU"], b["SU"])
    assert np.allclose(a["Wscale"], b["Wscale"], rtol=1e-6, atol=0)
    qstr = a["meta"]["quantizer_str"]
    hess = "_hess_" in qstr
    for k in a:
        if k in ("meta", "SU", "Wscale"):
            continue
        if k == "lut" and qstr.startswith("sq_"):
            # ALS's centroid solve over those assignments
            assert np.allclose(a[k], b[k], rtol=1e-3 if hess else 1e-4,
                               atol=1e-6)
        elif k in ("tlut", "lut"):
            assert np.array_equal(a[k], b[k]), (path_a, k)
        else:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert (a[k] != b[k]).mean() <= (HESS_WORDS if hess else WORDS), (
                path_a, k)
    for k, v in b["meta"].items():
        if k in ("err", "orig_err") and hess:
            assert np.isclose(a["meta"][k], v, rtol=HESS_ERR_RTOL), (path_a, k)
        elif k in FLOAT_META:
            assert np.isclose(a["meta"][k], v, rtol=META_RTOL,
                              atol=META_ATOL), (path_a, k)
        else:  # the port reads in_part / out_part back as tuples
            assert np.array_equal(a["meta"][k], v), (path_a, k)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def on_demand(dense, tmp_path_factory):
    """Both loaders quantize the mixed qdict on demand into their own
    save_dir, with the same (the reference's) Hessians."""
    dp, jH = dense[0], dense[5]
    root = tmp_path_factory.mktemp("on_demand")
    jdir, pdir = str(root / "ref"), str(root / "port")
    jmodel = jloader.build_quantized_model(
        JConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=jdir, dense_params=dp, impl="xla", hess=jH)
    model = loader.build_quantized_model(
        LlamaConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=pdir, dense_params=dp, dummy=False, impl="dequant",
        hess=jH, device="cpu")
    return jdir, pdir, jmodel, model


def _logits(jspec, jparams, spec, params):
    tok = TOKENS[0][:1]
    want = np.asarray(jllama.forward(jspec, jparams, jax.numpy.asarray(tok)))
    got = llama.forward(spec, params, torch.as_tensor(tok)).numpy()
    return got, want


def test_on_demand_artifacts_match_reference(dense, on_demand):
    """The port's on-demand artifacts are the reference's: the same files,
    SU, tables and meta, the words but for near-ties (WORDS, HESS_WORDS),
    Wscale and the error diagnostics within float32 rounding."""
    jdir, pdir, _, (spec, _) = on_demand
    files = _files(pdir)
    assert files == _files(jdir) and len(files) == 28
    for f in files:
        _same_artifact(os.path.join(pdir, f), os.path.join(jdir, f))
    kinds = {nm: ls.kind for a, m in spec.layers for nm, ls in a.projs
             + m.projs}
    assert kinds["qkv"] == "vq" and kinds["qk"] == "tcq2"
    assert [a.merge for a, _ in spec.layers] == ["qkv", "qk", "kv", "qv"]
    assert [m.merge_ug for _, m in spec.layers] == [True, False, True,
                                                    False]


def test_on_demand_reads_both_ways(dense, on_demand):
    """Each loader reads the other's save_dir without quantizing (every
    artifact exists and is current), and the models' logits agree within
    SMALL_TOL: the port on the reference's artifacts against the
    reference, the reference on the port's against the port."""
    dp = dense[0]
    jdir, pdir, (jspec, jparams), (spec, params) = on_demand
    before = {f: os.path.getmtime(os.path.join(jdir, f))
              for f in _files(jdir)}
    spec_j, params_j = loader.build_quantized_model(
        LlamaConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=jdir, dense_params=dp, dummy=False, impl="dequant",
        device="cpu")
    assert before == {f: os.path.getmtime(os.path.join(jdir, f))
                      for f in _files(jdir)}
    got, want = _logits(jspec, jparams, spec_j, params_j)
    assert _rel(got, want) <= SMALL_TOL, _rel(got, want)
    jspec_p, jparams_p = jloader.build_quantized_model(
        JConfig(**CFG), QDICT, merge_info=MERGE, model_key=MODEL_KEY,
        save_dir=pdir, dense_params=dp, impl="xla")
    got, want = _logits(jspec_p, jparams_p, spec, params)
    assert _rel(got, want) <= SMALL_TOL, _rel(got, want)


HEAD_CFG = dict(vocab_size=256, hidden_size=16, intermediate_size=32,
                num_layers=1, num_heads=1, num_kv_heads=1, head_dim=16,
                rope_theta=10000.0)


def test_4bit_head_quantized_from_dense_head(tmp_path):
    """lm_head_bits=4 with dense params: the 999_lm_head artifact (tcq2s_8
    of the bf16 head padded to 4096 rows, SU seed*7+99) is quantized on
    demand, the same as the reference's; a stale stamp re-quantizes it.
    One 16-wide column block: 256 sequences a side.  The layers are
    rotfp16 (the SQ/VQ kernels take k/vec in multiples of 128)."""
    dp = jloader.random_dense_params(JConfig(**HEAD_CFG), seed=4)
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jspec, jparams = jloader.build_quantized_model(
        JConfig(**HEAD_CFG), "rotfp16", model_key=MODEL_KEY,
        save_dir=jdir, dense_params=dp, impl="xla", lm_head_bits=4)
    spec, params = loader.build_quantized_model(
        LlamaConfig(**HEAD_CFG), "rotfp16", model_key=MODEL_KEY,
        save_dir=pdir, dense_params=dp, dummy=False, impl="dequant",
        lm_head_bits=4, device="cpu")
    name = incoherent.artifact_path("", MODEL_KEY, 0, loader.LM_HEAD_QSTR,
                                    *loader.LM_HEAD_LAYER)
    assert name in _files(pdir)
    _same_artifact(os.path.join(pdir, name), os.path.join(jdir, name))
    assert spec.lm_head_spec.out_features == 4096
    got, want = _logits(jspec, jparams, spec, params)
    assert _rel(got, want) <= SMALL_TOL, _rel(got, want)
    path = os.path.join(pdir, name)
    art = incoherent.load_artifact(path)
    incoherent.save_artifact(
        dict(art, meta=dict(art["meta"], had_factors=[4, 4])), path)
    loader.build_quantized_model(
        LlamaConfig(**HEAD_CFG), "rotfp16", model_key=MODEL_KEY,
        save_dir=pdir, dense_params=dp, dummy=False, impl="dequant",
        lm_head_bits=4, device="cpu")
    assert incoherent.load_artifact(path)["meta"]["had_factors"] == [16]


def _stream(*_, **__):
    return np.random.default_rng(5).integers(0, 256, 16 * 8 + 3)


def _run_reference_script(name, argv, monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


QL_QDICT = {f"{i}_{k}": ("tcq_6_hess_0.9" if k == KO else
                         ["ldlq_2_6_hess_1.0", "0"] if k in (KQ, KK, KV)
                         else "ldlq_1_4_none_1.0")
            for i in range(HF_CONFIG["num_hidden_layers"])
            for k in loader.LAYER_KEYS}


def test_entry_points_match_reference(tmp_path, monkeypatch, capsys,
                                      reference_reader):
    """collect_hessians.main and quantize_layer.main on a local checkpoint
    with a synthetic stream (DATASET_LOADERS patched), each beside the
    reference's root script run the same way: the same Hessian files
    (within HESS_TOL) and sensitivity JSON, then the same artifacts from
    the port's Hessians; a second run skips all of them."""
    ckpt = str(tmp_path / "ckpt")
    _write_checkpoint(ckpt, tied=False)
    monkeypatch.setitem(evaluate.DATASET_LOADERS, "wikitext2", _stream)
    monkeypatch.setitem(jevaluate.DATASET_LOADERS, "wikitext2", _stream)
    args = ["--model", ckpt, "--nsamples", "8", "--ctx", "16"]
    for side in ("ref", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "ref":
            _run_reference_script("collect_hessians", args, monkeypatch)
        else:
            if not torch.cuda.is_available():  # the card by default
                with pytest.raises(SystemExit, match="no CUDA device"):
                    collect_hessians.main(args)
            collect_hessians.main(args + ["--device", "cpu"])
    got = dict(np.load(tmp_path / "port" / "hessians" / "custom_hessians.npz"))
    want = dict(np.load(tmp_path / "ref" / "hessians" / "custom_hessians.npz"))
    assert got.keys() == want.keys() and len(got) == 8
    for k in want:
        assert _rel(got[k], want[k]) <= HESS_TOL, k
    with open(tmp_path / "port" / "assets" / "custom_err_coeffs.json") as f:
        coeffs = json.load(f)
    with open(tmp_path / "ref" / "assets" / "custom_err_coeffs.json") as f:
        jcoeffs = json.load(f)
    assert coeffs.keys() == jcoeffs.keys()
    for k in jcoeffs:
        assert np.isclose(coeffs[k], jcoeffs[k], rtol=COEFF_RTOL), k

    qpath = str(tmp_path / "qdict.json")
    with open(qpath, "w") as f:
        json.dump(QL_QDICT, f)
    hpath = str(tmp_path / "port" / "hessians" / "custom_hessians.npz")
    qargs = ["--model", ckpt, "--qdict_path", qpath, "--hess_path", hpath]
    monkeypatch.chdir(tmp_path)
    _run_reference_script("quantize_layer", qargs + ["--save_dir", "ref_q"],
                          monkeypatch)
    capsys.readouterr()
    quantize_layer.main(qargs + ["--save_dir", "port_q", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("quantizing ") == 14 and "skip" not in out
    files = _files(str(tmp_path / "port_q"))
    assert files == _files(str(tmp_path / "ref_q")) and len(files) == 14
    for f in files:
        _same_artifact(str(tmp_path / "port_q" / f),
                       str(tmp_path / "ref_q" / f))
    quantize_layer.main(qargs + ["--save_dir", "port_q", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("skip ") == 14 and "quantizing" not in out
