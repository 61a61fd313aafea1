"""Port parity for local Hugging Face loading and the two evaluation entry
points.  The test writes its own tiny checkpoint (config.json and two
safetensors shards, weights from a numpy seed), with an untied and a
tied head: config_from_hf field by field and load_dense_params array for
array against the reference's, find_local_checkpoint with HF_HOME in a
temporary directory, a bf16 checkpoint (which the reference's numpy
reader cannot take) against its own values.

Then eval_qdict.main() end to end on the CPU: the reference quantizes
the checkpoint's layers on demand into a temporary save_dir (tcq_6 in
attention, tcq2s_6 in the MLP); the port reads those artifacts, takes a
qdict file from the same directory and a synthetic token stream in place
of WikiText-2 (DATASET_LOADERS patched), and writes its result beside the
qdict.  Its perplexity is held to the reference's eval_ppl of the same
model.  eval_qdict_zeroshot.main() likewise, with a character tokenizer
and synthetic questions in place of the cached ones.  Nothing is
downloaded."""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch

from qpalette_tpu.models import hf_weights as jhf
from qpalette_tpu.runtime import evaluate as jevaluate
from qpalette_tpu.runtime import zeroshot as jzeroshot
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch import eval_qdict, eval_qdict_zeroshot
from qpalette_tpu_torch.models import hf_weights
from qpalette_tpu_torch.runtime import evaluate, loader, zeroshot

from test_torch_zeroshot import MockTok

HF_CONFIG = {"vocab_size": 256, "hidden_size": 128,
             "intermediate_size": 256, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 32, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
             "architectures": ["LlamaForCausalLM"]}
ATTN = "tcq_6_none_0.9"
MLP = "tcq2s_6_none_0.9"
CTX, N_WINDOWS = 32, 3
# the port's dequant route against the reference's xla path on the same
# artifacts: the same bf16 weights, float32 sums in another order
# (tests/test_torch_evaluate.py measured up to 2.6e-4 on the mean CE)
CE_TOL = 1e-3
LL_TOL = 2e-2  # tests/test_torch_zeroshot.py's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(tied, seed=0):
    c = HF_CONFIG
    h, i, nl = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    t = {"model.embed_tokens.weight": w(c["vocab_size"], h),
         "model.norm.weight": 1 + w(h)}
    for li in range(nl):
        pre = f"model.layers.{li}."
        t.update({pre + "self_attn.q_proj.weight": w(h, h),
                  pre + "self_attn.k_proj.weight": w(kv, h),
                  pre + "self_attn.v_proj.weight": w(kv, h),
                  pre + "self_attn.o_proj.weight": w(h, h),
                  pre + "mlp.gate_proj.weight": w(i, h),
                  pre + "mlp.up_proj.weight": w(i, h),
                  pre + "mlp.down_proj.weight": w(h, i),
                  pre + "input_layernorm.weight": 1 + w(h),
                  pre + "post_attention_layernorm.weight": 1 + w(h)})
    if not tied:
        t["lm_head.weight"] = w(c["vocab_size"], h)
    return t


def _write_checkpoint(path, tied, dtype="float32"):
    """config.json and the tensors split over two shards; returns the
    tensors written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**HF_CONFIG, "tie_word_embeddings": tied,
                   "torch_dtype": dtype}, f)
    t = _tensors(tied)
    names = sorted(t)
    for n, part in enumerate((names[::2], names[1::2])):
        shard = os.path.join(path, f"model-0000{n + 1}-of-00002.safetensors")
        if dtype == "bfloat16":
            save_torch({k: torch.from_numpy(t[k]).to(torch.bfloat16)
                        for k in part}, shard)
        else:
            save_file({k: t[k] for k in part}, shard)
    return t


@pytest.mark.parametrize("tied", [False, True])
def test_config_from_hf_matches_reference(tmp_path, tied):
    _write_checkpoint(str(tmp_path), tied)
    got = hf_weights.config_from_hf(str(tmp_path))
    want = jhf.config_from_hf(str(tmp_path))
    for f in dataclasses.fields(want):
        if f.name != "dtype":  # jnp.bfloat16 against torch.bfloat16
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.tie_embeddings == tied
    assert got.num_layers == 2 and got.kv_out == 64


def _same_arrays(got, want):
    assert got.keys() == want.keys()
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == np.float32 and np.array_equal(g[k], w[k]), k
    for k in ("embed", "lm_head", "ln_f"):
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])


@pytest.fixture
def reference_reader(monkeypatch):
    """The reference's load_dense_params reads its safe_open handles after
    their ``with`` block has ended; this safetensors closes a handle there
    ("File is closed").  Here the handles stay open until they are
    collected, so the reference's reader runs as written."""
    import safetensors

    real = safetensors.safe_open

    class KeptOpen:
        def __init__(self, *args, **kwargs):
            self.handle = real(*args, **kwargs)

        def __enter__(self):
            return self.handle

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(safetensors, "safe_open", KeptOpen)


@pytest.mark.parametrize("tied", [False, True])
def test_load_dense_params_matches_reference(tmp_path, tied,
                                             reference_reader):
    t = _write_checkpoint(str(tmp_path), tied)
    for nl in (None, 1):
        got = hf_weights.load_dense_params(str(tmp_path), num_layers=nl)
        want = jhf.load_dense_params(str(tmp_path), num_layers=nl)
        _same_arrays(got, want)
        assert len(got["layers"]) == (nl or 2)
    head = t["model.embed_tokens.weight" if tied else "lm_head.weight"]
    assert np.array_equal(got["lm_head"], head)


def test_load_dense_params_reads_bf16(tmp_path):
    t = _write_checkpoint(str(tmp_path), False, dtype="bfloat16")
    got = hf_weights.load_dense_params(str(tmp_path))
    want = torch.from_numpy(t["model.layers.1.mlp.down_proj.weight"]).to(
        torch.bfloat16).float().numpy()
    assert np.array_equal(got["layers"][1]["mlp.down_proj"], want)
    assert got["embed"].dtype == np.float32


def test_find_local_checkpoint_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    snaps = tmp_path / "hub" / "models--org--tiny-llama" / "snapshots"
    _write_checkpoint(str(snaps / "a1"), False)
    os.makedirs(snaps / "b2")  # newer, but holds no safetensors
    (snaps / "b2" / "config.json").write_text("{}")
    for name, want in (("org/tiny-llama", str(snaps / "a1")),
                       ("org/absent", None),
                       (str(snaps / "b2"), str(snaps / "b2"))):
        assert hf_weights.find_local_checkpoint(name) == want
        assert jhf.find_local_checkpoint(name) == want


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """A checkpoint, the reference's artifacts of it in a save_dir, a
    qdict file, and the reference model built from them (impl xla)."""
    root = tmp_path_factory.mktemp("eval")
    ckpt, save = str(root / "ckpt"), str(root / "quant")
    _write_checkpoint(ckpt, tied=False)
    qdict = {}
    for i in range(HF_CONFIG["num_hidden_layers"]):
        for key in ("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj", "self_attn.o_proj"):
            qdict[f"{i}_{key}"] = ATTN
        for key in ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            qdict[f"{i}_{key}"] = [MLP, "0"]  # as a solver writes it
    qpath = str(root / "mix.json")
    with open(qpath, "w") as f:
        json.dump(qdict, f)
    jdense = hf_weights.load_dense_params(ckpt)  # numpy, as the reference's
    jspec, jparams = jbuild(jhf.config_from_hf(ckpt),
                            eval_qdict.read_qdict(qpath), model_key="custom",
                            save_dir=save, dense_params=jdense, impl="xla")
    return ckpt, save, qpath, jspec, jparams


def _stream():
    return np.random.default_rng(3).integers(0, 256, CTX * N_WINDOWS + 7)


def test_eval_qdict_main_matches_reference(quantized, monkeypatch, capsys):
    ckpt, save, qpath, jspec, jparams = quantized
    monkeypatch.setitem(evaluate.DATASET_LOADERS, "wikitext2",
                        lambda name: _stream())
    argv = ["--model", ckpt, "--qdict_path", qpath, "--save_dir", save,
            "--ctx_size", str(CTX)]
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(SystemExit, match="no CUDA device"):
            eval_qdict.main(argv)
    # --hess_path's Hessians reach the loader (for artifacts it quantizes
    # on demand); the spy stops the run there
    hpath = os.path.join(os.path.dirname(qpath), "h.npz")
    H = {"0_qkv": np.eye(128, dtype=np.float32),
         "1_down": np.eye(256, dtype=np.float32)}
    np.savez(hpath, **H)
    seen = {}

    class Reached(Exception):
        pass

    def spy(*args, **kwargs):
        seen.update(kwargs)
        raise Reached

    monkeypatch.setattr(loader, "build_quantized_model", spy)
    with pytest.raises(Reached):
        eval_qdict.main(argv + ["--device", "cpu", "--hess_path", hpath])
    monkeypatch.undo()
    monkeypatch.setitem(evaluate.DATASET_LOADERS, "wikitext2",
                        lambda name: _stream())
    assert seen["hess"].keys() == H.keys()
    assert all(np.array_equal(seen["hess"][k], H[k]) for k in H)
    assert seen["save_dir"] == save and seen["dense_params"] is not None
    eval_qdict.main(argv + ["--device", "cpu"])
    result = qpath.replace(".json", "_result")
    with open(result + ".json") as f:
        got = json.load(f)["wikitext2"]
    with open(result + ".txt") as f:
        assert f.read().startswith("wikitext2, ")
    jppl, javg = jevaluate.eval_ppl(jspec, jparams, _stream(), ctx_size=CTX,
                                    progress=False)
    assert np.isfinite(got["ppl"])
    assert abs(got["avg_loss"] - javg) < CE_TOL, (got, javg)
    assert abs(got["ppl"] - np.exp(got["avg_loss"])) < 1e-9 * got["ppl"]
    # a second run reads the cached result; --re_eval evaluates again
    capsys.readouterr()
    eval_qdict.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.startswith("cached:")
    eval_qdict.main(argv + ["--device", "cpu", "--re_eval"])
    assert "ppl: " in capsys.readouterr().out


def test_eval_qdict_zeroshot_main_matches_reference(quantized, monkeypatch):
    import transformers

    ckpt, save, qpath, jspec, jparams = quantized
    rng = np.random.default_rng(4)
    words = ["ant", "bee", "cat", "dove", "eel", "frog", "gnu"]
    examples = [{"query": " ".join(rng.choice(words, 6)),
                 "choices": [" " + " ".join(rng.choice(words, 2))
                             for _ in range(3)],
                 "gold": int(rng.integers(0, 3))} for _ in range(4)]
    monkeypatch.setattr(zeroshot, "task_examples",
                        lambda task, limit=None: examples[:limit])
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda name: MockTok())
    eval_qdict_zeroshot.main(["--model", ckpt, "--qdict_path", qpath,
                              "--save_dir", save, "--tasks", "piqa",
                              "--limit", "4", "--device", "cpu"])
    with open(qpath.replace(".json", "_zeroshot.json")) as f:
        got = json.load(f)["piqa"]
    want = jzeroshot.eval_multiple_choice(jspec, jparams, MockTok(), examples)
    assert got == want and got["n"] == 4
    # the picks agree because every score is within LL_TOL of the
    # reference's and the best choice leads by more than two of them
    spec, params = eval_qdict.load_quantized(
        argparse.Namespace(model=ckpt, num_layers=-1, impl="xla", seed=0,
                           save_dir=save),
        eval_qdict.read_qdict(qpath), None, torch.device("cpu"))
    for ex in examples:
        ps = [zeroshot.loglikelihood(spec, params, MockTok(), ex["query"],
                                     ch)[0] for ch in ex["choices"]]
        js = [jzeroshot.loglikelihood(jspec, jparams, MockTok(), ex["query"],
                                      ch)[0] for ch in ex["choices"]]
        assert np.abs(np.subtract(ps, js)).max() < LL_TOL
        top2 = np.sort(ps)[-2:]
        assert top2[1] - top2[0] > 2 * LL_TOL
