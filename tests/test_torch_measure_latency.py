"""The port's measure_latency entry point on the CPU, as the reference's
measure_latency.py takes its arguments: without --dummy it loads the
dense params (embed, norms, head) of a local checkpoint, --batch_size B
decodes a (B, 1) prompt, and --save_key writes the result under
eval_results/latency/<hf_path>/.  The test writes its own tiny checkpoint
(config.json and one safetensors file, weights from a numpy seed) into a
temporary HF_HOME and the projections' artifacts (the loader's dummy
artifacts of one scheme, saved as the quantizer saves them) into a
temporary save_dir; nothing is downloaded."""

import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from qpalette_tpu_torch import measure_latency
from qpalette_tpu_torch.models import hf_weights
from qpalette_tpu_torch.quant.incoherent import artifact_path, save_artifact
from qpalette_tpu_torch.runtime import loader

NAME = "org/tiny-llama"
QSTR = "tcq2s_6_none_0.9"
HF_CONFIG = {"vocab_size": 256, "hidden_size": 128,
             "intermediate_size": 256, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 32, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
             "tie_word_embeddings": False,
             "architectures": ["LlamaForCausalLM"]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoint(path):
    """config.json and one safetensors file; returns the tensors."""
    c = HF_CONFIG
    h, i = c["hidden_size"], c["intermediate_size"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    rng = np.random.default_rng(1)  # not the loader's dummy draws (seed 0)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    t = {"model.embed_tokens.weight": w(c["vocab_size"], h),
         "model.norm.weight": 1 + w(h),
         "lm_head.weight": w(c["vocab_size"], h)}
    for li in range(c["num_hidden_layers"]):
        pre = f"model.layers.{li}."
        for name, shape in (("self_attn.q_proj", (h, h)),
                            ("self_attn.k_proj", (kv, h)),
                            ("self_attn.v_proj", (kv, h)),
                            ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (i, h)),
                            ("mlp.up_proj", (i, h)),
                            ("mlp.down_proj", (h, i))):
            t[pre + name + ".weight"] = w(*shape)
        t[pre + "input_layernorm.weight"] = 1 + w(h)
        t[pre + "post_attention_layernorm.weight"] = 1 + w(h)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(HF_CONFIG, f)
    save_file(t, os.path.join(path, "model.safetensors"))
    return t


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """HF_HOME with the checkpoint cached under NAME, a save_dir with
    every projection's artifact, the working directory in tmp_path, and
    the params build_quantized_model returned (a list, one a build)."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    snap = tmp_path / "hf" / "hub" / "models--org--tiny-llama" / "snapshots"
    tensors = _checkpoint(str(snap / "a1"))
    cfg = hf_weights.config_from_hf(str(snap / "a1"))
    save = str(tmp_path / "quant")
    for i in range(cfg.num_layers):
        for key in loader.LAYER_KEYS:
            save_artifact(loader._get_dummy_artifact(cfg, i, key, QSTR, 0),
                          artifact_path(save, "custom", 0, QSTR, i, key))
    monkeypatch.chdir(tmp_path)
    built = []
    real = loader.build_quantized_model

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        built.append(out[1])
        return out

    monkeypatch.setattr(loader, "build_quantized_model", spy)
    return tensors, save, built


def _argv(save, *extra):
    return ["--hf_path", NAME, "--quantizer_str", QSTR, "--save_dir", save,
            "--lm_head_bits", "16", "--max_new_tokens", "4",
            "--num_samples", "1", "--device", "cpu", *extra]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_measure_latency_loads_local_checkpoint(setup):
    """Without --dummy the embed, final norm, layer norms and head are the
    checkpoint's (the reference passes dense_params to the builder)."""
    tensors, save, built = setup
    res = measure_latency.main(_argv(save))
    params = built[-1]
    assert torch.equal(params["embed"],
                       _bf16(tensors["model.embed_tokens.weight"]))
    assert torch.equal(params["lm_head"], _bf16(tensors["lm_head.weight"]))
    assert torch.equal(params["ln_f"], _bf16(tensors["model.norm.weight"]))
    assert torch.equal(params["layers"][1]["ln_mlp"], _bf16(
        tensors["model.layers.1.post_attention_layernorm.weight"]))
    assert res["dense_params"].endswith("a1")
    assert res["batch_size"] == 1 and res["num_layers"] == 2
    assert res["routes"] == {"tcq2/a8": 7 * 2}, res["routes"]
    # --dummy reads no weights: the checkpoint gives the config alone
    res = measure_latency.main(_argv(save, "--dummy"))
    assert res["dense_params"] is None and res["weights"] == "dummy"
    assert not torch.equal(built[-1]["embed"],
                           _bf16(tensors["model.embed_tokens.weight"]))


def test_measure_latency_batch_and_save_key(setup, capsys):
    """--batch_size 2 decodes two rows; the bandwidth line divides by B;
    --save_key writes the printed result to eval_results/latency/."""
    _, save, _ = setup
    res = measure_latency.main(_argv(save, "--batch_size", "2",
                                     "--save_key", "b2"))
    out = capsys.readouterr().out
    path = os.path.join("eval_results", "latency", NAME, "b2.json")
    assert f"saved {path}" in out
    with open(path) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res))
    assert saved["batch_size"] == 2 and saved["impl"] == "a8"
    assert saved["quantizer_str"] == QSTR and saved["qdict_path"] is None
    assert saved["weights"] == save and saved["lm_head_bits"] == 16
    assert np.isfinite(saved["average_tokens_per_sec"])
    assert saved["average_tokens_per_sec"] > 0
    # the sample line: streamed bytes x tokens/s / B
    line = next(ln for ln in out.splitlines() if ln.startswith("sample 0:"))
    tps = float(line.split()[2])
    gbs = float(line.split(",")[1].split()[0])
    want = saved["streamed_gb_per_token"] * tps / 2
    assert abs(gbs - want) <= 0.05 + 1e-3 * want, (gbs, want)
