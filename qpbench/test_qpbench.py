"""CPU tests of the benchmark harness, on the program's plain versions.

Every configuration and traffic mix runs end to end at a tiny size: the
configuration's quantization and attention layout at narrow widths and
two layers, the mix's kind at a few short requests.  Run with

  python -m pytest qpbench -q

The tiny sizes keep the program's routes: the LUT configuration's GEMVs
(K4) and dequant (K6); the arithmetic one's K1 a8 with a partial
512-column chunk (k = 1376) and a rotation with an odd factor (43).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qpbench import check, files, roofline, run, system
from qpbench.reference.llama import Reference
from qpbench.weights import Draws

BENCH = Path(__file__).resolve().parent
SEED = (1 << 31) + 12345  # wider than 32 signed bits
TINY = {"hidden_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
        "head_dim": 128}
TINY_CONFIGS = {
    "mistral7b-tcq3": {**TINY, "num_key_value_heads": 2,
                       "intermediate_size": 1024, "vocab_size": 512},
    "deepseek7b-tcq2s": {**TINY, "num_key_value_heads": 4,
                         "intermediate_size": 1376, "vocab_size": 4096},
}
TINY_MIXES = {
    "decode_bs1": {"prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 24},
                   "count": 4, "rounds": 2, "new_tokens": 6, "max_seq": 32,
                   "check_tokens": 10},
    "serve": {"slots": 2, "prefill_chunk": 8, "burst": 2, "max_seq": 48,
              "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 24},
              "new_len": {"dist": "uniform", "lo": 2, "hi": 4}, "count": 4,
              "rounds": 2,
              "check_tokens": 10, "trace_passes": 2},
}
# the limits at the tiny sizes, from the readings of test_control_fails
# (program / control over seeds 1-3, 48 served tokens each: served_gap
# 0-0.0089 / 0.056-0.11 at tcq_6 exact, 0-0.010 / 0.20-0.37 at tcq2s a8;
# sampled_gap at T 0.6, top-k 5: 0-0.00014 / 0.058-0.095 at tcq_6 exact,
# 0-0.017 / 0.11-0.30 at tcq2s a8)
TINY_LIMITS = {"served_gap": 0.025, "sampled_gap": 0.025,
               "served_gap_mean": 0.01}
FOUND = ("metrics", "traffic", "configs", "limits", "kinds", "heads",
         "reference/families", "reference/heads")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_root(tmp_path: Path) -> tuple:
    """A checkout-like root holding the benchmark's files found by name, at
    tiny sizes: (root, bench)."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    dst = tmp_path / "qpbench"
    for d in FOUND:
        shutil.copytree(BENCH / d, dst / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        data = json.loads((BENCH.parent / c["file"]).read_text())
        data.update(TINY_CONFIGS[c["name"]])
        (tmp_path / c["file"]).write_text(json.dumps(data))
    for w in bench["workloads"]:
        path = dst / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(path.read_text())
        mix.update(TINY_MIXES[mix["kind"]])
        path.write_text(json.dumps(mix))
        limits = json.loads((dst / "limits" / f"{w['name']}.json")
                            .read_text())
        (dst / "limits" / f"{w['name']}.json").write_text(json.dumps(
            {k: TINY_LIMITS[k] for k in limits}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, bench


def tiny_config(name: str) -> dict:
    data = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    data.update(TINY_CONFIGS[name])
    return {"model": data, "quantization": data["quantization"],
            "root": BENCH}


CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def seconds(cell: str) -> float:
    """A window in which a tiny run finishes a request or two."""
    return 3.0 if "serve" in cell else 2.0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end(tmp_path, cell, traced):
    root, bench = tiny_root(tmp_path)
    w = run.cell_of(bench, cell)
    result, checks, _ = run.measure(bench, w, SEED, seconds(cell), traced,
                                    "cpu", root=root)
    keys = {"correct", "attempted", "failed", "metrics", "device"}
    assert set(result) == keys | ({"breakdown"} if traced else set())
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in run.metrics_of(bench, w, traced)}
    got = set(result["metrics"])
    if traced:
        # the readers of the profiler's device ops find nothing on the CPU
        assert {m["name"] for m in run.metrics_of(bench, w, True)
                if m["source"] == "host_clock"} <= got <= want
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    for m in result["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_reference_agrees_with_the_program(name):
    """The program's logits of one forward against the reference's, and
    the control's further off."""
    from qpalette_tpu_torch.models import llama
    config = tiny_config(name)
    draws = Draws(7, config["model"], "cpu")
    spec, params = system.build(config, draws, "cpu")
    toks = torch.randint(0, config["model"]["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    got = llama.forward(spec, params, toks)[0]
    ref = Reference(config, draws)
    want = ref.logits(ref.hidden([toks[0]])[0])
    low = Reference(config, draws, control=config["quantization"]["control"])
    ctrl = low.logits(low.hidden([toks[0]])[0])
    err, ctrl_err = (float((x - want).abs().max()) for x in (got, ctrl))
    scale = float(want.abs().max())
    # bf16 activations (exact) and int8 ones (a8) against float32
    assert err < (0.02 if config["quantization"]["impl"] == "exact"
                  else 0.06) * scale
    assert ctrl_err > 3 * err


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_no_dequant_route_at_decode(name):
    """Every projection of a decode step (N <= 8 rows) takes a GEMV
    kernel: no (kind, impl) of the census is on the dequant route."""
    from qpalette_tpu_torch.measure_latency import route_census
    config = tiny_config(name)
    spec, _ = system.build(config, Draws(1, config["model"], "cpu"), "cpu")
    census = route_census(spec)
    assert all(impl != "dequant" for _, impl in census)
    assert sum(census.values()) == len(roofline.gemv_calls(config))


def _served(name, seed, temperature=0.0, top_k=None):
    """A tiny run's served sequences, greedy or sampled."""
    from qpalette_tpu_torch.runtime import decode
    config = tiny_config(name)
    draws = Draws(seed, config["model"], "cpu")
    spec, params = system.build(config, draws, "cpu")
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in (12, 20, 28):
        prompt = torch.randint(0, config["model"]["vocab_size"], (1, s),
                               generator=g)
        toks, _ = decode.generate(spec, params, prompt.numpy(), 16,
                                  max_seq=48, temperature=temperature,
                                  top_k=top_k, seed=seed)
        out.append(check.Served(toks[0, :s], toks[0, s:], temperature,
                                top_k))
    system.release(params)
    return config, draws, out


def _widest(config, draws, served, control=None):
    return float(torch.cat(check.gaps(config, draws, served, control,
                                      SEED)).max())


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_control_fails(name):
    """The control in the program's place reads above the limit on every
    seed; the program reads under it."""
    for seed in (1, 2, 3):
        config, draws, served = _served(name, seed)
        prog = _widest(config, draws, served)
        ctrl = _widest(config, draws, served,
                       config["quantization"]["control"])
        assert prog <= TINY_LIMITS["served_gap"] < ctrl, (seed, prog, ctrl)


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_sampled_control_fails(name):
    """Sampled tokens (T 0.6, top-k 5): the program's lie within the
    reference's top 5 to within the limit; the control's, drawn from its
    own top 5, do not."""
    for seed in (1, 2, 3):
        config, draws, served = _served(name, seed, 0.6, 5)
        prog = _widest(config, draws, served)
        ctrl = _widest(config, draws, served,
                       config["quantization"]["control"])
        assert prog <= TINY_LIMITS["sampled_gap"] < ctrl, (seed, prog, ctrl)


def _patched_run(tmp_path, monkeypatch, cell, target, fault):
    root, bench = tiny_root(tmp_path)
    monkeypatch.setattr(*target, fault)
    result, checks, _ = run.measure(bench, run.cell_of(bench, cell), SEED,
                                    seconds(cell), False, "cpu", root=root)
    return result, checks


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_fails(tmp_path, monkeypatch, cell):
    """A token altered where it is produced (the sampler, in the decode
    step and in the pool step) makes the run not correct."""
    from qpalette_tpu_torch.runtime import decode, serving
    real = decode.sample_logits

    def shifted(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(serving, "sample_logits", shifted)
    result, checks = _patched_run(tmp_path, monkeypatch, cell,
                                  (decode, "sample_logits"), shifted)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", [c for c in CELLS if "chat" in c])
def test_altered_sampled_token_fails(tmp_path, monkeypatch, cell):
    """A sampled token altered where it is produced, the greedy ones left
    as they are: sampled_gap alone fails the run."""
    from qpalette_tpu_torch.runtime import decode
    real = decode.sample_logits

    def shifted(logits, generator, temperature, top_k):
        out = real(logits, generator, temperature, top_k)
        return out if temperature == 0.0 else (out + 1) % logits.shape[-1]
    result, checks = _patched_run(tmp_path, monkeypatch, cell,
                                  (decode, "sample_logits"), shifted)
    assert not result["correct"], checks
    assert checks["served_gap"]["value"] <= checks["served_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_without_effect_fails(tmp_path, monkeypatch, cell):
    """A decode (or pool) step that leaves its state unchanged makes the
    run not correct."""
    from qpalette_tpu_torch.runtime import decode, serving
    target = ((serving.PoolStep, "replay") if "serve" in cell
              else (decode.CapturedStep, "replay"))

    def still(self, n=1):
        if hasattr(self, "host_pos"):
            self.host_pos += n
    result, checks = _patched_run(tmp_path, monkeypatch, cell, target, still)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_half_the_pool_left_out_fails(tmp_path, monkeypatch, cell):
    """A pool step that serves only the first half of its rows (the
    others' tokens never computed: 0) makes the run not correct."""
    from qpalette_tpu_torch.runtime import serving
    real = serving.PoolStep.replay

    def half(self, n=1):
        rows = torch.arange(self.n_slots // 2, self.n_slots)
        for _ in range(n):
            real(self, 1)
            self.history[rows, self.pos[rows]] = 0
            self.token[rows] = 0
    result, checks = _patched_run(tmp_path, monkeypatch, cell,
                                  (serving.PoolStep, "replay"), half)
    assert not result["correct"], checks


# a weight family, a head format, a kind and a metric that the benchmark
# does not have, each added as a file: the arithmetic trellis in mode
# dualmad (``tcq2``, paired-K-major like sum2), a bf16 head read in float32
# as it is, and a kind that serves each request's first token from its
# prefill alone
DUALMAD = '''
import torch
from qpbench.reference import decoders
X_BYTES = 4
PROGRAM_WORDS = "trellis"
def parse(qstr):
    return {"kv": int(qstr.split("_")[1])}
def word_shape(scheme, m, k):
    return decoders.trellis_words(scheme["kv"], 2, m, k)
def decode(scheme, words, m, k):
    u = decoders.unpack_states(words, scheme["kv"])
    w = torch.stack([decoders.signed_bytes((u * a) & decoders.M32).sum(-1)
                     for a in (34038481, 264435761)], dim=-1)
    vals = (w.to(torch.float64) / 147.800537109375).to(torch.float32)
    tiles = vals.reshape(-1, 8, 16, 2).permute(0, 2, 1, 3)
    return decoders.tiles_to_matrix(tiles.reshape(-1, 16, 16), m, k)
'''
HEAD_REF = '''
def weights(config, draws):
    md = config["model"]
    return {"head": draws.normal("lm_head", (md["vocab_size"],
                                             md["hidden_size"]))}
def logits(ref, hid):
    return hid @ weights(ref.config, ref.weights)["head"].float().T
def gemv_calls(config):
    return []
def weight_bytes(config):
    md = config["model"]
    return 2 * md["vocab_size"] * md["hidden_size"]
'''
HEAD_PROGRAM = '''
from qpbench import files
def install(spec, params, config, draws):
    ref = files.load("reference/heads", "plain", config["root"])
    params["lm_head"] = ref.weights(config, draws)["head"]
    return spec
'''
FIRST_TOKEN = '''
import time
import numpy as np
import torch
from qpbench import check, drive, generate
class Window:
    def __init__(self, spec, params, config, mix, seed):
        from qpalette_tpu_torch.runtime import decode
        self.decode, self.spec, self.params = decode, spec, params
        self.mix = mix
        self.requests = generate.requests(mix, seed,
                                          config["model"]["vocab_size"])
        self.caches = decode.captured_step(spec, params, 1, mix["max_seq"],
                                           0.0, None).caches
    def _first(self, req):
        toks = torch.as_tensor(req.prompt)[None].to(
            self.params["embed"].device)
        logits, _ = self.decode.prefill(self.spec, self.params, toks,
                                        self.caches)
        return logits[0, -1].argmax().reshape(1).cpu().numpy()
    def window(self, seconds):
        rec = drive.Record("first_token")
        t0 = time.perf_counter()
        for req in self.requests:
            rec.served.append((req, self._first(req)))
            rec.attempted += 1
            rec.tokens += 1
        rec.seconds = time.perf_counter() - t0
        return rec
    def traced(self, rec):
        pass
    def check_sample(self, rec, seed):
        return [check.Served(r.prompt, np.asarray(o, np.int64))
                for r, o in rec.served]
def numbers(config, draws, mix, sample, control=None, seed=0):
    gaps = check.gaps(config, draws, sample, control, seed)
    return {"first_gap": float(torch.cat(gaps).max())}
'''


def test_added_by_name(tmp_path):
    """A configuration of a new weight family and head format, a mix of a
    new kind, and a metric, added as files (and entries) from a temporary
    directory, are found by name with no file of the benchmark edited, and
    the run is correct."""
    root, bench = tiny_root(tmp_path)
    q = root / "qpbench"
    (q / "reference/families/tcq2.py").write_text(DUALMAD)
    (q / "reference/heads/plain.py").write_text(HEAD_REF)
    (q / "heads/plain.py").write_text(HEAD_PROGRAM)
    (q / "kinds/first_token.py").write_text(FIRST_TOKEN)
    data = json.loads((q / "configs/mistral7b-tcq3.json").read_text())
    data["quantization"].update(
        projections={p: "tcq2_6_none_0.9" for p in
                     ("q", "k", "v", "o", "gate", "up", "down")},
        merges=["qkv", "ug"], impl="exact", head="plain")
    (q / "configs/throwaway.json").write_text(json.dumps(data))
    (q / "traffic/first.json").write_text(json.dumps(
        {"kind": "first_token", "count": 3, "rounds": 1, "new_tokens": 1,
         "max_seq": 32,
         "prompt_len": {"dist": "uniform", "lo": 8, "hi": 24}}))
    (q / "metrics/tokens_a_request.first.py").write_text(
        "def read(rec, config):\n"
        "    return rec.tokens / rec.attempted\n")
    (q / "limits/throwaway.first.json").write_text(
        json.dumps({"first_gap": TINY_LIMITS["served_gap"]}))
    bench["configs"].append({"name": "throwaway", "source": "test",
                             "file": "qpbench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.first",
                               "config": "throwaway", "traffic": "first",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "setup_s.first", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["throwaway.first"]})
    (q / "metrics/setup_s.first.py").write_text(
        "def read(rec, config):\n    return rec.setup_s\n")
    bench["per_layer"].append({"name": "tokens_a_request.first",
                               "unit": "tokens", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "setup_s.first",
                               "workloads": ["throwaway.first"]})
    before = {p: p.read_bytes() for p in BENCH.rglob("*.py")}
    w = run.cell_of(bench, "throwaway.first")
    result, checks, low = run.measure(bench, w, SEED, 0.1, True, "cpu",
                                      root=root, control=True)
    assert result["correct"], checks
    assert set(low) == {"first_gap"}
    assert result["metrics"]["tokens_a_request.first"]["value"] == 1
    assert {p: p.read_bytes() for p in BENCH.rglob("*.py")} == before


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing on
    its standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    res = subprocess.run([sys.executable, "-m", "qpbench.run", "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_jax_check_by_whole_name(monkeypatch):
    assert run.jax_loaded() == []
    import qpalette_tpu_torch  # noqa: F401  (its name begins with one)
    assert run.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "qpalette_tpu.ops", object())
    assert run.jax_loaded() == ["qpalette_tpu"]


def test_nothing_run_imports_jax(tmp_path):
    """A whole traced run of every cell at the tiny size, in a fresh
    process, leaves no JAX module loaded."""
    code = (
        "import json, sys; from pathlib import Path\n"
        "sys.path.insert(0, {here!r})\n"
        "from qpbench import run, test_qpbench as t\n"
        "root, bench = t.tiny_root(Path({tmp!r}))\n"
        "for w in bench['workloads']:\n"
        "    run.measure(bench, w, t.SEED, 0.1, True, 'cpu', root=root)\n"
        "print(json.dumps(run.jax_loaded()))\n").format(
            here=str(BENCH.parent), tmp=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
