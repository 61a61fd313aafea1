"""Port parity for the loader: the JAX package's artifact files, one real
artifact of every kind through qlinear_apply under each impl, the tcq /
tcomb merges, and (test_torch_loader_model.py, which takes its cases from
here) a 4-layer model that the JAX package quantized and wrote to disk,
loaded by the port from the same directory.  Its 4-bit head's
artifact (4096 x 128 tcq2s_8: the vocab pads to 4096) is written before
the build with random words in the reference's meta schema, as the
reference reads it: quantizing it on demand takes 104 s on one CPU.

Artifacts come from the reference's own quantize_linear (left-only
incoherence, seeded) on numpy weights.  The model (test (d)) is built by
the reference at impl xla with the dense params of random_dense_params,
quantized on demand into a temporary save_dir; the port loads that
directory at impl dequant (its xla).  Choice "1" takes the reference to
its Pallas kernels (interpret mode) and the port to its exact GEMVs.

Pallas interpret mode: the arithmetic and vq kernels cost 1-4 s a first
call at k = 128, the LUT trellis kernels (tcq, tcomb, comb) several
minutes (compile), so the LUT kinds are held to the reference's xla path
here (their kernels are held to the interpret-mode reference at k = 32 in
test_torch_tcq_lut.py), and every choice "1" of the model names an
arithmetic or vq scheme.  The reference forward runs eagerly: jit of a
whole forward around interpret-mode kernels compiled for minutes."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.ops.codebooks import trellis_lut as j_trellis_lut
from qpalette_tpu.ops.codebooks import trellis_lut_arith as j_lut_arith
from qpalette_tpu.quant import incoherent as jinc
from qpalette_tpu.runtime import loader as jloader
from qpalette_tpu.runtime import qlinear as jqlinear

from qpalette_tpu_torch import convert
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.ops.codebooks import trellis_tlut
from qpalette_tpu_torch.quant import incoherent
from qpalette_tpu_torch.runtime import loader
from qpalette_tpu_torch.runtime.qlinear import dequant_weight, qlinear_apply

# (b): 64 x 128, but 64 x 256 for ldlq_2_4: the port's row-pack kernels
# take k/vec a multiple of 128 (as the 8B's every width is)
SCHEMES = {
    "tcq": "tcq_6_none_0.9",
    "tcomb": "tcomb_6_7_0.5_none_0.9",
    # ratio 0.4: out_part (16, 48), unequal halves 16-row aligned
    "comb": "comb_6_7_0.4_none_0.9",
    "tcq1_1mad": "tcq1_3_none_0.9",
    "tcq1_2mad": "tcq1x2_3_none_0.9",
    "tcq2_sum2": "tcq2s_6_none_0.9",
    "tcq2_dualmad": "tcq2_6_none_0.9",
    "ldlq_2_4": "ldlq_2_4_none_1.0",
    "sq_4": "sq_4_none_1.0",
    "rotfp16": "rotfp16",
}
LUT_KINDS = ("tcq", "tcomb", "comb")
M = 64
# the reference's impl of each port impl
JIMPL = {"exact": "pallas", "a8": "pallas_a8", "dequant": "xla"}
# of max|y|: the existing GEMV tolerances (exact, and the dequant route,
# which differs from the reference's xla product only in f32 sum order)
TOL = {"exact": 1e-4, "a8": 1e-3, "dequant": 1e-4}

# (d): the tiny config at 4 layers, one attention merge a layer (qkv, qk,
# kv, qv) and ug merged on three; kinds and choices mixed.  The reference
# quantizer compiles once per (scheme, shape), ~3-8 s each, so the mix
# repeats (scheme, shape) pairs where it can (k and v are (b)'s 64 x 128)
CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
           rope_theta=10000.0)
KQ, KK, KV_, KO, KG, KU, KD = loader.LAYER_KEYS
T2S, T2, T1, T1X, TQ, TC, CB, LD, SQ, RF = (
    SCHEMES[k] for k in ("tcq2_sum2", "tcq2_dualmad", "tcq1_1mad",
                         "tcq1_2mad", "tcq", "tcomb", "comb", "ldlq_2_4",
                         "sq_4", "rotfp16"))
MODEL_LAYERS = [
    {KQ: (T2S, "0"), KK: (T2S, "0"), KV_: (T2S, "0"), KO: (T1, "1"),
     KG: (TQ, "xla"), KU: (TQ, "xla"), KD: (LD, "0")},
    {KQ: (TC, "0"), KK: (TC, "0"), KV_: (SQ, "1"), KO: (CB, "xla"),
     KG: (T2, "0"), KU: (TQ, "0"), KD: (RF, "0")},
    {KQ: (TQ, "xla"), KK: (TQ, "0"), KV_: (TQ, "0"), KO: (T2S, "1"),
     KG: (T2, "0"), KU: (T2, "0"), KD: (T2, "xla")},
    {KQ: (T1, "0"), KK: (T2, "1"), KV_: (T1, "0"), KO: (CB, "0"),
     KG: (TQ, "0"), KU: (TQ, "0"), KD: (T2, "0")},
]
QDICT = {f"{i}_{k}": v for i, layer in enumerate(MODEL_LAYERS)
         for k, v in layer.items()}
MERGE = [["merge_qkv", "merge_ug"], ["merge_qk"], ["merge_kv", "merge_ug"],
         ["merge_qv", "merge_ug"]]
MODEL_KEY = "tiny"
PROMPT = np.random.default_rng(21).integers(0, 256, (1, 6)).astype(np.int32)
N_STEPS = 4
# the port's dequant route and exact GEMVs against the reference's xla and
# interpret-mode kernels: bf16 operands, f32 sums in another order, and
# the 4-bit head's int8 ties (as test_torch_model.py)
LOGIT_TOL = 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops (as
    test_torch_decode.py): parallel workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quantize(qstr, seed):
    k = 256 if qstr.startswith("ldlq_2") else 128
    w = np.random.default_rng(seed).standard_normal((M, k)) * 0.02
    return jinc.quantize_linear(w.astype(np.float32), qstr, seed=0)


@pytest.fixture(scope="module")
def arts():
    """One real reference artifact of each kind (the SU of seed 0)."""
    return {name: _quantize(qstr, seed=i)
            for i, (name, qstr) in enumerate(SCHEMES.items())}


def _meta_equal(a, b):
    return json.loads(json.dumps(a)) == json.loads(json.dumps(b))


def _arrays_equal(a, b):
    keys = set(a) - {"meta"}
    return keys == set(b) - {"meta"} and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for k in keys)


# --- (a) artifact files --------------------------------------------------

def test_artifact_path_matches_reference():
    args = ("quant_results", "3_8b", 0, "tcq_6_none_0.9", 3,
            "self_attn.q_proj")
    assert incoherent.artifact_path(*args) == jinc.artifact_path(*args)


@pytest.mark.parametrize("name", ["tcomb", "comb", "tcq2_sum2", "sq_4"])
def test_artifact_files_round_trip_both_ways(arts, name, tmp_path):
    """JAX save -> port load and port save -> JAX load keep every array
    (dtype and bits) and the meta; the port reads in_part / out_part back
    as the tuples the quantizer wrote."""
    art = arts[name]
    jpath, ppath = str(tmp_path / "j" / "a.npz"), str(tmp_path / "p" / "a.npz")
    jinc.save_artifact(art, jpath)
    got = incoherent.load_artifact(jpath)
    assert _arrays_equal(got, art) and got["meta"] == art["meta"]
    for key in ("in_part", "out_part"):
        if key in art["meta"]:
            assert isinstance(got["meta"][key], tuple)
    incoherent.save_artifact(got, ppath)
    back = jinc.load_artifact(ppath)
    assert _arrays_equal(back, art) and _meta_equal(back["meta"], art["meta"])


# --- (b) one artifact of each kind through qlinear_apply -----------------

def _jluts(meta):
    luts = {}
    if "tlut_bits" in meta:
        S = meta["tlut_bits"]
        luts[f"tcq{S}"] = jnp.asarray(j_trellis_lut(S), jnp.bfloat16)
    if "decode_mode" in meta:
        mode = meta["decode_mode"]
        luts[f"mad_{mode}"] = jnp.asarray(j_lut_arith(mode), jnp.bfloat16)
    return luts


def _luts(meta):
    if "tlut_bits" not in meta:
        return {}
    S = meta["tlut_bits"]
    return {f"tcq{S}": torch.tensor(trellis_tlut(S))}


@pytest.mark.parametrize("impl", ["exact", "a8", "dequant"])
@pytest.mark.parametrize("name", list(SCHEMES))
def test_kind_matches_reference_qlinear(arts, name, impl):
    """A real artifact of each kind, loaded by the port, through the port's
    qlinear_apply (4 rows: the GEMV class under exact / a8) against the
    reference's under pallas / pallas_a8 / xla on the same z.  LUT kinds
    under exact / a8 are held to the reference's xla (see the module
    docstring).  The dequant route's W_hat is bit-equal to the reference's
    dequant_weight rounded to bf16: both gather the same bf16 values (the
    arithmetic modes' integer weight / 147.8005, rounded once to f32 and
    then to bf16 on the reference's side, times its f32 reciprocal on the
    port's, give the same bf16 for every weight)."""
    art = arts[name]
    meta = art["meta"]
    jimpl = JIMPL[impl] if name not in LUT_KINDS else "xla"
    spec = loader._spec_from_meta(meta, impl)
    p = loader._params_from_artifact(art, "cpu")
    jspec = jloader._spec_from_meta(meta, jimpl)
    jp = jloader._params_from_artifact(art, jnp.bfloat16, jimpl)
    z = np.random.default_rng(7).standard_normal(
        (4, meta["in_features"])).astype(np.float32)
    want = np.asarray(jqlinear.qlinear_apply(
        jspec, jp, jnp.asarray(z).astype(jnp.bfloat16), _jluts(meta),
        out_dtype=jnp.float32))
    got = qlinear_apply(spec, p, torch.from_numpy(z).to(torch.bfloat16),
                        out_dtype=torch.float32, luts=_luts(meta))
    assert got.shape == (4, M)
    assert _rel(got.numpy(), want) < TOL[impl]
    if impl == "dequant" and meta["kind"] != "dense_rot":
        xspec = jloader._spec_from_meta(meta, "xla")
        xp = jloader._params_from_artifact(art, jnp.bfloat16, "xla")
        jw = np.asarray(jqlinear.dequant_weight(xspec, xp, _jluts(meta))
                        .astype(jnp.bfloat16).astype(jnp.float32))
        w = dequant_weight(spec, p, _luts(meta))
        assert w.dtype == torch.bfloat16
        assert np.array_equal(w.float().numpy(), jw)


def test_comb_gemv_is_two_row_halves(arts):
    """comb under exact: the two K4 row halves side by side equal the
    dequant route's product of the stacked halves."""
    art = arts["comb"]
    assert art["meta"]["out_part"] == (16, 48)
    p = loader._params_from_artifact(art, "cpu")
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 128)).astype(np.float32)).to(torch.bfloat16)
    luts = _luts(art["meta"])
    ys = [qlinear_apply(loader._spec_from_meta(art["meta"], impl), p, z,
                        out_dtype=torch.float32, luts=luts)
          for impl in ("exact", "dequant")]
    assert _rel(ys[0].numpy(), ys[1].numpy()) < 1e-5


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["comb", "rotfp16"])
def test_convert_takes_comb_and_dense_rot(arts, name, jimpl):
    """params_from_jax's projection of comb (canonical trellis1/2, or the
    kernel layouts trellis1_kt/trellis2_kt + clut) and dense_rot (w,
    wscale) equals the port's own load of the artifact."""
    art = arts[name]
    spec = loader._spec_from_meta(art["meta"], "exact")
    jp = jax.tree.map(np.asarray, jloader._params_from_artifact(
        art, jnp.bfloat16, jimpl))
    got = convert._proj(jp, spec, "cpu")
    want = loader._params_from_artifact(art, "cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)


# --- (c) merges -----------------------------------------------------------

@pytest.mark.parametrize("name", ["tcq", "tcomb"])
def test_merge_matches_reference(arts, name):
    """merge_artifacts of two real artifacts (one SU) gives the reference's
    words, Wscale and meta; a KV that disagrees raises on both sides."""
    a, b = arts[name], _quantize(SCHEMES[name], seed=40)
    want = jloader.merge_artifacts([a, b])
    got = loader.merge_artifacts([a, b])
    words = ("trellis",) if name == "tcq" else ("trellis1", "trellis2")
    for key in words + ("Wscale", "SU"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    assert got["meta"] == want["meta"]
    assert got["meta"]["out_features"] == 2 * M
    other = dict(b, meta=dict(b["meta"], KV=5, KV1=5))
    with pytest.raises(AssertionError):
        jloader.merge_artifacts([a, other])
    with pytest.raises(ValueError):
        loader.merge_artifacts([a, other])


def test_comb_and_dense_rot_do_not_merge(arts):
    """As in the reference, output-split comb and dense_rot do not merge."""
    for name in ("comb", "rotfp16"):
        with pytest.raises(ValueError):
            jloader.merge_artifacts([arts[name], arts[name]])
        with pytest.raises(ValueError):
            loader.merge_artifacts([arts[name], arts[name]])


def test_impl_choices_match_reference_qstr_for():
    """impl_for against the reference's qstr_for, under each session impl:
    "0" / False the session's, "1" / True the other class, names as
    named (one layer a choice)."""
    choices = ("0", 0, False, "False", "1", 1, True, "True", "pallas",
               "pallas_a8", "xla")
    qdict = {f"{i}_{k}": ("tcq2s_6_none_0.9", c)
             for i, c in enumerate(choices) for k in loader.LAYER_KEYS}
    for jsession, session in (("pallas", "exact"), ("pallas_a8", "a8"),
                              ("xla", "dequant")):
        jspec, _ = jloader.build_quantized_model(
            JConfig(**dict(CFG, num_layers=len(choices))), qdict, dummy=True,
            impl=jsession)
        for (a, _), c in zip(jspec.layers, choices, strict=True):
            assert JIMPL[loader.impl_for(c, session)] == a.projs[0][1].impl


# --- (e) what the port refuses --------------------------------------------

def test_out_of_scope_raises_with_its_roadmap_item(arts):
    """Nothing of the reference's is refused now: row_parallel_tp = 2
    builds block-rotated o / down (rot_blocks 2 on the spec and the dummy
    meta) whose forward runs, and hess is taken (the Hessians of artifacts
    quantized on demand).  What the kernels cannot take still raises:
    tcomb halves of unequal width, which the quantizer never writes (K5 /
    K7 take (k/2, k/2))."""
    cfg = LlamaConfig(**dict(CFG, num_layers=1))
    spec, params = loader.build_quantized_model(cfg, T2S, device="cpu",
                                                row_parallel_tp=2)
    (a, m), = spec.layers
    assert (a.rot_blocks_o, a.in_perm_o, m.rot_blocks_down,
            m.in_perm_down) == (2, 0, 2, 0)
    from qpalette_tpu_torch.models.llama import forward
    out = forward(spec, params, torch.zeros((1, 3), dtype=torch.int64))
    assert out.shape == (1, 3, CFG["vocab_size"])
    assert bool(torch.isfinite(out).all())
    loader.build_quantized_model(cfg, T2S, device="cpu", hess={"0_qkv": None},
                                 row_parallel_tp=1)
    art = arts["tcomb"]
    bad = dict(art, meta=dict(art["meta"], in_part=(32, 96)))
    with pytest.raises(NotImplementedError, match="equal halves"):
        loader._params_from_artifact(bad, "cpu")
    spec = dataclasses.replace(
        loader._spec_from_meta(art["meta"], "dequant"), split=(32, 96))
    with pytest.raises(NotImplementedError, match="equal halves"):
        dequant_weight(spec, loader._params_from_artifact(art, "cpu"),
                       _luts(art["meta"]))


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "qpalette_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    mod = words[1].split(".")[0]
                    assert mod not in ("jax", "jaxlib", "qpalette_tpu"), (
                        path, line)
