"""Model assembly: qdict + merge_info -> (ModelSpec, params).

Counterpart of ``qpalette_tpu/runtime/loader.py`` for the arithmetic
trellis kinds (tcq1 1mad/2mad, tcq2 dualmad/sum2), the LUT trellis kinds
(tcq, tcomb) and the SQ/VQ row-pack kind (vq: the ldlq, sq and vq2
families), keeping its seeds (``su_for``, the lm_head SU ``seed*7+99``
and dummy artifact ``seed*11+5``), its merge semantics (qkv / ug merges
of tcq1 / tcq2 with one KV and decode mode, of vq with one bits, vec and
codebook), the 4096-multiple vocab pad of the 4-bit lm_head and the
2048-multiple pad of the rotated int8 one.  Projections keep the canonical
``trellis`` (tcomb: ``trellis1`` / ``trellis2``; vq: ``qweight``) words;
the port defines no kernel-side layout yet.  The (2^S, 2) tables of tcq /
tcomb are held once per S in ``params["luts"]``; a vq projection holds its
own (2^bits, vec) float32 codebook ``lut``.  Dummy packed words come from
a ``torch.Generator`` on the target device.  ``random_dense_params`` and
``build_dense_model`` give the unquantized bf16 baseline.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from qpalette_tpu_torch.kernels import vq
from qpalette_tpu_torch.kernels.arith import SUPPORTED_KV
from qpalette_tpu_torch.models.llama import (AttnSpec, LlamaConfig, MLPSpec,
                                             ModelSpec)
from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv, trellis_tlut,
                                              vq_lut)
from qpalette_tpu_torch.ops.hadamard import hadamard_transform
from qpalette_tpu_torch.ops.packing import TD, words_to_torch
from qpalette_tpu_torch.quant.incoherent import parse_quantizer_str
from qpalette_tpu_torch.runtime.qlinear import IMPLS, LinearSpec

LAYER_KEYS = [
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
]

MODEL_KEYS = {
    "meta-llama/Llama-3.1-8B": "3_8b",
    "meta-llama/Llama-3.2-1B": "3_1b",
    "meta-llama/Llama-3.2-3B": "3_3b",
}

CONFIGS = {
    "3_8b": LlamaConfig.llama31_8b,
    "3_1b": LlamaConfig.llama32_1b,
    "3_3b": LlamaConfig.llama32_3b,
}

LM_HEAD_QSTR = "tcq2s_8_none_0.9"
LM_HEAD_BITS = (4, 8, 16)
I8_VOCAB_ALIGN = 2048  # the int8 head's vocab pad
I8_HEAD_ROWS = 8192  # head rows rotated and quantized a step
# the reference's solver emits these names for an explicit per-layer impl
_IMPL_NAMES = {"pallas": "exact", "pallas_a8": "a8"}


def proj_shape(cfg: LlamaConfig, key: str):
    h, i, kv = cfg.hidden_size, cfg.intermediate_size, cfg.kv_out
    return {
        "self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
        "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
        "mlp.gate_proj": (i, h), "mlp.up_proj": (i, h),
        "mlp.down_proj": (h, i),
    }[key]


def su_for(cfg: LlamaConfig, layer: int, key: str, seed: int) -> np.ndarray:
    """Deterministic shared sign vectors (q/k/v share, up/gate share)."""
    group = {"self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
             "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
             "mlp.gate_proj": "ug", "mlp.up_proj": "ug",
             "mlp.down_proj": "dp"}[key]
    n = proj_shape(cfg, key)[1]
    gid = {"qkv": 0, "o": 1, "ug": 2, "dp": 3}[group]
    rng = np.random.default_rng(seed * 1000003 + layer * 101 + gid)
    return (rng.standard_normal(n) > 0).astype(np.float32) * 2.0 - 1.0


def _spec_from_meta(meta: dict, impl: str) -> LinearSpec:
    kind = meta["kind"]
    common = dict(in_features=meta["in_features"],
                  out_features=meta["out_features"], impl=impl)
    if kind in ("tcq1", "tcq2"):
        mode, KV = meta["decode_mode"], meta["KV"]
        if (mode not in (("1mad", "2mad") if kind == "tcq1"
                         else ("sum2", "dualmad"))
                or KV not in SUPPORTED_KV[mode]):
            raise NotImplementedError(f"{kind} mode {mode!r} KV={KV} is "
                                      f"not ported")
        return LinearSpec(kind, KV=(KV,), mode=mode, **common)
    if kind == "tcq":
        return LinearSpec("tcq", KV=(meta["KV"],),
                          tlut_bits=meta["tlut_bits"], **common)
    if kind == "tcomb":
        return LinearSpec("tcomb", KV=(meta["KV1"], meta["KV2"]),
                          tlut_bits=meta["tlut_bits"],
                          split=tuple(meta["in_part"]), **common)
    if kind == "vq":
        if (meta["bits"], meta["vec"]) not in vq.SUPPORTED:
            raise NotImplementedError(f"vq bits={meta['bits']} vec="
                                      f"{meta['vec']} is not ported")
        return LinearSpec("vq", bits=meta["bits"], vec=meta["vec"], **common)
    raise NotImplementedError(f"scheme kind {kind!r} is not ported")


def dummy_artifact(qstr: str, shape, seed: int = 0) -> dict:
    """Shape-only artifact; packed words are generated on the target device
    in _params_from_artifact (``__device_dummy__`` holds their seed)."""
    m, n = shape
    spec = parse_quantizer_str(qstr)
    dims = {"quantizer_str": qstr, "in_features": n, "out_features": m}
    if spec.family in ("tcq1", "tcq1x2"):
        meta = {"kind": "tcq1", "KV": spec.KV[0],
                "decode_mode": "1mad" if spec.family == "tcq1" else "2mad",
                **dims}
    elif spec.family in ("tcq2", "tcq2s"):
        meta = {"kind": "tcq2", "KV": spec.KV[0],
                "decode_mode": ("sum2" if spec.family == "tcq2s"
                                else "dualmad"), **dims}
    elif spec.family == "tcq":
        meta = {"kind": "tcq", "KV": spec.KV[0],
                "tlut_bits": tlut_bits_for_kv(spec.KV[0]), **dims}
    elif spec.family == "tcomb":
        KV1, KV2 = spec.KV
        meta = {"kind": "tcomb", "KV1": KV1, "KV2": KV2,
                "tlut_bits": tlut_bits_for_kv(max(KV1, KV2)),
                "in_part": (n // 2, n // 2), **dims}
    elif spec.family in ("ldlq", "sq", "vq2"):
        meta = {"kind": "vq", "bits": spec.bits, "vec": spec.vec, **dims}
    else:
        raise NotImplementedError(f"dummy {spec.family!r} is not ported")
    rng = np.random.default_rng(seed)
    return {"SU": (rng.standard_normal(n) > 0).astype(np.float32) * 2 - 1,
            "Wscale": np.full((m,), 0.02, np.float32),
            "__device_dummy__": seed, "meta": meta}


_MERGE_KEYS = {"tcq1": ("KV", "decode_mode"), "tcq2": ("KV", "decode_mode"),
               "vq": ("bits", "vec")}


def merge_artifacts(arts: list) -> dict:
    """Row-concat merge of same-scheme tcq1 / tcq2 / vq artifacts (fused
    qkv / ug): trellis tiles are tile-row-major and row-packs row-major
    with a shared in_features, so stacking artifacts stacks output rows.
    KV and decode mode (vq: bits, vec and the codebook) must agree, and SU
    must already be shared."""
    m0 = arts[0]["meta"]
    if m0["kind"] not in _MERGE_KEYS:
        raise NotImplementedError(f"merge of {m0['kind']!r} is not ported")
    same = ("kind", "in_features") + _MERGE_KEYS[m0["kind"]]
    for a in arts[1:]:
        if any(a["meta"][key] != m0[key] for key in same):
            raise ValueError("can only merge the same scheme and in_features")
        if not np.array_equal(a["SU"], arts[0]["SU"]):
            raise ValueError("merge needs a shared SU")
        lut, lut0 = a.get("lut"), arts[0].get("lut")
        if (lut is None) != (lut0 is None) or (
                lut is not None and not np.array_equal(lut, lut0)):
            raise ValueError("VQ merge needs identical codebooks")
    out = {
        "meta": dict(m0, out_features=sum(a["meta"]["out_features"]
                                          for a in arts)),
        "SU": arts[0]["SU"],
        "Wscale": np.concatenate([a["Wscale"] for a in arts]),
    }
    if arts[0].get("lut") is not None:
        out["lut"] = arts[0]["lut"]
    if all(a.get("__device_dummy__") is not None for a in arts):
        out["__device_dummy__"] = arts[0]["__device_dummy__"]
    else:
        name = "qweight" if m0["kind"] == "vq" else "trellis"
        out[name] = np.concatenate([a[name] for a in arts], axis=0)
    return out


def word_shapes(ls: LinearSpec) -> dict:
    """Canonical word arrays of a tcq1 / tcq2 / tcq / tcomb / vq
    projection: name -> ((m/16)*(n_i/16), 4*KV_i), 8*KV words a tile for
    tcq1, and the row-pack (m, P*bits/32 + 1) for vq."""
    m, n = ls.out_features, ls.in_features
    if ls.kind == "vq":
        return {"qweight": (m, vq.row_words(n, ls.bits, ls.vec))}
    if ls.kind == "tcomb":
        n1, n2 = ls.split
        return {"trellis1": ((m // TD) * (n1 // TD), 4 * ls.KV[0]),
                "trellis2": ((m // TD) * (n2 // TD), 4 * ls.KV[1])}
    per_state = 8 if ls.kind == "tcq1" else 4
    return {"trellis": ((m // TD) * (n // TD), per_state * ls.KV[0])}


def _params_from_artifact(art: dict, device) -> dict:
    p = {"wscale": torch.as_tensor(art["Wscale"], dtype=torch.float32,
                                   device=device)}
    meta = art["meta"]
    shapes = word_shapes(_spec_from_meta(meta, "exact"))
    if meta["kind"] == "vq":
        # real sq_ / vq2_ artifacts carry their own codebook
        lut = art.get("lut")
        if lut is None:
            lut = vq_lut(meta["bits"], meta["vec"])
        p["lut"] = torch.tensor(np.asarray(lut, np.float32), device=device)
    if art.get("__device_dummy__") is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(art["__device_dummy__"]))
        for name, shape in shapes.items():
            p[name] = torch.randint(-(1 << 31), 1 << 31, shape,
                                    generator=gen, dtype=torch.int32,
                                    device=device)
        return p
    for name, shape in shapes.items():
        words = np.asarray(art[name], dtype=np.uint32)
        if words.shape != shape:
            raise ValueError(f"{name} {words.shape} != {shape}")
        p[name] = words_to_torch(words, device)
    return p


def tlut_tensors(spec, device) -> dict:
    """One (2^S, 2) float32 table per tlut_bits that the model's tcq /
    tcomb projections use, shared by all of them: {"tcq{S}": table}."""
    bits = {ls.tlut_bits for a, m in spec.layers
            for _, ls in a.projs + m.projs if ls.kind in ("tcq", "tcomb")}
    return {f"tcq{S}": torch.tensor(trellis_tlut(S), device=device)
            for S in sorted(bits)}


def int8_head_weights(w: torch.Tensor, su: torch.Tensor):
    """The rotated per-row symmetric int8 head of w (vocab, hidden), built
    as the reference builds it: W <- H(W * su) in float32, s = max|W|/127
    + 1e-12 a row, q = round(W / s); the vocab is padded to a multiple of
    2048 with zero rows of scale 1.  Returns (q (vocab_pad, hidden) int8,
    s (vocab_pad,) float32), on w's device, a block of rows at a time."""
    V, h = w.shape
    VP = -(-V // I8_VOCAB_ALIGN) * I8_VOCAB_ALIGN
    q = torch.zeros((VP, h), dtype=torch.int8, device=w.device)
    s = torch.ones(VP, dtype=torch.float32, device=w.device)
    for r0 in range(0, V, I8_HEAD_ROWS):
        wf = hadamard_transform(w[r0:r0 + I8_HEAD_ROWS].float() * su.float())
        sr = wf.abs().amax(dim=1) / 127.0 + 1e-12
        q[r0:r0 + wf.shape[0]] = torch.round(wf / sr[:, None]).to(torch.int8)
        s[r0:r0 + wf.shape[0]] = sr
    return q, s


def _get_dummy_artifact(cfg, layer, key, qstr, seed):
    # crc32, not hash(): stable across processes
    dseed = zlib.crc32(f"{layer}_{key}".encode()) % (1 << 31)
    art = dummy_artifact(qstr, proj_shape(cfg, key), seed=dseed)
    art["SU"] = su_for(cfg, layer, key, seed)
    return art


def build_quantized_model(cfg: LlamaConfig, qdict, merge_info=None,
                          dummy: bool = True, impl: str = "a8",
                          num_layers: Optional[int] = None,
                          lm_head_bits: int = 16, seed: int = 0,
                          device="cuda"):
    """Assemble (ModelSpec, params) with random (dummy) packed weights.

    qdict: quantizer_str, or {f"{i}_{key}": qstr | (qstr, impl_choice)}
    where impl_choice "0" is the default ``impl`` and "pallas"/"pallas_a8"
    name an impl explicitly.  merge_info: per-layer lists such as
    ["merge_qkv", "merge_ug"].  lm_head_bits: 16 (bf16), 8 (the rotated
    per-row int8 head) or 4 (tcq2s_8, always impl a8 as in the
    reference).  device: the card unless the caller asks for the CPU
    (``device="cpu"`` runs the plain versions)."""
    if not dummy:
        raise NotImplementedError("loading quantized artifacts is not "
                                  "ported; use dummy=True")
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if lm_head_bits not in LM_HEAD_BITS:
        raise NotImplementedError(f"lm_head_bits={lm_head_bits}")
    device = torch.device(device)
    nl = num_layers if num_layers is not None else cfg.num_layers
    dtype = cfg.dtype
    rng = np.random.default_rng(seed)

    def qstr_for(i, key):
        if isinstance(qdict, str):
            return qdict, impl
        v = qdict[f"{i}_{key}"]
        if not isinstance(v, (tuple, list)):
            return v, impl
        qs, choice = v
        if choice in _IMPL_NAMES:
            return qs, _IMPL_NAMES[choice]
        if choice in ("0", 0, False, "False"):
            return qs, impl
        raise NotImplementedError(f"impl choice {choice!r} for {i}_{key}: "
                                  f"the dequant path is not ported")

    def bf16(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).to(dtype)

    layers_params, layer_specs = [], []
    for i in range(nl):
        mi = merge_info[i] if merge_info is not None else []
        unknown = set(mi) - {"merge_qkv", "merge_ug"}
        if unknown:
            raise NotImplementedError(f"merges {sorted(unknown)}")
        arts, impls = {}, {}
        for key in LAYER_KEYS:
            qs, impls[key] = qstr_for(i, key)
            arts[key] = _get_dummy_artifact(cfg, i, key, qs, seed)

        def group_impl(*keys):
            ims = {impls[k] for k in keys}
            if len(ims) != 1:
                raise ValueError(f"merged projections need one impl, got "
                                 f"{ims} for {keys}")
            return ims.pop()

        KQ, KK, KV_, KO = LAYER_KEYS[:4]
        KG, KU, KD = LAYER_KEYS[4:]
        lp = {"su_qkv": bf16(arts[KQ]["SU"]), "su_o": bf16(arts[KO]["SU"]),
              "su_ug": bf16(arts[KU]["SU"]), "su_dp": bf16(arts[KD]["SU"])}
        if "merge_qkv" in mi:
            m = merge_artifacts([arts[KQ], arts[KK], arts[KV_]])
            im = group_impl(KQ, KK, KV_)
            attn_projs = [("qkv", _spec_from_meta(m["meta"], im))]
            lp["qkv"] = _params_from_artifact(m, device)
            merge_attn = "qkv"
        else:
            attn_projs = []
            for nm, kk in (("q", KQ), ("k", KK), ("v", KV_)):
                attn_projs.append((nm, _spec_from_meta(arts[kk]["meta"],
                                                       impls[kk])))
                lp[nm] = _params_from_artifact(arts[kk], device)
            merge_attn = None
        attn_projs.append(("o", _spec_from_meta(arts[KO]["meta"], impls[KO])))
        lp["o"] = _params_from_artifact(arts[KO], device)
        d_spec = ("down", _spec_from_meta(arts[KD]["meta"], impls[KD]))
        if "merge_ug" in mi:
            m = merge_artifacts([arts[KU], arts[KG]])
            mlp_projs = (("ug", _spec_from_meta(m["meta"],
                                                group_impl(KU, KG))), d_spec)
            lp["ug"] = _params_from_artifact(m, device)
        else:
            mlp_projs = (("up", _spec_from_meta(arts[KU]["meta"], impls[KU])),
                         ("gate", _spec_from_meta(arts[KG]["meta"],
                                                  impls[KG])), d_spec)
            lp["up"] = _params_from_artifact(arts[KU], device)
            lp["gate"] = _params_from_artifact(arts[KG], device)
        lp["down"] = _params_from_artifact(arts[KD], device)
        lp["ln_attn"] = torch.ones(cfg.hidden_size, dtype=dtype, device=device)
        lp["ln_mlp"] = torch.ones(cfg.hidden_size, dtype=dtype, device=device)
        layers_params.append(lp)
        layer_specs.append((AttnSpec(merge_attn, tuple(attn_projs)),
                            MLPSpec("merge_ug" in mi, mlp_projs)))

    cfg_nl = cfg if nl == cfg.num_layers else \
        LlamaConfig(**{**cfg.__dict__, "num_layers": nl})
    spec = ModelSpec(cfg_nl, tuple(layer_specs))
    params = {"layers": layers_params, "luts": tlut_tensors(spec, device)}
    # the same numpy draws as the reference, so dummy embeddings agree
    scale = 0.02
    params["embed"] = bf16(
        rng.standard_normal((cfg.vocab_size, cfg.hidden_size)) * scale)
    params["ln_f"] = torch.ones(cfg.hidden_size, dtype=dtype, device=device)
    lm_spec = None
    if lm_head_bits in (8, 16):
        params["lm_head"] = (params["embed"] if cfg.tie_embeddings else
                             bf16(rng.standard_normal(
                                 (cfg.vocab_size, cfg.hidden_size)) * scale))
    if lm_head_bits == 8:
        su = ((np.random.default_rng(seed * 7 + 99)
               .standard_normal(cfg.hidden_size) > 0) * 2.0 - 1.0)
        params["lm_head_su"] = torch.as_tensor(su.astype(np.float32),
                                               device=device)
        q, s = int8_head_weights(params.pop("lm_head"),
                                 params["lm_head_su"])
        params["lm_head_q"], params["lm_head_s"] = q, s
    elif lm_head_bits == 4:
        h = cfg.hidden_size
        VP = -(-cfg.vocab_size // 4096) * 4096  # 128256 -> 131072
        su = ((np.random.default_rng(seed * 7 + 99).standard_normal(h) > 0)
              * 2.0 - 1.0).astype(np.float32)
        art = dummy_artifact(LM_HEAD_QSTR, (VP, h), seed=seed * 11 + 5)
        art["SU"] = su
        lm_spec = _spec_from_meta(art["meta"], "a8")
        params["lm_head_q4"] = _params_from_artifact(art, device)
        params["lm_head_su"] = torch.as_tensor(su, device=device)
    return dataclasses.replace(spec, lm_head_spec=lm_spec), params


def random_dense_params(cfg: LlamaConfig, seed: int = 0,
                        scale: float = 0.02) -> dict:
    """Random dense Llama params as numpy float32: the reference's
    random_dense_params, the same numbers from the same seed."""
    rng = np.random.default_rng(seed)

    def w(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    layers = []
    for _ in range(cfg.num_layers):
        lp = {k: w(proj_shape(cfg, k)) for k in LAYER_KEYS}
        lp["ln_attn"] = np.ones((cfg.hidden_size,), np.float32)
        lp["ln_mlp"] = np.ones((cfg.hidden_size,), np.float32)
        layers.append(lp)
    emb = w((cfg.vocab_size, cfg.hidden_size))
    return {"layers": layers, "embed": emb,
            "lm_head": emb if cfg.tie_embeddings
            else w((cfg.vocab_size, cfg.hidden_size)),
            "ln_f": np.ones((cfg.hidden_size,), np.float32)}


def build_dense_model(cfg: LlamaConfig, dense_params: dict, device="cuda"):
    """The unquantized bf16 baseline (the reference's build_dense_model):
    every projection ``dense`` and unmerged, so the forward rotates no
    group; the identity ``su_*`` are kept as the reference keeps them."""
    device = torch.device(device)

    def bf16(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(torch.bfloat16)

    groups = ((("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
               ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj")),
              (("up", "mlp.up_proj"), ("gate", "mlp.gate_proj"),
               ("down", "mlp.down_proj")))
    layer_specs, layers = [], []
    for dp in dense_params["layers"][:cfg.num_layers]:
        lp, specs = {}, []
        for group in groups:
            projs = []
            for nm, key in group:
                m, n = proj_shape(cfg, key)
                projs.append((nm, LinearSpec("dense", n, m)))
                lp[nm] = {"w": bf16(dp[key])}
            specs.append(tuple(projs))
        for name, width in (("su_qkv", cfg.hidden_size),
                            ("su_o", cfg.hidden_size),
                            ("su_ug", cfg.hidden_size),
                            ("su_dp", cfg.intermediate_size)):
            lp[name] = torch.ones(width, dtype=torch.bfloat16, device=device)
        lp["ln_attn"] = bf16(dp["ln_attn"])
        lp["ln_mlp"] = bf16(dp["ln_mlp"])
        layers.append(lp)
        layer_specs.append((AttnSpec(None, specs[0]),
                            MLPSpec(False, specs[1])))
    params = {"layers": layers, "luts": {},
              "embed": bf16(dense_params["embed"]),
              "lm_head": bf16(dense_params["lm_head"]),
              "ln_f": bf16(dense_params["ln_f"])}
    return ModelSpec(cfg, tuple(layer_specs)), params
