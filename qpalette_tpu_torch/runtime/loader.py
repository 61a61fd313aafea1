"""Model assembly: qdict + merge_info (+ artifacts) -> (ModelSpec, params).

Counterpart of ``qpalette_tpu/runtime/loader.py`` on one device, for
every kind the reference quantizes: the arithmetic trellis kinds (tcq1
1mad/2mad, tcq2 dualmad/sum2), the LUT trellis kinds (tcq, input-split
tcomb, output-split comb), the SQ/VQ row-pack kind (vq: the ldlq, sq and
vq2 families) and the rotated dense baseline (dense_rot, ``rotfp16``).
It keeps the reference's seeds (``su_for``, the lm_head SU ``seed*7+99``
and dummy artifact ``seed*11+5``), its impl choices (``qstr_for``), its
merges (qkv / qk / kv / qv / ug of tcq1, tcq2, tcq, tcomb and vq, with
its agreement checks), the 4096-multiple vocab pad of the 4-bit lm_head
and the 2048-multiple pad of the rotated int8 one.  Weights are dummy
(packed words drawn by a ``torch.Generator`` on the target device) or read
from the artifacts the reference writes (``quant/incoherent.py``), whose
Hadamard stamp must match ``get_had_factors``; embed, norms and lm_head
come from ``dense_params`` or from the reference's numpy draws.
Projections keep the canonical ``trellis`` (tcomb / comb: ``trellis1`` /
``trellis2``; vq: ``qweight``) words.  The (2^S, 2) tables of tcq / tcomb
/ comb are held once per S in ``params["luts"]`` (an artifact's own
``tlut`` must be the committed one); a vq projection holds its own
(2^bits, vec) float32 codebook ``lut``.  ``random_dense_params`` and
``build_dense_model`` give the unquantized bf16 baseline.

With ``dense_params``, a missing artifact, or one whose Hadamard stamp is
stale, is quantized on demand on the loader's device (``quantize_linear``
with ``su_for``'s signs and the group's ``hess`` Hessian) and written
where it was looked for, as the reference does.  ``row_parallel_tp`` =
tp > 1 builds o and down for the row-parallel tensor-parallel forward
(parallel/tp.py): quantized (or dummied) against the block-diagonal
rotation I_tp x H-hat_{n/tp} (``rot_blocks`` = tp, artifacts under
``{qstr}__rb{tp}``), and input-split tcomb against the block-permuted
W[:, pi] with 2*tp rotation blocks (``in_perm_blocks`` = 2*tp, under
``{qstr}__rb{2tp}__perm{2tp}``), so that each shard's contiguous input
slice holds one KV1 and one KV2 piece.
"""

from __future__ import annotations

import dataclasses
import os
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
from qpalette_tpu_torch.ops.hadamard import get_had_factors, hadamard_transform
from qpalette_tpu_torch.ops.packing import TD, words_to_torch
from qpalette_tpu_torch.quant.hessian import HESSKEY
from qpalette_tpu_torch.quant.incoherent import (artifact_path, load_artifact,
                                                 parse_quantizer_str,
                                                 quantize_linear,
                                                 save_artifact)
from qpalette_tpu_torch.runtime.qlinear import (GEMV_IMPLS, IMPLS, LinearSpec,
                                                kernel_gap,
                                                require_equal_halves)

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
LM_HEAD_LAYER = (999, "lm_head")  # the 4-bit head's artifact name
# the reference's impl names (its solver's explicit per-layer choices) and
# the port's
IMPL_NAMES = {"pallas": "exact", "pallas_a8": "a8", "xla": "dequant"}
MERGES = ("merge_qkv", "merge_qk", "merge_kv", "merge_qv", "merge_ug")


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
    """The LinearSpec of an artifact's meta under impl, refused where the
    impl's kernels do not take the scheme (qlinear.kernel_gap): the GEMV
    impls (exact, a8) take the palette's kernel sets, impl dequant (the
    reference's xla route) the dequant kernels' wider ones."""
    ls = _linear_spec(meta, impl)
    gap = kernel_gap(ls)
    if gap is not None and impl in GEMV_IMPLS:
        dq = kernel_gap(dataclasses.replace(ls, impl="dequant"))
        raise NotImplementedError(
            f"{gap}: outside the palette's kernel sets, so impl {impl!r} "
            f"cannot run it; "
            + ("impl 'dequant' runs it" if dq is None else
               f"nor can impl 'dequant': {dq}"))
    if gap is not None:
        raise NotImplementedError(f"{gap}: outside the dequant kernels' "
                                  f"sets, so impl {impl!r} cannot run it")
    return ls


def _linear_spec(meta: dict, impl: str) -> LinearSpec:
    kind = meta["kind"]
    common = dict(in_features=meta["in_features"],
                  out_features=meta["out_features"], impl=impl)
    if kind in ("tcq1", "tcq2"):
        mode = meta["decode_mode"]
        if mode not in (("1mad", "2mad") if kind == "tcq1"
                        else ("sum2", "dualmad")):
            raise NotImplementedError(f"{kind} mode {mode!r}: not a mode of "
                                      f"{kind} (K1 takes {SUPPORTED_KV})")
        return LinearSpec(kind, KV=(meta["KV"],), mode=mode, **common)
    if kind == "tcq":
        return LinearSpec("tcq", KV=(meta["KV"],),
                          tlut_bits=meta["tlut_bits"], **common)
    if kind == "tcomb":
        ls = LinearSpec("tcomb", KV=(meta["KV1"], meta["KV2"]),
                        tlut_bits=meta["tlut_bits"],
                        split=tuple(meta["in_part"]), **common)
        require_equal_halves(ls)
        return ls
    if kind == "comb":
        return LinearSpec("comb", KV=(meta["KV1"], meta["KV2"]),
                          tlut_bits=meta["tlut_bits"],
                          split=tuple(meta["out_part"]), **common)
    if kind == "vq":
        return LinearSpec("vq", bits=meta["bits"], vec=meta["vec"], **common)
    if kind == "dense_rot":
        return LinearSpec("dense_rot", **common)
    raise NotImplementedError(f"scheme kind {kind!r}: not one the "
                              f"reference loads")


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
        raise NotImplementedError(f"no dummy artifact of {spec.family!r} "
                                  f"(the reference has none either)")
    rng = np.random.default_rng(seed)
    return {"SU": (rng.standard_normal(n) > 0).astype(np.float32) * 2 - 1,
            "Wscale": np.full((m,), 0.02, np.float32),
            "__device_dummy__": seed, "meta": meta}


# the meta that merged artifacts must share, and their word arrays
_MERGE_KEYS = {"tcq1": ("KV", "decode_mode"), "tcq2": ("KV", "decode_mode"),
               "tcq": ("KV", "tlut_bits"),
               "tcomb": ("KV1", "KV2", "tlut_bits", "in_part"),
               "vq": ("bits", "vec")}
_WORDS = {"tcq1": ("trellis",), "tcq2": ("trellis",), "tcq": ("trellis",),
          "tcomb": ("trellis1", "trellis2"), "vq": ("qweight",)}


def _check_tlut(art: dict) -> None:
    """The port holds one table per S for the whole model: an artifact's
    own ``tlut`` must be the committed one."""
    tlut = art.get("tlut")
    if tlut is not None and not np.array_equal(
            np.asarray(tlut, np.float32),
            trellis_tlut(art["meta"]["tlut_bits"])):
        raise ValueError(f"the artifact's tlut is not the committed "
                         f"tcq_tlut_{art['meta']['tlut_bits']}, which the "
                         f"port shares model-wide")


def merge_artifacts(arts: list) -> dict:
    """Row-concat merge of same-scheme artifacts (fused qkv / qk / kv / qv
    / ug): trellis tiles are tile-row-major (tcomb: each half's) and
    row-packs row-major with a shared in_features, so stacking artifacts
    stacks output rows.  The scheme's meta (tcq1 / tcq2: KV and decode
    mode; tcq: KV and tlut_bits; tcomb: both KV, tlut_bits and in_part;
    vq: bits, vec and the codebook) must agree, and SU must already be
    shared.  comb (output-split) and dense_rot do not merge, as in the
    reference."""
    m0 = arts[0]["meta"]
    if m0["kind"] not in _MERGE_KEYS:
        raise ValueError(f"merge not supported for scheme {m0['kind']!r}")
    same = ("kind", "in_features") + _MERGE_KEYS[m0["kind"]]
    for a in arts:
        if any(a["meta"][key] != m0[key] for key in same):
            raise ValueError(f"can only merge the same scheme and "
                             f"in_features ({same})")
        if not np.array_equal(a["SU"], arts[0]["SU"]):
            raise ValueError("merge needs a shared SU")
        lut, lut0 = a.get("lut"), arts[0].get("lut")
        if (lut is None) != (lut0 is None) or (
                lut is not None and not np.array_equal(lut, lut0)):
            raise ValueError("VQ merge needs identical codebooks")
        _check_tlut(a)
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
        for name in _WORDS[m0["kind"]]:
            out[name] = np.concatenate([a[name] for a in arts], axis=0)
    return out


def word_shapes(ls: LinearSpec) -> dict:
    """Canonical word arrays of a tcq1 / tcq2 / tcq / tcomb / comb / vq
    projection: name -> ((m/16)*(n_i/16), 4*KV_i) (comb: (m_i/16)*(n/16)
    tiles a half), 8*KV words a tile for tcq1, and the row-pack
    (m, P*bits/32 + 1) for vq."""
    m, n = ls.out_features, ls.in_features
    if ls.kind == "vq":
        return {"qweight": (m, vq.row_words(n, ls.bits, ls.vec))}
    if ls.kind == "tcomb":
        n1, n2 = ls.split
        return {"trellis1": ((m // TD) * (n1 // TD), 4 * ls.KV[0]),
                "trellis2": ((m // TD) * (n2 // TD), 4 * ls.KV[1])}
    if ls.kind == "comb":
        m1, m2 = ls.split
        return {"trellis1": ((m1 // TD) * (n // TD), 4 * ls.KV[0]),
                "trellis2": ((m2 // TD) * (n // TD), 4 * ls.KV[1])}
    per_state = 8 if ls.kind == "tcq1" else 4
    return {"trellis": ((m // TD) * (n // TD), per_state * ls.KV[0])}


def _params_from_artifact(art: dict, device) -> dict:
    p = {"wscale": torch.tensor(np.asarray(art["Wscale"], np.float32),
                                device=device)}
    meta = art["meta"]
    ls = _linear_spec(meta, "dequant")
    if ls.kind == "dense_rot":
        w = np.asarray(art["w"], np.float32)
        if w.shape != (ls.out_features, ls.in_features):
            raise ValueError(f"w {w.shape} does not fit {ls}")
        p["w"] = torch.tensor(w, device=device).to(torch.bfloat16)
        return p
    _check_tlut(art)
    shapes = word_shapes(ls)
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
    tcomb / comb projections use, shared by all of them: {"tcq{S}": table}."""
    bits = {ls.tlut_bits for a, m in spec.layers
            for _, ls in a.projs + m.projs
            if ls.kind in ("tcq", "tcomb", "comb")}
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


def _get_dummy_artifact(cfg, layer, key, qstr, seed, rot_blocks=1,
                        in_perm_blocks=0):
    # crc32, not hash(): stable across processes
    dseed = zlib.crc32(f"{layer}_{key}".encode()) % (1 << 31)
    art = dummy_artifact(qstr, proj_shape(cfg, key), seed=dseed)
    art["SU"] = su_for(cfg, layer, key, seed)
    art["meta"]["rot_blocks"] = rot_blocks
    art["meta"]["in_perm_blocks"] = in_perm_blocks
    return art


def block_perm(n: int, nblocks: int) -> np.ndarray:
    """pi of row-parallel tcomb: the input's column blocks of width
    n/nblocks in the order 0, 2, 4, ..., 1, 3, 5, ... (W[:, pi] is what is
    quantized; models/llama._block_perm_in permutes the activation)."""
    return (np.arange(n).reshape(nblocks // 2, 2, n // nblocks)
            .transpose(1, 0, 2).reshape(-1))


def read_artifact(path: str, shape, stamp_required: bool = False,
                  rot_blocks: int = 1):
    """The artifact at path, for a projection of shape (m, n) rotated in
    rot_blocks blocks, or None when there is none or its Hadamard stamp
    ``had_factors`` is not ``get_had_factors(n / rot_blocks)`` (stale).
    An artifact without a stamp is taken as current, as the reference
    takes it, unless stamp_required (the reference's lm_head check)."""
    if not os.path.exists(path):
        return None
    art = load_artifact(path)
    meta = art["meta"]
    if (meta["out_features"], meta["in_features"]) != tuple(shape):
        raise ValueError(f"{path}: ({meta['out_features']}, "
                         f"{meta['in_features']}), want {tuple(shape)}")
    have = meta.get("had_factors")
    want = list(get_had_factors(shape[1] // rot_blocks))
    if (have is None and stamp_required) or (
            have is not None and list(have) != want):
        return None
    return art


def get_artifact(path: str, shape, qstr: str, dense_w=None, su=None, H=None,
                 seed: int = 0, device="cuda", stamp_required: bool = False,
                 projection: bool = True, rot_blocks: int = 1,
                 in_perm_blocks: int = 0):
    """The artifact at path (read_artifact), or, when it is missing or
    stale, dense_w (m, n) quantized with qstr, SU su, Hessian H and
    rot_blocks rotation blocks on device and written to path (a
    projection's meta gains the reference loader's ``in_perm_blocks``).
    Without dense_w that raises."""
    art = read_artifact(path, shape, stamp_required, rot_blocks)
    if art is not None:
        return art
    if dense_w is None:
        what = "stale (its Hadamard stamp is not get_had_factors)" \
            if os.path.exists(path) else "missing"
        raise RuntimeError(f"{path}: the artifact is {what} and there are "
                           f"no dense weights to quantize")
    art = quantize_linear(dense_w, qstr, SU=su, H=H, seed=seed,
                          rot_blocks=rot_blocks, device=device)
    if projection:
        art["meta"]["in_perm_blocks"] = in_perm_blocks
    save_artifact(art, path)
    return art


def projection_artifact(cfg: LlamaConfig, i: int, key: str, qstr: str,
                        save_dir: str, model_key: str, seed: int = 0,
                        dense_params: Optional[dict] = None,
                        hess: Optional[dict] = None, device="cuda",
                        rot_blocks: int = 1, in_perm_blocks: int = 0):
    """Layer i's projection key under qstr: get_artifact at
    ``artifact_path(save_dir, model_key, seed, qdir, i, key)``, quantizing
    dense_params' weight with the signs su_for and the Hessian of its
    HESSKEY group in hess ({f"{i}_{group}": H}) when it is missing or
    stale.  rot_blocks > 1 (qdir ``{qstr}__rb{rot_blocks}``) rotates in
    blocks; in_perm_blocks > 0 (qdir ``...__perm{in_perm_blocks}``)
    quantizes W[:, pi] against H[pi][:, pi] and su[pi] (block_perm)."""
    qdir = qstr if rot_blocks == 1 else f"{qstr}__rb{rot_blocks}"
    dense_w = None if dense_params is None else dense_params["layers"][i][key]
    H = hess.get(f"{i}_{HESSKEY[key]}") if hess else None
    su = su_for(cfg, i, key, seed)
    if in_perm_blocks:
        qdir += f"__perm{in_perm_blocks}"
        pi = block_perm(proj_shape(cfg, key)[1], in_perm_blocks)
        su = su[pi]
        if dense_w is not None:
            dense_w = np.asarray(dense_w)[:, pi]
        if H is not None:
            H = np.asarray(H)[pi][:, pi]
    return get_artifact(
        artifact_path(save_dir, model_key, seed, qdir, i, key),
        proj_shape(cfg, key), qstr, dense_w=dense_w, su=su, H=H, seed=seed,
        device=device, rot_blocks=rot_blocks, in_perm_blocks=in_perm_blocks)


def impl_for(choice, impl: str) -> str:
    """The impl of a qdict entry's choice under the session impl (the
    reference's qstr_for): "0" / False the session's; "1" / True the other
    kernel class (dequant under exact or a8, exact under dequant); the
    reference's impl names "pallas", "pallas_a8", "xla" as named."""
    if isinstance(choice, str) and choice in IMPL_NAMES:
        return IMPL_NAMES[choice]
    if choice in ("1", 1, True, "True"):
        return "dequant" if impl in GEMV_IMPLS else "exact"
    return impl


KQ, KK, KV_, KO, KG, KU, KD = LAYER_KEYS
# (param name, the projections it holds) of each attention merge and of
# the MLP, in the reference's order
ATTN_GROUPS = {
    None: (("q", (KQ,)), ("k", (KK,)), ("v", (KV_,))),
    "qkv": (("qkv", (KQ, KK, KV_)),),
    "qk": (("qk", (KQ, KK)), ("v", (KV_,))),
    "kv": (("q", (KQ,)), ("kv", (KK, KV_))),
    "qv": (("qv", (KQ, KV_)), ("k", (KK,))),
}
MLP_GROUPS = {False: (("up", (KU,)), ("gate", (KG,))),
              True: (("ug", (KU, KG)),)}
# the projections that share one rotation (and SU)
ROT_GROUPS = {"su_qkv": (KQ, KK, KV_), "su_o": (KO,), "su_ug": (KU, KG),
              "su_dp": (KD,)}


def build_quantized_model(cfg: LlamaConfig, qdict, merge_info=None,
                          dummy: bool = True, impl: str = "a8",
                          num_layers: Optional[int] = None,
                          lm_head_bits: int = 16, seed: int = 0,
                          device="cuda", model_key: str = "model",
                          save_dir: str = "quant_results",
                          dense_params: Optional[dict] = None,
                          hess: Optional[dict] = None,
                          row_parallel_tp: int = 1):
    """Assemble (ModelSpec, params) from dummy weights or artifacts.

    qdict: quantizer_str, or {f"{i}_{key}": qstr | (qstr, impl_choice)}
    (see impl_for).  merge_info: per-layer lists such as ["merge_qkv",
    "merge_ug"] (also merge_qk, merge_kv, merge_qv).  impl: exact, a8 or
    dequant.  dummy=False reads each projection's artifact from
    ``artifact_path(save_dir, model_key, seed, qstr, i, key)``, quantizing
    a missing or stale one from dense_params on device (get_artifact).
    dense_params (numpy, as random_dense_params): the projections to
    quantize, embed, norms and lm_head; without it they are the
    reference's numpy draws from seed.  hess: {f"{i}_{group}": H}
    (collect_hessians; the group by HESSKEY) for the ``_hess_`` schemes
    quantized on demand.  lm_head_bits: 16 (bf16), 8
    (the rotated per-row int8 head, built from the dense head) or 4
    (tcq2s_8, always impl a8 as in the reference: dummy, or the
    ``999_lm_head`` artifact, quantized on demand from the bf16 dense
    head padded to a 4096 multiple; a missing one is a dummy head when
    there is no dense_params, as in the reference).  device: the card
    unless the caller asks for the CPU (``device="cpu"`` runs the plain
    versions).  row_parallel_tp > 1: o and down for the tensor-parallel
    forward of parallel/tp.py, block-rotated (and tcomb block-permuted),
    as in the module docstring; the single-device forward runs them too."""
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
        return qs, impl_for(choice, impl)

    def bf16(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    def artifact(i, key, qs, rb, pb):
        if dummy:
            return _get_dummy_artifact(cfg, i, key, qs, seed, rb, pb)
        return projection_artifact(cfg, i, key, qs, save_dir, model_key,
                                   seed, dense_params, hess, device, rb, pb)

    layers_params, layer_specs = [], []
    for i in range(nl):
        mi = merge_info[i] if merge_info is not None else []
        unknown = set(mi) - set(MERGES)
        if unknown:
            raise NotImplementedError(f"merges {sorted(unknown)}")
        merge_attn = None
        for mm in ("qkv", "qk", "kv", "qv"):  # the last one named wins
            if f"merge_{mm}" in mi:
                merge_attn = mm
        arts, impls, perms = {}, {}, {}
        for key in LAYER_KEYS:
            qs, impls[key] = qstr_for(i, key)
            rb = pb = 0
            if key in (KO, KD) and row_parallel_tp > 1:
                rb = row_parallel_tp
                if qs.startswith("tcomb"):
                    # each shard's slice holds a KV1 and a KV2 piece, each
                    # rotated on its own
                    rb = pb = 2 * row_parallel_tp
            perms[key] = pb
            arts[key] = artifact(i, key, qs, rb or 1, pb)

        lp = {}
        for name, keys in ROT_GROUPS.items():
            if any(not np.array_equal(arts[k]["SU"], arts[keys[0]]["SU"])
                   for k in keys):
                raise ValueError(f"layer {i}: {keys} must share one SU")
            lp[name] = bf16(arts[keys[0]]["SU"])

        def group(name, keys):
            ims = {impls[k] for k in keys}
            if len(ims) != 1:
                raise ValueError(f"merged projections need one impl, got "
                                 f"{ims} for {keys}")
            art = (arts[keys[0]] if len(keys) == 1
                   else merge_artifacts([arts[k] for k in keys]))
            lp[name] = _params_from_artifact(art, device)
            return name, _spec_from_meta(art["meta"], ims.pop())

        attn_projs = tuple(group(nm, keys) for nm, keys in
                           ATTN_GROUPS[merge_attn] + (("o", (KO,)),))
        merge_ug = "merge_ug" in mi
        mlp_projs = tuple(group(nm, keys) for nm, keys in
                          MLP_GROUPS[merge_ug] + (("down", (KD,)),))
        for name in ("ln_attn", "ln_mlp"):
            lp[name] = (bf16(dense_params["layers"][i][name])
                        if dense_params is not None else
                        torch.ones(cfg.hidden_size, dtype=dtype,
                                   device=device))
        layers_params.append(lp)
        layer_specs.append((
            AttnSpec(merge_attn, attn_projs,
                     rot_blocks_o=perms[KO] or row_parallel_tp,
                     in_perm_o=perms[KO]),
            MLPSpec(merge_ug, mlp_projs,
                    rot_blocks_down=perms[KD] or row_parallel_tp,
                    in_perm_down=perms[KD])))

    cfg_nl = cfg if nl == cfg.num_layers else \
        LlamaConfig(**{**cfg.__dict__, "num_layers": nl})
    spec = ModelSpec(cfg_nl, tuple(layer_specs))
    params = {"layers": layers_params, "luts": tlut_tensors(spec, device)}
    if dense_params is not None:
        params["embed"] = bf16(dense_params["embed"])
        params["ln_f"] = bf16(dense_params["ln_f"])
        head = dense_params["lm_head"]
    else:
        # the same numpy draws as the reference, so dummy embeddings agree
        scale = 0.02
        params["embed"] = bf16(
            rng.standard_normal((cfg.vocab_size, cfg.hidden_size)) * scale)
        params["ln_f"] = torch.ones(cfg.hidden_size, dtype=dtype,
                                    device=device)
        head = None if cfg.tie_embeddings or lm_head_bits == 4 else \
            rng.standard_normal((cfg.vocab_size, cfg.hidden_size)) * scale
    lm_spec = None
    if lm_head_bits in (8, 16):
        params["lm_head"] = params["embed"] if head is None else bf16(head)
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
        path = artifact_path(save_dir, model_key, seed, LM_HEAD_QSTR,
                             *LM_HEAD_LAYER)
        if not dummy and (dense_params is not None or os.path.exists(path)):
            w = None
            if dense_params is not None:
                # the reference quantizes its bf16 head, padded
                w = torch.as_tensor(np.asarray(head, np.float32)).to(
                    dtype).float().numpy()
                w = np.pad(w, ((0, VP - w.shape[0]), (0, 0)))
            art = get_artifact(path, (VP, h), LM_HEAD_QSTR, dense_w=w, su=su,
                               seed=seed, device=device, stamp_required=True,
                               projection=False)
            if not np.array_equal(np.asarray(art["SU"], np.float32), su):
                raise ValueError(f"{path}: SU is not the lm_head's "
                                 f"(seed * 7 + 99)")
        else:
            art = dummy_artifact(LM_HEAD_QSTR, (VP, h), seed=seed * 11 + 5)
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
