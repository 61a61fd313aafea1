"""Carry the reference's params over to the port exactly.

``params_from_jax`` takes the ``qpalette_tpu`` params pytree with every
leaf already a numpy array (the caller converts; this module never
imports jax) and the port's ModelSpec of the same model, and returns the
port's params dict on ``device`` (the card unless the caller asks for
the CPU).  Canonical ``trellis`` words are taken as they are (the
reference's impl ``xla``); the dense planar ``trellis_pl`` of tcq1 and
tcq2 (the reference's quantized lm_head, and every tcq1 / tcq2
projection under its pallas impls; even KV, or odd KV with an even
k/16) is inverted to canonical words.  tcq / tcomb projections come as
canonical ``trellis`` / ``trellis1`` + ``trellis2`` (the reference's
impl ``xla``) or as the kernel layouts ``trellis_kt`` / ``trellisc_kt``
plus ``clut`` (its ``pallas`` impls), inverted to canonical words; comb
projections come as ``trellis1`` + ``trellis2`` or as ``trellis1_kt`` +
``trellis2_kt`` + ``clut``, each row half inverted as a tcq; their
tables must be the committed ones (``luts`` entries ``tcq{S}``,
``clut``), which the port holds once per S.  vq projections come as the
canonical row-pack ``qweight`` + ``lut`` (impl ``xla``) or as the kernel
layout ``qweight_t`` + ``clut`` (its pallas impls), inverted to the
row-pack with a zero pad word; the codebook is kept per projection, in
float32.  A ``dense`` projection (the bf16 baseline) is its weight ``w``,
a ``dense_rot`` one (``rotfp16``) its weight ``w`` and ``wscale``.
Projection names follow the spec (q / k / v / qkv / qk / kv / qv / o, up
/ gate / ug / down).
The int8 lm_head (``lm_head_q`` (hidden, vocab padded) int8,
``lm_head_s`` (1, vocab padded), and ``lm_head_su`` when it is rotated)
is transposed to the port's (vocab padded, hidden) rows.  Any other
layout raises.
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.kernels.formats import (tcomb_kernel_to_canonical,
                                                tcq1_planar_to_canonical,
                                                tcq2_planar_to_canonical,
                                                tcq_kernel_to_canonical,
                                                vq_kernel_to_canonical)
from qpalette_tpu_torch.ops.codebooks import trellis_lut, trellis_tlut
from qpalette_tpu_torch.ops.packing import words_to_torch
from qpalette_tpu_torch.runtime.loader import tlut_tensors, word_shapes
from qpalette_tpu_torch.runtime.qlinear import LinearSpec

_LAYER_TENSORS = ("su_qkv", "su_o", "su_ug", "su_dp", "ln_attn", "ln_mlp")


def _bf16(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32),
                           device=device).to(torch.bfloat16)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32)


def _canonical_words(p: dict, ls: LinearSpec) -> dict:
    """The projection's trellis words in the canonical layout."""
    m, k = ls.out_features, ls.in_features
    layouts = {"tcq1": ({"trellis"}, {"trellis_pl"}),
               "tcq2": ({"trellis"}, {"trellis_pl"}),
               "tcq": ({"trellis"}, {"trellis_kt", "clut"}),
               "tcomb": ({"trellis1", "trellis2"}, {"trellisc_kt", "clut"}),
               "comb": ({"trellis1", "trellis2"},
                        {"trellis1_kt", "trellis2_kt", "clut"}),
               "vq": ({"qweight", "lut"}, {"qweight_t", "clut"})}
    if ls.kind not in layouts:
        raise NotImplementedError(f"kind {ls.kind!r}")
    keys = set(p) - {"wscale"}
    canonical, kernel = layouts[ls.kind]
    if keys == canonical:
        return {name: _u32(p[name]) for name in canonical - {"lut"}}
    if keys != kernel:
        raise ValueError(f"unsupported projection layout {sorted(p)}")
    if ls.kind == "vq":
        return {"qweight": vq_kernel_to_canonical(
            _u32(p["qweight_t"]), ls.bits, ls.vec, m, k)}
    if ls.kind in ("tcq1", "tcq2"):
        inverse = (tcq1_planar_to_canonical if ls.kind == "tcq1"
                   else tcq2_planar_to_canonical)
        return {"trellis": inverse(_u32(p["trellis_pl"]), m, k, ls.KV[0])}
    if not np.array_equal(np.asarray(p["clut"], np.float32),
                          trellis_tlut(ls.tlut_bits)):
        raise ValueError("the projection's table is not the committed "
                         f"tcq_tlut_{ls.tlut_bits}")
    if ls.kind == "tcq":
        return {"trellis": tcq_kernel_to_canonical(_u32(p["trellis_kt"]), m,
                                                   k, ls.KV[0])}
    if ls.kind == "comb":
        return {f"trellis{h}": tcq_kernel_to_canonical(
            _u32(p[f"trellis{h}_kt"]), m_h, k, KV)
            for h, m_h, KV in zip((1, 2), ls.split, ls.KV)}
    t1, t2 = tcomb_kernel_to_canonical(_u32(p["trellisc_kt"]), m,
                                       *ls.split, *ls.KV)
    return {"trellis1": t1, "trellis2": t2}


def _proj(p: dict, ls: LinearSpec, device) -> dict:
    m = ls.out_features
    if ls.kind == "dense":  # the bf16 baseline's unquantized weight
        if set(p) != {"w"}:
            raise ValueError(f"unsupported dense layout {sorted(p)}")
        w = _bf16(p["w"], device)
        if tuple(w.shape) != (m, ls.in_features):
            raise ValueError(f"w {tuple(w.shape)} does not fit {ls}")
        return {"w": w}
    if ls.kind == "dense_rot":  # the rotated bf16 baseline
        if set(p) != {"w", "wscale"}:
            raise ValueError(f"unsupported dense_rot layout {sorted(p)}")
        w = _bf16(p["w"], device)
        if tuple(w.shape) != (m, ls.in_features):
            raise ValueError(f"w {tuple(w.shape)} does not fit {ls}")
        return {"w": w, "wscale": _f32(p["wscale"], device)}
    shapes = word_shapes(ls)
    out = {}
    for name, words in _canonical_words(p, ls).items():
        if words.shape != shapes[name]:
            raise ValueError(f"{name} {words.shape} does not fit {ls}")
        out[name] = words_to_torch(words, device)
    if ls.kind == "vq":
        out["lut"] = _f32(p["lut"] if "lut" in p else p["clut"], device)
        if out["lut"].shape != (1 << ls.bits, ls.vec):
            raise ValueError(f"lut {tuple(out['lut'].shape)} does not fit "
                             f"{ls}")
    out["wscale"] = _f32(p["wscale"], device)
    if out["wscale"].shape != (m,):
        raise ValueError(f"wscale {tuple(out['wscale'].shape)} != ({m},)")
    return out


def _check_luts(luts: dict):
    """The reference's shared tables: ``mad_{mode}`` of the arithmetic
    modes (not read: the port decodes them arithmetically) and
    ``tcq{S}``, its bf16 (2^16, 2) expansion of the committed table, which
    must agree with the port's."""
    for key, lut in luts.items():
        if key in ("mad_sum2", "mad_dualmad", "mad_1mad", "mad_2mad"):
            continue
        if not (key.startswith("tcq") and key[3:].isdigit()):
            raise ValueError(f"unsupported luts entry {key!r}")
        want = trellis_lut(int(key[3:])).to(torch.bfloat16).float().numpy()
        if not np.array_equal(np.asarray(lut, np.float32), want):
            raise ValueError(f"luts[{key!r}] is not the expansion of the "
                             f"committed table")


def params_from_jax(np_params: dict, spec, device="cuda") -> dict:
    """Reference params (numpy leaves) + the port's ModelSpec -> port
    params with identical weights."""
    device = torch.device(device)
    top = set(np_params) - {"layers", "luts", "embed", "ln_f", "lm_head",
                            "lm_head_q4", "lm_head_su", "lm_head_q",
                            "lm_head_s"}
    if top:
        raise ValueError(f"unsupported params {sorted(top)}")
    _check_luts(np_params.get("luts", {}))
    layers = []
    for (aspec, mspec), lp in zip(spec.layers, np_params["layers"],
                                  strict=True):
        projs = dict(aspec.projs + mspec.projs)
        extra = set(lp) - set(projs) - set(_LAYER_TENSORS)
        if extra:
            raise ValueError(f"unsupported layer params {sorted(extra)}")
        out = {k: _bf16(lp[k], device) for k in _LAYER_TENSORS}
        for name, ls in projs.items():
            out[name] = _proj(lp[name], ls, device)
        layers.append(out)
    params = {"layers": layers, "luts": tlut_tensors(spec, device),
              "embed": _bf16(np_params["embed"], device),
              "ln_f": _bf16(np_params["ln_f"], device)}
    if spec.lm_head_spec is not None:
        params["lm_head_q4"] = _proj(np_params["lm_head_q4"],
                                     spec.lm_head_spec, device)
        params["lm_head_su"] = _f32(np_params["lm_head_su"], device)
    elif "lm_head_q" in np_params:
        q = np.asarray(np_params["lm_head_q"])
        if q.dtype != np.int8 or q.shape[0] != spec.config.hidden_size:
            raise ValueError(f"lm_head_q {q.dtype} {q.shape}")
        params["lm_head_q"] = torch.as_tensor(np.ascontiguousarray(q.T),
                                              device=device)
        params["lm_head_s"] = _f32(np.asarray(np_params["lm_head_s"])
                                   .reshape(-1), device)
        if "lm_head_su" in np_params:
            params["lm_head_su"] = _f32(np_params["lm_head_su"], device)
    else:
        if "lm_head_q4" in np_params or "lm_head_su" in np_params:
            raise ValueError("quantized lm_head params for a bf16-head spec")
        params["lm_head"] = _bf16(np_params["lm_head"], device)
    return params
