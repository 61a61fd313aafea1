"""Carry the reference's params over to the port exactly.

``params_from_jax`` takes the ``qpalette_tpu`` params pytree with every
leaf already a numpy array (the caller converts; this module never
imports jax) and the port's ModelSpec of the same model, and returns the
port's params dict on ``device``.  Canonical ``trellis`` words are taken
as they are; the even-KV planar ``trellis_pl`` (the reference's
quantized lm_head, and every tcq2 projection under its pallas impls) is
inverted to canonical words.  Any other layout raises.
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.kernels.formats import tcq2_planar_to_canonical
from qpalette_tpu_torch.ops.packing import words_to_torch
from qpalette_tpu_torch.runtime.qlinear import LinearSpec

_LAYER_TENSORS = ("su_qkv", "su_o", "su_ug", "su_dp", "ln_attn", "ln_mlp")


def _bf16(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32),
                           device=device).to(torch.bfloat16)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _proj(p: dict, ls: LinearSpec, device) -> dict:
    if ls.kind != "tcq2":
        raise NotImplementedError(f"kind {ls.kind!r}")
    m, k, KV = ls.out_features, ls.in_features, ls.KV[0]
    extra = set(p) - {"wscale", "trellis", "trellis_pl"}
    if extra or ("trellis" in p) == ("trellis_pl" in p):
        raise ValueError(f"unsupported projection layout {sorted(p)}")
    if "trellis" in p:
        words = np.asarray(p["trellis"], dtype=np.uint32)
    else:
        words = tcq2_planar_to_canonical(np.asarray(p["trellis_pl"],
                                                    dtype=np.uint32), m, k, KV)
    if words.shape != ((m // 16) * (k // 16), 4 * KV):
        raise ValueError(f"trellis {words.shape} does not fit {ls}")
    wscale = _f32(p["wscale"], device)
    if wscale.shape != (m,):
        raise ValueError(f"wscale {tuple(wscale.shape)} != ({m},)")
    return {"trellis": words_to_torch(words, device), "wscale": wscale}


def params_from_jax(np_params: dict, spec, device="cpu") -> dict:
    """Reference params (numpy leaves) + the port's ModelSpec -> port
    params with identical weights."""
    device = torch.device(device)
    top = set(np_params) - {"layers", "luts", "embed", "ln_f", "lm_head",
                            "lm_head_q4", "lm_head_su"}
    if top:
        raise ValueError(f"unsupported params {sorted(top)}")
    if set(np_params.get("luts", {})) - {"mad_sum2"}:
        raise ValueError(f"unsupported luts {sorted(np_params['luts'])}")
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
    params = {"layers": layers, "embed": _bf16(np_params["embed"], device),
              "ln_f": _bf16(np_params["ln_f"], device)}
    if spec.lm_head_spec is not None:
        params["lm_head_q4"] = _proj(np_params["lm_head_q4"],
                                     spec.lm_head_spec, device)
        params["lm_head_su"] = _f32(np_params["lm_head_su"], device)
    else:
        if "lm_head_q4" in np_params or "lm_head_su" in np_params:
            raise ValueError("quantized lm_head params for a bf16-head spec")
        params["lm_head"] = _bf16(np_params["lm_head"], device)
    return params
