"""Calibration: input Hessians and per-projection sensitivity coefficients.

Counterpart of ``qpalette_tpu/quant/hessian.py``.  H = sum of z^T z over
calibration tokens, per layer and projection-input group (``qkv`` takes
the attention norm's output, ``o`` the attention context, ``up`` the MLP
norm's output, ``down`` silu(gate) * up in float32), accumulated in
float32 on the model's device by re-running the port's forward layer by
layer (the reference's ``_inner_inputs`` recomputes the o / down inputs
the same way).  ``HESSKEY`` maps each projection to its group.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.runtime.qlinear import qlinear_apply

HESS_GROUPS = ["qkv", "o", "up", "down"]
HESSKEY = {
    "self_attn.q_proj": "qkv", "self_attn.k_proj": "qkv",
    "self_attn.v_proj": "qkv", "self_attn.o_proj": "o",
    "mlp.up_proj": "up", "mlp.gate_proj": "up", "mlp.down_proj": "down",
}


def _inner_inputs(aspec, mspec, cfg, lp, h, h2, cos, sin, luts):
    """The o-proj and down-proj inputs (un-rotated), (B*S, n) float32."""
    B, S, N = h.shape
    rotated = aspec.projs[0][1].kind != "dense"
    z = (llama._rotate_in(h.reshape(-1, N), lp["su_qkv"]) if rotated
         else h.reshape(-1, N))
    outs = {name: qlinear_apply(ls, lp[name], z, luts=luts).reshape(B, S, -1)
            for name, ls in aspec.projs if name != "o"}
    hs, kvd = cfg.hidden_size, cfg.kv_out
    if aspec.merge == "qkv":
        q, k, v = torch.split(outs["qkv"], [hs, kvd, kvd], dim=-1)
    elif aspec.merge == "qk":
        (q, k), v = torch.split(outs["qk"], [hs, kvd], dim=-1), outs["v"]
    elif aspec.merge == "kv":
        q, (k, v) = outs["q"], torch.split(outs["kv"], [kvd, kvd], dim=-1)
    elif aspec.merge == "qv":
        (q, v), k = torch.split(outs["qv"], [hs, kvd], dim=-1), outs["k"]
    else:
        q, k, v = outs["q"], outs["k"], outs["v"]
    q = llama.apply_rope(q.reshape(B, S, cfg.num_heads, cfg.head_dim),
                         cos, sin)
    k = llama.apply_rope(k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
                         cos, sin)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    o_in = llama._attention(q, k, v, 0, cfg).reshape(-1, N).float()
    rotated_m = mspec.projs[0][1].kind != "dense"
    zm = (llama._rotate_in(h2.reshape(-1, N), lp["su_ug"]) if rotated_m
          else h2.reshape(-1, N))
    if mspec.merge_ug:
        y = qlinear_apply(mspec.projs[0][1], lp["ug"], zm, luts=luts)
        up, gate = y[:, :cfg.intermediate_size], y[:, cfg.intermediate_size:]
    else:
        up = qlinear_apply(mspec.projs[0][1], lp["up"], zm, luts=luts)
        gate = qlinear_apply(mspec.projs[1][1], lp["gate"], zm, luts=luts)
    dp_in = torch.nn.functional.silu(gate.float()) * up.float()
    return o_in, dp_in


@torch.inference_mode()
def group_inputs(spec, params, tokens: torch.Tensor):
    """Yield (layer, [qkv, o, up, down] inputs as (B*S, n) float32) of
    one batch of tokens (B, S), layer by layer."""
    cfg = spec.config
    B, S = tokens.shape
    luts = params.get("luts")
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = llama.rope_tables(torch.arange(S, device=tokens.device),
                                 cfg.head_dim, cfg.rope_theta)
    for li, (aspec, mspec) in enumerate(spec.layers):
        lp = params["layers"][li]
        h = llama.rms_norm(x, lp["ln_attn"], cfg.rms_eps)
        a, _ = llama.attn_forward(aspec, cfg, lp, h, cos, sin, luts=luts)
        x = x + a
        h2 = llama.rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
        o_in, dp_in = _inner_inputs(aspec, mspec, cfg, lp, h, h2, cos, sin,
                                    luts)
        N = h.shape[-1]
        yield li, [h.reshape(-1, N).float(), o_in,
                   h2.reshape(-1, N).float(), dp_in]
        x = x + llama.mlp_forward(mspec, cfg, lp, h2, luts=luts)


def _tokens(batch, params) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch), dtype=torch.int64,
                           device=params["embed"].device)


def collect_hessians(spec, params, token_batches: List[np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    """{f"{layer}_{group}": H (n, n) float32 numpy}: the sum of z^T z over
    every token of token_batches (each (B, S) ints), divided by their
    count."""
    Hs, count = {}, 0
    for batch in token_batches:
        for li, zs in group_inputs(spec, params, _tokens(batch, params)):
            for g, z in zip(HESS_GROUPS, zs):
                key = f"{li}_{g}"
                if key not in Hs:
                    Hs[key] = torch.zeros((z.shape[1], z.shape[1]),
                                          dtype=torch.float32,
                                          device=z.device)
                Hs[key].addmm_(z.T, z)
        count += batch.shape[0] * batch.shape[1]
    return {k: H.cpu().numpy() / count for k, H in Hs.items()}


def collect_group_energy(spec, params, token_batches: List[np.ndarray]
                         ) -> Dict[str, float]:
    """Mean input energy (tr(H)/n) per {layer}_{group}, without the (n, n)
    Hessians: the mean of z^2 a batch, averaged over the batches."""
    acc = {}
    for batch in token_batches:
        for li, zs in group_inputs(spec, params, _tokens(batch, params)):
            for g, z in zip(HESS_GROUPS, zs):
                key = f"{li}_{g}"
                acc[key] = acc.get(key, 0.0) + torch.mean(z * z)
    return {k: float(v) / len(token_batches) for k, v in acc.items()}


def _normalised(coeffs: Dict[str, float]) -> Dict[str, float]:
    mean = np.mean(list(coeffs.values()))
    return {k: v / mean for k, v in coeffs.items()}


def err_coeffs_from_energy(energy: Dict[str, float], dense_params: dict,
                           num_layers: int) -> Dict[str, float]:
    """Sensitivity of each projection: its group's input energy times
    mean(W^2), normalised to mean 1 (as err_coeffs_from_hessians, from
    the diagonal summary alone)."""
    from qpalette_tpu_torch.runtime.loader import LAYER_KEYS
    return _normalised({
        f"{i}_{key}": float(energy[f"{i}_{HESSKEY[key]}"] * np.mean(
            np.asarray(dense_params["layers"][i][key]).astype(np.float64)
            ** 2))
        for i in range(num_layers) for key in LAYER_KEYS})


def err_coeffs_from_hessians(hessians: Dict[str, np.ndarray],
                             dense_params: dict,
                             num_layers: int) -> Dict[str, float]:
    """Sensitivity of each projection: tr(H)/n of its group times
    mean(W^2) (float64), normalised to mean 1."""
    from qpalette_tpu_torch.runtime.loader import LAYER_KEYS
    coeffs = {}
    for i in range(num_layers):
        for key in LAYER_KEYS:
            H = hessians[f"{i}_{HESSKEY[key]}"]
            W = np.asarray(dense_params["layers"][i][key])
            coeffs[f"{i}_{key}"] = float(np.trace(H) / H.shape[0] * np.mean(
                W.astype(np.float64) ** 2))
    return _normalised(coeffs)
