"""Quantizer proxy-error tables.

Counterpart of ``qpalette_tpu/msq/err_tables.py``: the proxy error of a
quantizer is its relative MSE on a size x size N(0, 1) matrix (numpy
seed 0: the same matrix the reference draws).  ``build_err_table`` reads
the committed ``assets/quant_err.json`` and measures an entry that is
not there, writing the table back after each one (under
``$QPALETTE_ASSETS`` when that is set).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qpalette_tpu_torch.msq.memmodel import LAYER_KEYS
from qpalette_tpu_torch.ops.codebooks import ASSETS, asset_dir
from qpalette_tpu_torch.quant import quantizers
from qpalette_tpu_torch.quant.incoherent import (ARITH_MODES, codebook_rms,
                                                 parse_quantizer_str)


def proxy_quantize(qstr: str, size: int = 4096, seed: int = 0,
                   device="cuda"):
    """Quantize the size x size N(0, 1) matrix W (no Hessian) on
    ``device`` as quantizer_proxy_err does.  Returns (the proxy error, the
    quantizer's linear dict (its words), its own W-hat (size, size)
    float32 in the frame it quantized: W scaled as below).

    The scale s of the quantizer_str is applied as the reference applies
    it: the LUT families quantize W * (s / cbr), the arithmetic ones
    W * (s * cbr), ldlq W * s (cbr: the codebook's RMS); the estimate is
    scaled back before the error."""
    spec = parse_quantizer_str(qstr)
    W = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (size, size)).astype(np.float32), device=device)
    s, fam = spec.scale_override, spec.family

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=W.device)

    if fam in ("tcq", "tcomb"):
        cbr = codebook_rms(spec)
        Ws = W * f32(s / cbr)
        if fam == "tcq":
            linear, hat = quantizers.quantize_mat_tcq(Ws, None, spec.KV[0])
        else:
            linear, hat = quantizers.quantize_mat_combt(Ws, None, *spec.KV)
        back = hat * f32(cbr / s)
    elif fam in ARITH_MODES:
        sc = f32(s * codebook_rms(spec))
        quant = (quantizers.quantize_mat_tcq1 if fam in ("tcq1", "tcq1x2")
                 else quantizers.quantize_mat_tcq2)
        linear, hat = quant(W * sc, None, spec.KV[0], mode=ARITH_MODES[fam])
        back = hat / sc
    elif fam == "ldlq":
        linear, hat = quantizers.quantize_mat_vq(W * f32(s), None, spec.bits,
                                                 spec.vec)
        back = hat / f32(s)
    else:
        raise ValueError(fam)
    err = float(torch.mean((back - W) ** 2) / torch.mean(W ** 2))
    return err, linear, hat


def quantizer_proxy_err(qstr: str, size: int = 4096, seed: int = 0,
                        device="cuda") -> float:
    """Relative MSE of quantizing a size x size N(0, 1) matrix (no
    Hessian) on ``device`` (see proxy_quantize)."""
    return proxy_quantize(qstr, size, seed, device)[0]


def build_err_table(qlist: List[str], size: int = 4096,
                    cache_name: Optional[str] = "quant_err.json",
                    verbose: bool = True, device="cuda") -> Dict[str, float]:
    """{quantizer_str: proxy error} for qlist: the table
    ``<assets>/<cache_name>``, each missing entry measured on ``device``
    by quantizer_proxy_err at ``size`` and written back at once (an entry
    takes seconds on the card)."""
    table = {}
    path = None
    if cache_name:
        path = asset_dir() / cache_name
        for src in (path, ASSETS / cache_name):
            if src.exists():
                with open(src) as f:
                    table = json.load(f)
                break
    for q in qlist:
        if q in table:
            continue
        t0 = time.time()
        table[q] = quantizer_proxy_err(q, size=size, device=device)
        if verbose:
            print(f"  err[{q}] = {table[q]:.5f} ({time.time() - t0:.1f}s)",
                  flush=True)
        if path:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                json.dump(table, f, indent=1)
    return table


def uniform_err_coeffs(num_layers: int) -> Dict[str, float]:
    """Flat sensitivity, for when no calibration data is available (the
    committed ``assets/3_8b_err_coeffs.json`` holds measured ones)."""
    return {f"{i}_{k}": 1.0 for i in range(num_layers) for k in LAYER_KEYS}
