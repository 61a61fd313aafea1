"""Quantizer proxy-error tables.

Counterpart of ``build_err_table`` and ``uniform_err_coeffs`` in
``qpalette_tpu/msq/err_tables.py``.  The table is the committed
``assets/quant_err.json``: the relative MSE of each quantizer on a random
4096x4096 Gaussian weight, which holds every scheme of both solver
palettes.  An entry that is not there would be measured by quantizing
that matrix, and the quantizers are not ported, so a missing entry raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from qpalette_tpu_torch.msq.memmodel import LAYER_KEYS

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def build_err_table(qlist: List[str], size: int = 4096,
                    cache_name: Optional[str] = "quant_err.json"
                    ) -> Dict[str, float]:
    """{quantizer_str: proxy error} for qlist, read from
    ``assets/<cache_name>``; size is the side of the matrix a missing
    entry would be measured on."""
    table = {}
    if cache_name:
        path = os.path.join(ASSET_DIR, cache_name)
        if os.path.exists(path):
            with open(path) as f:
                table = json.load(f)
    missing = [q for q in qlist if q not in table]
    if missing:
        raise NotImplementedError(
            f"no proxy error for {missing} in {cache_name}: measuring one "
            f"quantizes a {size}x{size} Gaussian matrix, and the quantizers "
            f"are not ported (ROADMAP Queue 1 item 7)")
    return table


def uniform_err_coeffs(num_layers: int) -> Dict[str, float]:
    """Flat sensitivity, for when no calibration data is available (the
    committed ``assets/3_8b_err_coeffs.json`` holds measured ones)."""
    return {f"{i}_{k}": 1.0 for i in range(num_layers) for k in LAYER_KEYS}
