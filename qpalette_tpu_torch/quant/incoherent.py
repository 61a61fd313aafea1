"""quantizer_str DSL.

Counterpart of ``QuantizerSpec`` / ``parse_quantizer_str`` in
``qpalette_tpu/quant/incoherent.py``:

  tcq_{KV}_{hess|none}_{scale}       trellis-coded (LUT), KV/2 bits/weight
  tcq1_/tcq1x2_/tcq2_/tcq2s_{KV}_... arithmetic-decode trellis
  tcomb_{KV1}_{KV2}_{r}_{hess}_{s}   input-split fractional TCQ
  comb_{KV1}_{KV2}_{r}_{hess}_{s}    output-split fractional TCQ
  ldlq_{vec}_{bits}_{hess}_{scale}   VQ/SQ via LDLQ
  sq_{bits}_{hess}_{scale}           scalar VQ
  vq2_{bits}_{hess}_{scale}          2-dim VQ
  rotfp16                            rotated dense baseline

and the artifact files of ``quant/incoherent.py`` (``artifact_path``,
``save_artifact``, ``load_artifact``): one ``.npz`` a projection, its
arrays beside a JSON ``__meta__`` string, read and written unchanged by
either package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class QuantizerSpec:
    """Parsed quantizer_str."""
    qstr: str
    family: str
    use_hess: bool
    scale_override: float
    KV: tuple | None = None
    ratio: float | None = None
    bits: int | None = None
    vec: int | None = None

    @property
    def avg_bits(self) -> float:
        """Bits per weight, excluding LUT overhead."""
        if self.family in ("tcq1", "tcq1x2"):
            return float(self.KV[0])
        if self.family in ("tcq", "tcq2", "tcq2s"):
            return self.KV[0] / 2
        if self.family in ("tcomb", "comb"):
            return (self.KV[0] + self.KV[1]) / 4
        return self.bits / self.vec


def parse_quantizer_str(qstr: str) -> QuantizerSpec:
    parts = qstr.split("_")
    fam = parts[0]
    if fam in ("tcq", "tcq1", "tcq1x2", "tcq2", "tcq2s"):
        _, kv, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv),))
    if fam in ("tcomb", "comb"):
        _, kv1, kv2, ratio, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv1), int(kv2)), ratio=float(ratio))
    if fam == "ldlq":
        _, vec, bits, hess, scale = parts
        return QuantizerSpec(qstr, "ldlq", hess == "hess", float(scale),
                             bits=int(bits), vec=int(vec))
    if fam == "sq":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "sq", hess == "hess", float(scale),
                             bits=int(bits), vec=1)
    if fam == "vq2":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "vq2", hess == "hess", float(scale),
                             bits=int(bits), vec=2)
    if fam == "rotfp16":
        return QuantizerSpec(qstr, "rotfp16", False, 1.0, bits=16, vec=1)
    raise ValueError(f"unknown quantizer_str {qstr!r}")


# meta entries that the quantizer writes as tuples; JSON stores lists
_TUPLE_META = ("in_part", "out_part")


def artifact_path(save_dir: str, model_key: str, seed: int,
                  quantizer_str: str, layer_idx: int, layer_key: str) -> str:
    return os.path.join(save_dir, model_key, f"left_only_seed{seed}_cache",
                        quantizer_str, f"{layer_idx}_{layer_key}.npz")


def save_artifact(art: dict, path: str) -> None:
    """Write art's arrays and its JSON meta to path (an ``.npz``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: v for k, v in art.items() if k != "meta"}
    np.savez(path, __meta__=json.dumps(art["meta"]), **arrays)


def load_artifact(path: str) -> dict:
    """An artifact's arrays and meta; ``in_part`` / ``out_part`` come back
    as the tuples the quantizer wrote."""
    with np.load(path, allow_pickle=False) as z:
        art = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"]))
    for key in _TUPLE_META:
        if key in meta:
            meta[key] = tuple(meta[key])
    art["meta"] = meta
    return art
