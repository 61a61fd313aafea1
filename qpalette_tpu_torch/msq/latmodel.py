"""Latency model of a decode step, for the latency-constrained solver.

Counterpart of ``qpalette_tpu/msq/latmodel.py``.  A table holds the
seconds of each (group, quantizer, impl flag) projection call in a decode
step, measured by ``fit_latency_coeffs`` on the card, plus a ``constant``:
the rest of the step.  Entries that were not measured come from a
per-family affine fit

    lat(group, q) = calls * launch_f + packed_bytes(group, q) / BW_f

over the measured samples.  ``qdict_latency`` is the step time the table
gives a solved qdict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq.memmodel import layer_mem_bytes
from qpalette_tpu_torch.msq.solver import MERGE_GROUPS, SIMPLE2KEY

GROUPS = list("qkvougd") + list(MERGE_GROUPS)


def fit_family_model(samples: List[Tuple[str, float, float]]):
    """samples: (family, packed_bytes, seconds) -> {family: (launch, 1/BW)}.

    Least squares per family on lat = a + b * bytes."""
    fams: Dict[str, list] = {}
    for fam, b, t in samples:
        fams.setdefault(fam, []).append((b, t))
    out = {}
    for fam, pts in fams.items():
        A = np.array([[1.0, b] for b, _ in pts])
        y = np.array([t for _, t in pts])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        a, b = float(coef[0]), float(max(coef[1], 1e-15))
        out[fam] = (max(a, 0.0), b)
    return out


def family_of(qstr: str) -> str:
    """The fit family of a quantizer: sum2 and the other arithmetic modes,
    each split by odd KV, the LUT trellis kinds, and SQ/VQ."""
    def _odd(q):
        try:
            return int(q.split("_")[1]) % 2 == 1
        except (IndexError, ValueError):
            return False
    if qstr.startswith("tcq2s"):
        return "sum2o" if _odd(qstr) else "sum2"
    if qstr.startswith(("tcq1", "tcq2")):
        return "tcq1o" if _odd(qstr) else "tcq1"
    if qstr.startswith(("tcq", "tcomb", "comb")):
        return "tcq"
    return "vq"


# when a family has no measured samples, borrow the nearest one
FAMILY_FALLBACK = {"sum2o": ("sum2", "tcq1o", "tcq1"),
                   "tcq1o": ("tcq1", "sum2o", "sum2"),
                   "sum2": ("sum2o", "tcq1"),
                   "tcq1": ("tcq1o", "sum2")}


def packed_bytes(cfg: LlamaConfig, group: str, qstr: str) -> float:
    bases = MERGE_GROUPS.get(group, (group,))
    return sum(layer_mem_bytes(cfg, SIMPLE2KEY[b], qstr) for b in bases)


def kernel_calls(group: str, qstr: str) -> int:
    """comb runs two kernels (row halves); every other kind one."""
    return 2 if qstr.startswith("comb") else 1


def build_lat_table(cfg: LlamaConfig, qlist: List[str],
                    family_params: Dict[str, tuple],
                    constant: float = 1.0e-3,
                    impl_flags=("False", "True")) -> Dict[str, float]:
    """The full table from family fits: every group x quantizer x impl
    flag (both flags by default: the solver's use_impl_choice looks up the
    ``_True`` keys)."""
    table = {"constant": constant, "__source__": "model"}
    for g in GROUPS:
        for q in qlist:
            fam = family_of(q)
            if fam not in family_params:
                for fb in (FAMILY_FALLBACK.get(fam, ())
                           + ("tcq1", "tcq", "vq")):
                    if fb in family_params:
                        fam = fb
                        break
                else:
                    fam = next(iter(family_params))
            a, b = family_params[fam]
            lat = kernel_calls(g, q) * a + packed_bytes(cfg, g, q) * b
            for fl in impl_flags:
                table[f"{g}_{q}_{fl}"] = lat
    return table


def qdict_groups(qdict, merge_info, num_layers: int):
    """[(layer, group, quantizer_str, impl flag "True"/"False")] of a solved
    qdict: the merge groups of merge_info, the other projections alone.
    A qdict entry is a quantizer_str or (quantizer_str, choice); choice
    "1" is the solver's dequant route (its ``_True`` keys)."""
    out = []
    for i in range(num_layers):
        merged = [m[len("merge_"):] for m in (merge_info[i] if merge_info
                                              else [])]
        covered = {b for g in merged for b in MERGE_GROUPS[g]}
        groups = merged + [b for b in "qkvougd" if b not in covered]
        for g in groups:
            entry = qdict[f"{i}_{SIMPLE2KEY[MERGE_GROUPS.get(g, (g,))[0]]}"]
            qstr, choice = ((entry, "0") if isinstance(entry, str)
                            else (entry[0], str(entry[1])))
            out.append((i, g, qstr, "True" if choice == "1" else "False"))
    return out


def qdict_latency(table: Dict[str, float], qdict, merge_info,
                  num_layers: int) -> float:
    """Seconds a decode step by the table: the constant plus each group's
    entry (the solver's estimate of its own solution)."""
    return float(table["constant"]) + sum(
        float(table[f"{g}_{q}_{fl}"])
        for _, g, q, fl in qdict_groups(qdict, merge_info, num_layers))
