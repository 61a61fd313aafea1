"""Mixed-scheme quantization (MSQ) solvers.

Counterpart of ``qpalette_tpu/msq/solver.py``, the same formulations:

  - memory-constrained: one quantizer a linear, total bytes within the
    budget, the least sum of err_coeff(layer) * quant_err(q);
  - latency-constrained, fusion-aware: a layer's projections are covered
    by singles {q,k,v,o,u,g,d} and merge groups {qk,kv,qv,qkv,ug}, each
    with a quantizer and a kernel-impl flag, every base projection
    exactly once; the sum of the groups' latency coefficients plus the
    table's ``constant`` within 1 / target_thp.

Both are exact MILPs on scipy's HiGHS (``scipy.optimize.milp``), with a
Lagrangian fast path and fallback (given a multiplier each linear or
group picks its best quantizer on its own; bisection on the
multiplier).  The impl flag "1" (``_True`` latency keys) is the dequant
route, offered to ldlq quantizers only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.msq.memmodel import (LAYER_KEYS, constant_mem_bytes,
                                             layer_mem_bytes)

# the candidate palettes (the reference's solve_mem_const.py /
# solve_lat_const.py): quantizer_str -> bits a weight
QDICT_MEM = {
    "tcq_3_none_0.9": 1.5, "tcq_4_none_0.9": 2.0, "tcq_5_none_0.9": 2.5,
    "tcq_6_none_0.9": 3.0, "tcq_7_none_0.9": 3.5, "tcq_8_none_0.9": 4.0,
    "tcq_9_none_0.9": 4.5, "tcq_10_none_0.9": 5.0,
    "tcomb_3_4_0.5_none_0.9": 1.75, "tcomb_4_5_0.5_none_0.9": 2.25,
    "tcomb_5_6_0.5_none_0.9": 2.75, "tcomb_6_7_0.5_none_0.9": 3.25,
    "tcomb_7_8_0.5_none_0.9": 3.75, "tcomb_8_9_0.5_none_0.9": 4.25,
    "tcomb_9_10_0.5_none_0.9": 4.75,
}
QDICT_LAT = dict(QDICT_MEM, **{
    f"ldlq_1_{b}_none_1.0": float(b) for b in range(2, 9)
}, **{
    f"ldlq_2_{b}_none_1.0": b / 2 for b in range(3, 13)
}, **{
    # arithmetic trellis, V=1 (1mad)
    f"tcq1_{b}_none_0.9": float(b) for b in range(2, 6)
}, **{
    # arithmetic trellis, V=2 (dualmad): KV/2 bits a weight
    f"tcq2_{b}_none_0.9": b / 2 for b in range(4, 11)
}, **{
    # arithmetic trellis, V=2 (sum2)
    f"tcq2s_{b}_none_0.9": b / 2 for b in range(4, 11)
})

SIMPLE2KEY = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.o_proj",
    "u": "mlp.up_proj", "g": "mlp.gate_proj", "d": "mlp.down_proj",
}
MERGE_GROUPS = {
    "qk": ("q", "k"), "kv": ("k", "v"), "qv": ("q", "v"),
    "qkv": ("q", "k", "v"), "ug": ("u", "g"),
}
ATTN_PARTITIONS = [
    (("q",), ("k",), ("v",)),
    (("qk",), ("v",)), (("kv",), ("q",)), (("qv",), ("k",)),
    (("qkv",),),
]
MLP_PARTITIONS = [(("u",), ("g",)), (("ug",),)]


def _err(cfg, err_table, err_coeffs, lidx, key, qstr):
    coeff = float(err_coeffs.get(f"{lidx}_{key}", 1.0)) \
        if err_coeffs else 1.0
    return coeff * float(err_table[qstr])


# ---------------------------------------------------------------------------
# memory-constrained solver
# ---------------------------------------------------------------------------

def solve_mem_constrained(cfg: LlamaConfig, qlist: List[str],
                          err_table: Dict[str, float],
                          target_bits: float,
                          err_coeffs: Optional[Dict[str, float]] = None,
                          num_layers: Optional[int] = None,
                          exact: bool = True) -> Dict[str, str]:
    """Pick one quantizer per linear under a total-memory budget.

    Returns {f"{i}_{key}": quantizer_str} (reference output schema)."""
    nl = num_layers or cfg.num_layers
    linears = [(i, key) for i in range(nl) for key in LAYER_KEYS]
    mems = np.array([[layer_mem_bytes(cfg, key, q) for q in qlist]
                     for i, key in linears])
    errs = np.array([[_err(cfg, err_table, err_coeffs, i, key, q)
                      for q in qlist] for i, key in linears])
    total_default = sum(layer_mem_bytes(cfg, key, "default")
                        for i, key in linears)
    # reserve the SU sign-vector bytes so calc_avg_bits stays under target
    budget = total_default * target_bits / 16.0 - constant_mem_bytes(cfg) * nl

    choice = None
    if exact:
        choice = _milp_assign(errs, mems, budget)
    if choice is None:
        choice = _lagrangian_assign(errs, mems, budget)
    return {f"{i}_{key}": qlist[c]
            for (i, key), c in zip(linears, choice)}


def _milp_assign(errs, mems, budget):
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    L, Q = errs.shape
    nvar = L * Q
    A = lil_matrix((L + 1, nvar))
    for l in range(L):
        A[l, l * Q:(l + 1) * Q] = 1.0
    A[L, :] = mems.reshape(-1)
    lb = np.concatenate([np.ones(L), [0.0]])
    ub = np.concatenate([np.ones(L), [budget]])
    res = milp(c=errs.reshape(-1),
               constraints=LinearConstraint(A.tocsr(), lb, ub),
               integrality=np.ones(nvar),
               bounds=Bounds(0, 1),
               options={"time_limit": 60.0})
    if not res.success:
        return None
    x = res.x.reshape(L, Q)
    return np.argmax(x, axis=1)


def _lagrangian_assign(errs, mems, budget, iters: int = 60):
    """Bisection on the memory multiplier; per-linear argmin decomposition."""
    lo, hi = 0.0, 1.0
    # grow hi until feasible
    for _ in range(60):
        c = np.argmin(errs + hi * mems, axis=1)
        if mems[np.arange(len(c)), c].sum() <= budget:
            break
        hi *= 4.0
    best = None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        c = np.argmin(errs + mid * mems, axis=1)
        used = mems[np.arange(len(c)), c].sum()
        if used <= budget:
            best = c
            hi = mid
        else:
            lo = mid
    if best is None:
        best = np.argmin(errs + hi * mems, axis=1)
    return best


# ---------------------------------------------------------------------------
# latency-constrained fusion-aware solver
# ---------------------------------------------------------------------------

@dataclass
class LatSolution:
    qdict: Dict[str, Tuple[str, str]]
    merge_info: List[List[str]]
    est_latency: float
    est_err: float


def _group_options(qlist, lat_coeffs, group, use_impl_choice):
    """All (qstr, impl) with a latency coefficient for this group."""
    opts = []
    for q in qlist:
        impls = ("0", "1") if (use_impl_choice and q.startswith("ldlq")) \
            else ("0",)
        for im in impls:
            kkey = f"{group}_{q}_{'True' if im == '1' else 'False'}"
            if kkey in lat_coeffs:
                opts.append((q, im, float(lat_coeffs[kkey])))
    return opts


def _milp_lat(nl, attn_parts, mlp_parts, group_opts, opt_err_fn, opt_mem_fn,
              lat_limit, mem_budget):
    """Exact fusion-aware MILP: binary y[layer, group, option]; each base
    projection covered exactly once a layer; Σ latency ≤ limit (+ optional
    Σ mem ≤ budget); minimize Σ err.  Solved with scipy-HiGHS."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    # enumerate variables
    var_meta = []  # (layer, group, qstr, impl, err, lat, mem)
    groups = sorted(group_opts)
    for lidx in range(nl):
        for g in groups:
            for (qstr, im, lat) in group_opts[g]:
                var_meta.append((lidx, g, qstr, im,
                                 opt_err_fn(lidx, g, qstr), lat,
                                 opt_mem_fn(g, qstr)))
    nvar = len(var_meta)
    bases = ["q", "k", "v", "o", "u", "g", "d"]
    cover_rows = {(l, b): i for i, (l, b) in enumerate(
        (l, b) for l in range(nl) for b in bases)}
    nrows = len(cover_rows) + 1 + (1 if mem_budget is not None else 0)
    A = lil_matrix((nrows, nvar))
    lat_row = len(cover_rows)
    mem_row = lat_row + 1
    c = np.zeros(nvar)
    for vi, (lidx, g, qstr, im, e, lat, mm) in enumerate(var_meta):
        c[vi] = e
        for b in MERGE_GROUPS.get(g, (g,)):
            A[cover_rows[(lidx, b)], vi] = 1.0
        A[lat_row, vi] = lat
        if mem_budget is not None:
            A[mem_row, vi] = mm
    lb = np.ones(len(cover_rows))
    ub = np.ones(len(cover_rows))
    # HiGHS satisfies row bounds only to its (absolute ~1e-6) feasibility
    # tolerance; pull the resource caps in so returned solutions are
    # strictly feasible for the caller's hard limit
    lb = np.concatenate([lb, [0.0]])
    ub = np.concatenate([ub, [lat_limit - max(2e-6, 1e-4 * lat_limit)]])
    if mem_budget is not None:
        lb = np.concatenate([lb, [0.0]])
        ub = np.concatenate([ub, [mem_budget * (1.0 - 1e-5)]])
    res = milp(c=c, constraints=LinearConstraint(A.tocsr(), lb, ub),
               integrality=np.ones(nvar), bounds=Bounds(0, 1),
               options={"time_limit": 60.0})
    if not res.success:
        return None
    qdict = {}
    merge_info = [[] for _ in range(nl)]
    terr = tlat = tmem = 0.0
    for vi, (lidx, g, qstr, im, e, lat, mm) in enumerate(var_meta):
        if res.x[vi] < 0.5:
            continue
        terr += e
        tlat += lat
        tmem += mm
        for b in MERGE_GROUPS.get(g, (g,)):
            qdict[f"{lidx}_{SIMPLE2KEY[b]}"] = (qstr, im)
        if len(g) > 1:
            merge_info[lidx].append(f"merge_{g}")
    return qdict, merge_info, terr, tlat, tmem


def solve_lat_constrained(cfg: LlamaConfig, qlist: List[str],
                          err_table: Dict[str, float],
                          lat_coeffs: Dict[str, float],
                          target_thp: float,
                          err_coeffs: Optional[Dict[str, float]] = None,
                          mem_target_bits: Optional[float] = None,
                          num_layers: Optional[int] = None,
                          no_fuse: bool = False,
                          use_impl_choice: bool = False,
                          exact: bool = True) -> LatSolution:
    """Fusion-aware latency-constrained MSQ.

    exact=True solves the MILP exactly with scipy-HiGHS; the per-layer
    Lagrangian decomposition with multiplier bisection is the fast path
    (exact=False) and the fallback when HiGHS finds no solution.

    lat_coeffs: {f"{group}_{qstr}_{False|True}": seconds} + {"constant":
    s}, the schema of ``fit_latency_coeffs``'s table."""
    nl = num_layers or cfg.num_layers
    lat_limit = 1.0 / target_thp - float(lat_coeffs.get("constant", 0.0))

    attn_parts = [ATTN_PARTITIONS[0]] if no_fuse else ATTN_PARTITIONS
    mlp_parts = [MLP_PARTITIONS[0]] if no_fuse else MLP_PARTITIONS

    # Precompute per-(layer, group, option): err sum over covered base keys
    def opt_err(lidx, group, qstr):
        bases = MERGE_GROUPS.get(group, (group,))
        return sum(_err(cfg, err_table, err_coeffs, lidx,
                        SIMPLE2KEY[b], qstr) for b in bases)

    def opt_mem(group, qstr):
        bases = MERGE_GROUPS.get(group, (group,))
        return sum(layer_mem_bytes(cfg, SIMPLE2KEY[b], qstr) for b in bases)

    group_opts = {}
    for part in attn_parts + mlp_parts:
        for g in part:
            gname = g[0]
            if gname not in group_opts:
                group_opts[gname] = _group_options(qlist, lat_coeffs, gname,
                                                   use_impl_choice)
    for g in ("o", "d"):
        group_opts[g] = _group_options(qlist, lat_coeffs, g,
                                       use_impl_choice)
    for g, opts in group_opts.items():
        if not opts:
            raise ValueError(f"no latency coefficients for group {g!r}")

    mem_budget = None
    if mem_target_bits is not None:
        total_default = sum(layer_mem_bytes(cfg, key, "default")
                            for key in LAYER_KEYS) * nl
        mem_budget = total_default * mem_target_bits / 16.0

    def layer_best(lidx, lam_lat, lam_mem):
        """Best (config, err, lat, mem) for one layer given multipliers."""
        best = None
        for apart in attn_parts:
            for mpart in mlp_parts:
                groups = [g[0] for g in apart] + ["o"] + \
                         [g[0] for g in mpart] + ["d"]
                tot_cost = tot_err = tot_lat = tot_mem = 0.0
                picks = {}
                for g in groups:
                    gb = None
                    for (qstr, im, lat) in group_opts[g]:
                        e = opt_err(lidx, g, qstr)
                        mm = opt_mem(g, qstr)
                        cost = e + lam_lat * lat + lam_mem * mm
                        if gb is None or cost < gb[0]:
                            gb = (cost, qstr, im, e, lat, mm)
                    tot_cost += gb[0]
                    tot_err += gb[3]
                    tot_lat += gb[4]
                    tot_mem += gb[5]
                    picks[g] = (gb[1], gb[2])
                if best is None or tot_cost < best[0]:
                    best = (tot_cost, picks, tot_err, tot_lat, tot_mem)
        return best

    def solve_at(lam_lat, lam_mem):
        qdict = {}
        merge_info = []
        terr = tlat = tmem = 0.0
        for lidx in range(nl):
            _, picks, e, lt, mm = layer_best(lidx, lam_lat, lam_mem)
            terr += e
            tlat += lt
            tmem += mm
            mlist = []
            for g, (qstr, im) in picks.items():
                bases = MERGE_GROUPS.get(g, (g,))
                for b in bases:
                    qdict[f"{lidx}_{SIMPLE2KEY[b]}"] = (qstr, im)
                if len(g) > 1:
                    mlist.append(f"merge_{g}")
            merge_info.append(mlist)
        return qdict, merge_info, terr, tlat, tmem

    if exact:
        out = _milp_lat(nl, attn_parts, mlp_parts, group_opts, opt_err,
                        opt_mem, lat_limit, mem_budget)
        if out is not None:
            qdict, merge_info, terr, tlat, _ = out
            return LatSolution(qdict, merge_info,
                               tlat + float(lat_coeffs.get("constant", 0.0)),
                               terr)

    # bisection on the latency multiplier (mem multiplier: outer loop)
    def bisect_lat(lam_mem):
        lo, hi = 0.0, 1.0
        for _ in range(60):
            _, _, _, lt, _ = solve_at(hi, lam_mem)
            if lt <= lat_limit:
                break
            hi *= 4.0
        sol = None
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            out = solve_at(mid, lam_mem)
            if out[3] <= lat_limit:
                sol = out
                hi = mid
            else:
                lo = mid
        return sol if sol is not None else solve_at(hi, lam_mem)

    if mem_budget is None:
        sol = bisect_lat(0.0)
    else:
        lo, hi = 0.0, 1e-9
        sol = bisect_lat(0.0)
        if sol[4] > mem_budget:
            for _ in range(40):
                s = bisect_lat(hi)
                if s[4] <= mem_budget:
                    break
                hi *= 4.0
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                s = bisect_lat(mid)
                if s[4] <= mem_budget:
                    sol = s
                    hi = mid
                else:
                    lo = mid
    qdict, merge_info, terr, tlat = sol[0], sol[1], sol[2], sol[3]
    return LatSolution(qdict, merge_info,
                       tlat + float(lat_coeffs.get("constant", 0.0)), terr)
