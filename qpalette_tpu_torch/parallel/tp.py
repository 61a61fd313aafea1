"""Tensor parallelism over ``torch.distributed``: Megatron-style column /
row split of every decoder layer.

Counterpart of ``qpalette_tpu/parallel/tp.py``.  A rank holds its slice
of each weight (``shard_params``) and its forward, with or without a KV
cache, is ``models.llama.forward`` under its *local* spec
(``localize_spec``: heads, kv heads and the intermediate width divided by
tp), whose ``tp_group`` sums the row-parallel partial outputs with
``torch.distributed.all_reduce``; its cache holds its kv heads
(``llama.init_kv_caches`` of the local spec, or ``kv_cache_slice``):

  * q / k / v and up / gate (and their merges) are column-parallel: a
    rank takes its output rows, and the shared input rotation sees the
    replicated activation unchanged.
  * o and down are row-parallel: a rank takes its input columns.  They
    are quantized against the block-diagonal rotation I_tp x H-hat_{n/tp}
    (the loader's ``row_parallel_tp``), so each rank rotates its own slice
    with a full local Hadamard, and the partial outputs are summed: two
    all_reduce a layer.
  * attention runs on the rank's heads; its KV cache holds its kv heads.

The port's canonical layouts are sliced directly (``shard_params``), each
leaf of a projection along one axis:

  leaf                  column-parallel           row-parallel
  trellis (tcq, tcq1,   its m-tiles: rows          its k-tiles: the
  tcq2; (mt*kt, W))     [s*mt/tp, ..) of (mt,kt,W) columns of (mt, kt, W)
  trellis1 / trellis2   m-tiles of each half       k-tiles of each half
  (tcomb: k halves)     (split unchanged)          (split (n1/tp, n2/tp))
  trellis1 / trellis2   refused: the halves' rows  k-tiles of each half
  (comb: m halves)      are not a rank's rows
  qweight (vq; (m, W))  rows                       words of P/tp positions,
                                                   a zero pad word appended
  wscale                rows                       replicated
  w (dense, dense_rot)  rows                       columns
  lut                   replicated                 replicated

Embed, norms, the tables, the shared-rotation signs (su_qkv, su_ug) and
every head (bf16, int8 ``lm_head_q`` / ``lm_head_s``, 4-bit
``lm_head_q4``) are replicated; su_o and su_dp are sliced as the input.

Merged projections (qkv, qk, kv, qv, ug) are a row-concat of parts, and a
rank needs rows [q_s | k_s | v_s]: ``shard_interleave_merged`` reorders
the merged rows (m-tiles of the words) shard-major first, so that the
rank's slice is contiguous and the local forward's split points line up.
Row-parallel tcomb was quantized against W[:, pi] (the loader's
``in_perm_blocks`` = 2*tp), so a rank's contiguous input slice holds one
KV1 and one KV2 piece; the port keeps the halves as two arrays, each
sliced natively by k-tiles, and only the permuted SU vector is reordered
shard-major (``shard_interleave_tcomb_rows``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qpalette_tpu_torch.models.llama import AttnSpec, MLPSpec, ModelSpec

ROW_PROJS = ("o", "down")
MERGED_PROJS = ("qkv", "qk", "kv", "qv", "ug")
TD = 16
ROW_KINDS = ("tcq", "tcq1", "tcq2", "vq", "dense", "dense_rot", "tcomb",
             "comb")


def _merged_parts(cfg, name: str):
    """Output-row widths of a merged projection's parts (loader order)."""
    hs = cfg.num_heads * cfg.head_dim
    kv = cfg.kv_out
    I = cfg.intermediate_size
    return {"qkv": (hs, kv, kv), "qk": (hs, kv), "kv": (kv, kv),
            "qv": (hs, kv), "ug": (I, I)}[name]


def _shard_interleave(counts, tp: int) -> np.ndarray:
    """Permutation over sum(counts) positions: concat-of-parts order ->
    shard-major order (shard s gets part_i[s*ci/tp:(s+1)*ci/tp] for every
    i, contiguously)."""
    offs = np.cumsum([0] + list(counts[:-1]))
    out = []
    for s in range(tp):
        for c, o in zip(counts, offs):
            if c % tp:
                raise ValueError(f"part widths {counts} do not split over "
                                 f"tp={tp}")
            step = c // tp
            out.extend(range(o + s * step, o + (s + 1) * step))
    return np.asarray(out, np.int64)


def _scale_linear_spec(lspec, tp: int, row: bool):
    """A projection's LinearSpec -> a rank's local LinearSpec."""
    if row:
        if lspec.kind not in ROW_KINDS or lspec.in_features % tp:
            raise ValueError(f"row-parallel {lspec.kind} with in_features "
                             f"{lspec.in_features} over tp={tp}")
        split = lspec.split
        if lspec.kind == "tcomb":
            # the halves shard together: quantized in the block-permuted
            # space (loader in_perm_blocks), each rank runs a local tcomb
            n1, n2 = lspec.split
            if n1 % (TD * tp) or n2 % (TD * tp):
                raise ValueError(f"tcomb halves {lspec.split} over tp={tp}")
            split = (n1 // tp, n2 // tp)
        if lspec.kind == "vq" and (lspec.in_features // lspec.vec // tp
                                   * lspec.bits) % 32:
            raise ValueError(f"vq row-parallel needs whole words a rank "
                             f"(k={lspec.in_features}, bits={lspec.bits}, "
                             f"vec={lspec.vec}, tp={tp})")
        if (lspec.kind not in ("vq", "dense", "dense_rot")
                and (lspec.in_features // tp) % TD):
            raise ValueError(f"{lspec.kind} row-parallel needs whole "
                             f"k-tiles a rank (k={lspec.in_features}, "
                             f"tp={tp})")
        return dataclasses.replace(lspec, in_features=lspec.in_features // tp,
                                   split=split)
    if lspec.kind == "comb":
        raise NotImplementedError(
            "comb as a column-parallel projection: its output halves' rows "
            "are not a rank's rows")
    m = lspec.out_features
    tiled = lspec.kind not in ("vq", "dense", "dense_rot")
    if m % tp or (tiled and (m // tp) % TD):
        raise ValueError(f"column-parallel {lspec.kind} with out_features "
                         f"{m} over tp={tp}: a rank needs whole "
                         f"{'16-row tiles' if tiled else 'rows'}")
    return dataclasses.replace(lspec, out_features=m // tp)


def localize_spec(spec: ModelSpec, tp: int, group=None) -> ModelSpec:
    """The global ModelSpec -> a rank's local spec: heads, kv heads and the
    intermediate width divided by tp, each projection's LinearSpec scaled
    (_scale_linear_spec), o / down rotated in rot_blocks / tp local blocks
    (2 for row-parallel tcomb's KV1 / KV2 pieces) with no input
    permutation (a rank's slice already arrives [KV1 piece | KV2 piece]),
    and tp_group = group."""
    cfg = spec.config
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads} "
                         f"and num_kv_heads={cfg.num_kv_heads}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size="
                         f"{cfg.intermediate_size}")
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)
    layers = []
    for aspec, mspec in spec.layers:
        if aspec.rot_blocks_o % tp or mspec.rot_blocks_down % tp:
            raise ValueError(
                f"row-parallel layers must be quantized with rot_blocks=tp "
                f"(2*tp for tcomb): o {aspec.rot_blocks_o}, down "
                f"{mspec.rot_blocks_down}, tp {tp} (the loader's "
                f"row_parallel_tp)")
        aprojs = tuple((nm, _scale_linear_spec(ls, tp, nm == "o"))
                       for nm, ls in aspec.projs)
        mprojs = tuple((nm, _scale_linear_spec(ls, tp, nm == "down"))
                       for nm, ls in mspec.projs)
        layers.append((AttnSpec(aspec.merge, aprojs,
                                rot_blocks_o=aspec.rot_blocks_o // tp),
                       MLPSpec(mspec.merge_ug, mprojs,
                               rot_blocks_down=mspec.rot_blocks_down // tp)))
    return dataclasses.replace(spec, config=lcfg, layers=tuple(layers),
                               tp_group=group)


# --- placement: the rank's slice of each leaf -------------------------------

def _tiles(a: torch.Tensor, mt: int):
    """(mt*kt, W) tile-row-major words -> (mt, kt, W)."""
    return a.reshape(mt, a.shape[0] // mt, a.shape[1])


def _permute_merged_leaf(leaf: str, a: torch.Tensor, ls, perm1, perm16):
    """A merged projection's leaf with its output rows in shard-major
    order: perm1 over rows, perm16 over m-tiles."""
    if leaf in ("wscale", "w", "qweight"):
        return a[torch.as_tensor(perm1, device=a.device)].contiguous()
    if leaf in ("trellis", "trellis1", "trellis2"):
        t = _tiles(a, ls.out_features // TD)
        p = torch.as_tensor(perm16, device=a.device)
        return t[p].reshape(a.shape).contiguous()
    return a  # lut


def shard_interleave_merged(params: dict, spec: ModelSpec, tp: int) -> dict:
    """Merged projections' output rows reordered shard-major, so that a
    rank's contiguous slice is [q_s | k_s | v_s] (see the docstring)."""
    cfg = spec.config
    out_layers = []
    for lp, (aspec, mspec) in zip(params["layers"], spec.layers,
                                  strict=True):
        projs = dict(aspec.projs + mspec.projs)
        nlp = dict(lp)
        for name in MERGED_PROJS:
            if name not in nlp:
                continue
            parts = _merged_parts(cfg, name)
            perm1 = _shard_interleave(parts, tp)
            perm16 = _shard_interleave([p // TD for p in parts], tp)
            nlp[name] = {leaf: _permute_merged_leaf(leaf, a, projs[name],
                                                    perm1, perm16)
                         for leaf, a in nlp[name].items()}
        out_layers.append(nlp)
    return dict(params, layers=out_layers)


def shard_interleave_tcomb_rows(params: dict, spec: ModelSpec,
                                tp: int) -> dict:
    """Row-parallel tcomb: the (block-permuted) SU vector of o / down
    reordered shard-major, so that a rank's contiguous slice holds the
    signs of its KV1 piece and then of its KV2 piece.  The port's two
    word arrays shard by k-tiles as they are."""
    out_layers = []
    for lp, (aspec, mspec) in zip(params["layers"], spec.layers,
                                  strict=True):
        nlp = dict(lp)
        for su_key, perm in (("su_o", aspec.in_perm_o),
                             ("su_dp", mspec.in_perm_down)):
            if perm:
                n = nlp[su_key].shape[0]
                pe = torch.as_tensor(_shard_interleave([n // 2, n // 2], tp),
                                     device=nlp[su_key].device)
                nlp[su_key] = nlp[su_key][pe]
        out_layers.append(nlp)
    return dict(params, layers=out_layers)


def _rows(a: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s rows of dim 0 split tp ways: of a tile-row-major
    trellis (mt*kt, W), its m-tiles."""
    n = a.shape[0] // tp
    return a[rank * n:(rank + 1) * n].contiguous()


def _col_leaf(leaf: str, a: torch.Tensor, ls, tp: int, rank: int):
    if leaf in ("wscale", "w", "qweight", "trellis", "trellis1", "trellis2"):
        return _rows(a, tp, rank)
    return a  # lut


def _row_leaf(leaf: str, a: torch.Tensor, ls, tp: int, rank: int):
    if leaf in ("wscale", "lut"):
        return a
    if leaf == "w":
        n = a.shape[1] // tp
        return a[:, rank * n:(rank + 1) * n].contiguous()
    if leaf == "qweight":
        # P/tp positions of each row: whole words, then a zero pad word
        words = ls.in_features // ls.vec * ls.bits // 32 // tp
        out = torch.zeros((a.shape[0], words + 1), dtype=a.dtype,
                          device=a.device)
        out[:, :words] = a[:, rank * words:(rank + 1) * words]
        return out
    if leaf in ("trellis", "trellis1", "trellis2"):
        m = ls.split[0 if leaf == "trellis1" else 1] \
            if ls.kind == "comb" and leaf != "trellis" else ls.out_features
        t = _tiles(a, m // TD)
        kt = t.shape[1] // tp
        return t[:, rank * kt:(rank + 1) * kt].reshape(-1, a.shape[1]) \
            .contiguous()
    raise ValueError(f"row-parallel leaf {leaf!r}")


def shard_params(params: dict, spec: ModelSpec, tp: int,
                 rank: int) -> dict:
    """Rank `rank`'s params of the tp-way tensor-parallel forward, from the
    global (single-device) params: the merged and tcomb interleaves, then
    each leaf's slice as the module docstring's table says.  Replicated
    tensors are shared with `params`, not copied."""
    if tp > 1:
        params = shard_interleave_merged(params, spec, tp)
        params = shard_interleave_tcomb_rows(params, spec, tp)
    layers = []
    for lp, (aspec, mspec) in zip(params["layers"], spec.layers,
                                  strict=True):
        projs = dict(aspec.projs + mspec.projs)
        nlp = {}
        for key, v in lp.items():
            if key in ("su_o", "su_dp"):
                nlp[key] = _rows(v, tp, rank)
            elif key in projs:
                row = key in ROW_PROJS
                ls = projs[key]
                _scale_linear_spec(ls, tp, row)  # raises where it cannot
                leaf = _row_leaf if row else _col_leaf
                nlp[key] = {name: leaf(name, a, ls, tp, rank)
                            for name, a in v.items()}
            else:  # su_qkv, su_ug, norms
                nlp[key] = v
        layers.append(nlp)
    return dict(params, layers=layers)


def kv_cache_slice(caches, tp: int, rank: int, dp: int = 1,
                   dp_rank: int = 0):
    """A rank's part of global KV caches: each (B, T, kv_heads, ...)
    tensor (the int8 cache's scales too) at its kv heads [rank*hk/tp, ...)
    and, over dp, its batch rows [dp_rank*B/dp, ...), as a copy."""
    out = []
    for kv in caches:
        b, h = kv[0].shape[0] // dp, kv[0].shape[2] // tp
        out.append(tuple(c[dp_rank * b:(dp_rank + 1) * b, :,
                           rank * h:(rank + 1) * h].contiguous()
                         for c in kv))
    return out
