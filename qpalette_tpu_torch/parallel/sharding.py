"""Column-parallel (dp, tp) sharding: every projection split along its
output rows.

Counterpart of ``qpalette_tpu/parallel/sharding.py``, the reference's
round-1 scheme.  The mesh is ("dp", "tp") over the job's processes
(``make_mesh``, on ``multihost.dcn_mesh``): the batch splits over dp,
the weights over tp.  ``param_shardings`` places each leaf as the
reference's ``_leaf_pspec`` does, on the port's canonical leaves:

  leaf                                      placement
  trellis, trellis1, trellis2 (tile-row-    rows of dim 0: the rank's
  major (m/16 * k/16, W)), qweight (m, W)   m-tiles / rows (each comb half
                                            its own)
  wscale (m,), w (m, n)                     rows (comb: each half's rows)
  embed, lm_head (vocab, hidden)            vocab rows (tied: one split)
  lm_head_q4's trellis and wscale           vocab rows of the padded head
  SU vectors, norms, tables (luts, a vq     replicated
  codebook lut), the int8 head
  (lm_head_q, lm_head_s, lm_head_su)

``shard_params`` gives this rank its slices, ``localize_spec`` its local
spec: every LinearSpec at the local m (comb's halves (m1/tp, m2/tp)),
the head's too, and ``col_group`` set to the tp group, which makes
``models.llama.forward`` the column-parallel forward.  The residual
stream, every input rotation and so every kernel's activation stay
replicated: each rank runs its projections on its output rows and
all-gathers the output over tp wherever the next consumer wants the
whole activation (the reference's GSPMD inserts the same all-gathers),
runs attention on its own heads with its own kv heads in the cache
(``kv_cache_shardings``: batch rows over dp, kv heads over tp), looks up
its vocab rows of the embedding (summed over tp: one nonzero a token) and
gathers the head's logits over vocab.

Two placements differ from the reference's GSPMD shards, which keep the
global semantics whatever the layout:

  * comb's output halves: a rank takes each half's rows (its words are
    the reference's shards of trellis1 / trellis2), and its wscale is
    the same rows of each half, where the reference splits the
    concatenated wscale contiguously (rows of the first half only, at
    tp 2 with equal halves).  Each half is gathered on its own before the
    halves are concatenated [m1 | m2].
  * merged projections (qkv, qk, kv, qv, ug) split their concatenated
    rows contiguously, as the reference does (no shard-major interleave:
    the output is gathered whole before it is split into its parts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from qpalette_tpu_torch.models.llama import ModelSpec
from qpalette_tpu_torch.parallel import multihost
from qpalette_tpu_torch.parallel.tp import (TD, _rows, _scale_linear_spec,
                                            kv_cache_slice)


@dataclass(frozen=True)
class Shard:
    """A leaf split over the mesh axis `axis` along dim `dim` (0 for every
    leaf this scheme splits): rank r of n holds [r*d/n, (r+1)*d/n).  With
    parts (widths along dim, in order), each part is split so and the
    rank's pieces concatenated (comb's wscale: each output half on its
    own)."""
    axis: str = "tp"
    dim: int = 0
    parts: tuple = ()


def make_mesh(n_devices: Optional[int] = None,
              tp: Optional[int] = None) -> DeviceMesh:
    """The ("dp", "tp") mesh of the job's first n_devices processes (default
    the world size); tp defaults to n_devices, dp = n_devices // tp."""
    n = n_devices or dist.get_world_size()
    tp = tp or n
    return multihost.dcn_mesh(tp, n // tp)


def _leaf_pspec(key: str) -> Optional[Shard]:
    """The placement of a param leaf by name (the loader's schema); None
    is replicated."""
    if key in ("trellis", "trellis1", "trellis2", "qweight", "wscale", "w",
               "embed", "lm_head"):
        return Shard("tp", 0)
    return None  # SU, norms, tables, the int8 head


def _proj_shardings(proj: dict, ls) -> dict:
    """A projection's leaves: _leaf_pspec, but comb's wscale by halves."""
    out = {k: _leaf_pspec(k) for k in proj}
    if ls.kind == "comb":
        out["wscale"] = Shard("tp", 0, tuple(ls.split))
    return out


def param_shardings(params: dict, spec: ModelSpec) -> dict:
    """A pytree of the params' structure: each leaf's Shard, or None where
    it is replicated."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) if isinstance(v, (dict, list)) else
                    _leaf_pspec(k) for k, v in tree.items()}
        return [walk(v) for v in tree]

    out = walk(params)
    for lo, lp, (aspec, mspec) in zip(out["layers"], params["layers"],
                                      spec.layers, strict=True):
        for name, ls in aspec.projs + mspec.projs:
            lo[name] = _proj_shardings(lp[name], ls)
    return out


def _slice(a: torch.Tensor, place: Optional[Shard], tp: int,
           rank: int) -> torch.Tensor:
    """The rank's slice of a leaf placed at dim 0 (tp._rows: of a trellis,
    its m-tiles), each of place.parts on its own."""
    if place is None:
        return a
    if not place.parts:
        return _rows(a, tp, rank)
    offs = [0]
    for width in place.parts:
        offs.append(offs[-1] + width)
    return torch.cat([_rows(a[o0:o1], tp, rank)
                      for o0, o1 in zip(offs, offs[1:])])


def local_params(params: dict, spec: ModelSpec, tp: int, rank: int) -> dict:
    """Rank `rank` of tp's params (param_shardings' slices; replicated
    tensors shared with params, not copied).  The spec must split
    (localize_spec raises where it cannot); tied embeddings keep one
    tensor for embed and lm_head."""
    localize_spec(spec, tp)

    def walk(tree, places):
        if isinstance(tree, dict):
            return {k: walk(v, places[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, p) for v, p in zip(tree, places)]
        return _slice(tree, places, tp, rank)

    tied = params.get("lm_head") is params["embed"]
    out = walk(params, param_shardings(params, spec))
    if tied:
        out["lm_head"] = out["embed"]
    return out


def shard_params(params: dict, spec: ModelSpec, mesh: DeviceMesh) -> dict:
    """This rank's params on a (dp, tp) mesh: local_params at its tp index
    (every dp group the same slices)."""
    return local_params(params, spec, _tp_size(mesh),
                        mesh.get_local_rank("tp"))


def _local_linear(ls, tp: int):
    """A projection's LinearSpec at the rank's output rows: tp's column
    split, and comb (which tp.py refuses) by its halves' rows."""
    if ls.kind != "comb":
        return _scale_linear_spec(ls, tp, row=False)
    if any(p % (tp * TD) for p in ls.split):
        raise ValueError(f"column-parallel comb with output halves "
                         f"{ls.split} over tp={tp}: a rank needs whole "
                         f"16-row tiles of each")
    return dataclasses.replace(ls, out_features=ls.out_features // tp,
                               split=tuple(p // tp for p in ls.split))


def localize_spec(spec: ModelSpec, tp: int, group=None) -> ModelSpec:
    """The global spec -> a rank's spec of the column-parallel forward:
    the config unchanged (global widths; the forward takes its own heads
    from the group), each projection's LinearSpec and the 4-bit head's at
    the local rows (_local_linear), col_group = group.  Raises where the
    heads, the kv heads or the vocab do not split tp ways."""
    cfg = spec.config
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads} "
                         f"and num_kv_heads={cfg.num_kv_heads}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size}")
    layers = tuple(
        (dataclasses.replace(a, projs=tuple((n, _local_linear(ls, tp))
                                            for n, ls in a.projs)),
         dataclasses.replace(m, projs=tuple((n, _local_linear(ls, tp))
                                            for n, ls in m.projs)))
        for a, m in spec.layers)
    head = spec.lm_head_spec
    return dataclasses.replace(
        spec, layers=layers, col_group=group,
        lm_head_spec=None if head is None else _local_linear(head, tp))


def kv_cache_shardings(caches, mesh: DeviceMesh):
    """This rank's slice of global caches on a (dp, tp) mesh: batch over
    dp, kv heads over tp (tp.kv_cache_slice)."""
    return kv_cache_slice(caches, _tp_size(mesh), mesh.get_local_rank("tp"),
                          _dp_size(mesh), mesh.get_local_rank("dp"))


def _tp_size(mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("tp"))


def _dp_size(mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("dp"))
