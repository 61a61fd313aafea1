"""Llama with incoherent quantized linears.

Counterpart of ``qpalette_tpu/models/llama.py``: a functional forward over
a params dict, with the static layout in hashable specs.  Serving only,
no autograd.  The KV cache is preallocated per layer, bf16 ``(k, v)`` or
int8 ``(k8, ks, v8, vs)`` with per-(token, head) scales, and the forward
writes it in place.  The cache position is a Python int, a 0-d integer
tensor or a (B,) tensor (one position a row); as a tensor it stays on
the device, so a step can be captured in a CUDA graph and replayed at a
new position.  A spec with a ``tp_group`` is one rank's local spec of the
tensor-parallel forward (parallel/tp.py): its row-parallel o and down
outputs are summed over that ``torch.distributed`` group.  A spec with a
``col_group`` is one rank's spec of the column-parallel forward
(parallel/sharding.py): its projections hold the rank's output rows and
their outputs are gathered over the group where the next consumer needs
the whole activation, attention runs on the rank's heads (its cache holds
its kv heads), the embedding holds its vocab rows
(the lookups summed over the group) and the head's logits are gathered
over vocab; the residual stream stays whole on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from qpalette_tpu_torch.kernels.int8_gemv import int8_gemv, int8_gemv_a8
from qpalette_tpu_torch.ops.hadamard import hadamard_transform_t
from qpalette_tpu_torch.runtime.qlinear import qlinear_apply


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def kv_out(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=2048,
                           intermediate_size=8192, num_layers=16,
                           num_heads=32, num_kv_heads=8, head_dim=64,
                           rope_theta=500000.0, tie_embeddings=True)

    @staticmethod
    def llama32_3b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=3072,
                           intermediate_size=8192, num_layers=28,
                           num_heads=24, num_kv_heads=8, head_dim=128,
                           rope_theta=500000.0, tie_embeddings=True)

    @staticmethod
    def tiny(vocab: int = 256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab, hidden_size=128,
                           intermediate_size=256, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=32,
                           rope_theta=10000.0)


@dataclass(frozen=True)
class AttnSpec:
    """merge in {None, 'qkv', 'qk', 'kv', 'qv'}; projs = ((name,
    LinearSpec), ..., ('o', _)): q, k, v unmerged, else the merged group
    and the projection it leaves out, in the loader's order.
    rot_blocks_o > 1: o's input rotation is block-diagonal (I_b x H-hat),
    as quantized for row-parallel sharding; in_perm_o > 0: o's input is
    block-permuted first (_block_perm_in; row-parallel tcomb)."""
    merge: Optional[str]
    projs: tuple
    rot_blocks_o: int = 1
    in_perm_o: int = 0


@dataclass(frozen=True)
class MLPSpec:
    merge_ug: bool
    projs: tuple  # (("ug",) | ("up", "gate")) + ("down",)
    rot_blocks_down: int = 1
    in_perm_down: int = 0  # see AttnSpec.in_perm_o


@dataclass(frozen=True)
class ModelSpec:
    config: LlamaConfig
    layers: tuple  # ((AttnSpec, MLPSpec), ...)
    # non-None: quantized lm_head (params "lm_head_q4" + "lm_head_su");
    # None: the bf16 "lm_head", or the int8 head ("lm_head_q" (vocab
    # padded, hidden) int8, "lm_head_s" scales, "lm_head_su" if rotated)
    lm_head_spec: Optional[object] = None
    # set on a rank's local spec of the tensor-parallel forward: the
    # torch.distributed group its row-parallel o / down outputs are summed
    # over (the reference's tp_axis); None: the single-device forward
    tp_group: Optional[object] = None
    # set on a rank's spec of the column-parallel forward
    # (parallel/sharding.py): the group its projections' output rows, heads
    # and vocab rows are split over; None: not column-parallel
    col_group: Optional[object] = None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim) float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., heads, head_dim); HF rotate_half convention."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return (x.float() * cos[..., None, :]
            + rot.float() * sin[..., None, :]).to(x.dtype)


def _rotate_in(x: torch.Tensor, su: torch.Tensor) -> torch.Tensor:
    """Incoherence rotation of activations: z = (x * SU) @ H^T."""
    return hadamard_transform_t(x * su).to(x.dtype)


def _block_perm_in(z: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Row-parallel tcomb's input permutation (AttnSpec.in_perm_o): the
    column blocks of width n/nblocks in the order 0, 2, 4, ..., 1, 3, 5,
    ..., so that each tensor-parallel shard's contiguous slice holds one
    KV1 and one KV2 piece."""
    N, n = z.shape
    tp = nblocks // 2
    return (z.reshape(N, tp, 2, n // nblocks).transpose(1, 2)
            .reshape(N, n))


def _tp_sum(y: torch.Tensor, group, dtype) -> torch.Tensor:
    """A row-parallel projection's output in dtype: with a group, the
    ranks' float32 partial outputs summed over it (the reference's psum)
    and rounded once, as the single-device product rounds its sum."""
    if group is not None:
        dist.all_reduce(y, group=group)
    return y.to(dtype)


def cat_cols(chunks, parts=None) -> torch.Tensor:
    """The ranks' output columns (..., c) each, in rank order, put together
    (..., n*c); with parts (the local widths of comb's two output halves)
    each part on its own, [part 1 of every rank | part 2 of every rank]."""
    if not parts or len(parts) == 1:
        return torch.cat(chunks, dim=-1)
    pieces, off = [], 0
    for width in parts:
        pieces += [c[..., off:off + width] for c in chunks]
        off += width
    return torch.cat(pieces, dim=-1)


def _gather_cols(y: torch.Tensor, group, parts=None) -> torch.Tensor:
    """Column parallelism: the ranks' columns of y all-gathered over group
    and put together (cat_cols).  No group: y."""
    if group is None:
        return y
    y = y.contiguous()
    chunks = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(chunks, y, group=group)
    return cat_cols(chunks, parts)


def _project(lspec, p: dict, z: torch.Tensor, group, **kw) -> torch.Tensor:
    """qlinear_apply, and under column parallelism (group) the ranks'
    output rows gathered to the whole width (comb by its halves)."""
    y = qlinear_apply(lspec, p, z, **kw)
    return _gather_cols(y, group, lspec.split if lspec.kind == "comb"
                        else None)


def _col_rank(group) -> tuple:
    """(rank, ranks) of a column-parallel group, (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _embed(table: torch.Tensor, tokens: torch.Tensor,
           group) -> torch.Tensor:
    """The embedding rows of tokens; under column parallelism table holds
    the rank's contiguous vocab rows: each rank looks up the tokens it
    holds (zeros elsewhere) and the lookups are summed over the group in
    float32, exact (one nonzero a token)."""
    if group is None:
        return table[tokens]
    r, _ = _col_rank(group)
    v = table.shape[0]
    local = tokens - r * v
    held = (local >= 0) & (local < v)
    x = torch.where(held[..., None], table[local.clamp(0, v - 1)].float(),
                    0.0)
    dist.all_reduce(x, group=group)
    return x


def _positions(S: int, offset, device) -> torch.Tensor:
    """Positions of S queries from offset: (S,) for an int or a 0-d
    tensor, (B, S) for per-row (B,) offsets."""
    pos = torch.arange(S, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        return pos[None, :] + offset[:, None]
    return pos + offset


def _causal_mask(S: int, T: int, offset, device) -> torch.Tensor:
    """Additive mask: query i (position offset+i) sees keys <= it; (S, T),
    or (B, S, T) for per-row offsets."""
    q = _positions(S, offset, device)[..., None]
    kpos = torch.arange(T, device=device)
    return torch.where(kpos <= q, 0.0, -1e30).to(torch.float32)


_FLASH_MIN_CELLS = 1 << 22  # S*T above this -> blockwise attention


def _attention(q, k, v, offset, cfg: LlamaConfig):
    """q (B,S,h,d), k/v (B,T,hk,d); grouped heads, float32 softmax.  The
    query positions start at offset (see _causal_mask).  Above
    _FLASH_MIN_CELLS query-key pairs (a long prefill, a ctx-8192
    perplexity window) it takes _attention_flash: the whole (B, h, S, T)
    float32 logits would be 8.6 GB a layer at S = T = 8192."""
    if q.shape[1] * k.shape[1] > _FLASH_MIN_CELLS:
        return _attention_flash(q, k, v, offset, cfg)
    return _attention_whole(q, k, v, offset, cfg)


def _attention_whole(q, k, v, offset, cfg: LlamaConfig):
    """_attention over the whole (B, h, S, T) float32 logits."""
    B, S, H, D = q.shape
    T, hk = k.shape[1], k.shape[2]
    g = H // hk
    qf = (q.float() * (D ** -0.5)).reshape(B, S, hk, g, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    mask = _causal_mask(S, T, offset, q.device)
    logits = logits + (mask if mask.dim() == 2 else mask[:, None, None])
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H * D).to(q.dtype)


def _attention_flash(q, k, v, offset, cfg: LlamaConfig, qc: int = 512,
                     tc: int = 512):
    """Blockwise softmax attention: query chunks of qc rows, each over KV
    chunks of tc keys with a running (max, denom, acc) in float32, so the
    live logits are (B, hk, qc, g, tc).  qc / tc fall back to the largest
    of 256, 128, ..., 1 that divides S / T.  With a Python-int offset the
    KV chunks wholly after a query chunk's last position are skipped; a
    0-d or per-row (B,) tensor offset scans them all (masked)."""
    B, S, H, D = q.shape
    T, hk = k.shape[1], k.shape[2]
    g = H // hk
    qc = next(c for c in (qc, 256, 128, 64, 32, 16, 8, 4, 2, 1)
              if S % c == 0)
    tc = next(c for c in (tc, 256, 128, 64, 32, 16, 8, 4, 2, 1)
              if T % c == 0)
    static_off = isinstance(offset, int)
    per_row = isinstance(offset, torch.Tensor) and offset.dim() == 1
    dev = q.device
    # heads first: (B, hk, S, g, D) queries, (B, hk, T, D) keys and values
    qf = (q.float() * (D ** -0.5)).reshape(B, S, hk, g, D).transpose(1, 2)
    kf = k.float().transpose(1, 2).contiguous()
    vf = v.float().transpose(1, 2).contiguous()
    outs = []
    for qi in range(S // qc):
        qb = qf[:, :, qi * qc:(qi + 1) * qc].reshape(B, hk, qc * g, D)
        qpos = torch.arange(qc, device=dev) + qi * qc
        if per_row:  # (B, 1, qc, 1, 1) against the keys' last axis
            qpos = (qpos[None, :] + offset[:, None])[:, None, :, None, None]
        else:  # (qc, 1, 1)
            qpos = (qpos + offset)[:, None, None]
        n_kv = (min(T // tc, (qi * qc + qc + offset + tc - 1) // tc)
                if static_off else T // tc)
        m = torch.full((B, hk, qc, g), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, hk, qc, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, hk, qc * g, D), dtype=torch.float32,
                          device=dev)
        for ti in range(n_kv):
            kb = kf[:, :, ti * tc:(ti + 1) * tc]  # (B, hk, tc, D)
            vb = vf[:, :, ti * tc:(ti + 1) * tc]
            lg = (qb @ kb.transpose(-1, -2)).reshape(B, hk, qc, g, tc)
            kpos = torch.arange(tc, device=dev) + ti * tc
            lg = torch.where(kpos <= qpos, lg, -1e30)
            mb = torch.maximum(m, lg.amax(dim=-1))
            p = torch.exp(lg - mb[..., None])
            alpha = torch.exp(m - mb)
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha.reshape(B, hk, qc * g, 1)
                   + p.reshape(B, hk, qc * g, tc) @ vb)
            m = mb
        acc = acc / torch.clamp_min(l.reshape(B, hk, qc * g, 1), 1e-30)
        outs.append(acc.reshape(B, hk, qc, g, D))
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H * D).to(q.dtype)


def _store(cache: torch.Tensor, val: torch.Tensor, cache_pos) -> None:
    """Write val (B, S, ...) into cache (B, T, ...) in place at cache_pos:
    rows cache_pos..+S-1 along T for an int or a 0-d tensor (the
    reference's dynamic_update_slice), or from each row's own position
    for a (B,) tensor (its per-row scatter)."""
    B, S = val.shape[:2]
    val = val.to(cache.dtype)
    cols = _positions(S, cache_pos, cache.device)
    if cols.dim() == 1:
        cache.index_copy_(1, cols, val)
        return
    rows = torch.arange(B, device=cache.device).repeat_interleave(S)
    cache.index_put_((rows, cols.reshape(-1)),
                     val.reshape((B * S,) + val.shape[2:]))


def _q8(x: torch.Tensor):
    """int8 values and f32 scales a (token, head): absmax / 127 + 1e-8,
    round half to even (the reference's int8 KV cache)."""
    xf = x.float()
    # a true division: on the card PyTorch divides by a Python float
    # through its reciprocal (one ulp off); a device tensor, unlike
    # torch.tensor, is made without a host copy (legal under capture)
    s = xf.abs().amax(dim=-1, keepdim=True) / torch.full(
        (), 127.0, device=x.device) + 1e-8
    return torch.round(xf / s).to(torch.int8), s


def attn_forward(spec: AttnSpec, cfg: LlamaConfig, p: dict, x: torch.Tensor,
                 cos, sin, kv_cache=None, cache_pos=0, luts=None,
                 tp_group=None, col_group=None):
    """x (B, S, hidden) -> (out, kv).  With kv_cache, k/v are written into
    the caches in place at cache_pos (see _store) and attention runs over
    the whole cache: bf16 ``(k, v)``, or int8 ``(k8, ks, v8, vs)`` holding
    the values quantized by _q8 and read back as (q * s) in bf16.  The
    group's activations are rotated unless its first projection is
    ``dense`` (the bf16 baseline, whose weights are not rotated).  Under
    tensor parallelism cfg and spec are a rank's local ones and o's
    partial output is summed over tp_group.  Under column parallelism
    (col_group) cfg is the global one, spec the rank's: q, k and v of
    their own hold the rank's heads as computed, a merged group's output
    and comb's halves are gathered over col_group whole, attention runs on
    the rank's heads (kv_cache holds its kv heads), and its output is
    gathered before o, o's output for the residual."""
    B, S, N = x.shape
    xs = x.reshape(-1, N)
    rotated = spec.projs[0][1].kind != "dense"
    non_o = [(nm, ls) for nm, ls in spec.projs if nm != "o"]
    hs = cfg.num_heads * cfg.head_dim
    kv = cfg.kv_out

    def group(nm, ls):
        # the group an output is gathered over: not q, k or v of their own
        # (their rows are the rank's heads), unless comb splits them
        return None if nm in ("q", "k", "v") and ls.kind != "comb" \
            else col_group

    if len(non_o) == 1:
        # a lone group (merged qkv) takes the un-rotated activation, so
        # that qlinear_apply can keep the rotation in float32 where the
        # reference fuses it into the kernel's prologue
        (name, lspec), = non_o
        outs = {name: _project(lspec, p[name], xs, group(name, lspec),
                               pre_rot=p["su_qkv"] if rotated else None,
                               luts=luts)}
    else:
        # several groups share one rotated activation
        z = _rotate_in(xs, p["su_qkv"]) if rotated else xs
        outs = {nm: _project(ls, p[nm], z, group(nm, ls), luts=luts)
                for nm, ls in non_o}
    if spec.merge is None:
        q, k, v = outs["q"], outs["k"], outs["v"]
    elif spec.merge == "qkv":
        q, k, v = torch.split(outs["qkv"], [hs, kv, kv], dim=-1)
    elif spec.merge == "qk":
        (q, k), v = torch.split(outs["qk"], [hs, kv], dim=-1), outs["v"]
    elif spec.merge == "kv":
        q, (k, v) = outs["q"], torch.split(outs["kv"], [kv, kv], dim=-1)
    elif spec.merge == "qv":
        (q, v), k = torch.split(outs["qv"], [hs, kv], dim=-1), outs["k"]
    else:
        raise NotImplementedError(f"attention merge {spec.merge!r}")
    # the rank's heads (all of them but under column parallelism)
    r, n = _col_rank(col_group)
    D = cfg.head_dim
    h, hk = cfg.num_heads // n, cfg.num_kv_heads // n

    def own(t, heads):
        # a gathered output's columns of the rank's heads; a local one as
        # it is
        w = heads * D
        return t if t.shape[-1] == w else t[:, r * w:(r + 1) * w]

    q, k, v = own(q, h), own(k, hk), own(v, hk)
    q = apply_rope(q.reshape(B, S, h, D), cos, sin)
    k = apply_rope(k.reshape(B, S, hk, D), cos, sin)
    v = v.reshape(B, S, hk, D)
    if kv_cache is not None and len(kv_cache) == 4:
        ck, cks, cv, cvs = kv_cache
        for cache, val in zip(kv_cache, (*_q8(k), *_q8(v))):
            _store(cache, val, cache_pos)
        k_full = (ck.float() * cks).to(k.dtype)
        v_full = (cv.float() * cvs).to(v.dtype)
        new_kv = kv_cache
    elif kv_cache is not None:
        ck, cv = kv_cache
        _store(ck, k, cache_pos)
        _store(cv, v, cache_pos)
        k_full, v_full, new_kv = ck, cv, (ck, cv)
    else:
        k_full, v_full, new_kv = k, v, (k, v)
    att = _attention(q, k_full, v_full, cache_pos, cfg)
    oname, ospec = spec.projs[-1]
    if oname != "o":
        raise ValueError(f"last attention projection is {oname!r}")
    z_o = _gather_cols(att.reshape(B * S, -1), col_group)
    if spec.in_perm_o:
        z_o = _block_perm_in(z_o, spec.in_perm_o)
    out = _project(ospec, p["o"], z_o, col_group,
                   pre_rot=p["su_o"] if rotated else None, luts=luts,
                   rot_blocks=spec.rot_blocks_o,
                   out_dtype=None if tp_group is None else torch.float32)
    return _tp_sum(out, tp_group, x.dtype).reshape(B, S, N), new_kv


def mlp_forward(spec: MLPSpec, cfg: LlamaConfig, p: dict, x: torch.Tensor,
                luts=None, tp_group=None, col_group=None):
    """x (B, S, hidden) -> out; rotated (and down summed over tp_group) as
    in attn_forward.  Under col_group, up and gate of their own (not comb)
    give h of the rank's rows, gathered once before down; a merged ug's
    output or comb's is gathered whole; down's output is gathered for the
    residual."""
    B, S, N = x.shape
    I = cfg.intermediate_size
    xs = x.reshape(-1, N)
    rotated = spec.projs[0][1].kind != "dense"
    if spec.merge_ug:
        (ug_name, ug_spec), (_, d_spec) = spec.projs
        y = _project(ug_spec, p[ug_name], xs, col_group,
                     pre_rot=p["su_ug"] if rotated else None, luts=luts)
        up, gate = y[:, :I], y[:, I:]
        local = False
    else:
        z = _rotate_in(xs, p["su_ug"]) if rotated else xs
        (_, u_spec), (_, g_spec), (_, d_spec) = spec.projs
        local = u_spec.kind != "comb" and g_spec.kind != "comb"
        grp = None if local else col_group
        up = _project(u_spec, p["up"], z, grp, luts=luts)
        gate = _project(g_spec, p["gate"], z, grp, luts=luts)
    h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    if local:
        h = _gather_cols(h, col_group)
    if spec.in_perm_down:
        h = _block_perm_in(h, spec.in_perm_down)
    out = _project(d_spec, p["down"], h, col_group,
                   pre_rot=p["su_dp"] if rotated else None, luts=luts,
                   rot_blocks=spec.rot_blocks_down,
                   out_dtype=None if tp_group is None else torch.float32)
    return _tp_sum(out, tp_group, x.dtype).reshape(B, S, N)


@torch.inference_mode()
def forward(spec: ModelSpec, params: dict, tokens: torch.Tensor,
            kv_caches=None, cache_pos=0, return_hidden: bool = False):
    """tokens (B, S) -> logits (B, S, vocab) float32 (and the caches when
    kv_caches is given: the incremental path writing at cache_pos, an int,
    a 0-d tensor or per-row (B,)).  return_hidden=True returns the
    final-norm hidden state (B, S, hidden) instead of the logits.  Under
    column parallelism (spec.col_group) every rank returns the whole
    logits of its rows, and its caches hold its kv heads."""
    cfg = spec.config
    B, S = tokens.shape
    col = spec.col_group
    x = _embed(params["embed"], tokens, col).to(cfg.dtype)
    offset = cache_pos if kv_caches is not None else 0
    cos, sin = rope_tables(_positions(S, offset, tokens.device), cfg.head_dim,
                           cfg.rope_theta)
    luts = params.get("luts")
    new_caches = []
    for li, (aspec, mspec) in enumerate(spec.layers):
        lp = params["layers"][li]
        h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
        a, kv = attn_forward(aspec, cfg, lp, h, cos, sin,
                             kv_cache=None if kv_caches is None
                             else kv_caches[li], cache_pos=offset,
                             luts=luts, tp_group=spec.tp_group,
                             col_group=col)
        x = x + a
        h = rms_norm(x, lp["ln_mlp"], cfg.rms_eps)
        x = x + mlp_forward(mspec, cfg, lp, h, luts=luts,
                            tp_group=spec.tp_group, col_group=col)
        new_caches.append(kv)
    x = rms_norm(x, params["ln_f"], cfg.rms_eps)
    if return_hidden:
        return (x, new_caches) if kv_caches is not None else x
    if spec.lm_head_spec is not None:
        # quantized lm_head: f32 logits over the padded vocab, sliced back
        logits = _project(spec.lm_head_spec, params["lm_head_q4"],
                          x.reshape(-1, cfg.hidden_size), col,
                          pre_rot=params["lm_head_su"],
                          out_dtype=torch.float32)
        logits = logits[:, :cfg.vocab_size].reshape(B, S, cfg.vocab_size)
    elif "lm_head_q" in params:
        logits = int8_head(params, x.reshape(-1, cfg.hidden_size))
        logits = logits[:, :cfg.vocab_size].reshape(B, S, cfg.vocab_size)
    else:
        logits = _gather_cols(x.float() @ params["lm_head"].float().T,
                              col)
    if kv_caches is not None:
        return logits, new_caches
    return logits


HEAD_ROWS = 16384  # vocab rows of the int8 head's prefill product a step


def int8_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The int8 lm_head: x (rows, hidden) -> f32 logits over the padded
    vocab.  With ``lm_head_su`` x is rotated first and up to 8 rows take
    K10 (int8 activations), else K11; more rows take a plain product of
    the f32 weights q * s, as the reference's XLA does."""
    su = params.get("lm_head_su")
    if su is not None:
        x = _rotate_in(x, su.to(x.dtype))
    q, s = params["lm_head_q"], params["lm_head_s"]
    if x.shape[0] <= 8:
        gemv = int8_gemv_a8 if su is not None else int8_gemv
        return gemv(x.contiguous(), q, s)
    # f32 weights a block of vocab rows at a time: the whole f32 head would
    # be 2.1 GB for Llama-3.1-8B
    xf = x.float()
    out = torch.empty((x.shape[0], q.shape[0]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, q.shape[0], HEAD_ROWS):
        w = q[r0:r0 + HEAD_ROWS].float() * s[r0:r0 + HEAD_ROWS, None]
        out[:, r0:r0 + HEAD_ROWS] = xf @ w.T
    return out


def init_kv_caches(spec: ModelSpec, batch: int, max_seq: int, device,
                   quantized: bool = False):
    """Preallocated caches a layer, (B, T, kv_heads, head_dim) each: bf16
    (k, v), or with quantized=True int8 (k8, ks, v8, vs) with f32
    per-(token, head) scales (B, T, kv_heads, 1), about half the bytes."""
    cfg = spec.config
    # under column parallelism: the rank's kv heads
    shp = (batch, max_seq, cfg.num_kv_heads // _col_rank(spec.col_group)[1],
           cfg.head_dim)
    if quantized:
        sshp = shp[:3] + (1,)
        return [(torch.zeros(shp, dtype=torch.int8, device=device),
                 torch.ones(sshp, dtype=torch.float32, device=device),
                 torch.zeros(shp, dtype=torch.int8, device=device),
                 torch.ones(sshp, dtype=torch.float32, device=device))
                for _ in range(cfg.num_layers)]
    return [(torch.zeros(shp, dtype=cfg.dtype, device=device),
             torch.zeros(shp, dtype=cfg.dtype, device=device))
            for _ in range(cfg.num_layers)]
