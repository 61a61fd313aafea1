"""Port parity for tensor parallelism (qpalette_tpu_torch/parallel,
qpalette_tpu_torch/dryrun.py) on the 2-layer CFG of tests/test_parallel.py.

  - localize_spec, the merged and tcomb interleaves and each rank's slice
    of every leaf against the JAX package's (its kernel-layout shards on
    the virtual-device mesh, each inverted to canonical words);
  - a row_parallel_tp = 2 model's single-device forward against the JAX
    forward of the same weights (params_from_jax);
  - TP over gloo with 2 and 4 CPU processes, and dp x tp over 2 x 2, with
    and without a KV cache, against the port's own single-device forward;
  - TP over 2 gloo processes against the JAX package's tp_forward_fn on
    two of the 8 virtual devices;
  - the dry run (dryrun_multichip) over 4 processes.

TP budget.  The TP forward sums the ranks' float32 partial outputs of o
and down and rounds the sum to bf16 once, as the single-device product
rounds its own sum: the two differ only in the order of float32 sums,
and so only where that order flips a bf16 rounding of a layer's output,
by one ulp (2^-8 relative) of that element.  A flip moves the residual
stream by an ulp of its update, which the next norm and the head carry
to the logits at about that share of max|logit|: TP_BUDGET allows two
such ulps, 2^-7 of max|logit|.  (The JAX package sums bf16-rounded
partials instead, 2^-9 of each partial before the sum: its TP forward
against the port's takes JAX_TP_BUDGET, four ulps.)

Every process runs on one torch thread."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.parallel import tp as jtp
from qpalette_tpu.parallel.sharding import make_mesh
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch import convert, dryrun
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.parallel import tp
from qpalette_tpu_torch.runtime.loader import LAYER_KEYS, build_quantized_model
from qpalette_tpu_torch.runtime.qlinear import dequant_weight

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=8, num_kv_heads=4, head_dim=32,
           rope_theta=10000.0)
TP_BUDGET = 2.0 ** -7
JAX_TP_BUDGET = 2.0 ** -6
LOGIT_TOL = 1.5e-2  # port vs JAX forward of the same weights (test_torch_vq)
MERGE = [["merge_qkv", "merge_ug"]] * 2
# the dry run's mix: merged tcq2 qkv, tcq1 o, merged tcq up/gate, ldlq down
MIXED = {f"{i}_{k}": q for i in range(2) for k, q in dryrun.DRYRUN_SCHEMES}
# row-parallel tcomb (block-permuted, 2*tp rotation blocks) at o / down,
# merged tcq2s qkv and tcq1 up/gate: every k slice of tp = 4 whole tiles
TCOMB = {f"{i}_{k}": ("tcomb_6_7_0.5_none_0.9" if k in (
    "self_attn.o_proj", "mlp.down_proj") else "tcq2s_6_none_0.9"
    if k.startswith("self_attn") else "tcq1_3_none_0.9")
    for i in range(2) for k in LAYER_KEYS}
# tests/test_parallel.py's own TP case: ldlq_2_4 column-parallel, tcq1_3
# row-parallel, no merges
REF_MIXED = {f"{i}_{k}": ("tcq1_3_none_0.9" if k in (
    "self_attn.o_proj", "mlp.down_proj") else "ldlq_2_4_none_1.0")
    for i in range(2) for k in LAYER_KEYS}
TOKENS = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (4, 8)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(qdict, tpn, merge=MERGE):
    return build_quantized_model(LlamaConfig(**CFG), qdict,
                                 merge_info=merge, dummy=True, impl="exact",
                                 device="cpu", row_parallel_tp=tpn)


def _zero_tcomb_pads(jspec, jparams):
    """The JAX dummy's fused tcomb layout (trellisc_kt) holds random words
    in the KV1 half's pad rows, which its kernel never reads and the
    port's inverse wants zero: zero them."""
    layers = []
    for (a, m), lp in zip(jspec.layers, jparams["layers"]):
        lp = dict(lp)
        for name, ls in a.projs + m.projs:
            if "trellisc_kt" in lp[name]:
                t = np.array(lp[name]["trellisc_kt"])
                t[:ls.split[0] // 16, 4 * ls.KV[0]:] = 0
                lp[name] = dict(lp[name], trellisc_kt=jnp.asarray(t))
        layers.append(lp)
    return dict(jparams, layers=layers)


def _from_jax(qdict, tpn, impl, merge=MERGE):
    """The JAX model (dummy, row_parallel_tp = tpn) and the port's spec
    and params of the same weights."""
    jspec, jparams = jbuild(JConfig(**CFG), qdict, merge_info=merge,
                            dummy=True, impl=impl, row_parallel_tp=tpn,
                            model_key="tp", save_dir="/nonexistent")
    jparams = _zero_tcomb_pads(jspec, jparams)
    spec, _ = _port_model(qdict, tpn, merge)
    return jspec, jparams, spec, convert.params_from_jax(_np(jparams), spec,
                                                         "cpu")


def _rel(got, want):
    got, want = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                            np.float32) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_shard_interleave_and_localize_spec_match_reference():
    """The shard-major permutation and every field of the local spec."""
    for counts, tpn in (([256, 128, 128], 2), ([16, 8, 8], 4), ([8, 8], 2)):
        assert np.array_equal(tp._shard_interleave(counts, tpn),
                              jtp._shard_interleave(counts, tpn))
    for qdict, tpn in ((MIXED, 2), (TCOMB, 4)):
        jspec, _, spec, _ = _from_jax(qdict, tpn, "xla")
        jl, pl = jtp.localize_spec(jspec, tpn), tp.localize_spec(spec, tpn)
        for f in ("num_heads", "num_kv_heads", "intermediate_size"):
            assert getattr(pl.config, f) == getattr(jl.config, f)
        for (ja, jm), (a, m) in zip(jl.layers, pl.layers, strict=True):
            assert (a.rot_blocks_o, a.in_perm_o, m.rot_blocks_down,
                    m.in_perm_down) == (ja.rot_blocks_o, ja.in_perm_o,
                                        jm.rot_blocks_down, jm.in_perm_down)
            for (jn, jls), (n, ls) in zip(ja.projs + jm.projs,
                                          a.projs + m.projs, strict=True):
                assert n == jn
                assert (ls.kind, ls.in_features, ls.out_features,
                        ls.split) == (jls.kind, jls.in_features,
                                      jls.out_features, tuple(jls.split))


@pytest.mark.parametrize("qdict,tpn", [(MIXED, 2), (TCOMB, 4)],
                         ids=["mixed_tp2", "tcomb_tp4"])
def test_rank_slices_equal_reference_shards(qdict, tpn):
    """Each rank's slice of every leaf (after the merged and tcomb
    interleaves) equals the JAX package's shard of it on a tp mesh of the
    virtual devices: kernel-layout words turned canonical at the local
    shape; SU vectors, norms and the replicated leaves as they are.  A
    row-parallel vq (the mix's down) is held by its decoded weight to the
    rank's columns of the W-hat of the reference's words instead (its
    qweight_t turned canonical whole): the reference's shard
    of its kernel layout (qweight_t) keeps the global chunk size kb (256
    positions here), while its kernel picks the local one (128), so that
    shard does not decode to the rank's columns (ROADMAP Queue 3)."""
    jspec, jparams, spec, params = _from_jax(qdict, tpn, "pallas")
    mesh = make_mesh(tpn, tp=tpn)
    sharded = jtp.shard_tp_params(jparams, jspec, mesh)
    lspec = tp.localize_spec(spec, tpn)
    for rank in range(tpn):
        dev = mesh.devices.reshape(-1)[rank]

        def shard(a):
            return np.asarray(next(s.data for s in a.addressable_shards
                                   if s.device == dev))

        local = tp.shard_params(params, spec, tpn, rank)
        for li, ((a, m), jl, pl) in enumerate(zip(
                lspec.layers, sharded["layers"], local["layers"])):
            for key in ("su_qkv", "su_o", "su_ug", "su_dp", "ln_attn",
                        "ln_mlp"):
                assert np.array_equal(
                    pl[key].float().numpy(),
                    np.asarray(shard(jl[key]), np.float32)), (rank, li, key)
            for name, ls in a.projs + m.projs:
                if ls.kind == "vq" and name in tp.ROW_PROJS:
                    gls = dict(spec.layers[li][0].projs
                               + spec.layers[li][1].projs)[name]
                    w = dequant_weight(gls, params["layers"][li][name],
                                       None).float().numpy()
                    k = ls.in_features
                    got = dequant_weight(ls, pl[name], None).float()
                    assert np.array_equal(
                        got.numpy(), w[:, rank * k:(rank + 1) * k])
                    continue
                want = convert._proj({k: shard(v) for k, v in
                                      jl[name].items()}, ls, "cpu")
                assert set(want) == set(pl[name]), name
                for leaf, t in want.items():
                    assert torch.equal(pl[name][leaf], t), (rank, name,
                                                            leaf)


def test_row_parallel_single_device_forward_matches_reference():
    """A row_parallel_tp = 2 model (block-rotated o / down, tcomb
    block-permuted) on one device, against the JAX forward (impl xla)."""
    for qdict in (MIXED, TCOMB):
        jspec, jparams, spec, params = _from_jax(qdict, 2, "xla")
        a = spec.layers[0][0]
        assert a.rot_blocks_o == (4 if qdict is TCOMB else 2)
        want = np.asarray(jllama.forward(jspec, jparams,
                                         jnp.asarray(TOKENS.numpy())))
        got = llama.forward(spec, params, TOKENS)
        assert _rel(got, want) < LOGIT_TOL


def _save_case(tmp_path, spec, params, tokens=TOKENS):
    path = os.path.join(tmp_path, "case.pt")
    torch.save({"spec": spec, "params": params, "tokens": tokens}, path)
    return path


@pytest.mark.parametrize("qdict,dp,tpn", [(MIXED, 1, 2), (TCOMB, 1, 4),
                                          (MIXED, 2, 2)],
                         ids=["tp2", "tp4", "dp2xtp2"])
def test_tp_over_gloo_matches_single_device(tmp_path, qdict, dp, tpn):
    """dp x tp gloo processes: the forward's logits of each rank's rows,
    and a cached prefill + 3 greedy decode steps (logits, greedy tokens,
    the rank's KV cache heads), against the single-device forward within
    TP_BUDGET."""
    spec, params = _port_model(qdict, tpn)
    B, S = TOKENS.shape
    steps = 3
    ref = llama.forward(spec, params, TOKENS)
    caches = llama.init_kv_caches(spec, B, S + steps, "cpu")
    logits, caches = llama.forward(spec, params, TOKENS, kv_caches=caches,
                                   cache_pos=0)
    seq = [logits[:, -1]]
    for i in range(steps):
        tok = seq[-1].argmax(-1)[:, None]
        logits, caches = llama.forward(spec, params, tok, kv_caches=caches,
                                       cache_pos=S + i)
        seq.append(logits[:, -1])
    ref_steps = torch.stack(seq, 1)
    outs = dryrun.run_ranks(dryrun.tp_case_rank, dp * tpn, dp, tpn,
                            _save_case(tmp_path, spec, params), steps, "cpu")
    b = B // dp
    worst = 0.0
    for rank, out in enumerate(outs):
        rows = slice(out["dp"] * b, (out["dp"] + 1) * b)
        for got, want in ((out["logits"], ref[rows]),
                          (out["steps"], ref_steps[rows])):
            worst = max(worst, _rel(got, want))
        assert torch.equal(out["steps"].argmax(-1),
                           ref_steps[rows].argmax(-1))
        heads = tp.kv_cache_slice(caches, tpn, rank % tpn)
        for (k, v), (kr, vr) in zip(out["caches"], heads):
            assert _rel(k, kr[rows]) < TP_BUDGET
            assert _rel(v, vr[rows]) < TP_BUDGET
    assert worst < TP_BUDGET, worst


def test_tp_over_gloo_matches_reference_tp_forward(tmp_path):
    """tests/test_parallel.py's TP case (ldlq_2_4 column-parallel, tcq1_3
    row-parallel) at impl exact over 2 gloo processes against the JAX
    package's tp_forward_fn (impl pallas, interpret mode) on two virtual
    devices, the same weights."""
    jspec, jparams, spec, params = _from_jax(REF_MIXED, 2, "pallas",
                                             merge=None)
    mesh = make_mesh(2, tp=2)
    fwd = jtp.tp_forward_fn(jspec, mesh, jparams)
    toks = jnp.asarray(TOKENS.numpy()[:2])
    want = np.asarray(fwd(jtp.shard_tp_params(jparams, jspec, mesh),
                          jax.device_put(toks, NamedSharding(mesh, P()))))
    outs = dryrun.run_ranks(dryrun.tp_case_rank, 2, 1, 2,
                            _save_case(tmp_path, spec, params, TOKENS[:2]),
                            0, "cpu")
    for out in outs:
        assert _rel(out["logits"], want) < JAX_TP_BUDGET


def test_dryrun_multichip_four_processes(capsys):
    """python -m qpalette_tpu_torch.dryrun 4 --device cpu: dp = 2 x tp = 2
    within its budget (it raises beyond)."""
    worst = dryrun.dryrun_multichip(4, device="cpu")
    assert worst < dryrun.TP_BUDGET
    assert "dryrun_multichip OK on 4 processes" in capsys.readouterr().out


def test_entry_forward_runs():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1, 8, 256) and bool(torch.isfinite(out).all())


def test_column_parallel_comb_and_ragged_splits_raise():
    """What a rank cannot take raises before any run: comb as a
    column-parallel projection (its halves' rows are not a rank's rows),
    heads that tp does not divide, and a spec not quantized for tp."""
    ls = dataclasses.replace(
        _port_model(MIXED, 2)[0].layers[0][0].projs[0][1], kind="comb",
        split=(384, 128))
    with pytest.raises(NotImplementedError, match="comb"):
        tp._scale_linear_spec(ls, 2, row=False)
    spec, _ = _port_model(MIXED, 2)
    with pytest.raises(ValueError, match="num_heads"):
        tp.localize_spec(spec, 16)
    with pytest.raises(ValueError, match="rot_blocks"):
        tp.localize_spec(_port_model(MIXED, 1)[0], 2)


def test_dequantized_rank_weights_tile_the_global_weight():
    """The rank slices, dequantized (K2/K3/K6/K7/K9 plain), put back
    together give the global W-hat: o / down side by side along k (tcomb
    in its permuted column order), the merged qkv row blocks per part."""
    for qdict, tpn in ((MIXED, 2), (TCOMB, 4)):
        spec, params = _port_model(qdict, tpn)
        lspec = tp.localize_spec(spec, tpn)
        g = dict(spec.layers[0][0].projs + spec.layers[0][1].projs)
        lo = dict(lspec.layers[0][0].projs + lspec.layers[0][1].projs)
        glob = {n: dequant_weight(g[n], params["layers"][0][n],
                                  params["luts"]) for n in ("o", "down",
                                                            "qkv")}
        ranks = [tp.shard_params(params, spec, tpn, r)["layers"][0]
                 for r in range(tpn)]
        for n in ("o", "down"):
            w = torch.cat([dequant_weight(lo[n], r[n], params["luts"])
                           for r in ranks], 1)
            if g[n].kind == "tcomb":  # rank r: [KV1 piece r | KV2 piece r]
                k = w.shape[1]
                w = w.reshape(-1, tpn, 2, k // (2 * tpn)).transpose(1, 2) \
                    .reshape(-1, k)
            assert torch.equal(w, glob[n]), n
        parts = tp._merged_parts(spec.config, "qkv")
        qkv = [dequant_weight(lo["qkv"], r["qkv"], params["luts"])
               for r in ranks]
        off = 0
        for width in parts:
            block = torch.cat([q[off // tpn:(off + width) // tpn]
                               for q in qkv])
            assert torch.equal(block, glob["qkv"][off:off + width])
            off += width
