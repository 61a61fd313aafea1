"""Port parity for the column-parallel (dp, tp) scheme
(qpalette_tpu_torch/parallel/sharding.py, the column forward of
models/llama.py, multihost's scheme "column", the dry run's two legs) on
the 2-layer dry-run config.

  - param_shardings places every leaf as the reference's _leaf_pspec;
  - each rank's slice of every leaf at tp 2 and 4 equals the JAX
    package's shard_params shard on the virtual devices (kernel layouts
    made canonical with convert._proj at the local shape): the mixed
    qdict (canonical and kernel layouts), a 4-bit head, tied embeddings
    and a comb projection;
  - the column forward over 2 and 4 gloo processes, and over dp x tp =
    2 x 2 with a cached greedy decode, against the port's single-device
    forward: bit for bit (every input of every kernel is whole and each
    output row's sum runs as on one device; the gathers copy);
  - one column forward against the JAX package's sharded forward;
  - the dry run's two legs over 4 and 8 processes.

Every process runs on one torch thread."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig
from qpalette_tpu.parallel import sharding as jsh
from qpalette_tpu.runtime.loader import build_quantized_model as jbuild

from qpalette_tpu_torch import convert, dryrun
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.parallel import multihost, sharding, tp
from qpalette_tpu_torch.runtime.loader import (build_quantized_model,
                                               tlut_tensors, word_shapes)
from qpalette_tpu_torch.runtime.qlinear import LinearSpec

CFG = dict(vars(dryrun.DRYRUN_CFG))
CFG.pop("dtype")
MIXED = dryrun.dryrun_qdict()
MERGE = dryrun.DRYRUN_MERGES
# the port at impl dequant against the reference's xla: the same bf16
# W-hat, the f32 sums in another order (tests/test_torch_arith_model.py)
LOGIT_TOL = 2e-2
TOKENS = torch.as_tensor(np.random.default_rng(9).integers(0, 256, (4, 8)))
COMB_SPLIT = (192, 64)  # o's unequal output halves: whole tiles at tp 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(impl="xla", head=16, tied=False, qdict=MIXED, merge=MERGE):
    cfg = JConfig(**dict(CFG, tie_embeddings=tied))
    return jbuild(cfg, qdict, merge_info=merge, dummy=True, impl=impl,
                  lm_head_bits=head, model_key="sharding",
                  save_dir="/nonexistent")


def _port_spec(impl="exact", head=16, tied=False):
    cfg = LlamaConfig(**dict(CFG, tie_embeddings=tied))
    return build_quantized_model(cfg, MIXED, merge_info=MERGE, dummy=True,
                                 impl=impl, lm_head_bits=head, device="cpu")


def _from_jax(impl="xla", head=16, port_impl="exact"):
    jspec, jparams = _jax_model(impl, head)
    spec, _ = _port_spec(port_impl, head)
    return jspec, jparams, spec, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), spec, "cpu")


def _with_comb(spec, params, seed=3):
    """spec and params with every o projection replaced by a comb of
    unequal output halves COMB_SPLIT (random words, KV 6 / 7, a random
    Wscale, so that a rank's rows of each half show)."""
    gen = torch.Generator().manual_seed(seed)
    n = spec.config.hidden_size
    ls = LinearSpec("comb", n, n, KV=(6, 7), tlut_bits=9, split=COMB_SPLIT,
                    impl=spec.layers[0][0].projs[-1][1].impl)
    layers, lps = [], []
    for (a, m), lp in zip(spec.layers, params["layers"]):
        p = {name: torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                 dtype=torch.int32)
             for name, shape in word_shapes(ls).items()}
        p["wscale"] = 0.01 + 0.02 * torch.rand(n, generator=gen)
        layers.append((dataclasses.replace(a, projs=a.projs[:-1]
                                           + (("o", ls),)), m))
        lps.append(dict(lp, o=p))
    spec = dataclasses.replace(spec, layers=tuple(layers))
    return spec, dict(params, layers=lps, luts=tlut_tensors(spec, "cpu"))


def _rank_tree(sharded, mesh, rank):
    """The reference's shard of every leaf on tp rank `rank` (dp 0)."""
    dev = mesh.devices[0, rank]
    return jax.tree.map(lambda a: np.asarray(next(
        s.data for s in a.addressable_shards if s.device == dev)), sharded)


def _equal(t, a):
    """A port tensor and a reference array of the same values."""
    return np.array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_param_shardings_follow_leaf_pspec():
    """Every leaf's placement is the reference _leaf_pspec's of its name:
    a split of dim 0 over tp where it says ("tp", ...) or ("tp",),
    replicated where it says () (the port holds only canonical leaves);
    comb's wscale by its halves; the 4-bit head's leaves by vocab rows."""
    for head in (16, 4):
        spec, params = _with_comb(*_port_spec(head=head))
        places = sharding.param_shardings(params, spec)

        def walk(tree, place, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, place[k], path + (k,))
                return
            if isinstance(tree, list):
                for i, (v, p) in enumerate(zip(tree, place)):
                    walk(v, p, path + (i,))
                return
            key = path[-1]
            want = jsh._leaf_pspec(key, tree.dim())
            if path[0] == "layers" and path[2] == "o" and key == "wscale":
                assert place == sharding.Shard("tp", 0, COMB_SPLIT), path
            elif want == P():
                assert place is None, path
            else:
                assert want[0] == "tp" and place == sharding.Shard("tp", 0), \
                    path

        walk(params, places, ())
        if head == 4:
            assert places["lm_head_q4"]["trellis"] == sharding.Shard()
            assert places["lm_head_su"] is None


def _check_projection(lp, jl, name, ls):
    """A rank's leaves of a projection equal the reference's shards, made
    canonical at the local shape."""
    want = convert._proj(jl[name], ls, "cpu")
    assert set(want) == set(lp[name]), name
    for leaf, t in want.items():
        assert torch.equal(lp[name][leaf], t), (name, leaf)


@pytest.mark.parametrize("tpn", [2, 4])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rank_slices_equal_reference_shards(impl, tpn):
    """The mixed qdict (merged tcq2 qkv, tcq1 o, merged tcq ug, ldlq_2_6
    down) with the 4-bit head: each rank's slices equal the reference's
    shards of its canonical leaves (xla) and of its kernel layouts
    (pallas: tcq1 / tcq2 trellis_pl and tcq trellis_kt split by m-tiles,
    made canonical at the local shape).  The vq down's kernel layout
    qweight_t (8, W/8, m) is split by the reference along its words (dim
    1), not its rows, and at tp 4 its 6 word-octets do not split at all
    (the reference's shard_params raises): at pallas the down is left out
    and held by its xla shard (the reference's dry run builds at xla)."""
    jspec, jparams, spec, params = _from_jax(impl, head=4)
    if impl == "pallas":
        jparams = dict(jparams, layers=[
            {k: v for k, v in lp.items() if k != "down"}
            for lp in jparams["layers"]])
    mesh = jsh.make_mesh(tpn, tp=tpn)
    sharded = jsh.shard_params(jparams, mesh)
    lspec = sharding.localize_spec(spec, tpn)
    for rank in range(tpn):
        ref = _rank_tree(sharded, mesh, rank)
        local = sharding.local_params(params, spec, tpn, rank)
        for (a, m), jl, lp in zip(lspec.layers, ref["layers"],
                                  local["layers"], strict=True):
            for key in ("su_qkv", "su_o", "su_ug", "su_dp", "ln_attn",
                        "ln_mlp"):
                assert _equal(lp[key], jl[key]), (rank, key)
            for name, ls in a.projs + m.projs:
                if ls.kind == "vq" and impl == "pallas":
                    continue
                _check_projection(lp, jl, name, ls)
        _check_projection(local, ref, "lm_head_q4", lspec.lm_head_spec)
        for key in ("embed", "ln_f", "lm_head_su"):
            assert _equal(local[key], ref[key]), (rank, key)
        assert local["luts"] is not None and all(
            local["luts"][k] is params["luts"][k] for k in params["luts"])


def test_vq_down_and_bf16_head_rows_equal_xla_shards():
    """The down's rows under column parallelism from the xla shards (the
    canonical row-pack split by rows) at tp 2 and 4."""
    jspec, jparams, spec, params = _from_jax("xla")
    for tpn in (2, 4):
        mesh = jsh.make_mesh(tpn, tp=tpn)
        sharded = jsh.shard_params(jparams, mesh)
        lspec = sharding.localize_spec(spec, tpn)
        for rank in range(tpn):
            ref = _rank_tree(sharded, mesh, rank)
            local = sharding.local_params(params, spec, tpn, rank)
            for li in range(2):
                ls = dict(lspec.layers[li][1].projs)["down"]
                assert (ls.kind, ls.out_features) == ("vq", 256 // tpn)
                _check_projection(local["layers"][li], ref["layers"][li],
                                  "down", ls)
            assert _equal(local["lm_head"], ref["lm_head"])


@pytest.mark.parametrize("tpn", [2, 4])
def test_tied_embeddings_share_one_split(tpn):
    """Tied embeddings: embed and lm_head are one tensor on a rank too,
    the reference's shard of both."""
    _, jparams = _jax_model(tied=True)
    spec, params = _port_spec(tied=True)
    assert params["lm_head"] is params["embed"]
    mesh = jsh.make_mesh(tpn, tp=tpn)
    sharded = jsh.shard_params(jparams, mesh)
    for rank in range(tpn):
        ref = _rank_tree(sharded, mesh, rank)
        local = sharding.local_params(params, spec, tpn, rank)
        assert local["lm_head"] is local["embed"]
        assert local["embed"].shape == (256 // tpn, 256)
        assert _equal(local["embed"], ref["embed"])
        assert _equal(local["lm_head"], ref["lm_head"])


@pytest.mark.parametrize("tpn", [2, 4])
def test_comb_rank_slices(tpn):
    """comb's words are the reference's shards of trellis1 / trellis2 (each
    half's m-tiles); its wscale is the same rows of each half: the
    reference's contiguous shards of the concatenated wscale, put back
    together and sliced by halves."""
    spec, params = _with_comb(*_port_spec())
    tree = {"layers": [{"o": {k: np.asarray(v) for k, v in lp["o"].items()}}
                       for lp in params["layers"]]}
    mesh = jsh.make_mesh(tpn, tp=tpn)
    sharded = jsh.shard_params(tree, mesh)
    refs = [_rank_tree(sharded, mesh, r) for r in range(tpn)]
    m1, m2 = COMB_SPLIT
    for li in range(2):
        wscale = np.concatenate([r["layers"][li]["o"]["wscale"]
                                 for r in refs])
        for rank in range(tpn):
            o = sharding.local_params(params, spec, tpn,
                                      rank)["layers"][li]["o"]
            jo = refs[rank]["layers"][li]["o"]
            for leaf in ("trellis1", "trellis2"):
                assert np.array_equal(o[leaf].numpy(), jo[leaf])
            a, b = m1 // tpn, m2 // tpn
            want = np.concatenate([wscale[rank * a:(rank + 1) * a],
                                   wscale[m1 + rank * b:m1 + (rank + 1) * b]])
            assert np.array_equal(o["wscale"].numpy(), want)
    lo = dict(sharding.localize_spec(spec, tpn).layers[0][0].projs)["o"]
    assert (lo.out_features, lo.split) == (256 // tpn, (m1 // tpn,
                                                        m2 // tpn))


def _save_case(tmp_path, spec, params, tokens=TOKENS):
    path = os.path.join(tmp_path, "case.pt")
    torch.save({"spec": spec, "params": params, "tokens": tokens}, path)
    return path


def _single_device(spec, params, steps):
    B, S = TOKENS.shape
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
    return ref, torch.stack(seq, 1), caches


def _model(case):
    if case == "mixed":
        return _port_spec()
    if case == "comb_head4":
        return _with_comb(*_port_spec(head=4))
    return _port_spec(tied=True)


@pytest.mark.parametrize("case,dp,tpn,steps", [
    ("mixed", 1, 2, 3), ("mixed", 1, 4, 3), ("mixed", 2, 2, 3),
    ("comb_head4", 1, 4, 1), ("tied", 1, 2, 1)],
    ids=["tp2", "tp4", "dp2xtp2", "comb_head4_tp4", "tied_tp2"])
def test_column_forward_over_gloo_equals_single_device(tmp_path, case, dp,
                                                       tpn, steps):
    """dp x tp gloo processes, column-parallel: each rank's logits of its
    rows, a cached prefill and greedy decode steps (logits, tokens) and
    its caches (its rows, its kv heads) equal the single-device run bit for
    bit."""
    spec, params = _model(case)
    ref, ref_steps, caches = _single_device(spec, params, steps)
    outs = dryrun.run_ranks(dryrun.tp_case_rank, dp * tpn, dp, tpn,
                            _save_case(tmp_path, spec, params), steps, "cpu",
                            "column")
    b = TOKENS.shape[0] // dp
    for rank, out in enumerate(outs):
        d = out["dp"]
        rows = slice(d * b, (d + 1) * b)
        assert torch.equal(out["logits"], ref[rows]), rank
        assert torch.equal(out["steps"], ref_steps[rows]), rank
        want = tp.kv_cache_slice(caches, tpn, rank % tpn, dp, d)
        for got_kv, want_kv in zip(out["caches"], want, strict=True):
            for g, w in zip(got_kv, want_kv, strict=True):
                assert torch.equal(g, w), rank


def test_column_forward_matches_reference_sharded_forward(tmp_path):
    """The mixed qdict on 2 gloo processes (impl dequant) against the
    reference's GSPMD forward of its shard_params on 2 virtual devices
    (impl xla), the same weights."""
    jspec, jparams, spec, params = _from_jax("xla", port_impl="dequant")
    mesh = jsh.make_mesh(2, tp=2)
    fwd = jax.jit(lambda p, t: jllama.forward(jspec, p, t))
    want = np.asarray(fwd(jsh.shard_params(jparams, mesh),
                          jnp.asarray(TOKENS.numpy())))
    outs = dryrun.run_ranks(dryrun.tp_case_rank, 2, 1, 2,
                            _save_case(tmp_path, spec, params), 0, "cpu",
                            "column")
    for out in outs:
        got = out["logits"].numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < LOGIT_TOL


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_runs_both_legs(n, capsys):
    """python -m qpalette_tpu_torch.dryrun n --device cpu: leg 1 column-
    parallel at tp = min(4, n), dp = n / 4 (bit-equal to one process on
    the CPU), leg 2 tcq1_3 row-parallel at tp 4, both within the budget."""
    worst = dryrun.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert worst < dryrun.TP_BUDGET
    assert (f"dryrun_multichip OK on {n} processes on cpu (mesh dp={n // 4} "
            f"tp=4, column-parallel") in out
    assert "max|d| / max|logit| = 0.00e+00" in out
    assert "dryrun tp OK (tp=4, tcq1_3_none_0.9 row-parallel" in out


def test_splits_a_rank_cannot_take_raise():
    """Ragged splits raise before any run: output rows that are not whole
    16-row tiles a rank, heads or vocab that tp does not divide, and an
    unknown scheme."""
    spec, params = _port_spec()
    with pytest.raises(ValueError, match="num_heads"):
        sharding.localize_spec(spec, 3)
    with pytest.raises(ValueError, match="num_heads"):
        sharding.local_params(params, spec, 16, 0)
    tcq = LinearSpec("tcq", 256, 96, KV=(4,), tlut_bits=9)
    with pytest.raises(ValueError, match="whole 16-row tiles"):
        sharding._local_linear(tcq, 4)  # 24 rows a rank
    assert sharding._local_linear(
        dataclasses.replace(tcq, kind="vq", bits=6, vec=2), 4
    ).out_features == 24  # a row-pack splits by rows
    comb = dataclasses.replace(tcq, kind="comb", KV=(6, 7), split=(64, 32))
    with pytest.raises(ValueError, match="whole 16-row tiles"):
        sharding._local_linear(comb, 4)  # the second half's 8 rows
    cfg = LlamaConfig(**dict(CFG, vocab_size=250))
    with pytest.raises(ValueError, match="vocab_size"):
        sharding.localize_spec(dataclasses.replace(spec, config=cfg), 4)
    with pytest.raises(ValueError, match="scheme"):
        multihost._local_spec(spec, None, "diagonal")


def test_kv_cache_slice_takes_the_int8_caches_scales():
    """tp.kv_cache_slice (kv_cache_shardings' body) cuts every tensor of a
    layer's cache, the int8 cache's (B, T, kv_heads, 1) scales too, by its
    batch rows over dp and its kv heads over tp."""
    spec, _ = _port_spec()
    caches = llama.init_kv_caches(spec, 4, 8, "cpu", quantized=True)
    gen = torch.Generator().manual_seed(1)
    for kv in caches:
        for c in kv:
            c.copy_(torch.randint(-100, 100, c.shape, generator=gen))
    hk = spec.config.num_kv_heads
    for d in range(2):
        for t in range(2):
            local = tp.kv_cache_slice(caches, 2, t, 2, d)
            for kv, lkv in zip(caches, local, strict=True):
                assert len(lkv) == 4
                for c, lc in zip(kv, lkv, strict=True):
                    assert lc.shape == (2, 8, hk // 2) + c.shape[3:]
                    assert torch.equal(lc, c[2 * d:2 * d + 2, :,
                                             t * hk // 2:(t + 1) * hk // 2])
