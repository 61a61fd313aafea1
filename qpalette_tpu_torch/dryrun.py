"""Entry points of a quick check: one process, and a multi-process dry run
of the (dp, tp) forward.

Counterpart of ``__graft_entry__.py``:

  entry()               the flagship scheme's tiny model and one forward
                        (fn, example args)
  dryrun_multichip(n)   the reference's two legs over gloo processes, on
                        one card or the CPU, each held to the one-process
                        forward (TP_BUDGET):
                        1. n processes as a (dp, tp) mesh, tp = min(4, n):
                           the reference's mixed qdict (merged tcq2 qkv,
                           tcq1 o, merged tcq up/gate, ldlq_2_6 down)
                           column-parallel (parallel/sharding.py), a forward
                           with its mean CE loss and a decode step into
                           sharded KV caches;
                        2. min(4, n) processes as a tp mesh: tcq1_3
                           everywhere at row_parallel_tp = tp, row-parallel
                           o / down (parallel/tp.py), a forward

  python -m qpalette_tpu_torch.dryrun [n] [--device cuda|cpu]
      # default 8 processes on the card (gloo takes CUDA tensors, so every
      # rank shares cuda:0; NCCL would want a card a rank)

Both run on the card unless the caller asks for the CPU.  ``run_ranks``
starts such a job (one process a rank, gloo, ``tcp://127.0.0.1:<free
port>``) and returns what each rank's function returns; the tests and
chip_smoke.py's tensor-parallel phase use it.
"""

from __future__ import annotations

import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from qpalette_tpu_torch.models.llama import LlamaConfig

DRYRUN_CFG = LlamaConfig(vocab_size=256, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=8,
                         num_kv_heads=4, head_dim=32, rope_theta=10000.0)
DRYRUN_SCHEMES = (("self_attn.q_proj", "tcq2_6_none_0.9"),
                  ("self_attn.k_proj", "tcq2_6_none_0.9"),
                  ("self_attn.v_proj", "tcq2_6_none_0.9"),
                  ("self_attn.o_proj", "tcq1_3_none_0.9"),
                  ("mlp.up_proj", "tcq_4_none_0.9"),
                  ("mlp.gate_proj", "tcq_4_none_0.9"),
                  ("mlp.down_proj", "ldlq_2_6_none_1.0"))
DRYRUN_MERGES = [["merge_qkv", "merge_ug"], []]
LEG2_QSTR = "tcq1_3_none_0.9"  # leg 2: every projection, row_parallel_tp
# max|logits - one-process logits| / max|one-process logits| allowed to
# the TP forward: it sums the ranks' float32 partial outputs of o / down
# and rounds once, so it differs from the one-process forward only where
# the order of the float32 sums flips a bf16 rounding of a layer output
# (an ulp, 2^-8, of that element, carried to the logits at about that
# share): two such ulps
TP_BUDGET = 2.0 ** -7


def entry(device="cuda"):
    """(fn, example_args): one forward of the tiny model with the
    flagship scheme everywhere (tcomb_4_5), dummy weights, on device."""
    from qpalette_tpu_torch.models.llama import forward
    from qpalette_tpu_torch.runtime.loader import build_quantized_model

    cfg = LlamaConfig.tiny()
    spec, params = build_quantized_model(cfg, "tcomb_4_5_0.5_none_0.9",
                                         dummy=True, device=device)

    def fn(params, tokens):
        return forward(spec, params, tokens)

    tokens = torch.as_tensor(np.arange(8)[None, :] % cfg.vocab_size,
                             device=device)
    return fn, (params, tokens)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, outdir, fn, args, threads):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def run_ranks(fn, world: int, *args, threads: int = 1) -> list:
    """fn(rank, world, *args) in `world` new processes that form one gloo
    job; returns their results in rank order (each saved with torch.save
    to a temporary directory, so a result may hold tensors).  fn must be a
    module-level function; a rank that fails makes this raise."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(world, free_port(), outdir, fn, args,
                                 threads))
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def tp_case_rank(rank, world, dp, tp, path, steps=0, device="cuda",
                 scheme="row"):
    """One rank of a (dp, tp) run on device of the case torch.save'd at
    path: {"spec", "params" (global), "tokens" (B, S)}, the weights placed
    by the scheme (multihost.shard_model_dcn: "row" or "column").  Returns
    this rank's dp index and its rows' logits of a forward over the
    tokens; with steps > 0 also the logits of a cached run (a prefill of
    the tokens, then `steps` greedy decode forwards, the caches this
    rank's rows and kv heads) and its local caches; all on the CPU."""
    from qpalette_tpu_torch.models.llama import init_kv_caches
    from qpalette_tpu_torch.parallel import multihost

    case = torch.load(path, map_location=device, weights_only=False)
    spec, tokens = case["spec"], case["tokens"]
    mesh = multihost.dcn_mesh(tp, dp)
    lspec, lparams = multihost.shard_model_dcn(case["params"], spec, mesh,
                                               scheme)
    out = {"dp": mesh.get_local_rank("dp"),
           "logits": multihost.dcn_forward_fn(spec, mesh, scheme=scheme)(
               lparams, tokens)}
    if steps:
        fwd = multihost.dcn_forward_fn(spec, mesh, with_cache=True,
                                       scheme=scheme)
        B, S = tokens.shape
        caches = init_kv_caches(lspec, B // dp, S + steps, device)
        logits, caches = fwd(lparams, tokens, caches, 0)
        seq = [logits[:, -1]]
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(steps):
            # every dp rank takes the whole batch and keeps its own rows
            full = tok.repeat(dp, 1)
            logits, caches = fwd(lparams, full, caches, S + i)
            seq.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)[:, None]
        out["steps"] = torch.stack(seq, 1)
        out["caches"] = caches
    return _to_cpu(out)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def dryrun_qdict(cfg: LlamaConfig = DRYRUN_CFG) -> dict:
    return {f"{i}_{key}": qs for i in range(cfg.num_layers)
            for key, qs in DRYRUN_SCHEMES}


def _build(leg: int, tp: int, device):
    """Leg 1's mixed qdict (single-device layers), or leg 2's tcq1_3 at
    row_parallel_tp = tp."""
    from qpalette_tpu_torch.runtime.loader import build_quantized_model
    if leg == 1:
        return build_quantized_model(DRYRUN_CFG, dryrun_qdict(),
                                     merge_info=DRYRUN_MERGES, dummy=True,
                                     impl="exact", device=device)
    return build_quantized_model(DRYRUN_CFG, LEG2_QSTR, dummy=True,
                                 impl="exact", device=device,
                                 row_parallel_tp=tp)


def _tokens(B: int, device) -> torch.Tensor:
    return torch.as_tensor(np.arange(B * 8).reshape(B, 8)
                           % DRYRUN_CFG.vocab_size, device=device)


def _mean_ce(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None])[..., 0].mean()


def _dryrun_rank(rank, world, dp, tp, device):
    """Leg 1 on one rank: the column-parallel forward of its dp rows, the
    mean CE over the dp groups, a decode step into its sharded caches."""
    from qpalette_tpu_torch.models.llama import init_kv_caches
    from qpalette_tpu_torch.parallel import multihost, sharding

    spec, params = _build(1, tp, device)
    mesh = sharding.make_mesh(dp * tp, tp)
    _, lparams = multihost.shard_model_dcn(params, spec, mesh, "column")
    del params
    tokens = _tokens(2 * dp, device)
    logits = multihost.dcn_forward_fn(spec, mesh, scheme="column")(
        lparams, tokens)
    # the eval step's mean CE, averaged over the dp groups
    loss = _mean_ce(logits, multihost.dp_batch_spec(tokens, mesh))
    dist.all_reduce(loss, group=mesh.get_group("dp"))
    loss = loss / dp
    # the global caches' slice of this rank: its rows, its kv heads
    caches = sharding.kv_cache_shardings(
        init_kv_caches(spec, 2 * dp, 16, device), mesh)
    step, caches = multihost.dcn_forward_fn(spec, mesh, with_cache=True,
                                            scheme="column")(
        lparams, tokens[:, :1], caches, 0)
    return {"dp": mesh.get_local_rank("dp"), "logits": logits.cpu(),
            "loss": float(loss), "step": step.cpu()}


def _leg2_rank(rank, world, device):
    """Leg 2 on one rank: the row-parallel forward of the two rows."""
    from qpalette_tpu_torch.parallel import multihost

    spec, params = _build(2, world, device)
    mesh = multihost.dcn_mesh(world, 1)
    _, lparams = multihost.shard_model_dcn(params, spec, mesh, "row")
    del params
    return multihost.dcn_forward_fn(spec, mesh, scheme="row")(
        lparams, _tokens(2, device)).cpu()


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def dryrun_multichip(n: int, device="cuda") -> float:
    """The reference's dry run over gloo processes on device (every rank
    on the one card, or on the CPU): leg 1, n processes as a (dp, tp)
    mesh, tp = min(4, n), the mixed qdict column-parallel; leg 2,
    min(4, n) processes, tcq1_3 row-parallel.  Returns the largest
    deviation of either leg from its one-process forward, as a share of
    its max|logit| (it raises above TP_BUDGET)."""
    from qpalette_tpu_torch.models.llama import forward, init_kv_caches

    tp = min(4, n)
    dp = n // tp
    spec, params = _build(1, tp, device)
    tokens = _tokens(2 * dp, device)
    ref = forward(spec, params, tokens)
    ref_loss = float(_mean_ce(ref, tokens))
    caches = init_kv_caches(spec, 2 * dp, 16, device)
    ref_step, _ = forward(spec, params, tokens[:, :1], kv_caches=caches,
                          cache_pos=0)
    ref, ref_step = ref.cpu(), ref_step.cpu()
    del params, caches
    outs = run_ranks(_dryrun_rank, dp * tp, dp, tp, str(device))
    worst = 0.0
    for out in outs:
        rows = slice(2 * out["dp"], 2 * out["dp"] + 2)
        worst = max(worst, _rel(out["logits"], ref[rows]),
                    _rel(out["step"], ref_step[rows]))
        if not np.isfinite(out["loss"]):
            raise RuntimeError(f"non-finite loss {out['loss']}")
    if worst > TP_BUDGET:
        raise RuntimeError(f"dry run leg 1: {worst:.3e} of max|logit| off "
                           f"the one-process forward (budget {TP_BUDGET})")
    print(f"dryrun_multichip OK on {n} processes on {device} (mesh dp={dp} "
          f"tp={tp}, column-parallel, loss={outs[0]['loss']:.3f}, one "
          f"process {ref_loss:.3f}; max|d| / max|logit| = {worst:.2e})")

    spec, params = _build(2, tp, device)
    ref = forward(spec, params, _tokens(2, device)).cpu()
    del params
    worst2 = max(_rel(got, ref) for got in
                 run_ranks(_leg2_rank, tp, str(device)))
    if worst2 > TP_BUDGET:
        raise RuntimeError(f"dry run leg 2: {worst2:.3e} of max|logit| off "
                           f"the one-process forward (budget {TP_BUDGET})")
    print(f"dryrun tp OK (tp={tp}, {LEG2_QSTR} row-parallel o / down; "
          f"max|d| / max|logit| against one process = {worst2:.2e})")
    return max(worst, worst2)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="processes (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (every rank on cuda:0) or cpu")
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)
