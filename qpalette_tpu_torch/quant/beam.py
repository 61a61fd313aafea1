"""Hessian-weighted beam search over trellis tile sequences.

Counterpart of ``qpalette_tpu/quant/beam.py``.  Viterbi is exact only for
a (block-)diagonal weighting; the within-tile Hessian block D-tilde
couples positions beyond the trellis state, so a beam over whole
candidate histories minimises the quadratic tile objective e D-tilde e^T
instead.  Each step scores the 2^KV successors of every beam element,

    delta = (w - x_i) Q_i (w - x_i)^T + 2 (w - x_i) . (D-tilde[P_i, :] e_hist^T),

and keeps the best ``beam``.  The first state is held to the Viterbi
seed's s0, and the last steps' new bits must reproduce s0's wrapped
bits (_wrap_constraints), so every result is a valid tail-biting
encoding; per tile the better of the beam result and the seed is kept.

The beam is selected by a stable sort of the candidates' scores: ties go
to the lower candidate index, as ``lax.top_k`` breaks them, so the two
packages keep the same beam wherever their scores agree in float32.
"""

from __future__ import annotations

import torch

L = 16
BIG = 1e30


def _wrap_constraints(s0: torch.Tensor, S: int, KV: int):
    """Forced new-bit masks and values a step for tail-biting.

    Step i appends KV stream bits at positions [i*KV + L - KV, i*KV + L);
    positions p >= S*KV wrap onto the start of the circular stream and
    must equal bit (p - S*KV) of s0.  Returns (fmask (S,) int64, the
    same for every sequence, and fval (B, S) int64)."""
    SKV = S * KV
    dev = s0.device
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(KV, device=dev)[None, :]
    p = i * KV + (L - KV) + j
    forced = p >= SKV
    fmask = torch.where(forced, 1 << j, 0).sum(1)
    src = torch.clamp(p - SKV, 0, L - 1)
    bits = (s0[:, None, None] >> src[None]) & 1
    fval = torch.where(forced[None], bits << j[None], 0).sum(2)
    return fmask, fval


def seq_objective(hat: torch.Tensor, X: torch.Tensor,
                  Dt: torch.Tensor) -> torch.Tensor:
    """The quadratic objective e D-tilde e^T of each tile: hat, X (B, T),
    Dt (T, T) -> (B,)."""
    e = (hat - X).to(torch.float32)
    return torch.einsum("bt,tu,bu->b", e, Dt.to(torch.float32), e)


@torch.inference_mode()
def tcq_quantize_beam(X: torch.Tensor, lut: torch.Tensor, Dt: torch.Tensor,
                      states_init: torch.Tensor, KV: int, v: int = 1,
                      beam: int = 16):
    """Refine Viterbi states under the whole within-tile weighting Dt.

    X (B, T) tile sequences (T = S*v); lut (2^L, v); Dt (T, T) PSD;
    states_init (B, S), a valid tail-biting encoding (quant/viterbi.py's
    tcq_quantize).  Returns (hat (B, T) float32, states (B, S) int64): per
    tile, the beam's result where its objective is at most the seed's."""
    Bt, T = X.shape
    S = T // v
    nc = 1 << KV
    dev = X.device
    X = X.to(torch.float32)
    lutf = lut.to(device=dev, dtype=torch.float32)
    Dtf = Dt.to(device=dev, dtype=torch.float32)
    s0 = states_init[:, 0].to(torch.int64)
    fmask, fval = _wrap_constraints(s0, S, KV)

    e0 = lutf[s0] - X[:, :v]  # (B, v)
    score0 = torch.einsum("bv,vu,bu->b", e0, Dtf[:v, :v], e0)
    ehist = torch.zeros((Bt, beam, T), dtype=torch.float32, device=dev)
    ehist[:, :, :v] = e0[:, None, :]
    # only element 0 is real at the first step: the others are held off
    # so that the first selection does not repeat one prefix
    score = score0[:, None] + torch.where(
        torch.arange(beam, device=dev)[None, :] == 0, 0.0, BIG)
    trace = torch.zeros((Bt, beam, S), dtype=torch.int64, device=dev)
    trace[:, :, 0] = s0[:, None]
    last = s0[:, None].expand(Bt, beam).clone()
    nb = torch.arange(nc, device=dev)
    for i in range(1, S):
        base = last >> KV  # (B, beam)
        succ = base[..., None] | (nb[None, None, :] << (L - KV))
        w = lutf[succ]  # (B, beam, nc, v)
        e = w - X[:, None, None, i * v:(i + 1) * v]
        Q = Dtf[i * v:(i + 1) * v, i * v:(i + 1) * v]
        r = torch.einsum("bkt,vt->bkv", ehist, Dtf[i * v:(i + 1) * v])
        quad = torch.einsum("bkcv,vu,bkcu->bkc", e, Q, e)
        lin = 2.0 * torch.einsum("bkcv,bkv->bkc", e, r)
        ok = (nb[None, None, :] & fmask[i]) == fval[:, i][:, None, None]
        cand = score[..., None] + quad + lin + torch.where(ok, 0.0, BIG)
        flat = cand.reshape(Bt, beam * nc)
        top, topi = torch.sort(flat, dim=1, stable=True)
        score, topi = top[:, :beam], topi[:, :beam]
        kidx = topi // nc
        ehist = torch.gather(ehist, 1, kidx[..., None].expand(-1, -1, T))
        trace = torch.gather(trace, 1, kidx[..., None].expand(-1, -1, S))
        last = torch.gather(succ.reshape(Bt, beam * nc), 1, topi)
        ehist[:, :, i * v:(i + 1) * v] = torch.gather(
            e.reshape(Bt, beam * nc, v), 1,
            topi[..., None].expand(-1, -1, v))
        trace[:, :, i] = last
    best = score.argmin(1)
    states_beam = trace[torch.arange(Bt, device=dev), best]
    hat_beam = lutf[states_beam].reshape(Bt, T)
    states_init = states_init.to(torch.int64)
    hat_init = lutf[states_init].reshape(Bt, T)
    better = seq_objective(hat_beam, X, Dtf) <= seq_objective(hat_init, X,
                                                              Dtf)
    states = torch.where(better[:, None], states_beam, states_init)
    hat = torch.where(better[:, None], hat_beam, hat_init)
    return hat, states
