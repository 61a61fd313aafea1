"""The comparison that decides ``correct``: served tokens against the plain
reference, teacher-forced.

The reference runs each checked request's prompt with its served tokens
once, whole, and reads its logits at every position that served a
token.  A token's gap is how far its reference logit lies below the
reference's k-th best there, or 0 where it is among the k best: k = 1 for
a greedy request (the widest gap by which a served token lies below the
reference's best), k = the sampler's top-k for a sampled one (a sampled
token has to be among the reference's top k, up to rounding).

The control, the reference one precision step lower in the program's
place, serves its own tokens at the same positions: a greedy request the
token it puts first, a sampled one a token it draws from its own top k
at the request's temperature (Gumbel-max, a generator seeded from the
run's seed).  Their gaps are read the same way.

Each kind (``kinds/<kind>.py``) says which numbers it compares; their
limits are in ``qpbench/limits/<cell>.json``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from qpbench.reference.llama import Reference

ROOT = Path(__file__).resolve().parent


@dataclass
class Served:
    """One checked request: its prompt and served ids, and how it sampled
    (temperature 0: greedy)."""
    prompt: np.ndarray
    tokens: np.ndarray
    temperature: float = 0.0
    top_k: int = None

    @property
    def k(self) -> int:
        return 1 if self.temperature == 0.0 else self.top_k


def limits(cell: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "limits" / f"{cell}.json").read_text())


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _gap(lg: torch.Tensor, pick: torch.Tensor, k: int) -> torch.Tensor:
    """(P,) gaps of the picked tokens below the k-th best of lg (P, vocab),
    0 within the k best."""
    kth = torch.topk(lg, k, dim=-1).values[:, -1]
    return (kth - lg.gather(1, pick[:, None])[:, 0]).clamp(min=0.0)


def _control_picks(lg: torch.Tensor, s: Served,
                   gen: torch.Generator) -> torch.Tensor:
    if s.temperature == 0.0:
        return lg.argmax(-1)
    vals, idx = torch.topk(lg / s.temperature, s.top_k, dim=-1)
    e = torch.empty(vals.shape, device=vals.device).exponential_(
        generator=gen)
    return idx.gather(1, (vals - torch.log(e)).argmax(-1)[:, None])[:, 0]


def gaps(config, draws, served: list, control=None, seed: int = 0) -> list:
    """served: [Served].  The gaps (a tensor a request) of the served
    tokens; with control, of the tokens the control serves at the same
    positions (the reference runs twice)."""
    dev = draws.device
    seqs = [_ids(np.concatenate([s.prompt, s.tokens[:-1]]), dev)
            for s in served]
    ref = Reference(config, draws)
    hid = ref.hidden(seqs)
    if control is None:
        picks = [_ids(s.tokens, dev) for s in served]
    else:
        low = Reference(config, draws, control=control)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (1 << 63))
        picks = [_control_picks(low.logits(h[len(s.prompt) - 1:]), s, gen)
                 for s, h in zip(served, low.hidden(seqs))]
    return [_gap(ref.logits(h[len(s.prompt) - 1:]), pick, s.k)
            for s, h, pick in zip(served, hid, picks)]
