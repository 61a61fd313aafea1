"""What the windows share: the record of a window, CUDA-event timestamps,
and the choice of the requests the check judges.

A window (``kinds/<kind>.py``) runs whole requests until ``seconds`` have
passed, and its length is the host clock from its start to the end of the
last one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from qpbench import generate, trace


@dataclass
class Record:
    kind: str
    seconds: float = 0.0
    setup_s: float = 0.0
    tokens: int = 0
    attempted: int = 0
    failed: int = 0
    least_s: float = 0.0
    gaps_ms: list = field(default_factory=list)
    prefill_s: list = field(default_factory=list)
    served: list = field(default_factory=list)  # (request, output ids)
    admit_s: float = 0.0
    slice: trace.Slice = None
    traced_steps: int = 0  # steps in the traced slice


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Marks:
    """A timestamp a token: CUDA events on the card, the host clock after
    the step on the CPU (a rehearsal)."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t = ([torch.cuda.Event(enable_timing=True) for _ in range(n)]
                  if self.cuda else [0.0] * n)

    def mark(self, j: int) -> None:
        if self.cuda:
            self.t[j].record()
        else:
            self.t[j] = time.perf_counter()

    def gaps_ms(self, n: int) -> list:
        if self.cuda:
            return [self.t[j - 1].elapsed_time(self.t[j])
                    for j in range(1, n)]
        return [(self.t[j] - self.t[j - 1]) * 1e3 for j in range(1, n)]


def pick(done: list, tokens: int, seed: int) -> list:
    """Of done [(request, output ids)]: the one with the longest prompt,
    then others drawn from the seed until ``tokens`` served tokens are
    in."""
    if not done:
        return []
    done = sorted(done, key=lambda ro: -len(ro[0].prompt))
    out, rest = [done[0]], done[1:]
    for i in generate.rng(seed + 1).permutation(len(rest)):
        if sum(len(o) for _, o in out) >= tokens:
            break
        out.append(rest[i])
    return out


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
