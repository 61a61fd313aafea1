"""The one generator of traffic: a mix's data file -> its requests.

A mix is ``qpbench/traffic/<name>.json``.  Its ``kind`` names the window
that drives it (``kinds/<kind>.py``); the rest are parameters.  The
lengths are a fixed set, the same for every seed: ``count`` quantiles of
the mix's prompt length (``prompt_len``) and output length (``new_len``)
distributions (``log_uniform`` or ``uniform`` over [lo, hi]; a fixed
``new_tokens`` instead of ``new_len``), repeated for ``rounds`` rounds,
each of which the seed puts in another order.  The seed draws the token
ids (uniform over the vocabulary) and each request's sampler seed.  Every
``greedy_every``-th request of that order is greedy (all of them when the
mix does not say); the others sample at the mix's ``sampling``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


@dataclass
class Request:
    index: int
    prompt: np.ndarray  # int64 token ids
    new_tokens: int
    greedy: bool
    sampler_seed: int


def load(name: str, root: Path = ROOT) -> dict:
    path = root / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def lengths(dist: dict, count: int) -> np.ndarray:
    """The count quantiles of a length distribution, as whole numbers."""
    q = (np.arange(count) + 0.5) / count
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "log_uniform":
        vals = lo * (hi / lo) ** q
    elif dist["dist"] == "uniform":
        vals = lo + (hi - lo) * q
    else:
        raise ValueError(f"length distribution {dist['dist']!r}")
    return np.rint(vals).astype(np.int64)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))


def rounds(r: np.random.Generator, values: np.ndarray,
           n: int) -> np.ndarray:
    """n rounds of values, each round in an order of its own: any window
    of whole rounds holds the same work whatever the seed."""
    return np.concatenate([r.permutation(values) for _ in range(n)])


def requests(mix: dict, seed: int, vocab: int) -> list:
    """The requests of a mix for one seed, in their order."""
    r = rng(seed)
    count, n = mix["count"], mix["rounds"]
    lens = rounds(r, lengths(mix["prompt_len"], count), n)
    if "new_len" in mix:
        outs = rounds(r, lengths(mix["new_len"], count), n)
    else:
        outs = np.full(len(lens), mix["new_tokens"])
    every = mix.get("greedy_every", 1)
    return [Request(i, r.integers(0, vocab, int(s), dtype=np.int64), int(o),
                    i % every == 0, int(r.integers(0, 1 << 62)))
            for i, (s, o) in enumerate(zip(lens, outs))]
