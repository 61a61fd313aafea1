"""Decode engine: prefill, single-token step, generation loop, sampling.

Counterpart of ``qpalette_tpu/runtime/decode.py``.  PyTorch runs eagerly:
``generate_fast`` is a plain loop here (capturing the step in a CUDA
graph is later work).  Sampling draws its noise from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from qpalette_tpu_torch.models import llama


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_k: Optional[int]) -> torch.Tensor:
    """logits (B, vocab) -> token ids (B,) int64.  Temperature 0 is argmax;
    otherwise the Gumbel-max trick, among the exact top-k when top_k is
    set (the reference uses an approximate top-k on large vocabularies)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(temperature, 1e-5)
    idx = None
    if top_k is not None:
        logits, idx = torch.topk(logits, top_k, dim=-1)
    # Gumbel noise -log(E), E ~ Exp(1)
    e = torch.empty_like(logits).exponential_(generator=generator)
    choice = torch.argmax(logits - torch.log(e), dim=-1)
    if idx is None:
        return choice
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def prefill(spec, params, tokens: torch.Tensor, kv_caches):
    return llama.forward(spec, params, tokens, kv_caches=kv_caches,
                         cache_pos=0)


def decode_step(spec, params, tokens: torch.Tensor, kv_caches,
                cache_pos: int, generator: torch.Generator,
                temperature: float = 0.6, top_k: Optional[int] = 5):
    """tokens (B, 1) at cache_pos -> (next (B, 1), caches)."""
    logits, kv_caches = llama.forward(spec, params, tokens,
                                      kv_caches=kv_caches,
                                      cache_pos=cache_pos)
    nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
    return nxt[:, None], kv_caches


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generate(spec, params, prompt: np.ndarray, max_new_tokens: int,
              max_seq: Optional[int], temperature: float,
              top_k: Optional[int], seed: int, n_untimed: int):
    """Prefill, then max_new_tokens - 1 decode steps; the first n_untimed
    steps are warm-up, the rest are timed (host clock, synchronized)."""
    device = params["embed"].device
    B, S = prompt.shape
    T = max_seq or (S + max_new_tokens)
    caches = llama.init_kv_caches(spec, B, T, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    logits, caches = prefill(spec, params, tokens, caches)
    cur = sample_logits(logits[:, -1], gen, temperature, top_k)[:, None]
    outs = [cur]
    pos = S
    n_steps = max_new_tokens - 1
    for _ in range(min(n_untimed, n_steps)):
        cur, caches = decode_step(spec, params, cur, caches, pos, gen,
                                  temperature, top_k)
        outs.append(cur)
        pos += 1
    _sync(device)
    t0 = time.perf_counter()
    n_timed = 0
    for _ in range(n_steps - min(n_untimed, n_steps)):
        cur, caches = decode_step(spec, params, cur, caches, pos, gen,
                                  temperature, top_k)
        outs.append(cur)
        pos += 1
        n_timed += 1
    _sync(device)
    dt = time.perf_counter() - t0
    seq = np.concatenate([np.asarray(prompt)]
                         + [o.cpu().numpy() for o in outs], axis=1)
    tps = n_timed * B / dt if n_timed else float("nan")
    return seq, {"tokens_per_sec": tps, "decode_time_s": dt,
                 "timed_tokens": n_timed, "device": str(device)}


def generate(spec, params, prompt: np.ndarray, max_new_tokens: int,
             max_seq: Optional[int] = None, temperature: float = 0.6,
             top_k: Optional[int] = 5, seed: int = 1234):
    """Sampled (or greedy at temperature 0) generation; prompt (B, S).
    Returns (tokens (B, S+max_new_tokens), stats); tokens/s is timed over
    the decode loop after one warm-up step."""
    return _generate(spec, params, prompt, max_new_tokens, max_seq,
                     temperature, top_k, seed, n_untimed=1)


def generate_fast(spec, params, prompt: np.ndarray, max_new_tokens: int,
                  max_seq: Optional[int] = None, temperature: float = 0.6,
                  top_k: Optional[int] = 5, seed: int = 1234):
    """Generation with every decode step timed (the reference's one-dispatch
    scan loop; here a plain eager loop)."""
    return _generate(spec, params, prompt, max_new_tokens, max_seq,
                     temperature, top_k, seed, n_untimed=0)


def model_bytes(params) -> int:
    """Total bytes of every tensor in a nested params dict/list."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(model_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(model_bytes(v) for v in params)
    return 0
