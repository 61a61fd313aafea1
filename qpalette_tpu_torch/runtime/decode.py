"""Decode engine: prefill, the single-token step, generation, sampling.

Counterpart of ``qpalette_tpu/runtime/decode.py``, whose step
(``decode_step``) and whole loop (``generate_scan``, one ``lax.scan``)
are each one compiled program.  Here the step is a ``CapturedStep``: on a
CUDA device it is captured once in a CUDA graph, and each token is one
replay of it, with the token, the cache position and the caches in static
device buffers that the graph itself advances.  On the CPU (a rehearsal)
the same step runs eagerly.  A capture that fails raises: there is no
eager fallback on the card.  Sampling draws its noise from an explicit
``torch.Generator``, registered with the graph.  Prefill runs eagerly.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from qpalette_tpu_torch.kernels import launch_counts
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


def decode_step(spec, params, tokens: torch.Tensor, kv_caches, cache_pos,
                generator: torch.Generator, temperature: float = 0.6,
                top_k: Optional[int] = 5):
    """tokens (B, 1) at cache_pos (int, 0-d or (B,) tensor) -> (next
    (B, 1), caches), eagerly."""
    logits, kv_caches = llama.forward(spec, params, tokens,
                                      kv_caches=kv_caches,
                                      cache_pos=cache_pos)
    nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
    return nxt[:, None], kv_caches


class CapturedStep:
    """The decode step over static buffers: ``token`` (B, 1) at ``pos``
    (0-d int64) -> the step's last-position ``logits`` (B, vocab) float32,
    the next token in ``token`` and in ``history[:, pos + 1]`` ((B, T + 1)
    int64, indexed by position), and ``pos + 1``.  It owns its ``caches``
    (T positions) and its sampler's ``generator``.

    On a CUDA device one eager step on a side stream warms up (builds the
    kernels' libraries, fills the rotations' factor cache, sets kernel
    attributes), then the step is captured in a CUDA graph with the
    generator registered; ``launches`` holds the kernel launches the
    capture recorded, by wrapper.  ``replay(n)`` launches the graph n
    times (one dispatch a token, nothing read back); on the CPU it runs
    the same step eagerly."""

    def __init__(self, spec, params, batch: int, max_seq: int,
                 temperature: float, top_k: Optional[int],
                 quantized_kv: bool = False):
        device = params["embed"].device
        self.spec, self.params = spec, params
        self.temperature, self.top_k = temperature, top_k
        self.max_seq = max_seq
        self.caches = llama.init_kv_caches(spec, batch, max_seq, device,
                                           quantized=quantized_kv)
        self.token = torch.zeros((batch, 1), dtype=torch.int64,
                                 device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.logits = torch.zeros((batch, spec.config.vocab_size),
                                  dtype=torch.float32, device=device)
        self.history = torch.zeros((batch, max_seq + 1), dtype=torch.int64,
                                   device=device)
        self.generator = torch.Generator(device=device)
        self.host_pos = 0  # the host's copy of pos, for bounds
        self.graph = None
        self.launches = {}
        if device.type == "cuda":
            self._capture(device)

    @torch.inference_mode()
    def _step(self):
        logits, _ = llama.forward(self.spec, self.params, self.token,
                                  kv_caches=self.caches,
                                  cache_pos=self.pos)
        self.logits.copy_(logits[:, -1])
        nxt = sample_logits(self.logits, self.generator, self.temperature,
                            self.top_k)[:, None]
        self.history.index_copy_(1, (self.pos + 1)[None], nxt)
        self.token.copy_(nxt)
        self.pos.add_(1)

    def _capture(self, device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        state = self.generator.get_state()
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.generator.set_state(state)
        self.reset(torch.zeros_like(self.token), 0)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        with torch.cuda.graph(graph):
            self._step()
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        self.graph = graph

    def reset(self, token: torch.Tensor, pos: int):
        """Set the step's input: token (B, 1) at position pos."""
        self.token.copy_(token)
        self.pos.fill_(pos)
        self.host_pos = pos

    def replay(self, n: int = 1):
        """n steps: n graph replays on the card, n eager steps on the CPU."""
        if self.host_pos + n > self.max_seq:
            raise ValueError(f"{n} steps from position {self.host_pos} "
                             f"overrun the {self.max_seq}-position cache")
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
        self.host_pos += n


_CAPTURED: dict = {}


def captured_step(spec, params, batch: int, max_seq: int,
                  temperature: float = 0.6, top_k: Optional[int] = 5,
                  quantized_kv: bool = False) -> CapturedStep:
    """The CapturedStep of these static arguments, made (and on a CUDA
    device captured) at first use, as the reference's jit keeps one
    program per static argument set.  A step keeps its model alive:
    ``release_captured`` drops it."""
    key = (id(params), spec, batch, max_seq, temperature, top_k,
           quantized_kv)
    step = _CAPTURED.get(key)
    if step is None:
        step = _CAPTURED[key] = CapturedStep(spec, params, batch, max_seq,
                                             temperature, top_k,
                                             quantized_kv)
    return step


def release_captured(params):
    """Drop the captured steps of params: their graphs, caches and
    buffers."""
    for key in [k for k in _CAPTURED if k[0] == id(params)]:
        del _CAPTURED[key]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_scan(spec, params, first_token: torch.Tensor, caches,
                  start_pos: int, generator: torch.Generator, n_tokens: int,
                  temperature: float = 0.6, top_k: Optional[int] = 5):
    """The decode loop: n_tokens replays of the captured step from
    first_token (B, 1) at start_pos, nothing read back until one
    synchronize at the end.  Returns (tokens (B, n_tokens), caches).

    caches other than the step's own are copied into it first; the caches
    returned are the step's.  generator's state is handed to the step's
    generator and back, so it advances as if it had sampled."""
    B, T = first_token.shape[0], caches[0][0].shape[1]
    step = captured_step(spec, params, B, T, temperature, top_k,
                         quantized_kv=len(caches[0]) == 4)
    if caches is not step.caches:
        for mine, theirs in zip(step.caches, caches):
            for a, b in zip(mine, theirs):
                a.copy_(b)
    if generator is not step.generator:
        step.generator.set_state(generator.get_state())
    step.reset(first_token, start_pos)
    step.replay(n_tokens)
    if generator is not step.generator:
        generator.set_state(step.generator.get_state())
    toks = step.history[:, start_pos + 1:start_pos + 1 + n_tokens].clone()
    _sync(toks.device)
    return toks, step.caches


def _start(spec, params, prompt: np.ndarray, max_new_tokens: int,
           max_seq: Optional[int], temperature: float, top_k: Optional[int],
           seed: int):
    """The captured step of this generation, its caches prefilled with
    prompt (B, S) and its generator seeded; the first token (B, 1)
    sampled from the prefill's last logits."""
    device = params["embed"].device
    B, S = prompt.shape
    step = captured_step(spec, params, B, max_seq or (S + max_new_tokens),
                         temperature, top_k)
    step.generator.manual_seed(seed)
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    logits, _ = prefill(spec, params, tokens, step.caches)
    cur = sample_logits(logits[:, -1], step.generator, temperature,
                        top_k)[:, None]
    return step, cur


def _seq(prompt, cur, toks) -> np.ndarray:
    return np.concatenate([np.asarray(prompt), cur.cpu().numpy(),
                           toks.cpu().numpy()], axis=1)


def generate(spec, params, prompt: np.ndarray, max_new_tokens: int,
             max_seq: Optional[int] = None, temperature: float = 0.6,
             top_k: Optional[int] = 5, seed: int = 1234):
    """Sampled (or greedy at temperature 0) generation; prompt (B, S).
    Returns (tokens (B, S+max_new_tokens), stats).  One replay of the
    captured step a token; tokens/s is timed (host clock, one synchronize
    at the end) over the replays after the first."""
    step, cur = _start(spec, params, prompt, max_new_tokens, max_seq,
                       temperature, top_k, seed)
    S, n = prompt.shape[1], max_new_tokens - 1
    n_warm = min(1, n)
    warm, _ = generate_scan(spec, params, cur, step.caches, S,
                            step.generator, n_warm, temperature, top_k)
    t0 = time.perf_counter()
    toks, _ = generate_scan(spec, params, step.token, step.caches,
                            S + n_warm, step.generator, n - n_warm,
                            temperature, top_k)
    dt = time.perf_counter() - t0
    n_timed = n - n_warm
    tps = n_timed * prompt.shape[0] / dt if n_timed else float("nan")
    return _seq(prompt, cur, torch.cat([warm, toks], dim=1)), {
        "tokens_per_sec": tps, "decode_time_s": dt, "timed_tokens": n_timed,
        "device": str(cur.device), "captured": step.graph is not None}


def generate_fast(spec, params, prompt: np.ndarray, max_new_tokens: int,
                  max_seq: Optional[int] = None, temperature: float = 0.6,
                  top_k: Optional[int] = 5, seed: int = 1234):
    """generate through generate_scan, as the reference: a first call
    (capture on first use, warm-up) and a second, identical call from
    the same caches, position and generator state, which is timed."""
    step, cur = _start(spec, params, prompt, max_new_tokens, max_seq,
                       temperature, top_k, seed)
    S, n = prompt.shape[1], max_new_tokens - 1
    state = step.generator.get_state()
    toks, _ = generate_scan(spec, params, cur, step.caches, S,
                            step.generator, n, temperature, top_k)
    step.generator.set_state(state)
    t0 = time.perf_counter()
    toks, _ = generate_scan(spec, params, cur, step.caches, S,
                            step.generator, n, temperature, top_k)
    dt = time.perf_counter() - t0
    return _seq(prompt, cur, toks), {
        "tokens_per_sec": n * prompt.shape[0] / dt, "decode_time_s": dt,
        "timed_tokens": n, "untimed_calls": 1, "device": str(cur.device),
        "captured": step.graph is not None}


def model_bytes(params) -> int:
    """Total bytes of every tensor in a nested params dict/list."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(model_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(model_bytes(v) for v in params)
    return 0
