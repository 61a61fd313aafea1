"""Continuous-batching decode engine.

Counterpart of ``qpalette_tpu/runtime/serving.py``: a fixed pool of batch
slots, each with its own KV-cache position, admitting new requests as
slots free up.  The reference runs the pool's step as one jit over the
whole pool with per-slot positions, and a burst of n steps as one
``lax.scan``.  Here the pool step is a ``PoolStep``: on a CUDA device it
is captured once in a CUDA graph over static buffers (tokens, positions,
the active mask, the caches, the last logits, a per-row token history)
and a burst of n steps is n replays of it with one read-back.  On the CPU
the same step runs eagerly.  A capture that fails raises: there is no
eager fallback on the card.  Admission (``prefill_slots``) runs eagerly,
as ``decode.prefill`` does: one forward over the admitted slots' cache
rows, gathered and scattered back, with no graph per admission shape.

Sampled streams differ from the reference's: it splits a key a step, the
pool draws from one ``torch.Generator`` registered with the graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from qpalette_tpu_torch.kernels import launch_counts
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.runtime.decode import sample_logits


class PoolStep:
    """The pool's decode step over static buffers: ``token`` (B, 1) int64
    at ``pos`` (B,) int64, one position a row, with ``active`` (B,) bool
    -> the step's last-position ``logits`` (B, vocab) float32, the next
    token in ``token`` (0 in inactive rows) and in ``history[b, pos[b] +
    1]`` ((B, T + 1) int64), and every row's ``pos + 1``.  It owns its
    ``caches`` (T positions) and its sampler's ``generator``.

    On a CUDA device one eager step on a side stream warms up, then the
    step is captured in a CUDA graph with the generator registered
    (``launches``: the kernel launches the capture recorded, by wrapper).
    ``replay(n)`` launches the graph n times; on the CPU it runs the same
    step eagerly.  The caller keeps every row's pos + n within T - 1."""

    def __init__(self, spec, params, n_slots: int, max_seq: int,
                 temperature: float, top_k: Optional[int]):
        device = params["embed"].device
        self.spec, self.params = spec, params
        self.temperature, self.top_k = temperature, top_k
        self.n_slots, self.max_seq = n_slots, max_seq
        self.caches = llama.init_kv_caches(spec, n_slots, max_seq, device)
        self.token = torch.zeros((n_slots, 1), dtype=torch.int64,
                                 device=device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int64, device=device)
        self.active = torch.zeros((n_slots,), dtype=torch.bool,
                                  device=device)
        self.logits = torch.zeros((n_slots, spec.config.vocab_size),
                                  dtype=torch.float32, device=device)
        self.history = torch.zeros((n_slots, max_seq + 1),
                                   dtype=torch.int64, device=device)
        self.generator = torch.Generator(device=device)
        self.graph = None
        self.launches = {}
        self.owner = None  # the ContinuousBatcher that drives it
        if device.type == "cuda":
            self._capture(device)

    @torch.inference_mode()
    def step_eager(self):
        """One step, eagerly (what the graph replays)."""
        logits, _ = llama.forward(self.spec, self.params, self.token,
                                  kv_caches=self.caches, cache_pos=self.pos)
        self.logits.copy_(logits[:, -1])
        nxt = sample_logits(self.logits, self.generator, self.temperature,
                            self.top_k)
        nxt = torch.where(self.active, nxt, torch.zeros_like(nxt))
        self.history.scatter_(1, (self.pos + 1)[:, None], nxt[:, None])
        self.token.copy_(nxt[:, None])
        self.pos.add_(1)

    def _capture(self, device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        state = self.generator.get_state()
        with torch.cuda.stream(side):
            self.step_eager()
        torch.cuda.current_stream(device).wait_stream(side)
        self.generator.set_state(state)
        self.load(np.zeros((self.n_slots, 1), np.int64),
                  np.zeros(self.n_slots, np.int64),
                  np.zeros(self.n_slots, bool))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        with torch.cuda.graph(graph):
            self.step_eager()
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        self.graph = graph

    def load(self, tokens: np.ndarray, positions: np.ndarray,
             active: np.ndarray):
        """Set the step's inputs from the host: tokens (B, 1), positions
        (B,), active (B,)."""
        self.token.copy_(torch.as_tensor(tokens, dtype=torch.int64))
        self.pos.copy_(torch.as_tensor(positions, dtype=torch.int64))
        self.active.copy_(torch.as_tensor(active, dtype=torch.bool))

    def replay(self, n: int = 1):
        """n steps: n graph replays on the card, n eager steps on the CPU."""
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.step_eager()

    def read(self, positions: np.ndarray, n: int) -> np.ndarray:
        """The n tokens each row sampled after its start position: (B, n)
        int64, in one read-back."""
        cols = (torch.as_tensor(positions, dtype=torch.int64)[:, None]
                + torch.arange(1, n + 1)).to(self.history.device)
        return torch.gather(self.history, 1, cols).cpu().numpy()


_POOLS: dict = {}


def pool_step(spec, params, n_slots: int, max_seq: int,
              temperature: float = 0.6,
              top_k: Optional[int] = 5) -> PoolStep:
    """The PoolStep of these static arguments, made (and on a CUDA device
    captured) at first use, as ``decode.captured_step``.  A pool keeps its
    model alive: ``release_pools`` drops it."""
    key = (id(params), spec, n_slots, max_seq, temperature, top_k)
    pool = _POOLS.get(key)
    if pool is None:
        pool = _POOLS[key] = PoolStep(spec, params, n_slots, max_seq,
                                      temperature, top_k)
    return pool


def release_pools(params):
    """Drop the pools of params: their graphs, caches and buffers."""
    for key in [k for k in _POOLS if k[0] == id(params)]:
        del _POOLS[key]


@torch.inference_mode()
def prefill_slots(spec, params, caches, slots: torch.Tensor,
                  tokens: torch.Tensor, pos0: torch.Tensor):
    """Batched admission: several slots' prompt chunks in one forward.

    slots (B',) int64; tokens (B', C); pos0 (B',) each slot's start
    position.  The slots' cache rows are gathered, run through one
    forward (``return_hidden``: admission needs only the KV writes, not
    the head) and scattered back into caches in place; the other rows are
    not touched."""
    sliced = [tuple(c.index_select(0, slots) for c in kv) for kv in caches]
    _, new = llama.forward(spec, params, tokens, kv_caches=sliced,
                           cache_pos=pos0, return_hidden=True)
    for kv, kvn in zip(caches, new):
        for c, cn in zip(kv, kvn):
            c.index_copy_(0, slots, cn)
    return caches


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-pool scheduler: submit() requests, step() the pool, run() to
    completion; finished requests in ``finished`` by request id.  It
    drives the pool of its static arguments (``pool_step``); a later
    batcher on the same pool takes it over, and this one then raises."""

    def __init__(self, spec, params, n_slots: int = 4, max_seq: int = 512,
                 temperature: float = 0.6, top_k: Optional[int] = 5,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefill_chunk: int = 256):
        self.spec, self.params = spec, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.prefill_chunk = prefill_chunk
        self.temperature, self.top_k = temperature, top_k
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.pool = pool_step(spec, params, n_slots, max_seq, temperature,
                              top_k)
        self.pool.owner = self
        self.pool.generator.manual_seed(seed)
        self.positions = np.zeros((n_slots,), np.int64)
        self.cur = np.zeros((n_slots, 1), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    @property
    def caches(self):
        return self.pool.caches

    def _own(self):
        if self.pool.owner is not self:
            raise RuntimeError("another ContinuousBatcher took over this "
                               "batcher's pool")

    def submit(self, prompt: List[int], max_new_tokens: int = 64) -> int:
        if not 1 <= len(prompt) <= self.max_seq:
            # the cache rows are written in place: a prompt past the cache
            # would write out of bounds
            raise ValueError(f"a prompt of {len(prompt)} tokens does not fit "
                             f"a {self.max_seq}-position cache")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def _admit(self) -> int:
        """Assign waiting requests to free slots, then prefill their prompt
        contexts in chunk rounds: within a round, the chunks of equal
        length go through one prefill_slots forward.  Returns the number
        of requests admitted."""
        self._own()
        admitted = []
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                self.slot_req[slot] = self.queue.pop(0)
                self.positions[slot] = 0
                admitted.append(slot)
        if not admitted:
            return 0
        C = self.prefill_chunk
        chunks = {}  # slot -> [(tokens, pos)]
        for slot in admitted:
            req = self.slot_req[slot]
            ctx = req.prompt[:-1]
            lst = []
            pos = 0
            for c0 in range(0, (len(ctx) // C) * C, C):
                lst.append((ctx[c0:c0 + C], pos))
                pos += C
            tail = ctx[(len(ctx) // C) * C:]
            if tail:
                lst.append((tail, pos))
                pos += len(tail)
            chunks[slot] = lst
            self.positions[slot] = pos
            self.cur[slot, 0] = req.prompt[-1]
        rounds = max(len(v) for v in chunks.values())
        for r in range(rounds):
            by_len: Dict[int, List[int]] = {}
            for slot, lst in chunks.items():
                if r < len(lst):
                    by_len.setdefault(len(lst[r][0]), []).append(slot)
            for slots in by_len.values():
                toks = np.array([chunks[s][r][0] for s in slots], np.int64)
                pos0 = np.array([chunks[s][r][1] for s in slots], np.int64)
                prefill_slots(self.spec, self.params, self.caches,
                              torch.as_tensor(slots, device=self.device),
                              torch.as_tensor(toks, device=self.device),
                              torch.as_tensor(pos0, device=self.device))
        return len(admitted)

    def _decode(self, n: int) -> np.ndarray:
        """n pool steps from the host's tokens and positions: (B, n)
        tokens."""
        self._own()
        active = np.array([r is not None for r in self.slot_req])
        self.pool.load(self.cur, self.positions, active)
        self.pool.replay(n)
        return self.pool.read(self.positions, n)

    def _finish(self, slot: int, req: Request, eos_hit: bool):
        full = self.positions[slot] + 1 >= self.max_seq
        if len(req.output) >= req.max_new_tokens or full or eos_hit:
            req.done = True
            self.finished[req.rid] = req
            self.slot_req[slot] = None
            self.positions[slot] = 0

    def step(self):
        """One decode step across all active slots."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return False
        nxt = self._decode(1)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.positions[slot] += 1
            tok = int(nxt[slot, 0])
            req.output.append(tok)
            self.cur[slot, 0] = tok
            self._finish(slot, req, self.eos_id is not None
                         and tok == self.eos_id)
        return True

    def step_burst(self, n: int):
        """n decode steps with no admission in between: n replays and one
        read-back."""
        toks = self._decode(n)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.positions[slot] += n
            row = toks[slot].tolist()
            req.output.extend(row)
            self.cur[slot, 0] = row[-1]
            eos_hit = self.eos_id is not None and self.eos_id in row
            if eos_hit:
                cut = row.index(self.eos_id) + 1
                req.output = req.output[: len(req.output) - n + cut]
            self._finish(slot, req, eos_hit)

    def run(self, max_steps: int = 10000, burst: int = 16):
        """Drive to completion.  burst > 1 uses multi-step scheduling:
        between admissions, up to ``burst`` tokens decode in one burst
        (bounded by the least remaining budget and cache room, so nothing
        overshoots; EOS inside a burst trims the output after it)."""
        steps = 0
        while (any(r is not None for r in self.slot_req) or self.queue) \
                and steps < max_steps:
            self._admit()
            rem = [r.max_new_tokens - len(r.output)
                   for r in self.slot_req if r is not None]
            room = [self.max_seq - 1 - self.positions[s]
                    for s, r in enumerate(self.slot_req) if r is not None]
            n = min([burst] + rem + room) if rem else 0
            if n >= 2:
                self.step_burst(n)
            else:
                self.step()
            steps += 1
        return self.finished
