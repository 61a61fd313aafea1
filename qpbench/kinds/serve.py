"""``serve``: ``slots`` users, closed loop, through the program's
``ContinuousBatcher`` at greedy sampling.  Before every scheduler pass the
queue is topped up to ``slots`` outstanding requests, then
``run(max_steps=1, burst=burst)`` makes one pass (an admission of the
requests that fit, then one burst of pool steps).  Admission is timed on
the host by wrapping the batcher's ``_admit`` (with a synchronize after a
pass that admitted).

The check judges finished requests: the mean gap of their tokens below
the reference's best (``served_gap_mean``).  The pool's a8 GEMVs quantize
the x of all its rows under one scale a 512-column chunk, so a single
token's gap swings to within 3x of the control's widest; the mean
separates (PERF.md, section 2).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qpbench import check, drive, generate, roofline, trace


class Window:
    def __init__(self, spec, params, config, mix, seed):
        from qpalette_tpu_torch.runtime.serving import ContinuousBatcher
        self.mix = mix
        self.work = roofline.Work(config)
        self.requests = generate.requests(mix, seed,
                                          config["model"]["vocab_size"])
        self.batcher = ContinuousBatcher(
            spec, params, n_slots=mix["slots"], max_seq=mix["max_seq"],
            temperature=0.0, top_k=None, seed=seed,
            prefill_chunk=mix["prefill_chunk"])
        self.admit_s = 0.0
        self.replays = 0
        self.least_s = 0.0
        self._instrument()
        for req in sorted(self.requests, key=lambda r: -len(r.prompt))[
                :mix["slots"]]:
            self.batcher.submit(list(req.prompt), mix["burst"] + 1)
        self.batcher.run(burst=mix["burst"])
        self.batcher.finished.clear()
        self.next = 0
        self.by_rid = {}

    def _instrument(self):
        b, pool = self.batcher, self.batcher.pool
        admit, replay = b._admit, pool.replay
        work = self.work

        def timed_admit():
            chunks = _admission_chunks(b)
            t0 = time.perf_counter()
            with torch.profiler.record_function("qpbench.admit"):
                n = admit()
                if n:
                    drive.sync()
            if n:
                self.admit_s += time.perf_counter() - t0
                self.least_s += sum(work.chunk(c, p0) for c, p0 in chunks)
            return n

        def counted_replay(n=1):
            rows = [int(p) for p, r in zip(b.positions, b.slot_req)
                    if r is not None]
            self.replays += n
            self.least_s += sum(work.pool_step([p + j for p in rows])
                                for j in range(n))
            return replay(n)
        b._admit = timed_admit
        pool.replay = counted_replay

    def _top_up(self):
        b = self.batcher
        busy = sum(r is not None for r in b.slot_req) + len(b.queue)
        for _ in range(self.mix["slots"] - busy):
            req = self.requests[self.next % len(self.requests)]
            self.next += 1
            self.by_rid[b.submit(list(req.prompt), req.new_tokens)] = req

    def _tokens(self) -> int:
        b = self.batcher
        return (sum(len(r.output) for r in b.finished.values())
                + sum(len(r.output) for r in b.slot_req if r is not None))

    def window(self, seconds: float) -> drive.Record:
        rec = drive.Record("serve")
        self.admit_s = self.least_s = 0.0
        drive.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._top_up()
            self.batcher.run(max_steps=1, burst=self.mix["burst"])
        rec.seconds = time.perf_counter() - t0
        rec.tokens = self._tokens()
        rec.attempted = self.next
        rec.admit_s, rec.least_s = self.admit_s, self.least_s
        return rec

    def traced(self, rec: drive.Record) -> None:
        """A traced slice: ``trace_passes`` scheduler passes."""
        before = self.replays

        def passes():
            for _ in range(self.mix["trace_passes"]):
                self._top_up()
                self.batcher.run(max_steps=1, burst=self.mix["burst"])
        rec.slice = trace.traced(passes)
        rec.traced_steps = self.replays - before

    def check_sample(self, rec: drive.Record, seed: int) -> list:
        """Finished requests, chosen by ``drive.pick`` until
        ``check_tokens`` served tokens are in."""
        done = [(self.by_rid[rid], r.output) for rid, r in
                self.batcher.finished.items() if rid in self.by_rid]
        return [check.Served(r.prompt, np.asarray(o, np.int64))
                for r, o in drive.pick(done, self.mix["check_tokens"], seed)]


def numbers(config, draws, mix, sample, control=None, seed=0) -> dict:
    """served_gap_mean: the mean gap of the served tokens."""
    if not sample:
        return {}
    gaps = check.gaps(config, draws, sample, control, seed)
    return {"served_gap_mean": float(torch.cat(gaps).mean())}


def _admission_chunks(b) -> list:
    """(chunk length, start position) of the prompt chunks the batcher's
    next admission will prefill (its free slots take the queue's head)."""
    free = sum(r is None for r in b.slot_req)
    out = []
    c = b.prefill_chunk
    for req in b.queue[:free]:
        ctx = len(req.prompt) - 1
        out += [(min(c, ctx - p0), p0) for p0 in range(0, ctx, c)]
    return out
