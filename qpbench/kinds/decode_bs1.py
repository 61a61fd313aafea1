"""``decode_bs1``: one user, closed loop.

A request is the program's ``decode.prefill`` into a captured step's
caches, the first token sampled from its last logits, then one
``CapturedStep.replay(1)`` a further token; a CUDA event after the first
token and after every replay times the gaps between tokens.  Greedy
requests replay the step captured at temperature 0, the others the step
captured at the mix's sampling; both are captured once, at set-up.  The
next request starts when the tokens of the last one are read back.

The check judges greedy and sampled requests of the window: the greedy
ones' widest gap below the reference's best (``served_gap``), the sampled
ones' widest gap below the reference's top-k (``sampled_gap``).
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from qpbench import check, drive, generate, roofline, trace

TRACE_REPLAYS = 32  # replays a request in a traced slice


class Window:
    def __init__(self, spec, params, config, mix, seed):
        from qpalette_tpu_torch.runtime import decode
        self.decode = decode
        self.spec, self.params, self.mix = spec, params, mix
        self.work = roofline.Work(config)
        self.requests = generate.requests(mix, seed,
                                          config["model"]["vocab_size"])
        samp = mix["sampling"]
        modes = {True: (0.0, None),
                 False: (samp["temperature"], samp["top_k"])}
        self.steps = {g: decode.captured_step(spec, params, 1,
                                              mix["max_seq"], t, k)
                      for g, (t, k) in modes.items()}
        self.marks = drive.Marks(max(r.new_tokens for r in self.requests),
                                 params["embed"].device)
        # every prompt length's prefill once, on both captures
        firsts = {}
        for req in self.requests:
            firsts.setdefault(len(req.prompt), req)
        for i, req in enumerate(firsts.values()):
            self._request(self.steps[i % 2 == 0], req, 3)
        drive.sync()
        self.next = 0
        self.log = []  # a request: (start s, greedy, gap ms, host ms)

    def _prefill(self, step, req):
        """req's prompt into step's caches and its first token: (first
        token (1, 1), host seconds to a synchronize)."""
        t0 = time.perf_counter()
        tokens = torch.as_tensor(req.prompt, device=step.token.device)[None]
        logits, _ = self.decode.prefill(self.spec, self.params, tokens,
                                        step.caches)
        if not req.greedy:
            step.generator.manual_seed(req.sampler_seed)
        cur = self.decode.sample_logits(logits[:, -1], step.generator,
                                        step.temperature, step.top_k)[:, None]
        del logits
        self.marks.mark(0)
        drive.sync()
        return cur, time.perf_counter() - t0

    def _replays(self, step, req, cur, n):
        """The next n - 1 tokens after cur: (the n output ids, gaps in
        ms)."""
        s = len(req.prompt)
        step.reset(cur, s)
        t0 = time.perf_counter()
        with torch.profiler.record_function("qpbench.replays"):
            for j in range(1, n):
                step.replay(1)
                self.marks.mark(j)
        self.host_ms = (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)
        out = torch.cat([cur[0], step.history[0, s + 1:s + n]]).cpu().numpy()
        return out, self.marks.gaps_ms(n)

    def _request(self, step, req, n):
        """Serve req's first n tokens on step: (output ids, prefill s, gaps
        in ms)."""
        cur, prefill_s = self._prefill(step, req)
        out, gaps = self._replays(step, req, cur, n)
        return out, prefill_s, gaps

    def _take(self):
        req = self.requests[self.next % len(self.requests)]
        self.next += 1
        return req

    def window(self, seconds: float) -> drive.Record:
        rec = drive.Record("decode_bs1")
        drive.sync()
        t0 = time.perf_counter()
        while True:
            req = self._take()
            rec.attempted += 1
            n = req.new_tokens
            start = time.perf_counter() - t0
            out, pre, gaps = self._request(self.steps[req.greedy], req, n)
            rec.tokens += n
            rec.prefill_s.append(pre)
            rec.gaps_ms += gaps
            self.log.append((start, "greedy" if req.greedy else "sampled",
                             statistics.median(gaps), self.host_ms))
            s = len(req.prompt)
            rec.least_s += self.work.prefill(s) + sum(
                self.work.decode_step(p) for p in range(s, s + n - 1))
            rec.served.append((req, out))
            if time.perf_counter() - t0 >= seconds:
                break
        rec.seconds = time.perf_counter() - t0
        # the pace of each request: its median gap between tokens on the
        # card, and the host's ms a replay call
        print("[requests] start s, sampling, gap ms, host ms: " + "; ".join(
            f"{t:.1f} {c} {g:.3f} {h:.3f}" for t, c, g, h in self.log),
            file=sys.stderr)
        return rec

    def traced(self, rec: drive.Record) -> None:
        """A traced slice: the first TRACE_REPLAYS replays of the next
        greedy and the next sampled request, each on its capture, after
        their prefills (untraced: a prefill of a length with no
        power-of-two divisor runs its attention in one-row chunks, host
        ops that the profiler would take long to read)."""
        reqs = {}
        while len(reqs) < 2:
            req = self._take()
            reqs.setdefault(req.greedy, req)
        runs = []
        for req in reqs.values():
            step = self.steps[req.greedy]
            n = min(TRACE_REPLAYS + 1, req.new_tokens)
            cur, _ = self._prefill(step, req)
            runs.append((step, req, cur, n))
        rec.slice = trace.traced(lambda: [self._replays(*r) for r in runs])
        rec.traced_steps = sum(n - 1 for *_, n in runs)

    def check_sample(self, rec: drive.Record, seed: int) -> list:
        """Greedy and sampled requests of the window, each kind chosen by
        ``drive.pick`` until ``check_tokens`` served tokens are in."""
        samp = self.mix["sampling"]
        out = []
        for greedy in (True, False):
            done = [(r, o) for r, o in rec.served if r.greedy == greedy]
            for r, o in drive.pick(done, self.mix["check_tokens"], seed):
                out.append(check.Served(
                    r.prompt, o, 0.0 if greedy else samp["temperature"],
                    None if greedy else samp["top_k"]))
        return out


def numbers(config, draws, mix, sample, control=None, seed=0) -> dict:
    """served_gap over the greedy requests, sampled_gap over the sampled
    ones: the widest of their tokens' gaps."""
    gaps = check.gaps(config, draws, sample, control, seed)
    out = {}
    for name, greedy in (("served_gap", True), ("sampled_gap", False)):
        mine = [g for s, g in zip(sample, gaps)
                if (s.temperature == 0.0) == greedy]
        if mine:
            out[name] = float(torch.cat(mine).max())
    return out
