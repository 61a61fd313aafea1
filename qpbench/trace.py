"""A traced slice of a run: ``torch.profiler`` (CPU and CUDA activities)
around a callable, reduced to device ops, busy time and idle gaps.

busy_s is the union of the device ops' intervals, window_s the host
clock around the slice (it ends in a synchronize).  The breakdown lists
the device ops that took most time, by name, and the longest idle gaps
between device ops, each named by the innermost host op running at the
gap's middle.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch

# the port's kernels by CUDA name: the decode GEMVs (K1, K4/K5, K8, K10
# with its quantize kernel, K11) and the dequants (K2, K3, K6/K7, K9)
PORT_GEMV = re.compile(r"(v1|v2|wide|lut|vq|vq4)_gemv_kernel|wide_x_kernel|"
                       r"i8gemv_kernel|quantize_kernel")
PORT_DEQUANT = re.compile(r"\b(arith_dequant_kernel|v1_dequant_kernel|"
                          r"lut_ring_kernel|vq_dequant_kernel)\b")
TOP = 10


@dataclass
class Slice:
    ops: list = field(default_factory=list)  # (name, start_us, dur_us)
    busy_s: float = 0.0
    window_s: float = 0.0
    marks: dict = field(default_factory=dict)  # name -> host ranges
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def after(self, mark: str) -> list:
        """The device ops that start after the host range ``mark`` began
        (a slice's replays start after a synchronize)."""
        t = self.marks[mark][0][0]
        return [op for op in self.ops if op[1] >= t]


def _innermost(cpu, t):
    best = None
    for name, a, b in cpu:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "nothing traced"


def traced(fn) -> Slice:
    """Run fn() under the profiler and reduce its trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev_type = torch.autograd.DeviceType.CUDA
    ops, cpu, marks = [], [], {}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == dev_type:
            if not e.name.startswith("qpbench."):  # the ranges' GPU mirror
                ops.append((e.name, a, b - a))
        else:
            cpu.append((e.name, a, b))
            if e.name.startswith("qpbench."):
                marks.setdefault(e.name, []).append((a, b))
    out = Slice(ops=ops, window_s=window, marks=marks)
    if not ops:
        return out
    spans = sorted((a, a + d) for _, a, d in ops)
    busy, end, gaps = 0.0, spans[0][0], []
    for a, b in spans:
        if a > end:
            gaps.append((a - end, end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    out.busy_s = busy / 1e6
    by_name = {}
    for n, _, d in ops:
        by_name[n] = by_name.get(n, 0.0) + d
    out.device_ops = [[n[:120], t / 1e6] for n, t in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps.sort(reverse=True)
    out.idle_gaps = [[_innermost(cpu, (a + b) / 2)[:120], g / 1e6]
                     for g, a, b in gaps[:TOP]]
    return out
