"""gemv_roofline.decode: the decode GEMVs' least time over their device
time in the traced replays, in percent.  Least time: each call's packed
words, x and f32 y at 3.35 TB/s, or its 2 m k operations at the peak of
its type (int8 under a8, else float32), summed over the configuration's
calls a step.  Nothing is read when the traced GEMV launches a step are
not the configuration's calls."""

import sys

from qpbench import roofline
from qpbench.trace import PORT_GEMV


def read(rec, config):
    if rec.kind != "decode_bs1" or rec.slice is None or not rec.slice.ops:
        return None
    ops = [d for n, _, d in rec.slice.after("qpbench.replays")
           if PORT_GEMV.search(n)]
    calls = roofline.gemv_calls(config)
    if len(ops) != len(calls) * rec.traced_steps:
        print(f"gemv_roofline.decode: {len(ops) / rec.traced_steps} GEMV "
              f"launches a step traced, {len(calls)} calls expected",
              file=sys.stderr)
        return None
    a8 = config["quantization"]["impl"] == "a8"
    least = sum(roofline.gemv_bound_s(b, 1, m, k, sch["codec"].X_BYTES, a8)
                for m, k, b, sch in calls)
    return 100.0 * least / (sum(ops) / 1e6 / rec.traced_steps)
