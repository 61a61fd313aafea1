"""pool_step_ms.serve: device ms a ``PoolStep`` replay in the traced
slice: the device ops outside the admissions' host ranges (each ends in a
synchronize) over the replays."""


def read(rec, config):
    if rec.kind != "serve" or rec.slice is None or not rec.slice.ops:
        return None
    if not rec.traced_steps:
        return None
    admits = rec.slice.marks.get("qpbench.admit", [])
    pool = sum(d for _, a, d in rec.slice.ops
               if not any(lo <= a <= hi for lo, hi in admits))
    return pool / 1e3 / rec.traced_steps
