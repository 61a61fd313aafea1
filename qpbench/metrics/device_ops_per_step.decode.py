"""device_ops_per_step.decode: device ops in the profiler's trace a
replayed decode step (the captured launches, kernels and copies)."""



def read(rec, config):
    if rec.kind != "decode_bs1" or rec.slice is None or not rec.slice.ops:
        return None
    return len(rec.slice.after("qpbench.replays")) / rec.traced_steps
