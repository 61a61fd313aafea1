"""glue_ms_per_step.decode: device ms a replayed decode step of the ops
that are not the port's GEMV or dequant kernels (norms, RoPE, cache
writes, attention, rotations, the head's casts and products, the
sampler), from the traced slice's replays."""

from qpbench.trace import PORT_DEQUANT, PORT_GEMV


def read(rec, config):
    if rec.kind != "decode_bs1" or rec.slice is None or not rec.slice.ops:
        return None
    ops = rec.slice.after("qpbench.replays")
    glue = sum(d for n, _, d in ops
               if not (PORT_GEMV.search(n) or PORT_DEQUANT.search(n)))
    return glue / 1e3 / rec.traced_steps
