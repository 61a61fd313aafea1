"""step_mfu.serve: the window's least time over its length (host clock),
in percent.  Least time: each admission chunk's and each pool step's
model FLOPs at the bf16 peak or the bytes it must move at 3.35 TB/s, the
larger (roofline.Work), summed over the window."""


def read(rec, config):
    if rec.kind != "serve" or rec.seconds <= 0:
        return None
    return 100.0 * rec.least_s / rec.seconds
