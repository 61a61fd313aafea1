"""step_mfu.decode: the window's least time over its length (host clock),
in percent.  Least time: each unit of work's model FLOPs at the bf16 peak
or the bytes it must move at 3.35 TB/s, the larger (roofline.Work), summed
over the prefills and decode steps the window completed."""


def read(rec, config):
    if rec.kind != "decode_bs1" or rec.seconds <= 0:
        return None
    return 100.0 * rec.least_s / rec.seconds
