"""idle_share.decode: the share of the traced slice's window (host clock,
ending in a synchronize) in which no device op ran, in percent."""


def read(rec, config):
    if rec.kind != "decode_bs1" or rec.slice is None or not rec.slice.ops:
        return None
    return 100.0 * (1.0 - rec.slice.busy_s / rec.slice.window_s)
