"""admit_share.serve: host time inside the batcher's ``_admit`` (to a
synchronize, in passes that admitted) over the window's seconds, in
percent."""


def read(rec, config):
    if rec.kind != "serve" or rec.seconds <= 0:
        return None
    return 100.0 * rec.admit_s / rec.seconds
