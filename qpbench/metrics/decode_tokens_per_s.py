"""decode_tokens_per_s: output tokens of the requests completed in the
window over the window's seconds (host clock), prefills included."""


def read(rec, config):
    if rec.kind != "decode_bs1" or rec.seconds <= 0:
        return None
    return rec.tokens / rec.seconds
