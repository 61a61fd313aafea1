"""serve_tokens_per_s: output tokens the pool produced in the window
(finished requests and those still in a slot) over the window's seconds
(host clock)."""


def read(rec, config):
    if rec.kind != "serve" or rec.seconds <= 0:
        return None
    return rec.tokens / rec.seconds
