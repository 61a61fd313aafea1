"""prefill_ms.decode: the median host time of a request's
``decode.prefill`` and first sample, to a synchronize, over the
window's requests."""

import statistics


def read(rec, config):
    if rec.kind != "decode_bs1" or not rec.prefill_s:
        return None
    return statistics.median(rec.prefill_s) * 1e3
