"""itl_p95_ms.decode: the 95th percentile of every gap between consecutive
output tokens of every request in the window, from the CUDA events after
the first token and after each replay."""

from qpbench.drive import percentile


def read(rec, config):
    if rec.kind != "decode_bs1" or not rec.gaps_ms:
        return None
    return percentile(rec.gaps_ms, 95)
