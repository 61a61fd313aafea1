"""The yardstick: the card's published peaks, and the operations and bytes
of each unit of work, counted from shapes whatever code performs it.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM, 989
TFLOP/s bf16, 495 TF32, 67 float32, 1979 TOP/s int8.  A call's least
time is the larger of its bytes over the bandwidth and its operations
over the peak of their type; a share of a roofline is that least time
over the measured time.

The whole step's least time (``step_mfu``) counts the model's FLOPs at
the bf16 peak and the bytes that must move: every packed weight word and
row scale once, the embedding rows read, the cache positions attended
(read) and written, and the logits out.  A prefill needs the head at its
last position only.
"""

from __future__ import annotations

from qpbench.reference import decoders
from qpbench.reference.llama import groups, head

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "tfloat32": 495e12,
              "float32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind])


def gemv_bound_s(word_bytes, rows, m, k, x_bytes, a8, exact_kind="float32"):
    """K1/K4/K5 (and K8): packed words and x read once, f32 y written once;
    2*rows*m*k operations in int8 (a8) or else exact_kind."""
    return bound_s(word_bytes + rows * k * x_bytes + rows * m * 4,
                   2 * rows * m * k, "int8" if a8 else exact_kind)


def layer_calls(config: dict) -> list:
    """[(m, k, word bytes, scheme)] of every projection group of every
    layer, each one call to a port's kernel."""
    out = []
    for _ in range(config["model"]["num_hidden_layers"]):
        for _, members, n, sch, _ in groups(config):
            m = sum(r for _, r in members)
            words = decoders.word_shape(sch, m, n)
            out.append((m, n, words[0] * words[1] * 4, sch))
    return out


def gemv_calls(config: dict) -> list:
    """The calls a decode step (N <= 8 rows) sends to the port's GEMV
    kernels: every projection group's, and the head's where it is
    quantized."""
    return layer_calls(config) + head(config).gemv_calls(config)


class Work:
    """Operations and bytes of a configuration's units of work."""

    def __init__(self, config: dict):
        md = config["model"]
        calls = layer_calls(config)
        v, h = md["vocab_size"], md["hidden_size"]
        # the head over the vocabulary (rows padded past it compute nothing)
        self.proj_macs = sum(m * k for m, k, _, _ in calls) + v * h
        self.weight_bytes = (sum(b + 4 * m for m, _, b, _ in calls)
                             + head(config).weight_bytes(config))
        self.layers = md["num_hidden_layers"]
        self.heads, d = md["num_attention_heads"], md["head_dim"]
        self.d = d
        self.kv_row = 2 * md["num_key_value_heads"] * d * 2  # k, v in bf16
        self.head_macs = v * h
        self.vocab, self.hidden = v, h

    def _attn_flops(self, queries_keys: float) -> float:
        # QK^T and PV: 2 * 2 * d flops a (query, key) pair a head a layer
        return 4 * self.d * self.heads * self.layers * queries_keys

    def decode_step(self, pos: int) -> float:
        """Least seconds of a one-row step at position ``pos``."""
        return self.pool_step([pos])

    def pool_step(self, positions: list) -> float:
        """Least seconds of a pool step whose active rows sit at
        ``positions``."""
        rows = len(positions)
        flops = (2 * rows * self.proj_macs
                 + self._attn_flops(sum(p + 1 for p in positions)))
        nbytes = (self.weight_bytes + rows * 2 * self.hidden
                  + self.layers * self.kv_row * sum(p + 2 for p in positions)
                  + rows * self.vocab * 4)
        return bound_s(nbytes, flops, "bfloat16")

    def chunk(self, c: int, p0: int) -> float:
        """Least seconds of an admission chunk of c tokens at position p0
        (no head: admission only writes the cache)."""
        body = self.proj_macs - self.head_macs
        flops = 2 * c * body + self._attn_flops(c * (p0 + (c + 1) / 2))
        nbytes = (self.weight_bytes + c * 2 * self.hidden
                  + self.layers * self.kv_row * (p0 + c))
        return bound_s(nbytes, flops, "bfloat16")

    def prefill(self, s: int) -> float:
        """Least seconds of a prefill of s tokens (the head at the last
        position only)."""
        body = self.proj_macs - self.head_macs
        flops = (2 * s * body + 2 * self.head_macs
                 + self._attn_flops(s * (s + 1) / 2))
        nbytes = (self.weight_bytes + s * 2 * self.hidden
                  + self.layers * self.kv_row * s + self.vocab * 4)
        return bound_s(nbytes, flops, "bfloat16")
