"""Full float32 products on the card, whatever the caller's TF32 setting.

The quantizers' distances (Viterbi, k-means, LDLQ's feedback) compare
float32 sums whose near-ties decide codes; TF32 would round their
operands to 10 mantissa bits."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Turn TF32 matmuls off inside the block and restore the caller's
    setting after it."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
