"""PyTorch / CUDA (Hopper) port of the Q-Palette quantized-Llama runtime.

Mirrors the layout of the JAX reference package ``qpalette_tpu`` (ops,
kernels, models, runtime, quant, msq) and keeps its names, so each module
has a counterpart there.  This package imports torch and numpy only.
"""
