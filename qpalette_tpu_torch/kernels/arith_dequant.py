"""Arithmetic trellis dequant (K2, K3): the hand-written CUDA kernels and
their plain PyTorch version.

  tcq2_dequant  replaces qpalette_tpu/kernels/fused.py::_tcq2_dequant_kernel
                (K2, modes sum2 and dualmad, V=2)
  tcq1_dequant  replaces fused.py::_tcq1_dequant_kernel
                (K3, modes 1mad and 2mad, V=1)

Both (``csrc/arith_dequant.cu``) read the canonical trellis and write
W_hat (m, k) bf16 in natural order: each weight's integer value times
1/147.800537109375 in float32, rounded to bf16, as the TPU kernels'
output is.  They serve impl ``exact`` above 256 rows, where the product
with the activations follows (``runtime/qlinear.py``), and impl
``dequant``, which takes every KV from 1 to 16 (``DEQUANT_KV``; the
palette's KVs have a kernel instance each, any other the instance that
reads its KV at run time).  On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches its kernel
(counted in ``<wrapper>.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qpalette_tpu_torch.kernels import _build
from qpalette_tpu_torch.kernels.arith import (PLAIN_ROWS, MAD_INV,
                                              SUPPORTED_KV, arith_weights_mat,
                                              check_trellis)
from qpalette_tpu_torch.ops.packing import TD

SOURCE = "arith_dequant"  # csrc/arith_dequant.cu
_C_MODE = {"sum2": 0, "dualmad": 1, "1mad": 0, "2mad": 1}
# the KVs of each mode the kernels take (csrc kMaxKV: the 16-bit state)
DEQUANT_KV = {mode: tuple(range(1, 17)) for mode in SUPPORTED_KV}

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {fn: [_P, _P, _I, _I, _I, _I, _P]  # csrc/arith_dequant.cu
              for fn in ("tcq2_dequant", "tcq1_dequant")}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def arith_dequant_plain(trellis: torch.Tensor, mode: str, KV: int, m: int,
                        k: int) -> torch.Tensor:
    """W_hat (m, k) bf16: float32(w) * float32(1/147.8005...), rounded."""
    inv = torch.tensor(MAD_INV, dtype=torch.float32, device=trellis.device)
    kt = k // TD
    out = torch.empty((m, k), dtype=torch.bfloat16, device=trellis.device)
    for r0 in range(0, m, PLAIN_ROWS):
        r1 = min(m, r0 + PLAIN_ROWS)
        w = arith_weights_mat(trellis[(r0 // TD) * kt:(r1 // TD) * kt],
                              mode, KV, r1 - r0, k)
        out[r0:r1] = (w.to(torch.float32) * inv).to(torch.bfloat16)
    return out


def _dequant(wrapper, fn_name, trellis, mode, KV, m, k, out):
    dev = trellis.device
    check_trellis(trellis, mode, KV, m, k, dev, DEQUANT_KV)
    if out is not None and (out.dtype != torch.bfloat16
                            or tuple(out.shape) != (m, k)
                            or out.device != dev or not out.is_contiguous()
                            or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous 16-byte aligned "
                         f"bfloat16 ({m}, {k}) tensor on {dev}")
    if dev.type == "cpu":
        w = arith_dequant_plain(trellis, mode, KV, m, k)
        if out is None:
            return w
        out.copy_(w)
        return out
    if out is None:
        out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    _build.launch(_lib(), fn_name, dev, trellis.data_ptr(), out.data_ptr(), m,
                  k, KV, _C_MODE[mode])
    wrapper.launches += 1
    return out


def tcq2_dequant(trellis: torch.Tensor, KV: int, m: int, k: int, mode: str,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: V=2 trellis (T, 4*KV) in mode sum2 or dualmad -> W_hat (m, k)
    bf16, natural order."""
    if mode not in ("sum2", "dualmad"):
        raise ValueError(f"tcq2 mode {mode!r}")
    return _dequant(tcq2_dequant, "tcq2_dequant", trellis, mode, KV, m, k,
                    out)


def tcq1_dequant(trellis: torch.Tensor, KV: int, m: int, k: int, mode: str,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: V=1 trellis (T, 8*KV) in mode 1mad or 2mad -> W_hat (m, k)
    bf16, natural order."""
    if mode not in ("1mad", "2mad"):
        raise ValueError(f"tcq1 mode {mode!r}")
    return _dequant(tcq1_dequant, "tcq1_dequant", trellis, mode, KV, m, k,
                    out)


def dequant(mode: str, trellis, KV, m, k, out=None) -> torch.Tensor:
    """The K2 / K3 wrapper of a decode mode."""
    if mode in ("sum2", "dualmad"):
        return tcq2_dequant(trellis, KV, m, k, mode, out)
    return tcq1_dequant(trellis, KV, m, k, mode, out)


KERNELS = (tcq2_dequant, tcq1_dequant)
for _fn in KERNELS:
    _fn.launches = 0
