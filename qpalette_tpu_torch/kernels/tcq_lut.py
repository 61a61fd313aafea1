"""LUT trellis (quantlut_sym) kernels: the hand-written CUDA kernels and
their plain PyTorch versions.

  tcq_lut_gemv       replaces qpalette_tpu/kernels/fused.py::_tcq_kernel
  tcomb_lut_gemv     replaces fused.py::_tcomb_kernel
  tcq_lut_dequant    replaces fused.py::_tcq_dequant_kernel
  tcomb_lut_dequant  replaces fused.py::_tcomb_dequant_kernel

All four (``csrc/tcq_lut.cu``) read the canonical trellis (T, 4*KV) int32
words and a (2^S, 2) float32 table, and round every decoded weight to
bf16 as the TPU kernels do.  The GEMVs take N <= 8 rows of bf16 x and
return y = x @ W_hat^T in float32 without Wscale; the dequants return
W_hat (m, k) bf16 in natural order.  tcomb holds two canonical arrays,
KV1 on columns [0, k/2) and KV2 on [k/2, k).  The GEMVs take the
palette's KV 3-10 and tcomb's (KV, KV+1); the dequants every KV from 1 to
16 and every pair of them (``DEQUANT_KV``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (counted in ``<wrapper>.launches``) or raises.  The
library is compiled with nvcc into ``qpalette_tpu_torch/_build/`` at
first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qpalette_tpu_torch.kernels import _build
from qpalette_tpu_torch.ops.codebooks import expand_tlut
from qpalette_tpu_torch.ops.packing import TD, dequant_tcq

SOURCE = "tcq_lut"  # csrc/tcq_lut.cu
MAX_ROWS = 8  # GEMV rows; more rows take the dequant + product path
SUPPORTED_KV = (3, 4, 5, 6, 7, 8, 9, 10)
SUPPORTED_TCOMB = tuple((kv, kv + 1) for kv in range(3, 10))
# the dequant kernels' KVs (csrc kMaxKV), each tcomb half any of them: the
# GEMVs' have an instance each, any other the instance that reads its KVs
# at run time
DEQUANT_KV = tuple(range(1, 17))
SUPPORTED_S = (9, 10, 11)
# the GEMV's shared-memory table (kTabBits of csrc/tcq_lut.cu): 2^15 bytes,
# 2^(13-S) bf16x2 copies of each of the 2^S entries
GEMV_TABLE_BITS = 15

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {  # the C interface of csrc/tcq_lut.cu
    "tcq_lut_gemv": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "tcomb_lut_gemv": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "tcq_lut_dequant": [_P, _P, _I, _P, _I, _I, _I, _P],
    "tcomb_lut_dequant": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def _tlut_bits(tlut: torch.Tensor) -> int:
    S = tlut.shape[0].bit_length() - 1
    if (tlut.dtype != torch.float32 or tlut.dim() != 2
            or tuple(tlut.shape) != (1 << S, 2) or S not in SUPPORTED_S):
        raise ValueError(f"tlut {tlut.dtype} {tuple(tlut.shape)}: want "
                         f"float32 (2^S, 2), S in {SUPPORTED_S}")
    return S


def _check_words(words, name, KV, m, k, device):
    T = (m // TD) * (k // TD)
    if words.dtype != torch.int32 or tuple(words.shape) != (T, 4 * KV):
        raise ValueError(f"{name} {words.dtype} {tuple(words.shape)}: "
                         f"want int32 ({T}, {4 * KV})")
    if words.device != device:
        raise ValueError(f"{name} on {words.device}, want {device}")
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check(halves, tlut, m, k, device, x=None, out=None, out_dtype=None,
           out_shape=None) -> int:
    """halves: ((name, words, KV, k_i), ...).  Returns S."""
    if m <= 0 or k <= 0 or m % TD or k % (TD * len(halves)):
        raise ValueError(f"m={m}, k={k}: want positive multiples of 16 "
                         f"(k of 32 for tcomb)")
    for name, words, KV, k_i in halves:
        _check_words(words, name, KV, m, k_i, device)
    S = _tlut_bits(tlut)
    if tlut.device != device or not tlut.is_contiguous() \
            or tlut.data_ptr() % 16:
        raise ValueError(f"tlut on {tlut.device}, contiguous and 16-byte "
                         f"aligned on {device} wanted")
    if x is not None:
        if (x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k
                or not 1 <= x.shape[0] <= MAX_ROWS):
            raise ValueError(f"x {x.dtype} {tuple(x.shape)}: want bfloat16 "
                             f"(1..{MAX_ROWS}, {k})")
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"x on {x.device}: want contiguous on {device}")
    if out is not None and (out.dtype != out_dtype
                            or tuple(out.shape) != out_shape
                            or out.device != device
                            or not out.is_contiguous()
                            or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous 16-byte aligned "
                         f"{out_dtype} {out_shape} tensor on {device}")
    return S


def _bf16_lut(tlut: torch.Tensor) -> torch.Tensor:
    # the TPU kernels round each decoded weight to bf16
    return expand_tlut(tlut).to(torch.bfloat16)


# --- plain versions ---------------------------------------------------------

def tcq_lut_dequant_plain(trellis, tlut, KV, m, k) -> torch.Tensor:
    """W_hat (m, k) bf16."""
    return dequant_tcq(trellis, _bf16_lut(tlut), m, k, KV)


def tcomb_lut_dequant_plain(trellis1, trellis2, tlut, KV1, KV2, m,
                            k) -> torch.Tensor:
    lut = _bf16_lut(tlut)
    return torch.cat([dequant_tcq(trellis1, lut, m, k // 2, KV1),
                      dequant_tcq(trellis2, lut, m, k // 2, KV2)], dim=1)


def tcq_lut_gemv_plain(x, trellis, tlut, KV, m, k) -> torch.Tensor:
    w = tcq_lut_dequant_plain(trellis, tlut, KV, m, k)
    return x.to(torch.bfloat16).float() @ w.float().T


def tcomb_lut_gemv_plain(x, trellis1, trellis2, tlut, KV1, KV2, m,
                         k) -> torch.Tensor:
    w = tcomb_lut_dequant_plain(trellis1, trellis2, tlut, KV1, KV2, m, k)
    return x.to(torch.bfloat16).float() @ w.float().T


# --- wrappers ---------------------------------------------------------------

def _result(y, out):
    if out is None:
        return y
    out.copy_(y)
    return out


def tcq_lut_gemv(x, trellis, tlut, KV, m, k, out=None) -> torch.Tensor:
    """y = x @ W_hat^T, float32 (N, m), without Wscale (K4)."""
    if KV not in SUPPORTED_KV:
        raise ValueError(f"KV={KV} not in {SUPPORTED_KV}")
    N = x.shape[0]
    S = _check((("trellis", trellis, KV, k),), tlut, m, k, x.device, x=x,
               out=out, out_dtype=torch.float32, out_shape=(N, m))
    if x.device.type == "cpu":
        return _result(tcq_lut_gemv_plain(x, trellis, tlut, KV, m, k), out)
    if out is None:
        out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "tcq_lut_gemv", x.device, x.data_ptr(),
                  trellis.data_ptr(), tlut.data_ptr(), S, out.data_ptr(), N, m,
                  k, KV)
    tcq_lut_gemv.launches += 1
    return out


def tcomb_lut_gemv(x, trellis1, trellis2, tlut, KV1, KV2, m, k,
                   out=None) -> torch.Tensor:
    """Input-split tcomb in one launch (K5): KV1 on x[:, :k/2], KV2 on
    x[:, k/2:]; float32 (N, m) without Wscale."""
    if (KV1, KV2) not in SUPPORTED_TCOMB:
        raise ValueError(f"KV=({KV1}, {KV2}) not in {SUPPORTED_TCOMB}")
    N = x.shape[0]
    S = _check((("trellis1", trellis1, KV1, k // 2),
                ("trellis2", trellis2, KV2, k // 2)), tlut, m, k, x.device,
               x=x, out=out, out_dtype=torch.float32, out_shape=(N, m))
    if x.device.type == "cpu":
        return _result(tcomb_lut_gemv_plain(x, trellis1, trellis2, tlut, KV1,
                                            KV2, m, k), out)
    if out is None:
        out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "tcomb_lut_gemv", x.device, x.data_ptr(),
                  trellis1.data_ptr(), trellis2.data_ptr(), tlut.data_ptr(), S,
                  out.data_ptr(), N, m, k, KV1, KV2)
    tcomb_lut_gemv.launches += 1
    return out


def tcq_lut_dequant(trellis, tlut, KV, m, k, out=None) -> torch.Tensor:
    """W_hat (m, k) bf16, natural order (K6)."""
    if KV not in DEQUANT_KV:
        raise ValueError(f"KV={KV} not in {DEQUANT_KV}")
    dev = trellis.device
    S = _check((("trellis", trellis, KV, k),), tlut, m, k, dev, out=out,
               out_dtype=torch.bfloat16, out_shape=(m, k))
    if dev.type == "cpu":
        return _result(tcq_lut_dequant_plain(trellis, tlut, KV, m, k), out)
    if out is None:
        out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    _build.launch(_lib(), "tcq_lut_dequant", dev, trellis.data_ptr(),
                  tlut.data_ptr(), S, out.data_ptr(), m, k, KV)
    tcq_lut_dequant.launches += 1
    return out


def tcomb_lut_dequant(trellis1, trellis2, tlut, KV1, KV2, m, k,
                      out=None) -> torch.Tensor:
    """Both tcomb halves -> W_hat (m, k) bf16, natural order (K7)."""
    if KV1 not in DEQUANT_KV or KV2 not in DEQUANT_KV:
        raise ValueError(f"KV=({KV1}, {KV2}): each half's KV in "
                         f"{DEQUANT_KV}")
    dev = trellis1.device
    S = _check((("trellis1", trellis1, KV1, k // 2),
                ("trellis2", trellis2, KV2, k // 2)), tlut, m, k, dev,
               out=out, out_dtype=torch.bfloat16, out_shape=(m, k))
    if dev.type == "cpu":
        return _result(tcomb_lut_dequant_plain(trellis1, trellis2, tlut, KV1,
                                               KV2, m, k), out)
    if out is None:
        out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    _build.launch(_lib(), "tcomb_lut_dequant", dev, trellis1.data_ptr(),
                  trellis2.data_ptr(), tlut.data_ptr(), S, out.data_ptr(), m,
                  k, KV1, KV2)
    tcomb_lut_dequant.launches += 1
    return out


KERNELS = (tcq_lut_gemv, tcomb_lut_gemv, tcq_lut_dequant, tcomb_lut_dequant)
for _fn in KERNELS:
    _fn.launches = 0
