"""Arithmetic trellis decode-GEMV (K1): the hand-written CUDA kernels and
their plain PyTorch version.

Replaces ``qpalette_tpu/kernels/fused.py::_arith_kernel`` as reached
through ``tcq2_decode_matmul`` (modes ``sum2`` and ``dualmad``) and
``tcq1_decode_matmul`` (modes ``1mad`` and ``2mad``).  One wrapper per
family, each with its own launch count:

  tcq2s_decode_gemv  mode sum2     KV 4..10   csrc/tcq2_gemv.cu
  tcq2_decode_gemv   mode dualmad  KV 4..10   csrc/tcq2_gemv.cu
  tcq1_decode_gemv   1mad / 2mad   KV 2..5    csrc/tcq1_gemv.cu

Each reads the canonical trellis, (T, 4*KV) words for V=2 and (T, 8*KV)
for V=1, and returns y = x @ W_hat^T in float32 without Wscale, for
N <= 256 rows of x.  exact rounds x to bf16; a8 quantizes x to int8 per
512-column chunk with one absmax scale over all rows.  On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches its kernels or
raises.  Every mode runs on tensor cores.  Up to 8 rows: one body
(``csrc/arith_tc.cuh``), ``v2_gemv_kernel`` for V=2, ``v1_gemv_kernel``
for V=1.  Above 8 rows: ``wide_gemv_kernel`` (``csrc/arith_wide.cuh``:
each tile decoded once for all rows) under the mode's tile policy
(``WideTile`` for V=2, ``WideTile1`` for V=1), after a prologue kernel
that writes x into a workspace the wrapper allocates, so such a call
counts two launches.  Both sources are compiled with nvcc into
``qpalette_tpu_torch/_build/`` at first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qpalette_tpu_torch.kernels import _build
from qpalette_tpu_torch.ops.codebooks import (ARITH_V, MAD_SCALE,
                                              arith_weights_int)
from qpalette_tpu_torch.ops.packing import TD, tiles_to_mat, unpack_trellis

MAD_INV = 1.0 / MAD_SCALE
CHUNK = 512  # a8 columns per activation scale (the kernel's kChunk)
MAX_ROWS = 256
TC_ROWS = 8  # rows the narrow tensor-core kernels take (csrc kTcRows)
MAX_K = CHUNK * 64
# above TC_ROWS the workspace holds the chunk scales (csrc kWideScaleBytes),
# for V=1 a8 then -510 * sum(q) of each x row an 8-tile step (int32, rows
# padded to whole 8-row n-tiles), then x padded to whole n-tiles, one byte a
# value (a8) or two (exact)
WIDE_SCALE_BYTES = 512
WIDE_STEP = 128  # columns an 8-tile step
SUPPORTED_KV = {"sum2": tuple(range(4, 11)), "dualmad": tuple(range(4, 11)),
                "1mad": (2, 3, 4, 5), "2mad": (2, 3, 4, 5)}
# mode -> (CUDA source and its C function, the function's mode number)
_C_MODE = {"sum2": ("tcq2_gemv", 0), "dualmad": ("tcq2_gemv", 1),
           "1mad": ("tcq1_gemv", 0), "2mad": ("tcq1_gemv", 1)}
SOURCES = ("tcq2_gemv", "tcq1_gemv")

_P = ctypes.c_void_p
_I = ctypes.c_int
# the C interface of each source: one function of the source's name, which
# takes the wide kernel's workspace after out
SIGNATURES = {src: {src: [_P, _I, _P, _P, _P] + [_I] * 6 + [_P]}
              for src in SOURCES}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    return _build.load(source, SIGNATURES[source])


def wide(mode: str, rows: int) -> bool:
    """Whether a call of `rows` rows runs wide_gemv_kernel (every mode
    above 8 rows)."""
    return mode in ARITH_V and rows > TC_ROWS


def kernel_launches(mode: str, rows: int) -> int:
    """Kernels one call of `rows` rows launches: 2 above 8 rows (the x
    prologue, then the GEMV), else 1."""
    return 2 if wide(mode, rows) else 1


def workspace_bytes(mode: str, rows: int, k: int, a8: bool) -> int:
    """Bytes of wide_gemv_kernel's workspace for `rows` rows of x."""
    padded = -(-rows // 8) * 8
    sums = (4 * padded * -(-k // WIDE_STEP) if a8 and ARITH_V[mode] == 1
            else 0)
    return WIDE_SCALE_BYTES + sums + padded * k * (1 if a8 else 2)


def words_per_tile(mode: str, KV: int) -> int:
    return 8 * KV // ARITH_V[mode]


def arith_weights_mat(trellis: torch.Tensor, mode: str, KV: int, m: int,
                      k: int) -> torch.Tensor:
    """Canonical words of m/16 tile-rows -> (m, k) int64 unscaled weights
    in natural order (V=2 paired-K-major tiles, V=1 K-major)."""
    v = ARITH_V[mode]
    w = arith_weights_int(unpack_trellis(trellis, KV, v), mode)
    if v == 2:  # (T, t, row, c) -> (T, row, t, c)
        tiles = w.reshape(-1, TD // 2, TD, 2).permute(0, 2, 1, 3)
    else:  # (T, col, row) -> (T, row, col)
        tiles = w.reshape(-1, TD, TD).transpose(1, 2)
    return tiles_to_mat(tiles.reshape(-1, TD, TD), m, k)


def check_trellis(trellis, mode, KV, m, k, device, kvs=SUPPORTED_KV):
    """The trellis of (mode, KV) for an (m, k) W_hat, on device; kvs: the
    KVs of each mode that the calling kernel takes."""
    if mode not in kvs or KV not in kvs[mode]:
        raise ValueError(f"mode {mode!r} KV={KV}: supported {kvs}")
    if m % TD or k % TD or m <= 0 or k <= 0:
        raise ValueError(f"m={m}, k={k} must be positive multiples of 16")
    T, W = (m // TD) * (k // TD), words_per_tile(mode, KV)
    if trellis.dtype != torch.int32 or tuple(trellis.shape) != (T, W):
        raise ValueError(f"trellis {trellis.dtype} {tuple(trellis.shape)}: "
                         f"want int32 ({T}, {W})")
    if trellis.device != device:
        raise ValueError(f"trellis on {trellis.device}, want {device}")
    if not trellis.is_contiguous() or trellis.data_ptr() % 16:
        raise ValueError("trellis must be contiguous and 16-byte aligned")


def _check(x, trellis, mode, KV, m, k, out):
    if k > MAX_K:
        raise ValueError(f"k={k} above the kernel's {MAX_K}")
    if x.dim() != 2 or x.shape[1] != k or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x shape {tuple(x.shape)}: want "
                         f"(1..{MAX_ROWS}, {k})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: want float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    check_trellis(trellis, mode, KV, m, k, x.device)
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (x.shape[0], m)
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 (N, m) tensor "
                         "on x's device")


PLAIN_ROWS = 2048  # output rows decoded per step (bounds temporaries)


def arith_gemv_plain(x: torch.Tensor, trellis: torch.Tensor, mode: str,
                     KV: int, m: int, k: int, a8: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernels (same chunking and rounding).

    a8: each CHUNK of x is quantized with its own absmax scale over all
    rows; the chunk's integer dot runs in float64, exact, and is rounded
    to float32 before it is descaled, as the kernel's int32 sum is."""
    xf = x.to(torch.float32)
    if not a8:
        xf = xf.to(torch.bfloat16).to(torch.float32)
    N, kt = x.shape[0], k // TD
    out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    for r0 in range(0, m, PLAIN_ROWS):
        r1 = min(m, r0 + PLAIN_ROWS)
        w = arith_weights_mat(trellis[(r0 // TD) * kt:(r1 // TD) * kt],
                              mode, KV, r1 - r0, k)
        if not a8:
            # |w| <= 512: products of bf16 x are exact in float32
            out[:, r0:r1] = xf @ w.to(torch.float32).T
            continue
        wd = w.to(torch.float64)
        y = torch.zeros((N, r1 - r0), dtype=torch.float32, device=x.device)
        for c0 in range(0, k, CHUNK):
            xc = xf[:, c0:c0 + CHUNK]
            # one scale for all rows, by a true division as in the kernel
            # and the reference (on the card PyTorch divides by a Python
            # float through its reciprocal, one ulp off, which flips the
            # rounding of x = max|x|/2)
            sx = xc.abs().amax() / torch.tensor(127.0, device=x.device) + 1e-30
            q = torch.round(xc * (1.0 / sx))
            dot = q.to(torch.float64) @ wd[:, c0:c0 + CHUNK].T
            y = y + dot.to(torch.float32) * sx
        out[:, r0:r1] = y
    return out * MAD_INV


def _gemv(wrapper, mode, x, trellis, KV, m, k, a8, out) -> torch.Tensor:
    """Plain version on the CPU; on the card, launch and count each kernel
    in ``wrapper.launches``."""
    _check(x, trellis, mode, KV, m, k, out)
    if x.device.type == "cpu":
        y = arith_gemv_plain(x, trellis, mode, KV, m, k, a8)
        if out is not None:
            out.copy_(y)
            return out
        return y
    if out is None:
        out = torch.empty((x.shape[0], m), dtype=torch.float32,
                          device=x.device)
    source, cmode = _C_MODE[mode]
    N = x.shape[0]
    ws = (torch.empty(workspace_bytes(mode, N, k, a8), dtype=torch.uint8,
                      device=x.device) if wide(mode, N) else None)
    _build.launch(_lib(source), source, x.device, x.data_ptr(),
                  int(x.dtype == torch.bfloat16), trellis.data_ptr(),
                  out.data_ptr(), 0 if ws is None else ws.data_ptr(), N, m, k,
                  KV, cmode, int(a8))
    wrapper.launches += kernel_launches(mode, N)
    return out


def tcq2s_decode_gemv(x: torch.Tensor, trellis: torch.Tensor, KV: int,
                      m: int, k: int, a8: bool,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 in mode sum2 (tcq2s): y = x @ W_hat^T, float32 (N, m).

    x: (N, k) float32 or bfloat16, N <= 256.  trellis: canonical
    (T, 4*KV) int32 words."""
    return _gemv(tcq2s_decode_gemv, "sum2", x, trellis, KV, m, k, a8, out)


def tcq2_decode_gemv(x: torch.Tensor, trellis: torch.Tensor, KV: int,
                     m: int, k: int, a8: bool,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 in mode dualmad (tcq2); arguments as tcq2s_decode_gemv."""
    return _gemv(tcq2_decode_gemv, "dualmad", x, trellis, KV, m, k, a8, out)


def tcq1_decode_gemv(x: torch.Tensor, trellis: torch.Tensor, KV: int,
                     mode: str, m: int, k: int, a8: bool,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 in mode 1mad or 2mad (tcq1, V=1): trellis (T, 8*KV) words;
    otherwise as tcq2s_decode_gemv."""
    if mode not in ("1mad", "2mad"):
        raise ValueError(f"tcq1 mode {mode!r}")
    return _gemv(tcq1_decode_gemv, mode, x, trellis, KV, m, k, a8, out)


def decode_gemv(mode: str, x, trellis, KV, m, k, a8, out=None):
    """The K1 wrapper of a decode mode."""
    if mode == "sum2":
        return tcq2s_decode_gemv(x, trellis, KV, m, k, a8, out)
    if mode == "dualmad":
        return tcq2_decode_gemv(x, trellis, KV, m, k, a8, out)
    return tcq1_decode_gemv(x, trellis, KV, mode, m, k, a8, out)


KERNELS = (tcq2s_decode_gemv, tcq2_decode_gemv, tcq1_decode_gemv)
for _fn in KERNELS:
    _fn.launches = 0
