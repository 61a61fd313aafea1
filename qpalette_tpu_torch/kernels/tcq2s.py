"""tcq2s (sum2) decode-GEMV: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``qpalette_tpu/kernels/fused.py::_arith_kernel`` (mode ``sum2``,
dense even-KV) as reached through ``tcq2_decode_matmul``.  The kernel
(``csrc/tcq2s_gemv.cu``) reads the canonical trellis and returns
y = x @ W_hat^T in float32, without Wscale.  On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or
raises.

The kernel is compiled with nvcc into ``qpalette_tpu_torch/_build/`` at
first use and loaded with ctypes (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qpalette_tpu_torch.kernels import _build
from qpalette_tpu_torch.ops.codebooks import MAD_SCALE, sum2_pairs
from qpalette_tpu_torch.ops.packing import TD, unpack_trellis

MAD_INV = 1.0 / MAD_SCALE
CHUNK = 512  # a8 columns per activation scale (kernel's kChunk)
MAX_ROWS = 256
SUPPORTED_KV = (4, 6, 8)

SOURCE = "tcq2s_gemv"  # csrc/tcq2s_gemv.cu


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, {"tcq2s_gemv": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]})


def _check(x, trellis, KV, m, k, out):
    if KV not in SUPPORTED_KV:
        raise ValueError(f"KV={KV} not in {SUPPORTED_KV}")
    if m % TD or k % TD or m <= 0 or k <= 0:
        raise ValueError(f"m={m}, k={k} must be positive multiples of 16")
    if k > CHUNK * 64:
        raise ValueError(f"k={k} above the kernel's 32768")
    if x.dim() != 2 or x.shape[1] != k or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"x shape {tuple(x.shape)}: want (1..{MAX_ROWS}, {k})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: want float32 or bfloat16")
    T = (m // TD) * (k // TD)
    if trellis.dtype != torch.int32 or tuple(trellis.shape) != (T, 4 * KV):
        raise ValueError(f"trellis {trellis.dtype} {tuple(trellis.shape)}: "
                         f"want int32 ({T}, {4 * KV})")
    if trellis.device != x.device:
        raise ValueError(f"x on {x.device}, trellis on {trellis.device}")
    if not (x.is_contiguous() and trellis.is_contiguous()):
        raise ValueError("x and trellis must be contiguous")
    if trellis.data_ptr() % 16:
        raise ValueError("trellis must be 16-byte aligned")
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (x.shape[0], m)
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 (N, m) tensor "
                         "on x's device")


def sum2_weights_int(trellis: torch.Tensor, KV: int, m: int,
                     k: int) -> torch.Tensor:
    """Canonical words of m/16 tile-rows -> (m, k) float32 holding the
    unscaled integer weights (sb0+sb1 / sb2+sb3, paired-K-major)."""
    pairs = sum2_pairs(unpack_trellis(trellis, KV, 2))  # (T, 128, 2)
    tiles = pairs.reshape(m // TD, k // TD, TD // 2, TD, 2)
    # (mt, kt, t, row, c) -> (mt, row, kt, t, c)
    return tiles.permute(0, 3, 1, 2, 4).reshape(m, k).to(torch.float32)


_PLAIN_ROWS = 2048  # output rows decoded per step (bounds temporaries)


def tcq2s_decode_gemv_plain(x: torch.Tensor, trellis: torch.Tensor, KV: int,
                            m: int, k: int, a8: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same chunking and rounding).

    a8: each CHUNK of x is quantized with its own absmax scale; the chunk
    dot runs in float32, exact because every partial sum is an integer
    below 2^24 (512 * 127 * 256)."""
    xf = x.to(torch.float32)
    if not a8:
        xf = xf.to(torch.bfloat16).to(torch.float32)
    N, kt = x.shape[0], k // TD
    out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    for r0 in range(0, m, _PLAIN_ROWS):
        r1 = min(m, r0 + _PLAIN_ROWS)
        w = sum2_weights_int(trellis[(r0 // TD) * kt:(r1 // TD) * kt], KV,
                             r1 - r0, k)
        if not a8:
            out[:, r0:r1] = xf @ w.T
            continue
        y = torch.zeros((N, r1 - r0), dtype=torch.float32, device=x.device)
        for c0 in range(0, k, CHUNK):
            xc = xf[:, c0:c0 + CHUNK]
            sx = xc.abs().amax() / 127.0 + 1e-30  # one scale for all rows
            q = torch.round(xc * (1.0 / sx))
            y = y + (q @ w[:, c0:c0 + CHUNK].T) * sx
        out[:, r0:r1] = y
    return out * MAD_INV


def tcq2s_decode_gemv(x: torch.Tensor, trellis: torch.Tensor, KV: int,
                      m: int, k: int, a8: bool,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W_hat^T, float32 (N, m), without Wscale.

    x: (N, k) float32 or bfloat16, N <= 256 (exact: rounded to bf16 first;
    a8: quantized to int8 per 512-column chunk).  trellis: canonical
    (T, 4*KV) int32 words.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (counted in ``tcq2s_decode_gemv.launches``)."""
    _check(x, trellis, KV, m, k, out)
    if x.device.type == "cpu":
        y = tcq2s_decode_gemv_plain(x, trellis, KV, m, k, a8)
        if out is not None:
            out.copy_(y)
            return out
        return y
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if out is None:
        out = torch.empty((x.shape[0], m), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tcq2s_gemv(x.data_ptr(), int(x.dtype == torch.bfloat16),
                            trellis.data_ptr(), out.data_ptr(), x.shape[0],
                            m, k, KV, int(a8), stream)
    if rc != 0:
        raise RuntimeError(f"tcq2s_gemv launch failed: CUDA error {rc}")
    tcq2s_decode_gemv.launches += 1
    return out


tcq2s_decode_gemv.launches = 0
