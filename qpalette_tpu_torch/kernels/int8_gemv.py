"""int8 lm_head GEMVs: the hand-written CUDA kernels and their plain
PyTorch versions.

  int8_gemv_a8  replaces qpalette_tpu/kernels/fused.py::_i8gemv_a8_kernel
  int8_gemv     replaces fused.py::_i8gemv_kernel

Both (``csrc/int8_gemv.cu``) take N <= 8 rows of bf16 x (N, k), the head's
int8 weights ``wq`` (m, k) row-major (the port's layout: one contiguous
row an output, the vocab padded to a multiple of 2048) and float32
``scales`` (m,), and return float32 (N, m).  ``int8_gemv_a8`` quantizes x
to int8 with one absmax over all rows, sx = max|x|/127 + 1e-30 and
xq = round-half-even(x / sx), takes the int32 dot and returns
float(acc) * (scales * sx), as the reference does for its rotated head;
``int8_gemv`` returns (bf16 x . float(wq)) * scales.

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

SOURCE = "int8_gemv"  # csrc/int8_gemv.cu
MAX_ROWS = 8
PLAIN_ROWS = 8192  # output rows a step of the plain versions

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, {
        "int8_gemv_a8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "int8_gemv": [_P, _P, _P, _P, _I, _I, _I, _P],
    })


def _check(x, wq, scales, out):
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[1] % 16:
        raise ValueError(f"wq {wq.dtype} {tuple(wq.shape)}: want int8 "
                         f"(m, k), k a multiple of 16")
    m, k = wq.shape
    if (x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k
            or not 1 <= x.shape[0] <= MAX_ROWS):
        raise ValueError(f"x {x.dtype} {tuple(x.shape)}: want bfloat16 "
                         f"(1..{MAX_ROWS}, {k})")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (m,):
        raise ValueError(f"scales {scales.dtype} {tuple(scales.shape)}: "
                         f"want float32 ({m},)")
    for name, t in (("x", x), ("wq", wq), ("scales", scales)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} on {t.device}: want contiguous and "
                             f"16-byte aligned on {x.device}")
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (x.shape[0], m)
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 (N, m) tensor "
                         "on x's device")


# --- plain versions ---------------------------------------------------------

def int8_gemv_a8_plain(x, wq, scales) -> torch.Tensor:
    """The integer dot runs in float64, exact (its sums reach
    127*127*k > 2^24), and is rounded to float32 once, as the kernel's
    int32 sum is."""
    xf = x.float()
    # one scale for all rows, by a true division as in the kernel and the
    # reference (on the card PyTorch divides by a Python float through its
    # reciprocal, one ulp off, which flips the rounding of x = max|x|/2)
    sx = xf.abs().amax() / torch.tensor(127.0, device=x.device) + 1e-30
    xq = torch.round(xf / sx).double()
    out = torch.empty((x.shape[0], wq.shape[0]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, wq.shape[0], PLAIN_ROWS):
        acc = xq @ wq[r0:r0 + PLAIN_ROWS].double().T
        out[:, r0:r0 + PLAIN_ROWS] = (acc.float()
                                      * (scales[r0:r0 + PLAIN_ROWS] * sx))
    return out


def int8_gemv_plain(x, wq, scales) -> torch.Tensor:
    xf = x.to(torch.bfloat16).float()
    out = torch.empty((x.shape[0], wq.shape[0]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, wq.shape[0], PLAIN_ROWS):
        out[:, r0:r0 + PLAIN_ROWS] = ((xf @ wq[r0:r0 + PLAIN_ROWS].float().T)
                                      * scales[r0:r0 + PLAIN_ROWS])
    return out


# --- wrappers ---------------------------------------------------------------

def _run(wrapper, plain, x, wq, scales, out, *scratch):
    _check(x, wq, scales, out)
    if x.device.type == "cpu":
        y = plain(x, wq, scales)
        if out is None:
            return y
        out.copy_(y)
        return out
    (N, k), m = x.shape, wq.shape[0]
    if out is None:
        out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    bufs = [torch.empty(shape, dtype=dt, device=x.device)
            for shape, dt in scratch]
    _build.launch(_lib(), wrapper.__name__, x.device, x.data_ptr(),
                  wq.data_ptr(), scales.data_ptr(),
                  *[b.data_ptr() for b in bufs], out.data_ptr(), N, m, k)
    wrapper.launches += 1
    return out


def int8_gemv_a8(x, wq, scales, out=None) -> torch.Tensor:
    """Rotated int8 head with int8 activations (K10): float32 (N, m)."""
    N, k = x.shape
    # scratch: the int8 x and its scale, written by the quantize kernel
    return _run(int8_gemv_a8, int8_gemv_a8_plain, x, wq, scales, out,
                ((N, k), torch.int8), ((4,), torch.float32))


def int8_gemv(x, wq, scales, out=None) -> torch.Tensor:
    """int8 head with bf16 activations (K11): float32 (N, m)."""
    return _run(int8_gemv, int8_gemv_plain, x, wq, scales, out)


KERNELS = (int8_gemv_a8, int8_gemv)
for _fn in KERNELS:
    _fn.launches = 0
