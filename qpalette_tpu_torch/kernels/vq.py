"""SQ/VQ row-pack kernels: the hand-written CUDA kernels and their plain
PyTorch versions.

  vq_gemv     replaces qpalette_tpu/kernels/fused.py::_vq_kernel
  vq_dequant  replaces fused.py::_vq_dequant_kernel

Both (``csrc/vq.cu``) read the canonical row-pack (m, ceil(P*bits/32) +
1) int32 words, P = k/vec indices a row, and a (2^bits, vec) float32
codebook, and round every decoded value to bf16 as the TPU kernels do.
``vq_gemv`` takes N <= 8 rows of bf16 x and returns y = x @ W_hat^T in
float32 without Wscale; ``vq_dequant`` returns W_hat (m, k) bf16 in
natural order.  The GEMV takes P a multiple of 128 and the (bits, vec)
pairs of the ldlq palette (``SUPPORTED``): vec 1 with bits 2-8, vec 2
with bits 3-12 and vec 4 with bits 4-12 (1-3 bits a weight).  The dequant
takes k a multiple of 8 and bits 1-12 at vec 1, 2 and 4 (``DEQUANT``).
vec 4 at other bits raises NotImplementedError.

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
from qpalette_tpu_torch.ops.packing import dequant_lut

SOURCE = "vq"  # csrc/vq.cu
MAX_ROWS = 8  # GEMV rows; more rows take the dequant + product path
ALIGN_P = 128  # the GEMV's indices a row must be a multiple of this
DEQUANT_ALIGN_K = 8  # the dequant's k: a lane's 16-byte store
SUPPORTED = tuple([(b, 1) for b in range(2, 9)]
                  + [(b, 2) for b in range(3, 13)]
                  + [(b, 4) for b in range(4, 13)])  # (bits, vec)
# the dequant's pairs: the GEMV's and the 10 more of csrc's vq_dequant
DEQUANT = tuple((b, v) for v in (1, 2, 4) for b in range(1, 13))
# the GEMV's shared-memory table (kTabBytes of csrc/vq.cu): 2^15 bytes,
# min(32, 2^(13-w)) copies of each 32-bit entry of a w-bit window (vec 1,
# 2); vec 4 (vq4_gemv_kernel): min(16, 2^(12-bits)) copies of each 8-byte
# entry, 16 being the fewest that keep a warp's read at its least two
# wavefronts (chip_variants.py conflicts), fewer above bits 8 to stay in
# 32 KB
GEMV_TABLE_BITS = 15
GEMV_WARPS = 8  # warps a block of the GEMV: they split a row's chunks
GEMV4_ACC = 2  # vq4_gemv_kernel: a warp's accumulators (MMA j into j % 2)
GEMV4_MAX_COPY_BITS = 4


def gemv4_copy_bits(bits: int) -> int:
    """log2 of the copies of each 8-byte entry of the vec-4 table."""
    return min(GEMV4_MAX_COPY_BITS, 12 - bits)


_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {  # the C interface of csrc/vq.cu
    "vq_gemv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vq_dequant": [_P, _P, _P, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def row_words(k: int, bits: int, vec: int) -> int:
    """Words a row of the canonical row-pack, the pad word included."""
    return -(-(k // vec * bits) // 32) + 1


def _check(qweight, lut, bits, vec, m, k, device, pairs=SUPPORTED, x=None,
           out=None, out_dtype=None, out_shape=None):
    """pairs: the (bits, vec) the calling kernel takes; the GEMV (pairs
    SUPPORTED) wants k/vec a multiple of ALIGN_P, the dequant k a multiple
    of DEQUANT_ALIGN_K."""
    if vec == 4 and (bits, vec) not in pairs:
        b4 = [b for b, v in pairs if v == 4]
        raise NotImplementedError(f"vec 4 at bits={bits}: the kernels take "
                                  f"bits {min(b4)}-{max(b4)}")
    if (bits, vec) not in pairs:
        raise ValueError(f"(bits, vec)=({bits}, {vec}) not in {pairs}")
    align = ALIGN_P * vec if pairs is SUPPORTED else DEQUANT_ALIGN_K
    if m <= 0 or k <= 0 or k % align:
        raise ValueError(f"m={m}, k={k}: want k a positive multiple of "
                         f"{align}")
    W = row_words(k, bits, vec)
    if qweight.dtype != torch.int32 or tuple(qweight.shape) != (m, W):
        raise ValueError(f"qweight {qweight.dtype} {tuple(qweight.shape)}: "
                         f"want int32 ({m}, {W})")
    if lut.dtype != torch.float32 or tuple(lut.shape) != (1 << bits, vec):
        raise ValueError(f"lut {lut.dtype} {tuple(lut.shape)}: want float32 "
                         f"({1 << bits}, {vec})")
    for name, t in (("qweight", qweight), ("lut", lut)):
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} on {t.device}: want contiguous and "
                             f"16-byte aligned on {device}")
    if x is not None:
        if (x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != k
                or not 1 <= x.shape[0] <= MAX_ROWS):
            raise ValueError(f"x {x.dtype} {tuple(x.shape)}: want bfloat16 "
                             f"(1..{MAX_ROWS}, {k})")
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"x on {x.device}: want contiguous and 16-byte "
                             f"aligned on {device}")
    if out is not None and (out.dtype != out_dtype
                            or tuple(out.shape) != out_shape
                            or out.device != device
                            or not out.is_contiguous()
                            or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous 16-byte aligned "
                         f"{out_dtype} {out_shape} tensor on {device}")


# --- plain versions ---------------------------------------------------------

def vq_dequant_plain(qweight, lut, bits, vec, m, k) -> torch.Tensor:
    """W_hat (m, k) bf16: the codebook rounded to bf16, then gathered."""
    return dequant_lut(qweight, lut.to(torch.bfloat16), m, k, bits, vec)


def vq_gemv_plain(x, qweight, lut, bits, vec, m, k) -> torch.Tensor:
    w = vq_dequant_plain(qweight, lut, bits, vec, m, k)
    return x.to(torch.bfloat16).float() @ w.float().T


# --- wrappers ---------------------------------------------------------------

def _result(y, out):
    if out is None:
        return y
    out.copy_(y)
    return out


def vq_gemv(x, qweight, lut, bits, vec, m, k, out=None) -> torch.Tensor:
    """y = x @ W_hat^T, float32 (N, m), without Wscale (K8)."""
    N = x.shape[0]
    _check(qweight, lut, bits, vec, m, k, x.device, x=x, out=out,
           out_dtype=torch.float32, out_shape=(N, m))
    if x.device.type == "cpu":
        return _result(vq_gemv_plain(x, qweight, lut, bits, vec, m, k), out)
    if out is None:
        out = torch.empty((N, m), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "vq_gemv", x.device, x.data_ptr(),
                  qweight.data_ptr(), lut.data_ptr(), out.data_ptr(), N, m, k,
                  bits, vec)
    vq_gemv.launches += 1
    vq_gemv.by_vec[vec] += 1
    return out


def vq_dequant(qweight, lut, bits, vec, m, k, out=None) -> torch.Tensor:
    """W_hat (m, k) bf16, natural order (K9)."""
    dev = qweight.device
    _check(qweight, lut, bits, vec, m, k, dev, DEQUANT, out=out,
           out_dtype=torch.bfloat16, out_shape=(m, k))
    if dev.type == "cpu":
        return _result(vq_dequant_plain(qweight, lut, bits, vec, m, k), out)
    if out is None:
        out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    _build.launch(_lib(), "vq_dequant", dev, qweight.data_ptr(),
                  lut.data_ptr(), out.data_ptr(), m, k, bits, vec)
    vq_dequant.launches += 1
    vq_dequant.by_vec[vec] += 1
    return out


KERNELS = (vq_gemv, vq_dequant)
for _fn in KERNELS:
    _fn.launches = 0
    # the launches of each vec, counted beside .launches (both set to 0
    # by kernels.reset_launches)
    _fn.by_vec = {1: 0, 2: 0, 4: 0}
