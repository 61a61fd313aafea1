"""ctypes binding of the exact 1-D k-means in ``native/kmeans1d.cpp``.

Counterpart of ``qpalette_tpu/ops/native_pack.py``, of which the port
needs only ``kmeans1d``: the packed formats are ``ops/packing.py``'s, in
torch.  ``native/kmeans1d.cpp`` is compiled with the host's C++ compiler
into ``qpalette_tpu_torch/_build/libqpt_kmeans1d.so`` at first use, and
again when the source is newer than the library; the committed
``native/libqpt_pack.so`` is not loaded.  A failed build raises with the
compiler's output: nothing falls back to another k-means.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

NATIVE = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE / "kmeans1d.cpp"
LIB = Path(__file__).resolve().parents[1] / "_build" / "libqpt_kmeans1d.so"

_LIB = None

_f64p = ctypes.POINTER(ctypes.c_double)


def build() -> None:
    """Compile SOURCE into LIB (through a temporary file, so that
    parallel processes never load half a library)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler: {SOURCE} cannot be built")
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.parent / f".{LIB.name}.{os.getpid()}"
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared", "-o",
           str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if missing or stale."""
    global _LIB
    if _LIB is None:
        if not LIB.exists() or LIB.stat().st_mtime < SOURCE.stat().st_mtime:
            build()
        handle = ctypes.CDLL(str(LIB))
        handle.qpt_kmeans1d.argtypes = [_f64p, _f64p, ctypes.c_int64,
                                        ctypes.c_int, _f64p]
        handle.qpt_kmeans1d.restype = ctypes.c_double
        _LIB = handle
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f64p)


def kmeans1d(xs: np.ndarray, w, k: int) -> np.ndarray:
    """Optimal 1-D k-means centroids (k,) float64 of sorted xs, each with
    weight w (None: 1)."""
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    out = np.empty((k,), np.float64)
    if w is not None:
        w = np.ascontiguousarray(w, dtype=np.float64)
    lib().qpt_kmeans1d(_ptr(xs), _ptr(w) if w is not None else None,
                       xs.shape[0], k, _ptr(out))
    return out
