"""Build and load the port's CUDA sources: nvcc -> shared library with a
plain C interface -> ctypes, and the launch of one of its C functions.

Each ``csrc/<name>.cu`` compiles into ``qpalette_tpu_torch/_build/
lib<name>.so`` at first use, and again whenever the source or a shared
header ``csrc/*.cuh`` is newer than the library.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def compile_cu(src: Path, lib: Path) -> str:
    """nvcc ``src`` for sm_90a into the shared library ``lib`` and return
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".{lib.name}.{os.getpid()}"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return res.stdout + res.stderr


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so`` and return
    nvcc's output."""
    return compile_cu(CSRC / f"{name}.cu", lib_path(name))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build if missing or stale, load, and set each C function's
    argtypes (``signatures``: function name -> list of ctypes types);
    every function returns an int (a cudaError_t)."""
    lib_file = lib_path(name)
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    if not lib_file.exists() or lib_file.stat().st_mtime < newest:
        build(name)
    return bind(lib_file, signatures)


def bind(lib_file: Path, signatures: dict) -> ctypes.CDLL:
    """Load the built library ``lib_file`` and set its C functions'
    argtypes and int result, as ``load`` does."""
    lib = ctypes.CDLL(str(lib_file))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, fn_name: str, device: torch.device, *args):
    """Call ``fn_name`` of ``lib`` with ``args`` and the current stream of
    ``device`` (a CUDA device) as its last argument; raise if it returns a
    CUDA error (a launch the card refused never runs)."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
