"""Quantized-linear dispatch.

Counterpart of ``qpalette_tpu/runtime/qlinear.py`` for the kinds the port
runs: ``dense``, ``dense_rot`` and ``tcq2`` in mode ``sum2`` (tcq2s).
Impl names: ``exact`` (the reference's ``pallas``: bf16 activations,
exact decode) and ``a8`` (``pallas_a8``: int8 activations quantized
inside the kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from qpalette_tpu_torch.kernels.tcq2s import MAX_ROWS, tcq2s_decode_gemv
from qpalette_tpu_torch.ops.hadamard import get_had_factors, hadamard_transform_t

IMPLS = ("exact", "a8")
FUSE_ROT_ROWS = 8  # rows up to which the rotation output stays float32


@dataclass(frozen=True)
class LinearSpec:
    kind: str                 # dense | dense_rot | tcq2
    in_features: int
    out_features: int
    KV: tuple = ()            # (KV,)
    mode: str = ""            # tcq2 decode mode (sum2)
    impl: str = "exact"       # exact | a8


def can_fuse_rot(spec: LinearSpec, rows: int) -> bool:
    """True where the reference fuses the incoherence rotation into the
    kernel's activation prologue: tcq2 sum2, decode regime (rows <= 8) and
    a <= 2-factor Hadamard.  Then the rotated activation reaches the
    kernel in float32 instead of being cast back to the activation dtype."""
    if spec.impl not in IMPLS or rows > FUSE_ROT_ROWS:
        return False
    if spec.kind != "tcq2" or spec.mode != "sum2":
        return False
    return len(get_had_factors(spec.in_features)) <= 2


def qlinear_apply(spec: LinearSpec, p: dict, z: torch.Tensor, pre_rot=None,
                  out_dtype=None) -> torch.Tensor:
    """z (rows, in_features) -> (rows, out_features), Wscale applied in f32.

    pre_rot=su: z is UN-rotated; the rotation (z * su) @ H^T is applied
    here, in float32 and kept float32 where the reference fuses it
    (can_fuse_rot), else cast back to z's dtype.  out_dtype overrides the
    output dtype (default z's dtype)."""
    odt = out_dtype or z.dtype
    rows = z.shape[0]
    fused = pre_rot is not None and can_fuse_rot(spec, rows)
    if fused:
        z = hadamard_transform_t(z.float() * pre_rot.float())
    elif pre_rot is not None:
        z = hadamard_transform_t(z * pre_rot.to(z.dtype)).to(z.dtype)
    if spec.kind == "dense":
        return (z.float() @ p["w"].float().T).to(odt)
    if spec.kind == "dense_rot":
        y = z.float() @ p["w"].float().T
        return (y * p["wscale"].float()[None, :]).to(odt)
    if spec.kind != "tcq2" or spec.mode != "sum2":
        raise NotImplementedError(f"kind {spec.kind!r} mode {spec.mode!r}")
    if spec.impl not in IMPLS:
        raise ValueError(f"impl {spec.impl!r} not in {IMPLS}")
    a8 = spec.impl == "a8"
    x = (z if fused else z.to(torch.bfloat16)).contiguous()
    m, n, KV = spec.out_features, spec.in_features, spec.KV[0]
    if rows <= MAX_ROWS:
        y = tcq2s_decode_gemv(x, p["trellis"], KV, m, n, a8)
    elif a8:
        # very large row counts: 256-row chunks through the same kernel
        y = torch.cat([tcq2s_decode_gemv(x[r:r + MAX_ROWS], p["trellis"],
                                         KV, m, n, a8)
                       for r in range(0, rows, MAX_ROWS)])
    else:
        raise NotImplementedError(
            "impl 'exact' above 256 rows needs the tcq2_dequant kernel "
            "(K2), which is not ported yet")
    return (y * p["wscale"].float()[None, :]).to(odt)
