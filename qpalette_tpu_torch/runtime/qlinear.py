"""Quantized-linear dispatch.

Counterpart of ``qpalette_tpu/runtime/qlinear.py`` for every kind the
reference loads: ``dense``, ``dense_rot``, the arithmetic trellis kinds
``tcq2`` (modes ``sum2`` and ``dualmad``) and ``tcq1`` (modes ``1mad``
and ``2mad``), the LUT trellis kinds ``tcq``, input-split ``tcomb`` and
output-split ``comb``, and the SQ/VQ row-pack kind ``vq``.
Impl names: ``exact`` (the reference's ``pallas``: bf16 activations,
exact decode) and ``a8`` (``pallas_a8``: int8 activations quantized
inside the kernel; for tcq/tcomb/comb/vq the reference runs the same bf16
kernels, and so does the port) take the decode GEMVs up to 8 rows (the
arithmetic kinds up to 256); ``dequant`` (the reference's ``xla``)
decodes bf16 W_hat with the kind's dequant kernel (K2, K3, K6, K7, K9)
at any row count and takes the float32 product.  The dequant kernels take
more schemes than the GEMVs (every trellis KV from 1 to 16, any tcomb
pair, vq bits 1-12), so a scheme outside the palette's GEMV sets runs
under ``dequant`` as the reference's ``xla`` route runs it; the loader
refuses at build what an impl's kernels do not take (``kernel_gap``).
The LUT kinds read
their (2^S, 2) table from the model's shared ``luts`` dict, one entry per
``tlut_bits``; a vq projection holds its own (2^bits, vec) codebook,
``lut``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from qpalette_tpu_torch.kernels import arith_dequant, tcq_lut, vq
from qpalette_tpu_torch.kernels.arith import MAX_ROWS, SUPPORTED_KV, decode_gemv
from qpalette_tpu_torch.ops.hadamard import get_had_factors, hadamard_transform_t

IMPLS = ("exact", "a8", "dequant")
GEMV_IMPLS = ("exact", "a8")  # the decode-GEMV kernel class
FUSE_ROT_ROWS = 8  # rows up to which the rotation output stays float32


@dataclass(frozen=True)
class LinearSpec:
    kind: str                 # dense | dense_rot | tcq1 | tcq2 | tcq | tcomb
                              # | comb | vq
    in_features: int
    out_features: int
    KV: tuple = ()            # (KV,) or (KV1, KV2)
    tlut_bits: int = 0        # tcq / tcomb table bits S
    bits: int = 0             # vq index bits
    vec: int = 0              # vq values an index
    split: tuple = ()         # tcomb in_part (n1, n2), comb out_part
                              # (m1, m2)
    mode: str = ""            # tcq2: sum2 | dualmad; tcq1: 1mad | 2mad
    impl: str = "exact"       # exact | a8 | dequant

    def tcq_lut_key(self) -> str:
        return f"tcq{self.tlut_bits}"


def can_fuse_rot(spec: LinearSpec, rows: int, rot_blocks: int = 1) -> bool:
    """True where the reference fuses the incoherence rotation into the
    kernel's activation prologue: tcq1 (any mode) or tcq2 sum2, decode
    regime (rows <= 8), a <= 2-factor Hadamard of the (per-block,
    in_features / rot_blocks) rotation width and, for the reference's
    dense odd-KV layout (odd KV, even k/16), a last factor that is a
    multiple of 32.  Then the rotated activation reaches the kernel in
    float32 instead of being cast back to the activation dtype."""
    if spec.impl not in GEMV_IMPLS or rows > FUSE_ROT_ROWS:
        return False
    if not (spec.kind == "tcq1"
            or (spec.kind == "tcq2" and spec.mode == "sum2")):
        return False
    facs = get_had_factors(spec.in_features // rot_blocks)
    if len(facs) > 2:
        return False
    if spec.KV[0] % 2 and (spec.in_features // 16) % 2 == 0:
        return facs[-1] % 32 == 0
    return True


def require_equal_halves(spec: LinearSpec) -> None:
    """K5 / K7 take tcomb's two input halves at k/2 each: the only split
    the quantizer writes (in_part = (n/2, n/2)), and what a row-parallel
    shard holds too ((n1/tp, n2/tp) of a local width n/tp)."""
    n = spec.in_features
    if spec.split != (n // 2, n // 2):
        raise NotImplementedError(
            f"tcomb in_part {spec.split}: K5 / K7 take equal halves "
            f"({n // 2}, {n // 2}), the only split the quantizer writes")


def kernel_gap(spec: LinearSpec):
    """None where the kernels that the spec's impl runs take its scheme,
    else what falls outside their sets.  The GEMV impls (exact, a8) run
    the palette's GEMVs: K1 (tcq1 / tcq2) the modes' KVs of
    arith.SUPPORTED_KV, K4 (tcq, each comb half) tcq_lut.SUPPORTED_KV, K5
    (tcomb) tcq_lut.SUPPORTED_TCOMB, K8 (vq) vq.SUPPORTED.  Impl dequant
    runs the dequant kernels: K2 / K3 arith_dequant.DEQUANT_KV, K6 / K7
    tcq_lut.DEQUANT_KV (each half of a comb or tcomb), K9 vq.DEQUANT.  A
    pure function of the spec: the loader refuses a gap at build."""
    kind, gemv = spec.kind, spec.impl in GEMV_IMPLS
    if kind in ("tcq1", "tcq2"):
        kvs = SUPPORTED_KV if gemv else arith_dequant.DEQUANT_KV
        if spec.KV[0] not in kvs.get(spec.mode, ()):
            return (f"{kind} mode {spec.mode!r} KV={spec.KV[0]} "
                    f"({'K1' if gemv else 'K2 / K3'} take {kvs})")
    elif kind in ("tcq", "comb") or (kind == "tcomb" and not gemv):
        kvs = tcq_lut.SUPPORTED_KV if gemv else tcq_lut.DEQUANT_KV
        if any(kv not in kvs for kv in spec.KV):
            return (f"{kind} KV={spec.KV} ({'K4' if gemv else 'K6 / K7'} "
                    f"take KV in {kvs})")
    elif kind == "tcomb":
        if tuple(spec.KV) not in tcq_lut.SUPPORTED_TCOMB:
            return (f"tcomb KV={spec.KV} (K5 takes "
                    f"{tcq_lut.SUPPORTED_TCOMB})")
    elif kind == "vq":
        pairs = vq.SUPPORTED if gemv else vq.DEQUANT
        if (spec.bits, spec.vec) not in pairs:
            return (f"vq bits={spec.bits} vec={spec.vec} "
                    f"({'K8' if gemv else 'K9'} takes {pairs})")
    return None


def dequant_weight(spec: LinearSpec, p: dict, luts: dict) -> torch.Tensor:
    """The projection's W_hat (m, n) bf16, in the rotated space and without
    Wscale, from its kind's dequant kernel: K2 (tcq2), K3 (tcq1), K6 (tcq,
    and each row half of comb), K7 (tcomb), K9 (vq)."""
    m, n = spec.out_features, spec.in_features
    if spec.kind in ("tcq1", "tcq2"):
        return arith_dequant.dequant(spec.mode, p["trellis"], spec.KV[0], m,
                                     n)
    if spec.kind == "vq":
        return vq.vq_dequant(p["qweight"], p["lut"], spec.bits, spec.vec, m,
                             n)
    tlut = luts[spec.tcq_lut_key()]
    if spec.kind == "tcq":
        return tcq_lut.tcq_lut_dequant(p["trellis"], tlut, spec.KV[0], m, n)
    if spec.kind == "tcomb":
        require_equal_halves(spec)
        return tcq_lut.tcomb_lut_dequant(p["trellis1"], p["trellis2"], tlut,
                                         *spec.KV, m, n)
    if spec.kind == "comb":
        # the row halves written in place: 16-row multiples keep both
        # slices contiguous and 16-byte aligned
        m1, m2 = spec.split
        w = torch.empty((m, n), dtype=torch.bfloat16,
                        device=p["trellis1"].device)
        tcq_lut.tcq_lut_dequant(p["trellis1"], tlut, spec.KV[0], m1, n,
                                out=w[:m1])
        tcq_lut.tcq_lut_dequant(p["trellis2"], tlut, spec.KV[1], m2, n,
                                out=w[m1:])
        return w
    raise ValueError(f"kind {spec.kind!r} has no dequant kernel")


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (rows, n) @ w (m, n)^T in float32: the reference's dot of bf16
    operands into float32 (fused._dot_v16, qlinear's xla path).  bf16
    products are exact in float32, so with TF32 off (PyTorch's default)
    this differs from it only in the order of the f32 sums."""
    return x.float() @ w.float().T


def _lut_matmul(spec: LinearSpec, p: dict, x: torch.Tensor,
                luts: dict) -> torch.Tensor:
    """tcq / tcomb / comb: x (rows, n) bf16 -> (rows, m) float32 without
    Wscale.  Up to 8 rows through the GEMV kernels (comb: K4 on each row
    half, outputs side by side), more through dequant_weight and a
    product."""
    m, n = spec.out_features, spec.in_features
    if x.shape[0] > tcq_lut.MAX_ROWS:
        return _product(x, dequant_weight(spec, p, luts))
    tlut = luts[spec.tcq_lut_key()]
    if spec.kind == "tcq":
        return tcq_lut.tcq_lut_gemv(x, p["trellis"], tlut, spec.KV[0], m, n)
    if spec.kind == "comb":
        m1, m2 = spec.split
        return torch.cat([
            tcq_lut.tcq_lut_gemv(x, p["trellis1"], tlut, spec.KV[0], m1, n),
            tcq_lut.tcq_lut_gemv(x, p["trellis2"], tlut, spec.KV[1], m2, n)],
            dim=1)
    require_equal_halves(spec)
    return tcq_lut.tcomb_lut_gemv(x, p["trellis1"], p["trellis2"], tlut,
                                  *spec.KV, m, n)


def _vq_matmul(spec: LinearSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    """vq: x (rows, n) bf16 -> (rows, m) float32 without Wscale.  Up to 8
    rows through K8, more through K9 and a product, as _lut_matmul."""
    if x.shape[0] > vq.MAX_ROWS:
        return _product(x, dequant_weight(spec, p, None))
    return vq.vq_gemv(x, p["qweight"], p["lut"], spec.bits, spec.vec,
                      spec.out_features, spec.in_features)


def _arith_matmul(spec: LinearSpec, p: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """tcq1 / tcq2: x (rows, n) -> (rows, m) float32 without Wscale.  Up
    to 256 rows through K1; more rows as 256-row chunks of K1 under a8,
    and under exact through the dequant kernel (K2 / K3) and a product."""
    m, n, KV, mode = (spec.out_features, spec.in_features, spec.KV[0],
                      spec.mode)
    x = x.contiguous()
    a8 = spec.impl == "a8"
    if x.shape[0] <= MAX_ROWS:
        return decode_gemv(mode, x, p["trellis"], KV, m, n, a8)
    if a8:
        return torch.cat([decode_gemv(mode, x[r:r + MAX_ROWS], p["trellis"],
                                      KV, m, n, a8)
                          for r in range(0, x.shape[0], MAX_ROWS)])
    return _product(x.to(torch.bfloat16), dequant_weight(spec, p, None))


def qlinear_apply(spec: LinearSpec, p: dict, z: torch.Tensor, pre_rot=None,
                  out_dtype=None, luts=None, rot_blocks: int = 1
                  ) -> torch.Tensor:
    """z (rows, in_features) -> (rows, out_features), Wscale applied in f32.

    pre_rot=su: z is UN-rotated; the rotation (z * su) @ H^T (block-
    diagonal in rot_blocks blocks for a row-parallel layer) is applied
    here, in float32 and kept float32 where the reference fuses it
    (can_fuse_rot), else cast back to z's dtype.  out_dtype overrides the
    output dtype (default z's dtype).  luts: the model's tables
    ({"tcq{S}": (2^S, 2) float32}), read by tcq / tcomb / comb."""
    odt = out_dtype or z.dtype
    rows = z.shape[0]
    fused = pre_rot is not None and can_fuse_rot(spec, rows, rot_blocks)
    if fused:
        z = hadamard_transform_t(z.float() * pre_rot.float(), rot_blocks)
    elif pre_rot is not None:
        z = hadamard_transform_t(z * pre_rot.to(z.dtype),
                                 rot_blocks).to(z.dtype)
    if spec.kind == "dense":
        return (z.float() @ p["w"].float().T).to(odt)
    if spec.kind == "dense_rot":
        y = z.float() @ p["w"].float().T
        return (y * p["wscale"].float()[None, :]).to(odt)
    if spec.impl not in IMPLS:
        raise ValueError(f"impl {spec.impl!r} not in {IMPLS}")
    if spec.impl == "dequant":
        y = _product(z.to(torch.bfloat16), dequant_weight(spec, p, luts))
    elif spec.kind in ("tcq", "tcomb", "comb"):
        y = _lut_matmul(spec, p, z.to(torch.bfloat16).contiguous(), luts)
    elif spec.kind == "vq":
        y = _vq_matmul(spec, p, z.to(torch.bfloat16).contiguous())
    elif spec.kind in ("tcq1", "tcq2"):
        y = _arith_matmul(spec, p, z if fused else z.to(torch.bfloat16))
    else:
        raise NotImplementedError(f"kind {spec.kind!r}")
    return (y * p["wscale"].float()[None, :]).to(odt)
