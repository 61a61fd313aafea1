"""Incoherence processing, the quantizer_str DSL and per-projection
artifacts.

Counterpart of ``qpalette_tpu/quant/incoherent.py``: ``quantize_linear``
rotates W (out, in) as Wr = (W * SU) @ H (left-only incoherence, the
runtime rotating activations by the transpose), divides each row by
Wscale = RMS / (codebook RMS * scale), quantizes it with the scheme's
quantizer and returns the artifact dict (words, SU, Wscale, the tables
the loader needs, and meta with the Hadamard stamp and error
diagnostics).  The quantizer_str families (``QuantizerSpec`` /
``parse_quantizer_str``):

  tcq_{KV}_{hess|none}_{scale}       trellis-coded (LUT), KV/2 bits/weight
  tcq1_/tcq1x2_/tcq2_/tcq2s_{KV}_... arithmetic-decode trellis
  tcomb_{KV1}_{KV2}_{r}_{hess}_{s}   input-split fractional TCQ
  comb_{KV1}_{KV2}_{r}_{hess}_{s}    output-split fractional TCQ
  ldlq_{vec}_{bits}_{hess}_{scale}   VQ/SQ via LDLQ
  sq_{bits}_{hess}_{scale}           scalar VQ
  vq2_{bits}_{hess}_{scale}          2-dim VQ
  rotfp16                            rotated dense baseline

and the artifact files of ``quant/incoherent.py`` (``artifact_path``,
``save_artifact``, ``load_artifact``): one ``.npz`` a projection, its
arrays beside a JSON ``__meta__`` string, read and written unchanged by
either package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from qpalette_tpu_torch.ops.codebooks import (lut_rms, tlut_bits_for_kv,
                                              trellis_lut, trellis_lut_arith,
                                              trellis_tlut, vq_lut)
from qpalette_tpu_torch.ops.hadamard import (get_had_factors,
                                             hadamard_transform,
                                             random_signs)


@dataclass(frozen=True)
class QuantizerSpec:
    """Parsed quantizer_str."""
    qstr: str
    family: str
    use_hess: bool
    scale_override: float
    KV: tuple | None = None
    ratio: float | None = None
    bits: int | None = None
    vec: int | None = None

    @property
    def avg_bits(self) -> float:
        """Bits per weight, excluding LUT overhead."""
        if self.family in ("tcq1", "tcq1x2"):
            return float(self.KV[0])
        if self.family in ("tcq", "tcq2", "tcq2s"):
            return self.KV[0] / 2
        if self.family in ("tcomb", "comb"):
            return (self.KV[0] + self.KV[1]) / 4
        return self.bits / self.vec


def parse_quantizer_str(qstr: str) -> QuantizerSpec:
    parts = qstr.split("_")
    fam = parts[0]
    if fam in ("tcq", "tcq1", "tcq1x2", "tcq2", "tcq2s"):
        _, kv, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv),))
    if fam in ("tcomb", "comb"):
        _, kv1, kv2, ratio, hess, scale = parts
        return QuantizerSpec(qstr, fam, hess == "hess", float(scale),
                             KV=(int(kv1), int(kv2)), ratio=float(ratio))
    if fam == "ldlq":
        _, vec, bits, hess, scale = parts
        return QuantizerSpec(qstr, "ldlq", hess == "hess", float(scale),
                             bits=int(bits), vec=int(vec))
    if fam == "sq":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "sq", hess == "hess", float(scale),
                             bits=int(bits), vec=1)
    if fam == "vq2":
        _, bits, hess, scale = parts
        return QuantizerSpec(qstr, "vq2", hess == "hess", float(scale),
                             bits=int(bits), vec=2)
    if fam == "rotfp16":
        return QuantizerSpec(qstr, "rotfp16", False, 1.0, bits=16, vec=1)
    raise ValueError(f"unknown quantizer_str {qstr!r}")


ARITH_MODES = {"tcq1": "1mad", "tcq1x2": "2mad", "tcq2": "dualmad",
               "tcq2s": "sum2"}


def codebook_rms(spec: QuantizerSpec) -> float:
    """RMS of the scheme's codebook (1 for the SQ/VQ families)."""
    if spec.family in ("tcq", "tcomb", "comb"):
        return lut_rms(trellis_lut(tlut_bits_for_kv(max(spec.KV))))
    if spec.family in ARITH_MODES:
        return lut_rms(trellis_lut_arith(ARITH_MODES[spec.family]))
    return 1.0


def _rotate_weight(W: torch.Tensor, SU: torch.Tensor,
                   rot_blocks: int = 1) -> torch.Tensor:
    return hadamard_transform(W.to(torch.float32) * SU[None, :],
                              blocks=rot_blocks)


def rotate_hessian(H: torch.Tensor, SU: torch.Tensor,
                   rot_blocks: int = 1) -> torch.Tensor:
    """HRr = H^T S H S H-hat: the Hessian in the rotated input frame."""
    B = hadamard_transform(H.to(torch.float32) * SU[None, :],
                           blocks=rot_blocks)
    return hadamard_transform(B.T * SU[None, :], blocks=rot_blocks).T


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    # by a 0-d tensor: the card divides by a Python float through its
    # reciprocal, one ulp off the reference's division
    return x / torch.tensor(s, dtype=torch.float32, device=x.device)


def quantize_linear(W, quantizer_str: str, SU=None, H=None, seed: int = 0,
                    rot_blocks: int = 1, device="cuda",
                    return_hat: bool = False):
    """Quantize one linear weight W (out, in) into its artifact dict, on
    ``device``.  SU: the (in,) signs (None: random_signs from seed; the
    loader passes ``su_for``).  H: the (in, in) input Hessian, used by the
    ``_hess_`` schemes.  return_hat: return (art, Wr-hat), the quantizer's
    own (m, n) float32 estimate of the rotated, row-normalised weight on
    ``device``.  rot_blocks > 1 rotates W and H block-diagonally, I_b x
    H-hat_{n/b}: a row-parallel layer's shards each rotate their own slice
    of the input (parallel/tp.py); the stamp is then get_had_factors(n/b)."""
    from qpalette_tpu_torch.quant import quantizers
    spec = parse_quantizer_str(quantizer_str)
    device = torch.device(device)
    W = torch.as_tensor(np.asarray(W, np.float32) if not isinstance(
        W, torch.Tensor) else W, device=device).to(torch.float32)
    m, n = W.shape
    if SU is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        SU = random_signs(n, gen)
    SU = torch.as_tensor(np.asarray(SU, np.float32) if not isinstance(
        SU, torch.Tensor) else SU, device=device).to(torch.float32)

    Wr = _rotate_weight(W, SU, rot_blocks)
    # float32 throughout, as the reference's (its float64 cast is float32
    # without jax's x64); all-zero rows (a padded vocab) get a benign scale
    row_rms = torch.sqrt(torch.mean(Wr * Wr, dim=1)).clamp(min=1e-8)
    Wscale = _div(row_rms, codebook_rms(spec) * spec.scale_override)
    Wr = Wr / Wscale[:, None]

    use_hess = spec.use_hess and H is not None
    HRr = None
    if use_hess:
        Ht = torch.as_tensor(np.asarray(H, np.float32) if not isinstance(
            H, torch.Tensor) else H, device=device)
        HRr = rotate_hessian(Ht, SU, rot_blocks)

    fam = spec.family
    if fam == "tcq":
        linear, hatWr = quantizers.quantize_mat_tcq(Wr, HRr, spec.KV[0],
                                                    use_hess)
    elif fam in ("tcq1", "tcq1x2"):
        linear, hatWr = quantizers.quantize_mat_tcq1(
            Wr, HRr, spec.KV[0], mode=ARITH_MODES[fam], use_hess=use_hess)
    elif fam in ("tcq2", "tcq2s"):
        linear, hatWr = quantizers.quantize_mat_tcq2(
            Wr, HRr, spec.KV[0], use_hess=use_hess, mode=ARITH_MODES[fam])
    elif fam == "tcomb":
        if spec.ratio != 0.5:
            raise ValueError("tcomb supports ratio 0.5 only")
        linear, hatWr = quantizers.quantize_mat_combt(
            Wr, HRr, spec.KV[0], spec.KV[1], use_hess)
    elif fam == "comb":
        m0 = int(m * spec.ratio)
        linear, hatWr = quantizers.quantize_mat_comb(
            Wr, HRr, spec.KV[0], spec.KV[1], (m0, m - m0), use_hess)
    elif fam == "ldlq":
        linear, hatWr = quantizers.quantize_mat_vq(Wr, HRr, spec.bits,
                                                   spec.vec, use_hess)
    elif fam == "rotfp16":
        linear = {"kind": "dense_rot", "w": Wr.cpu().numpy(),
                  "in_features": n, "out_features": m}
        hatWr = Wr
    elif fam in ("sq", "vq2"):
        from qpalette_tpu_torch.quant.als import quantize_mat_vq_als
        linear, hatWr = quantize_mat_vq_als(Wr, HRr, spec.bits, spec.vec,
                                            use_hess=use_hess)
    else:
        raise ValueError(fam)

    scaled_W = Wr * Wscale[:, None]
    diff = scaled_W - hatWr * Wscale[:, None]
    orig_err = torch.mean(diff * diff)
    rel_err = float(orig_err / torch.mean(scaled_W * scaled_W))
    # incoherence diagnostics: kurtosis and skewness of the normalised rows
    Wn = Wr / torch.sqrt(torch.mean(Wr * Wr, dim=1, keepdim=True)).clamp(
        min=1e-12)
    kurt = float(torch.mean(torch.mean(Wn ** 4, dim=1) - 3.0))
    skew = float(torch.mean(torch.mean(Wn ** 3, dim=1)))
    art = {
        "meta": {
            "quantizer_str": quantizer_str,
            "kind": linear.pop("kind"),
            "in_features": n,
            "out_features": m,
            "rot_info": "skip_r",
            "rot_blocks": rot_blocks,
            # the rotation's Kronecker factors: the loader re-quantizes an
            # artifact whose stamp is not get_had_factors(n)
            "had_factors": list(get_had_factors(n // rot_blocks)),
            "err": rel_err,
            "orig_err": float(orig_err),
            "kurtosis": kurt,
            "skewness": skew,
            **{k: v for k, v in linear.items()
               if not isinstance(v, np.ndarray)},
        },
        "SU": SU.cpu().numpy(),
        "Wscale": Wscale.cpu().numpy(),
    }
    art.update({k: v for k, v in linear.items() if isinstance(v, np.ndarray)})
    if art["meta"]["kind"] in ("tcq", "tcomb", "comb"):
        art["tlut"] = np.asarray(trellis_tlut(art["meta"]["tlut_bits"]))
    elif art["meta"]["kind"] == "vq" and "lut" not in art:
        art["lut"] = np.asarray(vq_lut(spec.bits, spec.vec, device=device))
    return (art, hatWr) if return_hat else art


# meta entries that the quantizer writes as tuples; JSON stores lists
_TUPLE_META = ("in_part", "out_part")


def artifact_path(save_dir: str, model_key: str, seed: int,
                  quantizer_str: str, layer_idx: int, layer_key: str) -> str:
    return os.path.join(save_dir, model_key, f"left_only_seed{seed}_cache",
                        quantizer_str, f"{layer_idx}_{layer_key}.npz")


def save_artifact(art: dict, path: str) -> None:
    """Write art's arrays and its JSON meta to path (an ``.npz``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: v for k, v in art.items() if k != "meta"}
    np.savez(path, __meta__=json.dumps(art["meta"]), **arrays)


def load_artifact(path: str) -> dict:
    """An artifact's arrays and meta; ``in_part`` / ``out_part`` come back
    as the tuples the quantizer wrote."""
    with np.load(path, allow_pickle=False) as z:
        art = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"]))
    for key in _TUPLE_META:
        if key in meta:
            meta[key] = tuple(meta[key])
    art["meta"] = meta
    return art
