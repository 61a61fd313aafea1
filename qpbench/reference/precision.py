"""The controls: the reference's arithmetic one precision step below what a
configuration states (its ``quantization.control``).

"fp8" rounds every projection's decoded weights and rotated input to
float8 e4m3 (the step below bf16); "int4" quantizes every rotated input
to 4-bit integers with one absmax scale a 512-column chunk of a row (the
step below int8 activations).  ``None`` leaves float32 as it is.
"""

from __future__ import annotations

import torch

CHUNK = 512


def round_input(x: torch.Tensor, control) -> torch.Tensor:
    if control == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    if control == "int4":
        n = x.shape[-1]
        pad = -n % CHUNK  # a last chunk shorter than 512 has its own scale
        xc = torch.nn.functional.pad(x, (0, pad))
        xc = xc.reshape(x.shape[:-1] + ((n + pad) // CHUNK, CHUNK))
        s = xc.abs().amax(dim=-1, keepdim=True) / 7.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.round(xc / s).clamp(-7, 7) * s
        return q.reshape(x.shape[:-1] + (n + pad,))[..., :n]
    if control is not None:
        raise ValueError(f"control {control!r}")
    return x


def round_weight(w: torch.Tensor, control) -> torch.Tensor:
    return w.to(torch.float8_e4m3fn).float() if control == "fp8" else w
