"""The benchmark's weights, drawn on the device from ``--seed``.

Every tensor has a name, and its own ``torch.Generator`` on the device,
seeded from the run's seed and the name, so that any one tensor can be
drawn again alone: the program receives each once at set-up, and the
reference draws each again, a layer at a time, after the window.  Draws
are made in the type they are served in: packed words as int32 holding
32 random bits, embedding and bf16 head rows as bf16 N(0, 0.02^2), signs
as +-1, row scales uniform in [0.015, 0.025].  The norm weights are ones
on both sides.
"""

from __future__ import annotations

import zlib

import torch

from qpbench.reference import decoders

WORD_LO, WORD_HI = -(1 << 31), 1 << 31
STD = 0.02
SCALE_LO, SCALE_HI = 0.015, 0.025


class Draws:
    """The named draws of one seed on one device, for one configuration
    (``config["model"]``: the sizes)."""

    def __init__(self, seed: int, model: dict, device):
        self.seed = int(seed)
        self.model = model
        self.device = torch.device(device)

    def _gen(self, name: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + zlib.crc32(name.encode()))
                      % (1 << 63))
        return g

    def normal(self, name, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen(name),
                           dtype=torch.bfloat16, device=self.device) * STD

    def words(self, name, shape) -> torch.Tensor:
        return torch.randint(WORD_LO, WORD_HI, shape,
                             generator=self._gen(name), dtype=torch.int32,
                             device=self.device)

    def row_scales(self, name, m) -> torch.Tensor:
        u = torch.rand((m,), generator=self._gen(name), dtype=torch.float32,
                       device=self.device)
        return SCALE_LO + (SCALE_HI - SCALE_LO) * u

    def signs(self, name, n) -> torch.Tensor:
        """n signs (float32 +-1)."""
        bits = torch.randint(0, 2, (n,), generator=self._gen(name),
                             device=self.device)
        return bits.to(torch.float32) * 2.0 - 1.0

    def embed(self) -> torch.Tensor:
        md = self.model
        return self.normal("embed", (md["vocab_size"], md["hidden_size"]))

    def group(self, layer: int, name: str, scheme: dict, m: int, n: int):
        """(words, row scales) of a projection group of m rows and n
        columns."""
        key = f"layers.{layer}.{name}"
        return (self.words(f"{key}.words", decoders.word_shape(scheme, m, n)),
                self.row_scales(f"{key}.wscale", m))

    def rotation_signs(self, layer: int, su: str) -> torch.Tensor:
        """A rotation group's signs."""
        md = self.model
        n = {"su_qkv": md["hidden_size"],
             "su_o": md["num_attention_heads"] * md["head_dim"],
             "su_ug": md["hidden_size"],
             "su_dp": md["intermediate_size"]}[su]
        return self.signs(f"layers.{layer}.{su}", n)
