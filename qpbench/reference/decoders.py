"""Plain decoding of packed weights, and the incoherence rotation.

A frozen, self-contained copy of the published formats, kept apart from
the program under test so that the benchmark's reference shares no code
with it.  Each weight family is a file of its own,
``reference/families/<family>.py``, found by the first field of a
quantizer string (``tcq_6_none_0.9`` -> ``tcq``); it holds ``parse``
(the string's parameters), ``word_shape``, ``decode`` (its words -> the
(m, k) float32 matrix without row scales) and ``X_BYTES`` (the bytes a
GEMV reads of each input element, for the roofline).  The trellis
families share the canonical words here: (T, 8*KV/V) 32-bit words a
projection, T = (m/16)*(k/16) tiles in tile-row-major order, state i of
a tile the 16-bit window at bit KV*i of the tile's circular stream.

The rotation is the randomized Hadamard transform z = (x * SU) @ H^T /
sqrt(n), H the Kronecker product of the factors of ``had_factors(n)``.

Everything here runs in float32 (int64 for the bit arithmetic) and
imports nothing but numpy, torch and the benchmark's file loader.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from qpbench import files

M32 = 0xFFFFFFFF
TILE = 16
REPO = Path(__file__).resolve().parents[2]  # the checkout's root


def scheme(qstr: str, root: Path = files.ROOT) -> dict:
    """A quantizer string -> {"family", "codec" (its family's module),
    and the family's parameters}."""
    family = qstr.split("_")[0]
    codec = files.load("reference/families", family, root)
    return {"family": family, "codec": codec, **codec.parse(qstr)}


def word_shape(sch: dict, m: int, k: int) -> tuple:
    return sch["codec"].word_shape(sch, m, k)


def decode(sch: dict, words: torch.Tensor, m: int, k: int,
           rows: slice = None) -> torch.Tensor:
    """The (m, k) float32 weight matrix (without its row scales) of a
    scheme's words; ``rows``, a slice of 16-row multiples, decodes those
    rows alone (tile-row-major words)."""
    if rows is not None:
        tiles_a_row = k // TILE
        words = words[rows.start // TILE * tiles_a_row:
                      rows.stop // TILE * tiles_a_row]
        m = rows.stop - rows.start
    return sch["codec"].decode(sch, words, m, k)


def trellis_words(kv: int, v: int, m: int, k: int) -> tuple:
    """The canonical word array of a trellis projection."""
    return ((m // TILE) * (k // TILE), 8 * kv // v)


def unpack_states(words: torch.Tensor, kv: int, v: int = 2) -> torch.Tensor:
    """words (T, 8*KV/v) -> the 256/v circular 16-bit states a tile."""
    n_words = words.shape[-1]
    off = torch.arange(256 // v, dtype=torch.int64, device=words.device) * kv
    w0 = off >> 5
    w1 = (w0 + 1) % n_words
    sh = off & 31
    u = words.to(torch.int64) & M32
    return ((u[..., w0 % n_words] >> sh) | (u[..., w1] << (32 - sh))) & 0xFFFF


def signed_bytes(h: torch.Tensor) -> torch.Tensor:
    """int64 h (< 2^32) -> (..., 4) signed bytes, lowest first."""
    b = torch.stack([(h >> (8 * i)) & 255 for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b)


def tiles_to_matrix(tiles: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """(T, 16, 16) tile-row-major -> (m, k)."""
    t = tiles.reshape(m // TILE, k // TILE, TILE, TILE)
    return t.permute(0, 2, 1, 3).reshape(m, k)


# ---------------------------------------------------------------------------
# the rotation
# ---------------------------------------------------------------------------

def _is_prime(q: int) -> bool:
    return q >= 2 and all(q % f for f in range(2, int(q ** 0.5) + 1))


def _jacobsthal(q: int) -> np.ndarray:
    squares = {(i * i) % q for i in range(1, q)}
    chi = np.array([0] + [1 if r in squares else -1 for r in range(1, q)])
    i = np.arange(q)
    return chi[(i[:, None] - i[None, :]) % q]


@functools.lru_cache(maxsize=None)
def hadamard(k: int) -> np.ndarray:
    """k x k with H @ H.T = k I: Sylvester, Paley I (k - 1 prime, 3 mod 4),
    Paley II (k/2 - 1 prime, 1 mod 4), doubling, else a seeded random
    orthogonal matrix (numpy seed 7919 k + 13) times sqrt(k)."""
    if k == 1:
        return np.ones((1, 1))
    if k & (k - 1) == 0:
        h = np.array([[1.0]])
        while h.shape[0] < k:
            h = np.block([[h, h], [h, -h]])
        return h
    if k % 4 == 0:
        q = k - 1
        if _is_prime(q) and q % 4 == 3:
            h = np.ones((k, k))
            h[1:, 0] = -1
            h[1:, 1:] = _jacobsthal(q) + np.eye(q)
            return h
        q = k // 2 - 1
        if k % 8 == 4 and _is_prime(q) and q % 4 == 1:
            c = np.zeros((q + 1, q + 1))
            c[0, 1:] = 1
            c[1:, 0] = 1
            c[1:, 1:] = _jacobsthal(q)
            return (np.kron(c, [[1, 1], [1, -1]])
                    + np.kron(np.eye(q + 1), [[1, -1], [-1, -1]]))
    if k % 2 == 0:
        return np.kron(hadamard(k // 2), [[1.0, 1.0], [1.0, -1.0]])
    a = np.random.default_rng(k * 7919 + 13).standard_normal((k, k))
    qm, r = np.linalg.qr(a)
    return qm * np.sign(np.diag(r))[None, :] * np.sqrt(k)


@functools.lru_cache(maxsize=None)
def had_factors(n: int) -> tuple:
    """Kronecker factors of the size-n rotation, each at most 256: K =
    4*odd(n) where a +-1 matrix of that order exists, else odd(n), then
    (n/b, b) with the widest power of two b."""
    m = n
    while m % 2 == 0:
        m //= 2
    if m == 1:
        big = 1
    else:
        big = 4 * m
        if np.abs(hadamard(big)).max() > 1.5 or n % big:
            big = m
    p2 = n // big
    if n <= 256:
        return (n,)
    for b in (256, 128, 64, 32, 16, 8, 4, 2):
        if p2 % b == 0 and n // b <= 256:
            return (n // b, b)
    factors = [] if big == 1 else [big]
    while p2 > 256:
        factors.append(256)
        p2 //= 256
    if p2 > 1:
        factors.append(p2)
    return tuple([factors[0]] + sorted(factors[1:]))


def rotate(x: torch.Tensor, su: torch.Tensor) -> torch.Tensor:
    """(x * su) @ H^T / sqrt(n) along the last axis, float32."""
    n = x.shape[-1]
    y = x.float() * su.float()
    facs = had_factors(n)
    lead = y.shape[:-1]
    y = y.reshape((-1,) + facs)
    for ax, f in enumerate(facs):
        h = torch.as_tensor(hadamard(f), dtype=torch.float32, device=x.device)
        y = torch.movedim(torch.movedim(y, 1 + ax, -1) @ h.T, -1, 1 + ax)
    return (y * n ** -0.5).reshape(lead + (n,))
