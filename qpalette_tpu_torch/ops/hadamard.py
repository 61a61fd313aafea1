"""Randomized-Hadamard incoherence rotations.

Counterpart of ``qpalette_tpu/ops/hadamard.py``: the same constructions
(Sylvester, Paley I/II, Kronecker doubling, seeded orthogonal fallback),
the same factorization ``get_had_factors`` and the same factor order, so
rotated activations agree with the reference.  A transform of size
n = a*b is applied as two small dense matmuls over the Kronecker factors
(reshape to (..., a, b) and contract each axis), in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["get_had_factors", "hadamard_matrix", "hadamard_transform",
           "hadamard_transform_t", "random_signs"]


def _is_prime(q: int) -> bool:
    if q < 2:
        return False
    for f in range(2, int(q**0.5) + 1):
        if q % f == 0:
            return False
    return True


def _paley_core(q: int) -> np.ndarray:
    """Jacobsthal matrix Q[i, j] = chi(i - j) over GF(q), q prime."""
    residues = set((i * i) % q for i in range(1, q))
    chi = np.zeros(q, dtype=np.int64)
    for r in range(1, q):
        chi[r] = 1 if r in residues else -1
    i = np.arange(q)
    return chi[(i[:, None] - i[None, :]) % q]


def _paley1(q: int) -> np.ndarray:
    """Paley I Hadamard matrix of order q + 1 (q prime, q = 3 mod 4)."""
    Q = _paley_core(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 0] = -1
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    return H


def _paley2(q: int) -> np.ndarray:
    """Paley II Hadamard matrix of order 2(q + 1) (q prime, q = 1 mod 4)."""
    Q = _paley_core(q)
    m = q + 1
    C = np.zeros((m, m), dtype=np.int64)
    C[0, 1:] = 1
    C[1:, 0] = 1
    C[1:, 1:] = Q
    P = np.array([[1, 1], [1, -1]], dtype=np.int64)
    N = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    return np.kron(C, P) + np.kron(np.eye(m, dtype=np.int64), N)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(k: int) -> np.ndarray:
    """Orthogonal k x k matrix with H @ H.T = k * I (float64 numpy).

    Hadamard (entries +-1) when Sylvester/Paley/doubling constructs it;
    otherwise a seeded random orthogonal matrix scaled by sqrt(k)."""
    if k == 1:
        return np.ones((1, 1))
    if k & (k - 1) == 0:  # power of two: Sylvester
        H = np.array([[1.0]])
        while H.shape[0] < k:
            H = np.block([[H, H], [H, -H]])
        return H
    if k % 4 == 0:
        q = k - 1
        if _is_prime(q) and q % 4 == 3:
            return _paley1(q).astype(np.float64)
        q = k // 2 - 1
        if k % 8 == 4 and _is_prime(q) and q % 4 == 1:
            return _paley2(q).astype(np.float64)
    if k % 2 == 0:
        # composite even order: H_k = H_{k/2} (x) H_2
        H2 = np.array([[1.0, 1.0], [1.0, -1.0]])
        return np.kron(hadamard_matrix(k // 2), H2)
    rng = np.random.default_rng(k * 7919 + 13)
    A = rng.standard_normal((k, k))
    Qm, R = np.linalg.qr(A)
    Qm = Qm * np.sign(np.diag(R))[None, :]
    return Qm * np.sqrt(k)


def _odd_part(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


@functools.lru_cache(maxsize=None)
def get_had_factors(n: int) -> tuple[int, ...]:
    """Factor n into Kronecker factors, each <= 256 (reference rule:
    K = 4*odd(n) when a +-1 Hadamard of that order exists, else odd(n);
    then exactly two factors (n/b, b) with the widest power-of-two b)."""
    if n <= 0:
        raise ValueError(n)
    m = _odd_part(n)
    if m == 1:
        K = 1
    else:
        K = 4 * m
        Hk = hadamard_matrix(K)
        if not np.allclose(Hk @ Hk.T, K * np.eye(K)):
            raise ValueError(f"bad Hadamard order {K}")
        if np.abs(Hk).max() > 1.5:  # random-orthogonal fallback was used
            K = m
        if n % K != 0:
            K = m
    p2 = n // K
    if p2 & (p2 - 1) != 0:
        raise ValueError(f"n={n} must be K * 2^p")
    if n <= 256:
        return (n,)
    for b in (256, 128, 64, 32, 16, 8, 4, 2):
        if p2 % b == 0 and n // b <= 256:
            return (n // b, b)
    factors = [] if K == 1 else [K]
    while p2 > 256:
        factors.append(256)
        p2 //= 256
    if p2 > 1:
        factors.append(p2)
    factors = [factors[0]] + sorted(factors[1:])
    return tuple(factors)


@functools.lru_cache(maxsize=None)
def _factor_mats(n: int, transpose: bool) -> tuple:
    """(factors, [float64 numpy factor matrices]) for size n."""
    facs = get_had_factors(n)
    mats = []
    for k in facs:
        H = hadamard_matrix(k)
        mats.append(np.ascontiguousarray(H.T if transpose else H))
    return facs, mats


@functools.lru_cache(maxsize=None)
def _factor_tensors(n: int, transpose: bool, device: torch.device):
    facs, mats = _factor_mats(n, transpose)
    return facs, [torch.as_tensor(H, dtype=torch.float32, device=device)
                  for H in mats]


def _apply(x: torch.Tensor, n: int, transpose: bool) -> torch.Tensor:
    """x (..., n) -> x @ (H_n / sqrt(n)) in float32, H_n = kron(factors)."""
    shp = x.shape
    facs, mats = _factor_tensors(n, transpose, x.device)
    xf = x.to(torch.float32)
    if len(facs) == 1:
        y = xf.reshape(-1, n) @ mats[0]
    elif len(facs) == 2:
        a, b = facs
        y = mats[0].T @ xf.reshape(-1, a, b) @ mats[1]
    else:
        y = xf.reshape((-1,) + facs)
        for ax, H in enumerate(mats):
            y = torch.movedim(torch.movedim(y, 1 + ax, -1) @ H, -1, 1 + ax)
    return (y * (float(n) ** -0.5)).reshape(shp)


def _transform(x: torch.Tensor, blocks: int, transpose: bool) -> torch.Tensor:
    n = x.shape[-1]
    if n % blocks:
        raise ValueError((n, blocks))
    if blocks == 1:
        return _apply(x, n, transpose)
    xb = x.reshape(x.shape[:-1] + (blocks, n // blocks))
    return _apply(xb, n // blocks, transpose).reshape(x.shape)


def hadamard_transform(x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """Forward transform along the last axis, y = x @ H, float32 out (the
    rotation the int8 lm_head is built with).  ``blocks`` as in
    hadamard_transform_t."""
    return _transform(x, blocks, transpose=False)


def hadamard_transform_t(x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """Transpose transform along the last axis, y = x @ H^T, float32 out.

    ``blocks > 1`` applies the block-diagonal I_blocks (x) H^T of size
    n/blocks (the tensor-parallel rotation)."""
    return _transform(x, blocks, transpose=True)


def random_signs(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n,) float32 +-1 signs drawn by ``generator``, on its device (the SU
    of incoherence processing when the caller gives none).  The reference
    draws them with jax.random.bernoulli, which the port cannot
    reproduce; every path that must agree with it passes SU (the loader's
    ``su_for``, the head's ``seed*7+99``)."""
    bits = torch.randint(0, 2, (n,), generator=generator,
                         device=generator.device)
    return bits.to(torch.float32) * 2.0 - 1.0
