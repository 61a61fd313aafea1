"""K-means for codebook construction.

Counterpart of ``qpalette_tpu/utils/kmeans.py``: Lloyd's iterations on
the device (``kmeans``), and for 1-D data the exact dynamic-programming
solution (``kmeans1d_exact``, ``native/kmeans1d.cpp`` through
``ops/native_pack``; its build failing raises).  The reference seeds a
d > 1 run with jax.random.choice; the port seeds it with a
torch.Generator, so a table made here differs from one the reference
would make (the committed tables are shared).
"""

from __future__ import annotations

import numpy as np
import torch

from qpalette_tpu_torch.ops import native_pack
from qpalette_tpu_torch.utils.precision import full_f32

DIST_BYTES = 256 << 20  # the (rows, k) float32 distances of a step


def kmeans1d_exact(x: np.ndarray, k: int,
                   max_bins: int = 1 << 16) -> np.ndarray:
    """Exact 1-D k-means centroids (k,) float32, sorted ascending.  Above
    max_bins points, the sorted points are first averaged into max_bins
    equal-count bins weighted by their counts (the DP is O(k*n))."""
    xs = np.sort(np.asarray(x, np.float64).reshape(-1))
    n = xs.shape[0]
    w = None
    if n > max_bins:
        edges = (n * np.arange(max_bins + 1)) // max_bins
        w = np.diff(edges).astype(np.float64)
        cs = np.concatenate([[0.0], np.cumsum(xs)])
        xs = (cs[edges[1:]] - cs[edges[:-1]]) / w
    return native_pack.kmeans1d(xs, w, k).astype(np.float32)


def assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each point: x (N, d), c (K, d) -> (N,) int64,
    by |x|^2 + |c|^2 - 2 x.c in float32, DIST_BYTES of distances at a
    time."""
    c2 = (c * c).sum(1)[None, :]
    rows = max(1, DIST_BYTES // (4 * c.shape[0]))
    out = []
    with full_f32():
        for r0 in range(0, x.shape[0], rows):
            xr = x[r0:r0 + rows]
            # (|x|^2 + |c|^2) - 2 x.c, the factor 2 exact: one rounding
            d = torch.addmm((xr * xr).sum(1, keepdim=True) + c2, xr, c.T,
                            alpha=-2.0)
            out.append(d.argmin(1))
    return torch.cat(out)


def kmeans(x, k: int, iters: int = 40, seed: int = 0,
           device="cuda") -> np.ndarray:
    """Lloyd's k-means of x (N, d) on ``device``: (k, d) float32 numpy
    centroids, sorted lexicographically.  1-D data takes kmeans1d_exact.
    Each step sums the points of a cluster in float64 (the card adds them
    in no fixed order) and keeps a centroid whose cluster is empty."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d == 1:
        return kmeans1d_exact(x[:, 0], k)[:, None]
    xt = torch.as_tensor(x, device=device)
    gen = torch.Generator(device=xt.device)
    gen.manual_seed(seed)
    c = xt[torch.randperm(n, generator=gen, device=xt.device)[:k]].clone()
    x64 = xt.to(torch.float64)
    for _ in range(iters):
        a = assign(xt, c)
        cnt = torch.zeros(k, dtype=torch.float64, device=xt.device)
        cnt.index_add_(0, a, torch.ones_like(a, dtype=torch.float64))
        s = torch.zeros((k, d), dtype=torch.float64, device=xt.device)
        s.index_add_(0, a, x64)
        newc = (s / cnt.clamp(min=1.0)[:, None]).to(torch.float32)
        c = torch.where(cnt[:, None] > 0, newc, c)
    c = c.cpu().numpy()
    return c[np.lexsort(c.T[::-1])]
