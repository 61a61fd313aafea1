"""csrc/v2_wide.cuh's v2_wide_kernel (K1 sum2 and dualmad at 8 < N <= 256)
emulated on the CPU for the rehearsals in test_torch_arith_wide.py (sum2)
and test_torch_dualmad_wide.py (dualmad).

The emulation follows the kernel on the plain words: the prologue's
workspace (a8's chunk scales over all N rows, then x in B-fragment order
at the kernel's byte offsets), the grid (m-groups of 8 m-tiles with a
partial last group, row groups of NT n-tiles, a cluster splitting k in
8-tile steps), each step's x slab copied from its contiguous bytes, every
n-tile's B registers read at the lane's offset in the slab against one A
decode of each tile (the tile policy's MMAs: sum2 one, dualmad two),
a8's int32 chunk fragments descaled at chunk boundaries, the fragments
summed over the cluster in rank order and written out by the epilogue's
index map.  Mutations: "offset" puts lane 2h+1's exact x words where lane
2h's go, "scale" takes each a8 scale over one row group's rows only,
"permute" swaps dualmad's h1 and h2 byte permutes of the a8 x word."""

import torch

from arith_fragment import (M32, S8_MMAS, c_frag, lane_weights, lane_windows,
                            prmt, sbytes)
from qpalette_tpu_torch.kernels import arith

WARPS, STEP = 8, 8  # kWideWarps (m-tiles a block), kWideTiles (a step)
CHUNK_TILES = arith.CHUNK // 16
MAX_CLUSTER, SMS = 8, 132


def n_tiles(ntot, a8, mode="sum2"):
    """The instance's n-tiles a warp (wide_rows): the fewest that hold an
    even share of the rows in the fewest row groups of at most
    WideTile::kMost n-tiles."""
    most = (16 if a8 else 32) if mode == "sum2" else (12 if a8 else 24)
    rg = -(-ntot // most)
    share = -(-ntot // rg)
    return min(nt for nt in (2, 4, 8, 12, 16, 24, 32)
               if nt >= share and nt <= most)


def stages(NT):
    """WideSmem's kStages."""
    return 3 if NT >= 24 else 4


def cluster_size(mgroups, rg, nst, NT, a8, mode="sum2"):
    """launch_wide's cluster size on SMS SMs (WideSmem's kStages,
    wide_min_blocks)."""
    acc = 4 * NT * (2 if a8 else 1)
    min_blocks = 3 if acc <= 16 else 2 if acc <= (32 if a8 else 64) else 1
    if mode == "dualmad" and not a8 and NT == 16:
        min_blocks = 1
    cs = 1
    while (cs < MAX_CLUSTER and mgroups * rg * cs < SMS * min_blocks
           and nst >= 2 * stages(NT) * cs):
        cs *= 2
    return cs


def x_offset(nt, t, NT, ntot, kt, a8):
    """wide_x_offset: bytes before lane 0's words of n-tile nt at k-tile t
    (ints, or tensors of them)."""
    y, j = nt // NT, nt % NT
    ntg = (torch.clamp(ntot - y * NT, max=NT) if torch.is_tensor(y)
           else min(NT, ntot - y * NT))
    return (y * kt * NT + t * ntg + j) * 128 * (1 if a8 else 2)


def workspace(x, NT, a8, mutate=None):
    """wide_x_kernel: (the workspace's words after its scale bytes, a flat
    int64 tensor of 32-bit values; a8: each chunk's (scale, 1/scale) as
    each row group's block reads it)."""
    N, k = x.shape
    kt, ntot = k // 16, -(-N // 8)
    rows, rg = 8 * ntot, -(-ntot // NT)
    xp = torch.zeros((rows, k), dtype=torch.float32)
    xp[:N] = x
    words = torch.zeros(rows * k * (1 if a8 else 2) // 4, dtype=torch.int64)
    nt = torch.arange(rows)[:, None] // 8
    off = x_offset(nt, torch.arange(kt)[None, :], NT, ntot, kt, a8)
    g = torch.arange(rows)[:, None] % 8
    scales = []
    if a8:
        q = torch.zeros((rows, k), dtype=torch.int64)
        for c0 in range(0, k, arith.CHUNK):
            groups = []
            for y in range(rg):
                r0, r1 = 8 * NT * y, min(N, 8 * NT * (y + 1))
                xs = x[r0:r1] if mutate == "scale" else x
                amax = xs[:, c0:c0 + arith.CHUNK].abs().amax()
                s = amax / torch.tensor(127.0) + 1e-30
                inv = torch.tensor(1.0) / s
                q[r0:r1, c0:c0 + arith.CHUNK] = torch.round(
                    x[r0:r1, c0:c0 + arith.CHUNK] * inv).to(torch.int64)
                groups.append((s, inv))
            scales.append(groups)
        qb = (q & 0xFF).reshape(rows, kt, 16)
        for c in range(4):  # lane 4g + c: [q(2c), q(2c+1), q(8+2c), q(9+2c)]
            w = (qb[..., 2 * c] | qb[..., 2 * c + 1] << 8
                 | qb[..., 8 + 2 * c] << 16 | qb[..., 9 + 2 * c] << 24)
            words[(off + (4 * g + c) * 4) // 4] = w
    else:
        bits = (xp.to(torch.bfloat16).view(torch.int16).to(torch.int64)
                & 0xFFFF).reshape(rows, kt, 16)

        def pair(col):
            return bits[..., col] | bits[..., col + 1] << 16

        for h in (0, 1):  # [pair(4h), pair(8+4h), pair(4h+2), pair(10+4h)]
            lane = 4 * g + (2 * (1 - h) if mutate == "offset" else 2 * h)
            for i, col in enumerate((4 * h, 8 + 4 * h, 4 * h + 2, 10 + 4 * h)):
                words[(off + lane * 8) // 4 + i] = pair(col)
    return words, scales


def a_regs(words, KV, mt, kt, a8, mode):
    """Each tile's A matrix of each MMA of the tile, decoded once from the
    lane registers: a8 [(mt, kt, 16, 32)] s8 hash bytes (dualmad: h1's,
    then h2's); exact sum2 [(mt, kt, 16, 16)] weights, exact dualmad two
    (mt, kt, 16, 8) tf32 weights (w0 of the four states, then w1:
    register r of lane (g, c) at fragment row g + 8*(r&1), k c + 4*(r>>1))."""
    u = lane_windows(words, KV).reshape(mt, kt, 32, 4)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    if a8:
        out = []
        for hash_fn, _ in S8_MMAS[mode]:
            a = torch.zeros((mt, kt, 16, 32), dtype=torch.int64)
            for r in range(4):
                sb = sbytes(hash_fn(u[..., r]))
                for b in range(4):
                    col = 4 * c + 16 * (r >> 1) + b
                    a[:, :, g + 8 * (r & 1), col] = sb[..., b]
            out.append(a)
        return out
    wl = lane_weights(u, mode)
    if mode == "sum2":
        a = torch.zeros((mt, kt, 16, 16), dtype=torch.int64)
        for r in range(4):
            for p in (0, 1):
                a[:, :, g + 8 * (r & 1), 2 * c + 8 * (r >> 1) + p] = (
                    wl[..., r, p])
        return [a]
    out = []
    for p in (0, 1):  # MMA 1: w0 (even columns), MMA 2: w1 (odd)
        a = torch.zeros((mt, kt, 16, 8), dtype=torch.int64)
        for r in range(4):
            a[:, :, g + 8 * (r & 1), c + 4 * (r >> 1)] = wl[..., r, p]
        out.append(a)
    return out


def b_regs(slab, a8, mode, mutate=None):
    """(..., 32 lanes, wide_words) slab words of an (n-tile, k-tile) ->
    each MMA's B matrix (..., 32 or 16 or 8, 8) from the lane's
    registers."""
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    if a8:
        sels = [sel for _, sel in S8_MMAS[mode]]
        if mutate == "permute":
            sels = sels[::-1]
        out = []
        for pair in sels:
            B = torch.zeros(slab.shape[:-2] + (32, 8), dtype=torch.int64)
            for reg, sel in enumerate(pair):
                sb = sbytes(prmt(slab[..., 0], sel))  # (..., 32, 4)
                for b in range(4):
                    B[..., 4 * c + 16 * reg + b, g] = sb[..., b]
            out.append(B)
        return out

    def half(i, p):  # bf16 column 2c + 8i + p as an f32 (tf32) value
        h = ((slab[..., i] >> (16 * p)) & 0xFFFF) << 16
        return (h & M32).to(torch.int32).view(torch.float32)

    if mode == "sum2":
        B = torch.zeros(slab.shape[:-2] + (16, 8), dtype=torch.float32)
        for i in (0, 1):  # b.x, b.y: columns 2c + 8i, +1
            for p in (0, 1):
                B[..., 2 * c + 8 * i + p, g] = half(i, p)
        return [B]
    out = []  # MMA p: b.x, b.y's half p moved into the high half
    for p in (0, 1):
        B = torch.zeros(slab.shape[:-2] + (8, 8), dtype=torch.float32)
        for i in (0, 1):
            B[..., c + 4 * i, g] = half(i, p)
        out.append(B)
    return out


def emulate(x, trellis, KV, m, k, a8, mode="sum2", cs=None, mutate=None):
    """v2_wide_kernel's y (N, m) float32 and a8's int32 chunk sums
    {(chunk, m-group, row group): (x rows, m rows)}, block by block."""
    N = x.shape[0]
    kt, mtiles, ntot = k // 16, m // 16, -(-N // 8)
    NT = n_tiles(ntot, a8, mode)
    rg, mgroups, nst = -(-ntot // NT), -(-mtiles // WARPS), -(-kt // STEP)
    cs = cs or cluster_size(mgroups, rg, nst, NT, a8, mode)
    words, scales = workspace(x, NT, a8, mutate)
    A = a_regs(trellis, KV, mtiles, kt, a8, mode)
    W = 1 if a8 else 2
    out = torch.zeros((N, m))
    chunk_sums = {}
    for mg in range(mgroups):
        nact = min(WARPS, mtiles - mg * WARPS)
        for y in range(rg):
            ntg = min(NT, ntot - y * NT)
            parts = []
            for rank in range(cs):
                s0 = nst * rank // cs
                nsteps = nst * (rank + 1) // cs - s0
                ta, tb = s0 * STEP, min(kt, (s0 + nsteps) * STEP)
                xsrc = x_offset(y * NT, ta, NT, ntot, kt, a8)
                acc = torch.zeros((nact, ntg, 16, 8))
                di = torch.zeros((nact, ntg, 16, 8), dtype=torch.int64)
                ch = -1
                # the x slots (stale words stay between steps)
                slots = torch.zeros((stages(NT), STEP * NT * 32 * W),
                                    dtype=torch.int64)
                for s in range(nsteps):
                    n = min(STEP, tb - ta - s * STEP)
                    t0 = ta + s * STEP
                    if a8 and t0 // CHUNK_TILES != ch:
                        if ch >= 0:
                            acc, di = descale(acc, di, scales[ch][y][0],
                                              (ch, mg, y), chunk_sums)
                        ch = t0 // CHUNK_TILES
                    # the step's x: one copy of its contiguous bytes into
                    # slot s % S; every lane reads its words of all NT
                    # n-tiles at t*ntg + j (past ntg: other words of the
                    # slot, an index error if outside it), the MMAs on
                    # n-tiles >= ntg feed fragments never stored
                    b0 = (xsrc + s * STEP * ntg * 128 * W) // 4
                    slot = slots[s % stages(NT)]
                    slot[:n * ntg * 32 * W] = words[b0:b0 + n * ntg * 32 * W]
                    t_, j_, l_, w_ = torch.meshgrid(
                        torch.arange(n), torch.arange(NT), torch.arange(32),
                        torch.arange(W), indexing="ij")
                    read = slot[((t_ * ntg + j_) * 32 + l_) * W + w_]
                    Bs = b_regs(read[:, :ntg], a8, mode, mutate)
                    Aws = [a[mg * WARPS:mg * WARPS + nact, t0:t0 + n]
                           for a in A]
                    if a8:  # int32 in the kernel: exact products and sums
                        for Aw, B in zip(Aws, Bs):
                            di = di + torch.einsum("wtik,tjkn->wjin", Aw, B)
                        # |w| <= 256 (sum2) or 512 (dualmad), |q| <= 127
                        assert int(di.abs().max()) < 1 << (
                            24 if mode == "sum2" else 25)
                    else:  # the tile's MMAs an n-tile, f32 sums
                        for t in range(n):
                            for Aw, B in zip(Aws, Bs):
                                acc = acc + torch.einsum(
                                    "wik,jkn->wjin", Aw[:, t].float(), B[t])
                if a8 and ch >= 0:
                    acc, di = descale(acc, di, scales[ch][y][0], (ch, mg, y),
                                      chunk_sums)
                g, c = torch.arange(32) >> 2, torch.arange(32) & 3
                parts.append(torch.stack([c_frag(acc[:, j], g, c)
                                          for j in range(ntg)], 1))
            # the epilogue: lane (g, c)'s float4, summed in rank order, is
            # rows 2g, 2g+1 of x rows 2c (x, z) and 2c+1 (y, w)
            v = torch.zeros_like(parts[0])
            for p in parts:
                v = v + p
            for w in range(nact):
                for j in range(ntg):
                    for lane in range(32):
                        row = (mg * WARPS + w) * 16 + 2 * (lane >> 2)
                        xr = (y * NT + j) * 8 + 2 * (lane & 3)
                        f = v[w, j, lane] * arith.MAD_INV
                        if xr < N:
                            out[xr, row:row + 2] = f[0::2]
                        if xr + 1 < N:
                            out[xr + 1, row:row + 2] = f[1::2]
    return out, chunk_sums


def descale(acc, di, sc, key, chunk_sums):
    """A chunk boundary: the f32 fragments take (float)int32 * scale, and
    the int32 fragments (nact, ntg, 16, 8) are gathered un-permuted by key
    (chunk, m-group, row group) as (x rows, m rows) for the exact check
    (fragment row fr is tile row 2*(fr%8) + fr/8)."""
    nact, ntg = di.shape[:2]
    tile_row = 2 * (torch.arange(16) % 8) + torch.arange(16) // 8
    rows = torch.zeros((8 * ntg, 16 * nact), dtype=torch.int64)
    for w in range(nact):
        rows.view(8 * ntg, nact, 16)[:, w, tile_row] = (
            di[w].permute(0, 2, 1).reshape(8 * ntg, 16))
    chunk_sums[key] = chunk_sums.get(key, 0) + rows
    return acc + di.to(torch.float32) * sc, torch.zeros_like(di)


def chunk_sums_exact(sums, x, words, mode, KV, m, k):
    """Every a8 int32 chunk sum of the emulation equals the integer product
    of the chunk's q (one scale over all N rows) and the weights."""
    N = x.shape[0]
    w_int = arith.arith_weights_mat(words, mode, KV, m, k)
    NT = n_tiles(-(-N // 8), True, mode)
    for (ch, mg, yg), got in sums.items():
        c0 = ch * arith.CHUNK
        xc = x[:, c0:c0 + arith.CHUNK]
        s = xc.abs().amax() / torch.tensor(127.0) + 1e-30
        q = torch.round(xc * (torch.tensor(1.0) / s)).to(torch.int64)
        r0 = yg * NT * 8
        r1 = min(N, r0 + got.shape[0])
        m0 = mg * WARPS * 16
        full = q[r0:r1] @ w_int[m0:m0 + got.shape[1], c0:c0 + arith.CHUNK].T
        assert torch.equal(got[:r1 - r0], full), (N, ch, mg, yg)
