"""csrc/arith_wide.cuh's wide_gemv_kernel (K1 at 8 < N <= 256, every mode)
emulated on the CPU for the rehearsals in test_torch_arith_wide.py (sum2),
test_torch_dualmad_wide.py (dualmad) and test_torch_v1_wide.py (1mad,
2mad).

The emulation follows the kernel on the plain words: the prologue's
workspace (a8's chunk scales over all N rows, V=1 a8's -510 * sum(q) of
each row an 8-tile step, then x in the tile order's B-fragment order at
the kernel's byte offsets), the grid (m-groups of 8 m-tiles with a
partial last group, row groups of NT n-tiles, a cluster splitting k in
8-tile steps), each step's x slab copied from its contiguous bytes, every
n-tile's B registers read at the lane's offset in the slab against one A
decode of each tile (the tile policy's MMAs: sum2 one, the other modes
two), V=1 a8's row sums added to the int32 fragments a step, a8's int32
chunk fragments descaled at chunk boundaries, the fragments summed over
the cluster in rank order and written out by the epilogue's index map.
Mutations: "offset" puts lane 2h+1's exact x words where lane 2h's go,
"scale" takes each a8 scale over one row group's rows only, "permute"
swaps dualmad's h1 and h2 byte permutes of the a8 x word, "order" writes
x in V=2's order under the V=1 lane map, "chunkbias" adds a chunk's whole
V=1 bias at the rank's first step of the chunk (wrong on a rank that
holds part of it), "hash" decodes 2mad's states with 1mad's hash."""

import torch

from arith_fragment import (M32, S8_MMAS, c_frag, lane_weights, lane_windows,
                            prmt, sbytes, v1_hash, v1_lane_windows)
from qpalette_tpu_torch.kernels import arith

WARPS, STEP = 8, 8  # kWideWarps (m-tiles a block), kWideTiles (a step)
V1_BIAS = 510  # kV1Bias: the V=1 weight is its hash's byte sum - 510
# V=1 a8: the byte permutes of the lane's x word that give the B registers
# b0, b1 of MMA 1 (columns 4c, 4c+1) and MMA 2 (4c+2, 4c+3)
V1_PERMS = ((0x0000, 0x1111), (0x2222, 0x3333))
# a8 int32 fragments stay below 2^bits within a chunk: |w| <= 256 (sum2),
# 512 (dualmad), V=1 byte sums <= 1020, times |q| <= 127 over 512 columns
FRAG_BITS = {"sum2": 24, "dualmad": 25, "1mad": 27, "2mad": 27}


def v1(mode):
    return arith.ARITH_V[mode] == 1
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
    wide_min_blocks: one block at 8 A registers, exact, 16 n-tiles, and
    V=1 exact at 12)."""
    acc = 4 * NT * (2 if a8 else 1)
    min_blocks = 3 if acc <= 16 else 2 if acc <= (32 if a8 else 64) else 1
    if mode != "sum2" and not a8 and (NT == 16 or v1(mode) and NT == 12):
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


def x_cols(mode, c, mutate=None):
    """(p, s): lane c's x columns p, p+1, p+s, p+s+1 of a k-tile in the
    tile order's B-fragment order (V=2: p = 2c, s = 8; V=1: p = 4c, s =
    2; "order" writes V=1's in V=2's)."""
    return (4 * c, 2) if v1(mode) and mutate != "order" else (2 * c, 8)


def workspace(x, NT, a8, mutate=None, mode="sum2"):
    """wide_x_kernel: (the workspace's x words, a flat int64 tensor of
    32-bit values; a8: each chunk's (scale, 1/scale) as each row group's
    block reads it; V=1 a8: the row sums, a flat int64 tensor of
    -510 * sum(q) at step * 8 * ceil(N / 8) + row, else None)."""
    N, k = x.shape
    kt, ntot = k // 16, -(-N // 8)
    rows, rg = 8 * ntot, -(-ntot // NT)
    xp = torch.zeros((rows, k), dtype=torch.float32)
    xp[:N] = x
    words = torch.zeros(rows * k * (1 if a8 else 2) // 4, dtype=torch.int64)
    nt = torch.arange(rows)[:, None] // 8
    off = x_offset(nt, torch.arange(kt)[None, :], NT, ntot, kt, a8)
    g = torch.arange(rows)[:, None] % 8
    scales, sums = [], None
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
        for c in range(4):  # lane 4g + c: [q(p), q(p+1), q(p+s), q(p+s+1)]
            p, st = x_cols(mode, c, mutate)
            w = (qb[..., p] | qb[..., p + 1] << 8
                 | qb[..., p + st] << 16 | qb[..., p + st + 1] << 24)
            words[(off + (4 * g + c) * 4) // 4] = w
        if v1(mode):  # a (step, row): -510 * the row's q over the step
            nst = -(-kt // STEP)
            qt = torch.zeros((rows, nst * STEP * 16), dtype=torch.int64)
            qt[:, :k] = q
            sums = (-V1_BIAS * qt.reshape(rows, nst, STEP * 16).sum(-1)
                    ).T.reshape(-1)
    else:
        bits = (xp.to(torch.bfloat16).view(torch.int16).to(torch.int64)
                & 0xFFFF).reshape(rows, kt, 16)

        def pair(col):
            return bits[..., col] | bits[..., col + 1] << 16

        for h in (0, 1):  # lanes 2h, 2h+1: pair(p), pair(p+s) of each
            lane = 4 * g + (2 * (1 - h) if mutate == "offset" else 2 * h)
            cols = [col for c in (2 * h, 2 * h + 1)
                    for p, st in [x_cols(mode, c, mutate)]
                    for col in (p, p + st)]
            for i, col in enumerate(cols):
                words[(off + lane * 8) // 4 + i] = pair(col)
    return words, scales, sums


def v1_a_regs(words, KV, mt, kt, a8, mode, mutate=None):
    """WideTile1's A matrices, decoded once a tile: register r of lane (g,
    c) holds pair r/2's state r%2 (V1Tile's map: states 64c + 2g + 16p +
    i), MMA q registers 4q..4q+3.  a8 two (mt, kt, 16, 32) u8 hash bytes
    (register r at fragment row g + 8*(r&1), k 4c + 16*(r>>1) + byte);
    exact two (mt, kt, 16, 8) tf32 weights, byte sum - 510 through the
    f32 bits of 1.5*2^23 as v1_weight computes it (k c + 4*(r>>1))."""
    u = v1_lane_windows(words, KV).reshape(mt, kt, 32, 4, 2)
    h = v1_hash(u, "1mad" if mutate == "hash" else mode)
    ub = torch.stack([(h >> (8 * b)) & 0xFF for b in range(4)], -1)
    lane = torch.arange(32)
    g, c = lane >> 2, lane & 3
    bits = (0x4B400000 + ub.sum(-1)).to(torch.int32)
    wf = bits.view(torch.float32) - torch.tensor(12583422.0)
    tf32 = (wf.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert torch.equal(tf32, (ub.sum(-1) - V1_BIAS).to(torch.float32))
    out = []
    for q in (0, 1):
        a = torch.zeros((mt, kt, 16, 32 if a8 else 8), dtype=torch.int64)
        for r in range(4):
            pair, i = 2 * q + (r >> 1), r & 1
            if a8:
                for b in range(4):
                    a[:, :, g + 8 * (r & 1), 4 * c + 16 * (r >> 1) + b] = (
                        ub[:, :, :, pair, i, b])
            else:
                a[:, :, g + 8 * (r & 1), c + 4 * (r >> 1)] = (
                    tf32[:, :, :, pair, i].to(torch.int64))
        out.append(a)
    return out


def a_regs(words, KV, mt, kt, a8, mode, mutate=None):
    """Each tile's A matrix of each MMA of the tile, decoded once from the
    lane registers: a8 [(mt, kt, 16, 32)] s8 hash bytes (dualmad: h1's,
    then h2's); exact sum2 [(mt, kt, 16, 16)] weights, exact dualmad two
    (mt, kt, 16, 8) tf32 weights (w0 of the four states, then w1:
    register r of lane (g, c) at fragment row g + 8*(r&1), k c + 4*(r>>1));
    V=1: v1_a_regs."""
    if v1(mode):
        return v1_a_regs(words, KV, mt, kt, a8, mode, mutate)
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
        sels = (list(V1_PERMS) if v1(mode)
                else [sel for _, sel in S8_MMAS[mode]])
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
    out = []  # dualmad MMA p: b.x, b.y's half p moved into the high half;
    for p in (0, 1):  # V=1 MMA p: word p's halves (columns 4c+2p, +1)
        B = torch.zeros(slab.shape[:-2] + (8, 8), dtype=torch.float32)
        for i in (0, 1):
            B[..., c + 4 * i, g] = half(p, i) if v1(mode) else half(i, p)
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
    words, scales, sums = workspace(x, NT, a8, mutate, mode)
    A = a_regs(trellis, KV, mtiles, kt, a8, mode, mutate)
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
                        if sums is not None and mutate == "chunkbias":
                            c0 = ch * CHUNK_TILES // STEP
                            for st in range(c0, min(nst, c0 + 4)):
                                di = di + bias(sums, st, y, NT, ntot, ntg)
                    if sums is not None and mutate != "chunkbias":
                        di = di + bias(sums, s0 + s, y, NT, ntot, ntg)
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
                        assert int(di.abs().max()) < 1 << FRAG_BITS[mode]
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


def bias(sums, step, y, NT, ntot, ntg):
    """V=1 a8: the row sums a step adds to the int32 fragments (nact, ntg,
    16, 8): n-tile j's column n (x row 8j + n of row group y) takes the
    word at step * 8 * ntot + y * NT * 8 + 8j + n, as lane (g, c) reads it
    (an int2 at 2c of each n-tile)."""
    idx = (step * 8 * ntot + y * NT * 8 + 8 * torch.arange(ntg)[:, None]
           + torch.arange(8)[None, :])
    return sums[idx][None, :, None, :]


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
