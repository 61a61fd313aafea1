"""csrc/arith_wide.cuh's wide_gemv_kernel under the V=1 tile policy
(tcq1_gemv.cu's WideTile1: K1 1mad and 2mad at 8 < N <= 256) rehearsed on
the CPU against the plain version (``-k wide_fragment``; the emulation is
tests/wide_fragment.py, shared with the sum2 and dualmad rehearsals), and
the port's K1 above 8 rows against the JAX reference.

WideTile1: v1_gemv_kernel's lane map (lane (g, c) decodes states 64c + 2g
+ {0, 1, 16, 17, 32, 33, 48, 49}, four pairs), a tile decoded once into 8
A registers, two MMAs an n-tile.  a8: the hashes' unsigned bytes as u8 A
registers of two mma.m16n8k32 against the x word [q(4c), q(4c+1),
q(4c+2), q(4c+3)] under byte permutes 0x0000 / 0x1111 and 0x2222 / 0x3333;
the prologue writes -510 * sum(q) of each x row an 8-tile step, and a warp
adds its steps' to the int32 fragments, so a rank that holds part of a
chunk takes only its own columns' bias.  exact: the byte sums - 510 as
tf32 weights of two mma.m16n8k8 on the bf16 words of columns (4c, 4c+1)
and (4c+2, 4c+3).  KV 2, 3 and 5, k = 2576 (161 k-tiles: a partial last
step and chunk), N = 9, 49 and 191 at the launcher's cluster, without one
and at a forced one of 2 that splits chunk 2 between its ranks.  The bias
summed over a whole chunk on a split rank, V=2's x order under the V=1
lane map, and 1mad's hash for 2mad must fail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import fused

from qpalette_tpu_torch.kernels import arith
from qpalette_tpu_torch.ops.packing import words_to_torch
from wide_fragment import (CHUNK_TILES, STEP, chunk_sums_exact,
                           cluster_size, emulate, n_tiles)

M, K = 160, 2576  # 10 m-tiles: a whole m-group and one of 2
# (rows, cluster size): None takes the launcher's choice on 132 SMs
CASES = [(9, None), (49, 1), (49, 2), (191, None)]
# the JAX reference's own small shape (tests/test_torch_arith.py's M, K)
# and its a8 tolerance there (int8 ties may round the other way, and the
# reference adds 2*sum(x) of the unquantized x where the port takes the
# exact integer weight)
REF_M, REF_K, A8_TOL = 32, 32, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(KV, N, seed, m=M, k=K):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, ((m // 16) * (k // 16), 8 * KV),
                         dtype=np.uint32)
    x = rng.standard_normal((N, k)).astype(np.float32)
    return words, x


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _splits_a_chunk(N, cs, a8, mode):
    """Whether a rank of the call's cluster holds part of a chunk."""
    ntot, kt = -(-N // 8), K // 16
    NT = n_tiles(ntot, a8, mode)
    nst = -(-kt // STEP)
    cs = cs or cluster_size(-(-M // 128), -(-ntot // NT), nst, NT, a8, mode)
    per = CHUNK_TILES // STEP  # steps a chunk
    return any((nst * r // cs) % per for r in range(1, cs))


@pytest.mark.parametrize("a8", [False, True], ids=["exact", "a8"])
@pytest.mark.parametrize("KV", [2, 3, 5])
@pytest.mark.parametrize("mode", ["1mad", "2mad"])
def test_v1_wide_fragment_matches_plain(mode, KV, a8):
    """The emulated kernel equals arith_gemv_plain in 1mad and 2mad: a8's
    integer chunk sums exactly (the step biases summed over the ranks of
    a split chunk; rows split over row groups of 12 n-tiles at 191), y of
    both variants within the f32 sum order (exact: bf16 x times the
    integer weights, which tf32 holds, is exact in f32)."""
    for N, cs in CASES:
        words, x = _case(KV, N, seed=500 + 10 * KV + N + (mode == "2mad"))
        tw, xt = words_to_torch(words), torch.from_numpy(x)
        y, sums = emulate(xt, tw, KV, M, K, a8, mode, cs)
        want = arith.arith_gemv_plain(xt, tw, mode, KV, M, K, a8)
        assert _rel(y, want) < 1e-5, (N, cs, _rel(y, want))
        if a8:
            chunk_sums_exact(sums, xt, tw, mode, KV, M, K)
    assert _splits_a_chunk(49, 2, a8, mode)
    assert _splits_a_chunk(191, None, a8, mode)
    assert (K // 16) % STEP and K % arith.CHUNK  # partial step and chunk


@pytest.mark.parametrize("mutate,mode,a8", [
    ("chunkbias", "1mad", True), ("order", "1mad", True),
    ("order", "2mad", False), ("hash", "2mad", True),
    ("hash", "2mad", False)])
def test_v1_wide_fragment_mutation_fails(mutate, mode, a8):
    """The emulation catches the bias summed over a whole chunk on a rank
    that holds part of it (a cluster of 2 at 49 rows), x written in V=2's
    order under the V=1 lane map, and 2mad decoded with 1mad's hash."""
    KV, N = 3, 49
    words, x = _case(KV, N, seed=9)
    tw, xt = words_to_torch(words), torch.from_numpy(x)
    y, _ = emulate(xt, tw, KV, M, K, a8, mode, cs=2, mutate=mutate)
    want = arith.arith_gemv_plain(xt, tw, mode, KV, M, K, a8)
    assert _rel(y, want) > 1e-3, mutate


@pytest.mark.parametrize("mode,KV", [("1mad", 3), ("2mad", 4)])
def test_k1_above_8_rows_matches_reference_kernel(mode, KV):
    """arith.decode_gemv at N = 9 and 24 (the port's wide rows; the plain
    version on the CPU) against fused.tcq1_decode_matmul in interpret
    mode on the same bf16 x and words: exact within the f32 sum order,
    a8 within A8_TOL."""
    words, _ = _case(KV, 1, seed=600 + KV, m=REF_M, k=REF_K)
    tr_pl = kf.tcq1_planar_weights(jnp.asarray(words), REF_M, REF_K, KV)
    tw = words_to_torch(words)
    rng = np.random.default_rng(700 + KV)
    for N in (9, 24):
        x = rng.standard_normal((N, REF_K)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        for a8, tol in ((False, 1e-5), (True, A8_TOL)):
            ref = torch.from_numpy(np.array(fused.tcq1_decode_matmul(
                xb, tr_pl, KV, mode, REF_M, REF_K, a8=a8)))
            got = arith.decode_gemv(mode, xt, tw, KV, REF_M, REF_K, a8)
            assert got.shape == (N, REF_M)
            assert _rel(got, ref) < tol, (N, a8, _rel(got, ref))
