"""csrc/v2_wide.cuh's v2_wide_kernel in mode dualmad (K1 dualmad at 8 < N
<= 256) rehearsed on the CPU against the plain version
(``-k wide_fragment``; the emulation is tests/wide_fragment.py, shared
with the sum2 rehearsal).

dualmad's tile policy: a tile decoded once into 8 A registers a lane, two
MMAs an n-tile.  a8: u*kMad1A (h1) and u*kMad2A (h2) of the lane's four
windows as s8 A registers of two mma.m16n8k32 into one int32 fragment, h1
against the workspace word's byte permutes 0x0000 / 0x2222 (x columns
2c, 8+2c, each byte four times), h2 against 0x1111 / 0x3333 (2c+1, 9+2c).
exact: the byte sums of h1 (w0) and h2 (w1) as tf32 weights of two
mma.m16n8k8, one a column parity, against the bf16 x words' halves moved
into the high half.  Row groups of at most 24 n-tiles (exact) and 12
(a8).  KV 6 and 7 (Path A's qkv and ug) and 9, k = 2576 (161 k-tiles: a
partial last step and chunk), N = 9, 49 and 191 (a partial last n-tile;
at 191 exact takes one block of 24 n-tiles, a8 two row groups of 12).
A wrong x offset, an a8 scale over one block's rows, or h1 and h2's
permutes swapped must fail."""

import numpy as np
import pytest
import torch

from qpalette_tpu_torch.kernels import arith
from qpalette_tpu_torch.ops.packing import words_to_torch
from wide_fragment import STEP, chunk_sums_exact, emulate, n_tiles

M, K = 160, 2576  # 10 m-tiles: a whole m-group and one of 2
# (rows, cluster size): None takes the launcher's choice on 132 SMs
CASES = [(9, None), (49, 1), (191, None)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(KV, N, seed):
    rng = np.random.default_rng(seed)
    words = words_to_torch(rng.integers(0, 1 << 32, ((M // 16) * (K // 16),
                                                     4 * KV), dtype=np.uint32))
    x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    return words, x


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("a8", [False, True], ids=["exact", "a8"])
@pytest.mark.parametrize("KV", [6, 7, 9])
def test_dualmad_wide_fragment_matches_plain(KV, a8):
    """The emulated kernel at N = 9, 49, 191 equals arith_gemv_plain in
    mode dualmad: a8's integer chunk sums exactly (h1 and h2 into one
    int32 fragment, below 2^25; rows split over blocks at 191 included),
    y of both variants within the f32 sum order (exact: bf16 x times the
    integer weights, which tf32 holds, is exact in f32)."""
    for N, cs in CASES:
        words, x = _case(KV, N, seed=300 + 10 * KV + N)
        y, sums = emulate(x, words, KV, M, K, a8, "dualmad", cs)
        want = arith.arith_gemv_plain(x, words, "dualmad", KV, M, K, a8)
        assert _rel(y, want) < 1e-5, (N, cs, _rel(y, want))
        if not a8:
            continue
        ntot = -(-N // 8)  # a8 above 96 rows: row groups of 12 n-tiles
        assert (N > 96) == (ntot > n_tiles(ntot, True, "dualmad"))
        chunk_sums_exact(sums, x, words, "dualmad", KV, M, K)
    assert (K // 16) % STEP and K % arith.CHUNK  # partial step and chunk


@pytest.mark.parametrize("mutate,a8", [("offset", False), ("scale", True),
                                       ("permute", True)])
def test_dualmad_wide_fragment_mutation_fails(mutate, a8):
    """The emulation catches a wrong x offset (exact: lane 2h+1's words
    where lane 2h's go), a8 scales over one block's rows, and h1's and
    h2's byte permutes swapped (each hash against the other column's q)."""
    KV, N = 7, 191
    words, x = _case(KV, N, seed=8)
    y, _ = emulate(x, words, KV, M, K, a8, "dualmad", mutate=mutate)
    want = arith.arith_gemv_plain(x, words, "dualmad", KV, M, K, a8)
    assert _rel(y, want) > 1e-3, mutate
