"""csrc/v2_wide.cuh's v2_wide_kernel in mode sum2 (K1 sum2 at 8 < N <= 256)
rehearsed on the CPU against the plain version (``-k wide_fragment``;
the emulation is tests/wide_fragment.py, shared with the dualmad
rehearsal).

The emulation follows the kernel on the plain words: the prologue's
workspace (a8's chunk scales over all N rows, then x in B-fragment order
at the kernel's byte offsets), the grid (m-groups of 8 m-tiles with a
partial last group, row groups of NT n-tiles, a cluster splitting k in
8-tile steps), each step's x slab copied from its contiguous bytes, every
n-tile's B registers read at the lane's offset in the slab against one A
decode of each tile, a8's int32 chunk fragments descaled at chunk
boundaries, the fragments summed over the cluster in rank order and
written out by the epilogue's index map.  k = 2576 (161 k-tiles: a partial
last step and chunk); N = 9, 49 and 191 leave a partial last n-tile, and
a8 at N = 191 splits the rows over two blocks.  A wrong x offset or a
scale over one block's rows must fail."""

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
@pytest.mark.parametrize("KV", list(range(4, 11)))
def test_wide_fragment_matches_plain(KV, a8):
    """The emulated kernel at N = 9, 49, 191 equals arith_gemv_plain: a8's
    integer chunk sums exactly (rows split over blocks at 191 included),
    y of both variants within the f32 sum order."""
    for N, cs in CASES:
        words, x = _case(KV, N, seed=200 + 10 * KV + N)
        y, sums = emulate(x, words, KV, M, K, a8, cs=cs)
        want = arith.arith_gemv_plain(x, words, "sum2", KV, M, K, a8)
        # bf16 x times integer weights, or int32 chunk sums descaled: only
        # the order of the f32 sums differs
        assert _rel(y, want) < 1e-5, (N, cs, _rel(y, want))
        if not a8:
            continue
        kt, ntot = K // 16, -(-N // 8)
        NT = n_tiles(ntot, True)
        assert (N > 128) == (ntot > NT)  # rows split over blocks at 191
        chunk_sums_exact(sums, x, words, "sum2", KV, M, K)
        assert kt % STEP and K % arith.CHUNK  # partial step and chunk


@pytest.mark.parametrize("mutate,a8", [("offset", False), ("scale", True)])
def test_wide_fragment_mutation_fails(mutate, a8):
    """The emulation catches a wrong x offset (exact: lane 2h+1's words
    where lane 2h's go) and a8 scales over one block's rows."""
    KV, N = 6, 191
    words, x = _case(KV, N, seed=7)
    y, _ = emulate(x, words, KV, M, K, a8, mutate=mutate)
    want = arith.arith_gemv_plain(x, words, "sum2", KV, M, K, a8)
    assert _rel(y, want) > 1e-3, mutate
