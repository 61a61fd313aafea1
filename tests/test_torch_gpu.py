"""The tcq2s CUDA kernel against its plain PyTorch version on the card, at
the Llama-3.1-8B shapes of the 215.0thp_cc path.  Marked ``gpu``; each
test skips itself when no CUDA device is present.

  python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from qpalette_tpu_torch.kernels.tcq2s import (tcq2s_decode_gemv,
                                              tcq2s_decode_gemv_plain)

pytestmark = pytest.mark.gpu

# (projection, m, k, KV) as the 215 qdict + merge_info give them
SHAPES_215 = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 6),
              ("ug", 28672, 4096, 4), ("ug", 28672, 4096, 6),
              ("down", 4096, 14336, 6), ("lm_head", 131072, 4096, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's integer dot products must run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _case(m, k, KV, N, x_dtype, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31, ((m // 16) * (k // 16), 4 * KV),
                          generator=gen, dtype=torch.int32, device=device)
    x = torch.randn((N, k), generator=gen, device=device).to(x_dtype)
    return words, x


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,KV", SHAPES_215)
def test_kernel_matches_plain_on_card(cuda, name, m, k, KV, a8):
    for N, x_dtype in ((1, torch.float32), (4, torch.float32),
                       (16, torch.bfloat16)):
        words, x = _case(m, k, KV, N, x_dtype, cuda, seed=m + k + KV + N)
        before = tcq2s_decode_gemv.launches
        y = tcq2s_decode_gemv(x, words, KV, m, k, a8)
        torch.cuda.synchronize()
        assert tcq2s_decode_gemv.launches == before + 1
        ref = tcq2s_decode_gemv_plain(x, words, KV, m, k, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # exact: f32 sums over up to 14336 terms in another order; a8: the
        # same chunks and rounding, but a tie may round the other way
        assert rel <= (1e-3 if a8 else 1e-4), (name, N, rel)


def test_kernel_rejects_cpu_trellis_with_cuda_x(cuda):
    words, x = _case(64, 256, 6, 1, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError):
        tcq2s_decode_gemv(x, words.cpu(), 6, 64, 256, True)
