"""The CUDA kernels against their plain PyTorch versions on the card: tcq2s
at the Llama-3.1-8B shapes of the 215.0thp_cc path, and the LUT trellis
kernels (tcq / tcomb GEMV and dequant) at the shapes of the 3.25-bit
flagship.  Marked ``gpu``; each test skips itself when no CUDA device is
present.

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from qpalette_tpu_torch.kernels import tcq_lut
from qpalette_tpu_torch.kernels.tcq2s import (tcq2s_decode_gemv,
                                              tcq2s_decode_gemv_plain)
from qpalette_tpu_torch.ops.codebooks import tlut_bits_for_kv, trellis_tlut

pytestmark = pytest.mark.gpu

# (projection, m, k, KV) as the 215 qdict + merge_info give them
SHAPES_215 = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 6),
              ("ug", 28672, 4096, 4), ("ug", 28672, 4096, 6),
              ("down", 4096, 14336, 6), ("lm_head", 131072, 4096, 8)]
# (projection, m, k, KV) of the 3.25-bit flagship (unmerged)
SHAPES_FLAGSHIP = [("q/o", 4096, 4096, (8,)), ("q/o", 4096, 4096, (8, 9)),
                   ("k/v", 1024, 4096, (10,)), ("gate/up", 14336, 4096, (6,)),
                   ("down", 4096, 14336, (6,))]


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


def _lut_case(m, k, KV, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kh = k // len(KV)
    words = [torch.randint(-(1 << 31), 1 << 31, ((m // 16) * (kh // 16),
                                                 4 * kv), generator=gen,
                           dtype=torch.int32, device=device) for kv in KV]
    tlut = torch.tensor(trellis_tlut(tlut_bits_for_kv(max(KV))),
                        device=device)
    return words, tlut


@pytest.mark.parametrize("name,m,k,KV", SHAPES_FLAGSHIP)
def test_lut_gemv_matches_plain_on_card(cuda, name, m, k, KV):
    words, tlut = _lut_case(m, k, KV, cuda, seed=m + k + sum(KV))
    gemv, plain = ((tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain)
                   if len(KV) == 1 else
                   (tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain))
    for N in (1, 4, 8):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(N)
        x = torch.randn((N, k), generator=gen, device=cuda).bfloat16()
        before = gemv.launches
        y = gemv(x, *words, tlut, *KV, m, k)
        torch.cuda.synchronize()
        assert gemv.launches == before + 1
        ref = plain(x, *words, tlut, *KV, m, k)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # the same bf16 weights and activations; f32 sums over up to
        # 14336 terms in another order
        assert rel <= 1e-4, (name, KV, N, rel)


@pytest.mark.parametrize("name,m,k,KV", SHAPES_FLAGSHIP)
def test_lut_dequant_bit_equal_to_plain_on_card(cuda, name, m, k, KV):
    words, tlut = _lut_case(m, k, KV, cuda, seed=m + k + sum(KV) + 1)
    deq, plain = ((tcq_lut.tcq_lut_dequant, tcq_lut.tcq_lut_dequant_plain)
                  if len(KV) == 1 else
                  (tcq_lut.tcomb_lut_dequant,
                   tcq_lut.tcomb_lut_dequant_plain))
    before = deq.launches
    w = deq(*words, tlut, *KV, m, k)
    torch.cuda.synchronize()
    assert deq.launches == before + 1
    ref = plain(*words, tlut, *KV, m, k)
    assert torch.equal(w.view(torch.int16), ref.view(torch.int16)), name


def test_lut_kernels_reject_cpu_trellis_with_cuda_x(cuda):
    words, tlut = _lut_case(64, 256, (6,), cuda, seed=2)
    x = torch.zeros((1, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tcq_lut.tcq_lut_gemv(x, words[0].cpu(), tlut, 6, 64, 256)
    with pytest.raises(ValueError):
        tcq_lut.tcq_lut_gemv(x, words[0], tlut.cpu(), 6, 64, 256)
