"""The CUDA kernels against their plain PyTorch versions on the card: the
arithmetic trellis GEMV (K1) in all four modes at the Llama-3.1-8B shapes
of the 215.0thp_cc path and of bench.py's tcq2mix scheme, the arithmetic
dequants (K2, K3) at the same shapes, the LUT trellis kernels (tcq /
tcomb GEMV and dequant) at the shapes of the 3.25-bit flagship and at KV 3,
the SQ/VQ row-pack kernels (K8, K9) at the shapes of the ldlq_2_6 path and
at every ldlq (bits, vec), and the int8 lm_head GEMVs (K10, K11) at the
8B head's shape.  Marked ``gpu``; each test skips itself when no CUDA
device is present.

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                        tcq_lut, vq)
from qpalette_tpu_torch.kernels.arith import (arith_gemv_plain,
                                              tcq2s_decode_gemv)
from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv, trellis_tlut,
                                              vq_lut)
from qpalette_tpu_torch.runtime.qlinear import LinearSpec, qlinear_apply

pytestmark = pytest.mark.gpu

# (projection, m, k, KV) as the 215 qdict + merge_info give them
SHAPES_215 = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 6),
              ("ug", 28672, 4096, 4), ("ug", 28672, 4096, 6),
              ("down", 4096, 14336, 6), ("lm_head", 131072, 4096, 8)]
# (projection, m, k, mode, KV): bench.py's tcq2mix (merged qkv tcq2_6, ug
# tcq2_7, o/down tcq1_3), then 2mad and odd-KV sum2 at 4096x4096
SHAPES_ARITH = [("qkv", 6144, 4096, "dualmad", 6),
                ("ug", 28672, 4096, "dualmad", 7),
                ("o", 4096, 4096, "1mad", 3), ("down", 4096, 14336, "1mad", 3),
                ("2mad3", 4096, 4096, "2mad", 3),
                ("2mad4", 4096, 4096, "2mad", 4),
                ("sum2_5", 4096, 4096, "sum2", 5),
                ("sum2_7", 4096, 4096, "sum2", 7)]
# K2 sum2 at the 215 shapes too
SHAPES_DEQUANT = SHAPES_ARITH + [
    (name, m, k, "sum2", KV) for name, m, k, KV in SHAPES_215
    if name != "lm_head"]
# (projection, m, k, KV) of the 3.25-bit flagship (unmerged)
SHAPES_FLAGSHIP = [("q/o", 4096, 4096, (8,)), ("q/o", 4096, 4096, (8, 9)),
                   ("k/v", 1024, 4096, (10,)), ("gate/up", 14336, 4096, (6,)),
                   ("down", 4096, 14336, (6,)),
                   ("o kv3", 4096, 4096, (3,)), ("o kv3", 4096, 4096, (3, 4)),
                   ("down kv3", 4096, 14336, (3,)),
                   ("down kv3", 4096, 14336, (3, 4))]
# (projection, m, k) of Llama-3.1-8B with merged qkv / ug
SHAPES_8B = [("qkv", 6144, 4096), ("o", 4096, 4096), ("ug", 28672, 4096),
             ("down", 4096, 14336)]
# (bits, vec, m, k): ldlq_2_6 at every 8B shape, every ldlq pair at o and
# down
SHAPES_VQ = ([(6, 2, m, k) for _, m, k in SHAPES_8B]
             + [(b, v, m, k) for b, v in vq.SUPPORTED
                for _, m, k in SHAPES_8B[1::2] if (b, v) != (6, 2)])
HEAD = (129024, 4096)  # the int8 head: vocab 128256 padded to 2048s


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's integer dot products must run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _case(m, k, KV, N, x_dtype, device, seed, mode="sum2"):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = arith.words_per_tile(mode, KV)
    words = torch.randint(-(1 << 31), 1 << 31, ((m // 16) * (k // 16), W),
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
        ref = arith_gemv_plain(x, words, "sum2", KV, m, k, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # exact: f32 sums over up to 14336 terms in another order; a8: the
        # same chunks and rounding, but a tie may round the other way
        assert rel <= (1e-3 if a8 else 1e-4), (name, N, rel)


def test_kernel_rejects_cpu_trellis_with_cuda_x(cuda):
    words, x = _case(64, 256, 6, 1, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError):
        tcq2s_decode_gemv(x, words.cpu(), 6, 64, 256, True)
    with pytest.raises(ValueError):
        arith_dequant.tcq2_dequant(words, 6, 64, 256, "sum2",
                                   out=torch.empty((64, 256)))


def _counted(mode):
    return {"sum2": arith.tcq2s_decode_gemv, "dualmad": arith.tcq2_decode_gemv,
            "1mad": arith.tcq1_decode_gemv,
            "2mad": arith.tcq1_decode_gemv}[mode]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,mode,KV", SHAPES_ARITH)
def test_arith_gemv_matches_plain_on_card(cuda, name, m, k, mode, KV, a8):
    for N, x_dtype in ((1, torch.float32), (8, torch.float32),
                       (256, torch.bfloat16)):
        words, x = _case(m, k, KV, N, x_dtype, cuda, seed=m + k + KV + N,
                         mode=mode)
        fn = _counted(mode)
        before = fn.launches
        y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = arith_gemv_plain(x, words, mode, KV, m, k, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # exact: f32 sums in another order; a8: the same chunks and
        # rounding, but a tie may round the other way
        assert rel <= (1e-3 if a8 else 1e-4), (name, N, rel)


@pytest.mark.parametrize("name,m,k,mode,KV", SHAPES_DEQUANT)
def test_arith_dequant_bit_equal_to_plain_on_card(cuda, name, m, k, mode,
                                                  KV):
    words, _ = _case(m, k, KV, 1, torch.float32, cuda, seed=m + k + KV + 7,
                     mode=mode)
    fn = (arith_dequant.tcq2_dequant if mode in ("sum2", "dualmad")
          else arith_dequant.tcq1_dequant)
    before = fn.launches
    w = arith_dequant.dequant(mode, words, KV, m, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = arith_dequant.arith_dequant_plain(words, mode, KV, m, k)
    assert torch.equal(w.view(torch.int16), ref.view(torch.int16)), name


@pytest.mark.parametrize("kind,mode,KV", [("tcq2", "dualmad", 7),
                                          ("tcq1", "1mad", 3)])
def test_qlinear_large_rows_on_card(cuda, kind, mode, KV):
    """300 rows: exact through one dequant launch and a product, a8 through
    two 256-row GEMV chunks; both against the CPU plain path."""
    m, k = 256, 512
    words, x = _case(m, k, KV, 300, torch.bfloat16, cuda, seed=KV,
                     mode=mode)
    p = {"trellis": words, "wscale": torch.full((m,), 0.02, device=cuda)}
    p_cpu = {n: t.cpu() for n, t in p.items()}
    deq = (arith_dequant.tcq2_dequant if kind == "tcq2"
           else arith_dequant.tcq1_dequant)
    for impl, fn, launches in (("exact", deq, 1), ("a8", _counted(mode), 2)):
        spec = LinearSpec(kind, k, m, KV=(KV,), mode=mode, impl=impl)
        before = fn.launches
        y = qlinear_apply(spec, p, x, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert fn.launches == before + launches, impl
        ref = qlinear_apply(spec, p_cpu, x.cpu(), out_dtype=torch.float32)
        rel = ((y.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-3 if impl == "a8" else 1e-5), (impl, rel)


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


def _lut_gemv(KV):
    return ((tcq_lut.tcq_lut_gemv, tcq_lut.tcq_lut_gemv_plain)
            if len(KV) == 1 else
            (tcq_lut.tcomb_lut_gemv, tcq_lut.tcomb_lut_gemv_plain))


# ragged GEMV shapes: one m-tile; k/16 = 17 tiles (no whole ring slot for
# most warps), k = 4128 (258 tiles: a cluster split whose warps end on a
# partial slot; tcomb halves of 129); KV 3 and 10, whose last state's
# window wraps the tile's stream at the most and the fewest bits
SHAPES_LUT_RAGGED = [("m16 k272", 16, 272, (3,)),
                     ("m16 k272", 16, 272, (10,)),
                     ("m16 k4128", 16, 4128, (10,)),
                     ("m16 k4128", 16, 4128, (3, 4)),
                     ("m16 k4128", 16, 4128, (9, 10)),
                     ("m48 k4128", 48, 4128, (6,))]


@pytest.mark.parametrize("name,m,k,KV", SHAPES_FLAGSHIP + SHAPES_LUT_RAGGED)
def test_lut_gemv_matches_plain_on_card(cuda, name, m, k, KV):
    words, tlut = _lut_case(m, k, KV, cuda, seed=m + k + sum(KV))
    gemv, plain = _lut_gemv(KV)
    for N in range(1, 9):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(N)
        x = torch.randn((N, k), generator=gen, device=cuda).bfloat16()
        before = gemv.launches
        y = gemv(x, *words, tlut, *KV, m, k)
        torch.cuda.synchronize()
        assert gemv.launches == before + 1
        ref = plain(x, *words, tlut, *KV, m, k)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # the same bf16 weights and activations, and each bf16 product is
        # exact in f32: only the order of the f32 sums over up to 14336
        # terms differs (tensor-core fragments, then warps and blocks)
        assert rel <= 1e-4, (name, KV, N, rel)


@pytest.mark.parametrize("name,m,k,KV", [SHAPES_FLAGSHIP[2],
                                         SHAPES_FLAGSHIP[1],
                                         SHAPES_LUT_RAGGED[3]])
def test_lut_gemv_launches_are_bit_equal(cuda, name, m, k, KV):
    """Two launches on the same inputs give the same bits (the split-k
    partial sums are added in a fixed order, without atomics), and each
    call adds exactly 1 to the wrapper's count."""
    words, tlut = _lut_case(m, k, KV, cuda, seed=3 * m + k)
    gemv, _ = _lut_gemv(KV)
    x = torch.randn((8, k), device=cuda).bfloat16()
    ys = []
    for _ in range(2):
        before = gemv.launches
        ys.append(gemv(x, *words, tlut, *KV, m, k))
        torch.cuda.synchronize()
        assert gemv.launches == before + 1
    assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


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


def _vq_case(bits, vec, m, k, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31,
                          (m, vq.row_words(k, bits, vec)), generator=gen,
                          dtype=torch.int32, device=device)
    return words, torch.tensor(vq_lut(bits, vec), device=device)


@pytest.mark.parametrize("bits,vec,m,k", SHAPES_VQ)
def test_vq_kernels_match_plain_on_card(cuda, bits, vec, m, k):
    """K8 within 1e-4 of max|y| at N in {1, 8}; K9 bit-equal."""
    words, lut = _vq_case(bits, vec, m, k, cuda, seed=m + k + bits)
    for N in (1, 8):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(N)
        x = torch.randn((N, k), generator=gen, device=cuda).bfloat16()
        before = vq.vq_gemv.launches
        y = vq.vq_gemv(x, words, lut, bits, vec, m, k)
        torch.cuda.synchronize()
        assert vq.vq_gemv.launches == before + 1
        ref = vq.vq_gemv_plain(x, words, lut, bits, vec, m, k)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # the same bf16 operands; f32 sums over up to 14336 terms in
        # another order
        assert rel <= 1e-4, (bits, vec, m, k, N, rel)
    before = vq.vq_dequant.launches
    w = vq.vq_dequant(words, lut, bits, vec, m, k)
    torch.cuda.synchronize()
    assert vq.vq_dequant.launches == before + 1
    ref = vq.vq_dequant_plain(words, lut, bits, vec, m, k)
    assert torch.equal(w.view(torch.int16), ref.view(torch.int16))


def _head_case(device, N, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    m, k = HEAD
    wq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8,
                       device=device)
    scales = torch.rand(m, generator=gen, device=device) * 1e-3
    x = torch.randn((N, k), generator=gen, device=device).bfloat16()
    return x, wq, scales


@pytest.mark.parametrize("N", [1, 8])
def test_int8_head_kernels_match_plain_on_card(cuda, N):
    """K10 bit-equal to its plain version (float64 integer dot), K11
    within 1e-5 of max|y|."""
    x, wq, scales = _head_case(cuda, N, seed=N)
    for fn, plain in ((int8_gemv.int8_gemv_a8, int8_gemv.int8_gemv_a8_plain),
                      (int8_gemv.int8_gemv, int8_gemv.int8_gemv_plain)):
        before = fn.launches
        y = fn(x, wq, scales)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = plain(x, wq, scales)
        if fn is int8_gemv.int8_gemv_a8:
            assert torch.equal(y, ref), (y - ref).abs().max().item()
        else:
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            assert rel <= 1e-5, rel


def test_vq_and_int8_kernels_reject_cpu_operands(cuda):
    words, lut = _vq_case(6, 2, 64, 256, cuda, seed=3)
    x = torch.zeros((1, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        vq.vq_gemv(x, words.cpu(), lut, 6, 2, 64, 256)
    with pytest.raises(ValueError):
        vq.vq_dequant(words, lut.cpu(), 6, 2, 64, 256)
    with pytest.raises(ValueError):
        int8_gemv.int8_gemv_a8(x, torch.zeros((64, 256), dtype=torch.int8),
                               torch.ones(64, device=cuda))
