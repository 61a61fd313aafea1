"""The CUDA kernels against their plain PyTorch versions on the card: the
arithmetic trellis GEMV (K1) in all four modes at the Llama-3.1-8B shapes
of the 215.0thp_cc path and of bench.py's tcq2mix scheme and at ragged
shapes, the arithmetic
dequants (K2, K3) at the same shapes, the LUT trellis kernels (tcq /
tcomb GEMV and dequant) at the shapes of the 3.25-bit flagship and at KV 3,
the SQ/VQ row-pack kernels (K8, K9) at the shapes of the ldlq_2_6 path and
at every ldlq (bits, vec) (K8 also at m not a multiple of 16, and two
launches bit-equal), K1 in every mode above 8 rows (wide_gemv_kernel,
N = 9..256, two launches bit-equal), and the int8 lm_head GEMVs (K10,
K11) at the 8B head's shape; and the decode step captured in a CUDA
graph on a 2-layer tcq2s model (logits bit-equal to the eager forward, seeded sampling,
positions advanced by the graph); the serving pool step captured at 4 and
16 slots (bit-equal to the eager pool step) and admission (other slots'
cache rows bit-unchanged); the dry run and entry() on the card.  Marked
``gpu``; each test skips itself
when no CUDA device is present.

  python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from qpalette_tpu_torch.kernels import (arith, arith_dequant, int8_gemv,
                                        tcq_lut, vq)
from qpalette_tpu_torch.kernels.arith import (arith_gemv_plain,
                                              tcq2s_decode_gemv)
from qpalette_tpu_torch.ops.codebooks import (tlut_bits_for_kv, trellis_tlut,
                                              vq_lut)
from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig
from qpalette_tpu_torch.runtime import decode
from qpalette_tpu_torch.runtime.loader import build_quantized_model
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


def _counted(mode):
    return {"sum2": arith.tcq2s_decode_gemv, "dualmad": arith.tcq2_decode_gemv,
            "1mad": arith.tcq1_decode_gemv,
            "2mad": arith.tcq1_decode_gemv}[mode]


# The V=2 modes beyond their paths' shapes: 4096x4096 at the other KVs,
# and ragged shapes for the tensor-core kernel (N <= 8, 16-tile slots):
# one m-tile with k/16 = 17 (a partial slot, most warps idle); k = 1040 (a
# partial last slot and chunk); k = 4112 and k = 2576, where the last
# warp's range straddles a chunk boundary into a partial chunk
SHAPES_SUM2 = SHAPES_215 + [
    (f"kv{kv}", 4096, 4096, kv) for kv in (4, 5, 7, 8, 9, 10)] + [
    ("m16 k272", 16, 272, 10), ("m32 k4112", 32, 4112, 5),
    ("m16 k1040", 16, 1040, 7), ("m16 k2576", 16, 2576, 9)]
# dualmad: Path A's merged qkv (tcq2_6) and ug (tcq2_7)
SHAPES_DUALMAD = [("qkv", 6144, 4096, 6), ("ug", 28672, 4096, 7)] + [
    (f"kv{kv}", 4096, 4096, kv) for kv in range(4, 11)] + [
    ("m16 k272", 16, 272, 4), ("m32 k4112", 32, 4112, 10),
    ("m16 k1040", 16, 1040, 6), ("m16 k2576", 16, 2576, 8)]
SHAPES_V2 = ([(name, m, k, "sum2", KV) for name, m, k, KV in SHAPES_SUM2]
             + [(name, m, k, "dualmad", KV)
                for name, m, k, KV in SHAPES_DUALMAD])
# The V=1 modes on their tensor-core kernel (N <= 8, 16-tile slots, 16
# warps a block): Path A's o and down (tcq1_3, 1mad), 4096x4096 at KV 2-5,
# and ragged shapes: one m-tile with k/16 = 17; k = 4112, where the last
# warp's range straddles a chunk boundary into a partial chunk and slot;
# k = 2576, 11 slots over 16 warps (some warps idle)
SHAPES_V1 = [
    ("o", 4096, 4096, "1mad", 3), ("down", 4096, 14336, "1mad", 3)] + [
    (f"kv{kv}", 4096, 4096, mode, kv) for mode in ("1mad", "2mad")
    for kv in range(2, 6)] + [
    ("m16 k272", 16, 272, "1mad", 2), ("m16 k272", 16, 272, "2mad", 5),
    ("m32 k4112", 32, 4112, "1mad", 5), ("m32 k4112", 32, 4112, "2mad", 3),
    ("m16 k2576", 16, 2576, "1mad", 3), ("m16 k2576", 16, 2576, "2mad", 4)]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,mode,KV", SHAPES_V2 + SHAPES_V1)
def test_kernel_matches_plain_on_card(cuda, name, m, k, mode, KV, a8):
    """N = 1..8 (the tensor-core kernels) with f32 and bf16 x, and N = 16
    (every mode: wide_gemv_kernel after its x prologue, two launches),
    each kernel counted once."""
    cases = [(N, dt) for N in range(1, 9)
             for dt in (torch.float32, torch.bfloat16)]
    fn = _counted(mode)
    for N, x_dtype in cases + [(16, torch.bfloat16)]:
        words, x = _case(m, k, KV, N, x_dtype, cuda, seed=m + k + KV + N,
                         mode=mode)
        before = fn.launches
        y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
        torch.cuda.synchronize()
        assert fn.launches == before + arith.kernel_launches(mode, N)
        ref = arith_gemv_plain(x, words, mode, KV, m, k, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # exact: bf16 x times integer weights is exact in f32, only the
        # order of the f32 sums over up to 14336 terms differs; a8: the
        # same chunks, scales and integer chunk sums, but a warp descales
        # its part of a chunk (f32 rounding of partial products) and a tie
        # in the quantization may round the other way
        assert rel <= (1e-3 if a8 else 1e-4), (name, N, x_dtype, rel)


@pytest.mark.parametrize("mode", ["sum2", "dualmad", "1mad", "2mad"])
@pytest.mark.parametrize("a8", [False, True])
def test_sum2_launches_are_bit_equal(cuda, a8, mode):
    """Two launches of the tensor-core kernels (V=2: sum2, dualmad; V=1:
    1mad, 2mad) on the same inputs give the same bits (the warps'
    fragments are added in a fixed order, no atomics), and each call adds
    exactly 1 to the wrapper's count."""
    m, k, KV = 4096, 14336, (6 if mode in ("sum2", "dualmad") else 3)
    fn = _counted(mode)
    for N, x_dtype in ((8, torch.float32), (3, torch.bfloat16)):
        words, x = _case(m, k, KV, N, x_dtype, cuda, seed=N, mode=mode)
        ys = []
        for _ in range(2):
            before = fn.launches
            ys.append(arith.decode_gemv(mode, x, words, KV, m, k, a8))
            torch.cuda.synchronize()
            assert fn.launches == before + 1
        assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


def test_kernel_rejects_cpu_trellis_with_cuda_x(cuda):
    words, x = _case(64, 256, 6, 1, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError):
        tcq2s_decode_gemv(x, words.cpu(), 6, 64, 256, True)
    with pytest.raises(ValueError):
        arith_dequant.tcq2_dequant(words, 6, 64, 256, "sum2",
                                   out=torch.empty((64, 256)))


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,mode,KV", SHAPES_ARITH)
def test_arith_gemv_matches_plain_on_card(cuda, name, m, k, mode, KV, a8):
    # the V=2 modes at N <= 8: test_kernel_matches_plain_on_card
    cases = ((1, torch.float32), (8, torch.float32), (256, torch.bfloat16))
    for N, x_dtype in cases[2 if mode in ("sum2", "dualmad") else 0:]:
        words, x = _case(m, k, KV, N, x_dtype, cuda, seed=m + k + KV + N,
                         mode=mode)
        fn = _counted(mode)
        before = fn.launches
        y = arith.decode_gemv(mode, x, words, KV, m, k, a8)
        torch.cuda.synchronize()
        assert fn.launches == before + arith.kernel_launches(mode, N)
        ref = arith_gemv_plain(x, words, mode, KV, m, k, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        # exact: f32 sums in another order; a8: the same chunks and
        # rounding, but a tie may round the other way
        assert rel <= (1e-3 if a8 else 1e-4), (name, N, rel)


# wide_gemv_kernel (8 < N <= 256) in sum2 at a small shape: 10 m-tiles (a whole
# m-group of 8 and one of 2), k = 2576 (161 k-tiles: a partial step and a
# partial chunk), which few blocks split over a cluster; N = 9, 49, 191
# end in a partial n-tile, a8 above 128 rows splits the rows over blocks
WIDE_ROWS = (9, 16, 49, 64, 191, 256)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("KV", list(range(4, 11)))
def test_sum2_wide_matches_plain_on_card(cuda, KV, a8):
    m, k = 160, 2576
    for N in WIDE_ROWS:
        for x_dtype in (torch.float32, torch.bfloat16):
            words, x = _case(m, k, KV, N, x_dtype, cuda, seed=KV + N)
            before = tcq2s_decode_gemv.launches
            y = tcq2s_decode_gemv(x, words, KV, m, k, a8)
            torch.cuda.synchronize()
            assert tcq2s_decode_gemv.launches == before + 2
            ref = arith_gemv_plain(x, words, "sum2", KV, m, k, a8)
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            # exact: bf16 x times integer weights, f32 sums in another
            # order; a8: the same chunks, scales and integer chunk sums,
            # but a tie in the quantization may round the other way
            assert rel <= (1e-3 if a8 else 1e-4), (N, x_dtype, rel)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m,k", [(160, 2576), (4096, 14336)])
def test_sum2_wide_launches_are_bit_equal(cuda, m, k, a8):
    """Two launches give the same bits: the cluster's partial fragments
    are summed in rank order (no atomics)."""
    for N in (9, 191, 256):
        words, x = _case(m, k, 6, N, torch.bfloat16, cuda, seed=N)
        ys = [tcq2s_decode_gemv(x, words, 6, m, k, a8) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


# wide_gemv_kernel in dualmad at Path A's shapes (merged qkv tcq2_6, ug
# tcq2_7) and at odd k/16 (257 k-tiles: a partial step and chunk)
WIDE_DUALMAD = [("qkv", 6144, 4096, 6), ("ug", 28672, 4096, 7),
                ("odd_kt", 256, 4112, 7), ("odd_kt", 256, 4112, 9)]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,KV", WIDE_DUALMAD)
def test_dualmad_wide_matches_plain_on_card(cuda, name, m, k, KV, a8):
    """dualmad above 8 rows: two launches a call (the x prologue, then the
    GEMV), within 1e-4 (exact) / 1e-3 (a8) of max|y|; f32 x as well as
    bf16 at the odd shapes."""
    fn = arith.tcq2_decode_gemv
    dtypes = ((torch.bfloat16,) if name != "odd_kt"
              else (torch.float32, torch.bfloat16))
    for N in WIDE_ROWS:
        for x_dtype in dtypes:
            words, x = _case(m, k, KV, N, x_dtype, cuda, seed=KV + N,
                             mode="dualmad")
            before = fn.launches
            y = fn(x, words, KV, m, k, a8)
            torch.cuda.synchronize()
            assert fn.launches == before + 2
            ref = arith_gemv_plain(x, words, "dualmad", KV, m, k, a8)
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            # exact: bf16 x times integer weights (tf32 holds them), f32
            # sums in another order; a8: the same chunks, scales and
            # integer chunk sums, but a tie may round the other way
            assert rel <= (1e-3 if a8 else 1e-4), (name, N, x_dtype, rel)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,KV", [WIDE_DUALMAD[0], WIDE_DUALMAD[3]])
def test_dualmad_wide_launches_are_bit_equal(cuda, name, m, k, KV, a8):
    """Two launches give the same bits at 191 rows (a8: two row groups):
    the cluster's partial fragments are summed in rank order."""
    words, x = _case(m, k, KV, 191, torch.bfloat16, cuda, seed=191,
                     mode="dualmad")
    ys = [arith.tcq2_decode_gemv(x, words, KV, m, k, a8) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


# wide_gemv_kernel under the V=1 tile policy (1mad, 2mad) at Path A's o and
# down (tcq1_3), and at the ragged shapes of SHAPES_V1 (odd k/16: a
# partial step and chunk; one m-tile, so a cluster splits k)
WIDE_V1 = [(name, m, k, mode, 3) for name, m, k, _, _ in SHAPES_V1[:2]
           for mode in ("1mad", "2mad")] + [
    sh for sh in SHAPES_V1 if sh[0].startswith("m")]


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,mode,KV", WIDE_V1)
def test_v1_wide_matches_plain_on_card(cuda, name, m, k, mode, KV, a8):
    """1mad and 2mad above 8 rows: two launches a call (the x prologue,
    then the GEMV), within 1e-4 (exact) / 1e-3 (a8) of max|y|; f32 x as
    well as bf16 at the ragged shapes."""
    fn = arith.tcq1_decode_gemv
    dtypes = ((torch.bfloat16,) if not name.startswith("m")
              else (torch.float32, torch.bfloat16))
    for N in WIDE_ROWS:
        for x_dtype in dtypes:
            words, x = _case(m, k, KV, N, x_dtype, cuda, seed=KV + N,
                             mode=mode)
            before = fn.launches
            y = fn(x, words, KV, mode, m, k, a8)
            torch.cuda.synchronize()
            assert fn.launches == before + arith.kernel_launches(mode, N) == (
                before + 2)
            ref = arith_gemv_plain(x, words, mode, KV, m, k, a8)
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            # exact: bf16 x times integer weights (tf32 holds them), f32
            # sums in another order; a8: the same chunks, scales and
            # integer chunk sums (the -510 * sum(q) bias included), but a
            # tie may round the other way
            assert rel <= (1e-3 if a8 else 1e-4), (name, mode, N, x_dtype,
                                                   rel)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("name,m,k,mode,KV", [WIDE_V1[0], WIDE_V1[3],
                                              WIDE_V1[5]])
def test_v1_wide_launches_are_bit_equal(cuda, name, m, k, mode, KV, a8):
    """Two launches give the same bits at 191 rows (a8: two row groups):
    the cluster's partial fragments are summed in rank order."""
    words, x = _case(m, k, KV, 191, torch.bfloat16, cuda, seed=191,
                     mode=mode)
    ys = [arith.tcq1_decode_gemv(x, words, KV, mode, m, k, a8)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


# K2 / K3 beyond the paths' shapes: K3 at KVs outside the GEMV's set (an
# instance each since the persistent walk) and both at ragged shapes: one
# m-tile with k/16 = 17 (a last group of one tile), three with k/16 = 258
# (a last group of two)
DEQUANT_MORE = [(f"kv{kv}", 4096, 4096, "1mad", kv) for kv in (1, 6, 11, 16)]
DEQUANT_MORE += [("m16 k272", 16, 272, "1mad", 3),
                 ("m16 k272", 16, 272, "sum2", 3),
                 ("m48 k4128", 48, 4128, "2mad", 16),
                 ("m48 k4128", 48, 4128, "dualmad", 11)]


@pytest.mark.parametrize("name,m,k,mode,KV", SHAPES_DEQUANT + DEQUANT_MORE)
def test_arith_dequant_bit_equal_to_plain_on_card(cuda, name, m, k, mode,
                                                  KV):
    """Both launches bit-equal to the plain version, each adding exactly 1
    to the wrapper's count."""
    words, _ = _case(m, k, KV, 1, torch.float32, cuda, seed=m + k + KV + 7,
                     mode=mode)
    fn = (arith_dequant.tcq2_dequant if mode in ("sum2", "dualmad")
          else arith_dequant.tcq1_dequant)
    ref = arith_dequant.arith_dequant_plain(words, mode, KV, m, k)
    for _ in range(2):
        before = fn.launches
        w = arith_dequant.dequant(mode, words, KV, m, k)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(w.view(torch.int16), ref.view(torch.int16)), name


@pytest.mark.parametrize("kind,mode,KV", [("tcq2", "dualmad", 7),
                                          ("tcq1", "1mad", 3)])
def test_qlinear_large_rows_on_card(cuda, kind, mode, KV):
    """300 rows: exact through one dequant launch and a product, a8 through
    two GEMV chunks (256 and 44 rows, each an x prologue and the wide
    GEMV); both against the CPU plain path."""
    m, k = 256, 512
    words, x = _case(m, k, KV, 300, torch.bfloat16, cuda, seed=KV,
                     mode=mode)
    p = {"trellis": words, "wscale": torch.full((m,), 0.02, device=cuda)}
    p_cpu = {n: t.cpu() for n, t in p.items()}
    deq = (arith_dequant.tcq2_dequant if kind == "tcq2"
           else arith_dequant.tcq1_dequant)
    a8_launches = sum(arith.kernel_launches(mode, r) for r in (256, 44))
    for impl, fn, launches in (("exact", deq, 1),
                               ("a8", _counted(mode), a8_launches)):
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
    # the kernels take S <= 11: a KV above 10 gets the largest table
    S = min(max(tcq_lut.SUPPORTED_S), tlut_bits_for_kv(max(KV)))
    tlut = torch.tensor(trellis_tlut(S), device=device)
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


# K6 / K7 beyond the flagship: pairs outside the GEMV's set (the instance
# that reads its KVs) and the ragged shapes, with KV 2 / 16 halves
LUT_DEQUANT_MORE = [("5/7", 4096, 4096, (5, 7)), ("2/16", 4096, 4096, (2, 16)),
                    ("m16 k272", 16, 272, (2,)),
                    ("m48 k4128", 48, 4128, (5, 7)),
                    ("m48 k4128", 48, 4128, (2, 16))]


@pytest.mark.parametrize("name,m,k,KV",
                         SHAPES_FLAGSHIP + SHAPES_LUT_RAGGED
                         + LUT_DEQUANT_MORE)
def test_lut_dequant_bit_equal_to_plain_on_card(cuda, name, m, k, KV):
    """Both launches bit-equal to the plain version, each adding exactly 1
    to the wrapper's count."""
    words, tlut = _lut_case(m, k, KV, cuda, seed=m + k + sum(KV) + 1)
    deq, plain = ((tcq_lut.tcq_lut_dequant, tcq_lut.tcq_lut_dequant_plain)
                  if len(KV) == 1 else
                  (tcq_lut.tcomb_lut_dequant,
                   tcq_lut.tcomb_lut_dequant_plain))
    ref = plain(*words, tlut, *KV, m, k)
    for _ in range(2):
        before = deq.launches
        w = deq(*words, tlut, *KV, m, k)
        torch.cuda.synchronize()
        assert deq.launches == before + 1
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
    if vec == 4:  # no vec-4 codebook is committed: a seeded stand-in
        return words, torch.randn((1 << bits, vec), generator=gen,
                                  device=device)
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


@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("bits,vec,m,k", [(6, 2, 4096, 4096),
                                          (4, 1, 4096, 14336),
                                          (8, 4, 4096, 4096),
                                          (8, 4, 4096, 14336)])
def test_vq_gemv_launches_are_bit_equal(cuda, bits, vec, m, k, N):
    """Two launches on the same inputs give the same bits (the warps' C
    fragments are summed in a fixed order, without atomics), at Path C's o,
    Path D's down and Path F's vec-4 o and down."""
    words, lut = _vq_case(bits, vec, m, k, cuda, seed=5 * m + k)
    x = torch.randn((N, k), device=cuda).bfloat16()
    ys = []
    for _ in range(2):
        before = vq.vq_gemv.launches
        ys.append(vq.vq_gemv(x, words, lut, bits, vec, m, k))
        torch.cuda.synchronize()
        assert vq.vq_gemv.launches == before + 1
    assert torch.equal(ys[0].view(torch.int32), ys[1].view(torch.int32))


@pytest.mark.parametrize("bits,vec", vq.SUPPORTED)
def test_vq_gemv_ragged_m_matches_plain(cuda, bits, vec):
    """m not a multiple of 16 (the last m-tile's missing rows read a valid
    row and are never stored), one m-tile or many, k of three chunks and
    of 56 (Path C's down): within 1e-4 of max|y| at N in {1, 8}."""
    for m, k in ((5, 384 * vec), (4100, 384 * vec), (1000, 7168 * vec)):
        words, lut = _vq_case(bits, vec, m, k, cuda, seed=m + k + bits)
        for N in (1, 8):
            x = torch.randn((N, k), device=cuda).bfloat16()
            y = vq.vq_gemv(x, words, lut, bits, vec, m, k)
            torch.cuda.synchronize()
            ref = vq.vq_gemv_plain(x, words, lut, bits, vec, m, k)
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            assert rel <= 1e-4, (m, k, N, rel)


@pytest.mark.parametrize("bits", range(4, 13))
def test_vq4_gemv_row_slice_is_bit_equal(cuda, bits):
    """K8 at vec 4 sums each output element in an order fixed by k alone:
    the rows of a slice of the row-pack (a column-parallel rank's half,
    and rows 37-1000) come out bit-equal to the same rows of the whole,
    at o (8 chunks a row) and down (28), N in {1, 8}."""
    for m, k in ((4096, 4096), (4096, 14336)):
        words, lut = _vq_case(bits, 4, m, k, cuda, seed=3 * m + k + bits)
        for N in (1, 8):
            x = torch.randn((N, k), device=cuda).bfloat16()
            y = vq.vq_gemv(x, words, lut, bits, 4, m, k)
            for r0, r1 in ((m // 2, m), (37, 1000)):
                part = vq.vq_gemv(x, words[r0:r1].clone(), lut, bits, 4,
                                  r1 - r0, k)
                torch.cuda.synchronize()
                assert torch.equal(part.view(torch.int32),
                                   y[:, r0:r1].contiguous().view(
                                       torch.int32)), (m, k, N, r0, r1)


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


# the captured decode step on test_torch_model.py's 2-layer shapes: tcq2s_6
# everywhere, merged qkv / ug, the 4-bit head; 9 sum2 K1 launches a step
SMALL_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=1792,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                 rope_theta=5e5)
SMALL_S, SMALL_T = 6, 24


@pytest.fixture(scope="module")
def small_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec, params = build_quantized_model(
        LlamaConfig(**SMALL_CFG), "tcq2s_6_none_0.9",
        merge_info=[["merge_qkv", "merge_ug"]] * 2, dummy=True, impl="a8",
        lm_head_bits=4, seed=0, device="cuda")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, 512, (1, SMALL_S)), device="cuda")
    yield spec, params, prompt
    decode.release_captured(params)


def _prefilled(step, spec, params, prompt):
    """step's caches prefilled with prompt; its input the greedy token."""
    logits, _ = decode.prefill(spec, params, prompt, step.caches)
    cur = logits[:, -1].argmax(dim=-1)[:, None]
    step.reset(cur, prompt.shape[1])
    return cur


@pytest.mark.parametrize("quantized", [False, True])
def test_captured_step_bit_equal_to_eager(small_model, quantized):
    """Capture records the step's 9 K1 launches; 4 replays give the eager
    forward's logits and caches bit for bit from the same caches and
    position, with bf16 and int8 KV caches."""
    spec, params, prompt = small_model
    step = decode.CapturedStep(spec, params, 1, SMALL_T, 0.6, 5, quantized)
    assert step.graph is not None
    assert step.launches == {"tcq2s_decode_gemv": 9}
    tok = _prefilled(step, spec, params, prompt)
    eager = [tuple(t.clone() for t in c) for c in step.caches]
    for i in range(4):
        before = tcq2s_decode_gemv.launches
        step.replay()
        assert tcq2s_decode_gemv.launches == before  # a replay counts none
        want, eager = llama.forward(spec, params, tok, kv_caches=eager,
                                    cache_pos=SMALL_S + i)
        assert torch.equal(step.logits, want[:, -1]), i
        tok = step.token.clone()
    assert all(torch.equal(a, b) for c, e in zip(step.caches, eager)
               for a, b in zip(c, e))


def test_captured_sampling_is_seeded(small_model):
    """Replays from the same token and position draw new noise each time
    (temperature 1e4: top-5 nearly uniform), and the same seed draws the
    same tokens; two sampled generate_fast runs with one seed agree."""
    spec, params, prompt = small_model
    step = decode.CapturedStep(spec, params, 1, SMALL_T, 1e4, 5)
    cur = _prefilled(step, spec, params, prompt)
    draws = []
    for _ in range(2):
        step.generator.manual_seed(7)
        seq = []
        for _ in range(16):
            step.reset(cur, SMALL_S)
            step.replay()
            seq.append(step.token.item())
        draws.append(seq)
    assert draws[0] == draws[1] and len(set(draws[0])) > 1, draws
    runs = [decode.generate_fast(spec, params, prompt.cpu().numpy(), 12,
                                 seed=3) for _ in range(2)]
    assert runs[0][1]["captured"]
    assert np.array_equal(runs[0][0], runs[1][0])


def test_replay_advances_position(small_model):
    """The graph writes the next token at history[pos + 1] and adds one to
    pos; replays past the cache raise before launching."""
    spec, params, prompt = small_model
    step = decode.CapturedStep(spec, params, 1, SMALL_T, 0.0, None)
    _prefilled(step, spec, params, prompt)
    step.replay(3)
    assert step.pos.item() == step.host_pos == SMALL_S + 3
    assert step.history[0, SMALL_S + 3].item() == step.token.item()
    with pytest.raises(ValueError):
        step.replay(SMALL_T - SMALL_S - 2)
    assert step.pos.item() == SMALL_S + 3


# --- the loader's routes: impl dequant, comb, merged shapes ---------------

def _to_cpu(p):
    return {k: v.cpu() for k, v in p.items()}


def _spec_and_params(kind, m, k, device, seed, KV=(), mode="", bits=0,
                     vec=0, split=(), impl="dequant"):
    """A projection of the given kind with random words and Wscale on the
    card (canonical layouts, as the loader holds them), and its luts."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(rows, cols, per_state, kv):
        return torch.randint(-(1 << 31), 1 << 31,
                             ((rows // 16) * (cols // 16), per_state * kv),
                             generator=gen, dtype=torch.int32, device=device)

    S = tlut_bits_for_kv(max(KV)) if kind in ("tcq", "tcomb", "comb") else 0
    p = {"wscale": torch.rand(m, generator=gen, device=device) + 0.5}
    if kind in ("tcq1", "tcq2"):
        p["trellis"] = words(m, k, 8 if kind == "tcq1" else 4, KV[0])
    elif kind == "tcq":
        p["trellis"] = words(m, k, 4, KV[0])
    elif kind == "tcomb":
        split = (k // 2, k // 2)
        p["trellis1"], p["trellis2"] = (words(m, k // 2, 4, kv) for kv in KV)
    elif kind == "comb":
        p["trellis1"], p["trellis2"] = (words(mh, k, 4, kv)
                                        for mh, kv in zip(split, KV))
    else:
        p["qweight"] = torch.randint(
            -(1 << 31), 1 << 31, (m, vq.row_words(k, bits, vec)),
            generator=gen, dtype=torch.int32, device=device)
        p["lut"] = torch.tensor(vq_lut(bits, vec), device=device)
    spec = LinearSpec(kind, k, m, KV=KV, tlut_bits=S, bits=bits, vec=vec,
                      split=split, mode=mode, impl=impl)
    luts = {f"tcq{S}": torch.tensor(trellis_tlut(S), device=device)} if S \
        else {}
    return spec, p, luts


# (kind, m, k, options, its dequant kernel, launches a call): each kind at
# an 8B shape of a merge, comb with unequal 16-row halves
DEQUANT_ROUTE = [
    ("tcq2", 2048, 4096, dict(KV=(6,), mode="sum2"), "tcq2_dequant", 1),
    ("tcq2", 5120, 4096, dict(KV=(6,), mode="dualmad"), "tcq2_dequant", 1),
    ("tcq1", 4096, 4096, dict(KV=(3,), mode="1mad"), "tcq1_dequant", 1),
    ("tcq1", 2048, 4096, dict(KV=(4,), mode="2mad"), "tcq1_dequant", 1),
    ("tcq", 6144, 4096, dict(KV=(8,)), "tcq_lut_dequant", 1),
    ("comb", 4096, 4096, dict(KV=(6, 7), split=(1632, 2464)),
     "tcq_lut_dequant", 2),
    ("tcomb", 5120, 4096, dict(KV=(8, 9)), "tcomb_lut_dequant", 1),
    ("vq", 2048, 4096, dict(bits=6, vec=2), "vq_dequant", 1),
]


@pytest.mark.parametrize("kind,m,k,opts,kernel,calls", DEQUANT_ROUTE)
def test_dequant_route_matches_plain_on_card(cuda, kind, m, k, opts, kernel,
                                             calls):
    """impl dequant: W_hat from the kind's dequant kernel (K2, K3, K6 - twice
    for comb -, K7, K9) bit-equal to the plain version's, and the f32
    product with Wscale within 1e-5 of max|y| of the CPU's (the same bf16
    operands, f32 sums in another order)."""
    from qpalette_tpu_torch.kernels import launch_counts
    from qpalette_tpu_torch.runtime.qlinear import dequant_weight

    spec, p, luts = _spec_and_params(kind, m, k, cuda, seed=m + k, **opts)
    p_cpu, luts_cpu = _to_cpu(p), _to_cpu(luts)
    before = launch_counts()
    w = dequant_weight(spec, p, luts)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {kernel: calls}
    w_ref = dequant_weight(spec, p_cpu, luts_cpu)
    assert torch.equal(w.cpu().view(torch.int16), w_ref.view(torch.int16))
    for N in (1, 8, 16):
        x = torch.randn((N, k), device=cuda).bfloat16()
        y = qlinear_apply(spec, p, x, out_dtype=torch.float32, luts=luts)
        ref = qlinear_apply(spec, p_cpu, x.cpu(), out_dtype=torch.float32,
                            luts=luts_cpu)
        rel = ((y.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-5, (kind, N, rel)


@pytest.mark.parametrize("split", [(1632, 2464), (16, 4080), (4080, 16)])
def test_comb_is_two_lut_gemvs_on_card(cuda, split):
    """comb under exact at N <= 8: two K4 launches over the row halves
    (unequal, 16-row aligned), outputs side by side, against the plain
    versions within 1e-4 of max|y|."""
    spec, p, luts = _spec_and_params("comb", 4096, 4096, cuda, seed=9,
                                     KV=(6, 7), split=split, impl="exact")
    p_cpu, luts_cpu = _to_cpu(p), _to_cpu(luts)
    for N in (1, 8):
        x = torch.randn((N, 4096), device=cuda).bfloat16()
        before = tcq_lut.tcq_lut_gemv.launches
        y = qlinear_apply(spec, p, x, out_dtype=torch.float32, luts=luts)
        torch.cuda.synchronize()
        assert tcq_lut.tcq_lut_gemv.launches == before + 2
        ref = qlinear_apply(spec, p_cpu, x.cpu(), out_dtype=torch.float32,
                            luts=luts_cpu)
        rel = ((y.cpu() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, (split, N, rel)


# the m of the attention merges (kv 2048, qk / qv 5120, qkv 6144) and of ug
# (28672) at k = 4096, for the GEMVs no path ran there before
MERGED_M = [2048, 5120, 6144, 28672]


@pytest.mark.parametrize("m", MERGED_M)
@pytest.mark.parametrize("KV", [(8,), (8, 9)])
def test_lut_gemv_at_merged_m(cuda, m, KV):
    words, tlut = _lut_case(m, 4096, KV, cuda, seed=m + sum(KV))
    gemv, plain = _lut_gemv(KV)
    for N in (1, 8):
        x = torch.randn((N, 4096), device=cuda).bfloat16()
        y = gemv(x, *words, tlut, *KV, m, 4096)
        ref = plain(x, *words, tlut, *KV, m, 4096)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, (m, KV, N, rel)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m", MERGED_M[:2])
@pytest.mark.parametrize("mode,KV", [("sum2", 6), ("dualmad", 6),
                                     ("1mad", 3)])
def test_arith_gemv_at_merged_m(cuda, mode, KV, m, a8):
    for N in (1, 8):
        words, x = _case(m, 4096, KV, N, torch.float32, cuda, seed=m + N,
                         mode=mode)
        y = arith.decode_gemv(mode, x, words, KV, m, 4096, a8)
        ref = arith_gemv_plain(x, words, mode, KV, m, 4096, a8)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-3 if a8 else 1e-4), (mode, m, N, rel)


@pytest.mark.parametrize("m", MERGED_M[:2])
def test_vq_gemv_at_merged_m(cuda, m):
    qweight, lut = _vq_case(6, 2, m, 4096, cuda, seed=m)
    for N in (1, 8):
        x = torch.randn((N, 4096), device=cuda).bfloat16()
        y = vq.vq_gemv(x, qweight, lut, 6, 2, m, 4096)
        ref = vq.vq_gemv_plain(x, qweight, lut, 6, 2, m, 4096)
        rel = ((y - ref).abs().max() / ref.abs().max()).item()
        assert rel <= 1e-4, (m, N, rel)


def test_merged_model_replays_bit_equal_to_eager(cuda):
    """A 3-layer model with the qk, kv and qv merges, choices "1", "xla"
    and "pallas" beside "0" (session a8): the capture records an eager
    forward's launches, dequant kernels among them, and 4 replays give the
    eager forward's logits and caches bit for bit."""
    from qpalette_tpu_torch.kernels import launch_counts, reset_launches

    t8, tc, t2s, t2, t1, ld = ("tcq_8_none_0.9", "tcomb_8_9_0.5_none_0.9",
                               "tcq2s_6_none_0.9", "tcq2_6_none_0.9",
                               "tcq1_3_none_0.9", "ldlq_2_6_none_1.0")
    keys = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
            "mlp.down_proj")
    layers = [(t8, "0"), (t8, "0"), (t2s, "1"), (tc, "xla"), (t2, "0"),
              (t2, "0"), (ld, "1")], \
        [(t1, "1"), (t2s, "0"), (t2s, "0"), (tc, "0"), (t8, "xla"),
         (t8, "xla"), (t1, "pallas")], \
        [(ld, "0"), (t8, "1"), (ld, "0"), (t2, "pallas"), (tc, "0"),
         (tc, "0"), (t1, "0")]
    qdict = {f"{i}_{k}": v for i, layer in enumerate(layers)
             for k, v in zip(keys, layer)}
    merge = [["merge_qk", "merge_ug"], ["merge_kv"], ["merge_qv", "merge_ug"]]
    spec, params = build_quantized_model(
        LlamaConfig(**dict(SMALL_CFG, num_layers=3)), qdict,
        merge_info=merge, dummy=True, impl="a8", lm_head_bits=4, seed=0,
        device="cuda")
    assert [a.merge for a, _ in spec.layers] == ["qk", "kv", "qv"]
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, 512, (1, SMALL_S)), device="cuda")
    caches = llama.init_kv_caches(spec, 1, SMALL_T, "cuda")
    logits, caches = decode.prefill(spec, params, prompt, caches)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    reset_launches()
    llama.forward(spec, params, tok, kv_caches=caches, cache_pos=SMALL_S)
    torch.cuda.synchronize()
    eager_counts = {k: v for k, v in launch_counts().items() if v}
    for name in ("tcq2_dequant", "tcq1_dequant", "tcq_lut_dequant",
                 "tcomb_lut_dequant", "vq_dequant"):
        assert eager_counts.get(name), (name, eager_counts)
    step = decode.CapturedStep(spec, params, 1, SMALL_T, 0.0, None)
    assert step.launches == eager_counts
    tok = _prefilled(step, spec, params, prompt)
    eager = [tuple(t.clone() for t in c) for c in step.caches]
    for i in range(4):
        step.replay()
        want, eager = llama.forward(spec, params, tok, kv_caches=eager,
                                    cache_pos=SMALL_S + i)
        assert torch.equal(step.logits, want[:, -1]), i
        tok = step.token.clone()
    assert all(torch.equal(a, b) for c, e in zip(step.caches, eager)
               for a, b in zip(c, e))
    decode.release_captured(params)


def _pool_state(pool):
    return ([tuple(t.clone() for t in kv) for kv in pool.caches],
            [t.clone() for t in (pool.token, pool.pos, pool.active,
                                 pool.logits, pool.history)],
            pool.generator.get_state())


def _set_pool_state(pool, state):
    caches, bufs, gen = state
    for mine, kv in zip(pool.caches, caches):
        for a, b in zip(mine, kv):
            a.copy_(b)
    for a, b in zip((pool.token, pool.pos, pool.active, pool.logits,
                     pool.history), bufs):
        a.copy_(b)
    pool.generator.set_state(gen)


@pytest.mark.parametrize("slots", [4, 16])
def test_pool_graph_bit_equal_to_eager(small_model, slots):
    """The serving pool step (runtime/serving.PoolStep) at 4 slots (K1's
    tensor-core kernel, one launch a call) and 16 (the wide kernel, two):
    capture records 9 calls' launches; from the same buffers (per-row
    positions, some rows inactive, prefilled caches, the generator's
    state) a replay gives the eager step's logits, tokens, positions,
    history and caches bit for bit, sampled at temperature 0.6, top-k 5."""
    from qpalette_tpu_torch.kernels import arith
    from qpalette_tpu_torch.runtime import serving

    spec, params, _ = small_model
    pool = serving.PoolStep(spec, params, slots, SMALL_T, 0.6, 5)
    assert pool.launches == {
        "tcq2s_decode_gemv": 9 * arith.kernel_launches("sum2", slots)}
    rng = np.random.default_rng(slots)
    llama.forward(spec, params, torch.as_tensor(
        rng.integers(0, 512, (slots, 8)), device="cuda"),
        kv_caches=pool.caches, cache_pos=0)
    pool.load(rng.integers(0, 512, (slots, 1)), rng.integers(0, 9, slots),
              np.arange(slots) % 3 != 2)
    pool.generator.manual_seed(5)
    state = _pool_state(pool)
    for _ in range(2):
        pool.replay()
    graph = _pool_state(pool)
    _set_pool_state(pool, state)
    for _ in range(2):
        pool.step_eager()
    eager = _pool_state(pool)
    for a, b in zip(graph[1], eager[1]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for x, y in zip(graph[0], eager[0])
               for a, b in zip(x, y))
    assert (pool.token[~pool.active] == 0).all()
    serving.release_pools(params)


def test_admission_leaves_other_rows(small_model):
    """prefill_slots on the card writes the admitted slots' rows (two
    chunks at their own start positions) and leaves the other 14 slots'
    cache rows bit-unchanged."""
    from qpalette_tpu_torch.runtime import serving

    spec, params, _ = small_model
    caches = llama.init_kv_caches(spec, 16, SMALL_T, "cuda")
    rng = np.random.default_rng(1)
    llama.forward(spec, params, torch.as_tensor(
        rng.integers(0, 512, (16, 8)), device="cuda"), kv_caches=caches,
        cache_pos=0)
    before = [tuple(t.clone() for t in kv) for kv in caches]
    slots = torch.tensor([11, 3], device="cuda")
    serving.prefill_slots(spec, params, caches, slots, torch.as_tensor(
        rng.integers(0, 512, (2, 10)), device="cuda"),
        torch.tensor([0, 5], device="cuda"))
    others = [s for s in range(16) if s not in (3, 11)]
    for kv, old in zip(caches, before):
        for a, b in zip(kv, old):
            assert torch.equal(a[others], b[others])
            assert not torch.equal(a[[3, 11]], b[[3, 11]])


def test_dryrun_on_card(cuda, capsys):
    """python -m qpalette_tpu_torch.dryrun 2: two gloo ranks sharing the
    card (tp = 2) against the one-process forward on it, within the dry
    run's budget; entry()'s forward runs on the card."""
    from qpalette_tpu_torch import dryrun

    worst = dryrun.dryrun_multichip(2)
    assert worst < dryrun.TP_BUDGET
    assert "on cuda" in capsys.readouterr().out
    fn, args = dryrun.entry()
    out = fn(*args)
    assert out.is_cuda and out.shape == (1, 8, 256)
    assert bool(torch.isfinite(out).all())
