"""Port parity: the tcq2s decode-GEMV's plain version (the CPU path of
qpalette_tpu_torch.kernels.tcq2s) against the reference Pallas kernel
fused.tcq2_decode_matmul(mode="sum2"), run in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.kernels import formats as kf
from qpalette_tpu.kernels import fused
from qpalette_tpu.runtime import qlinear as jqlinear

from qpalette_tpu_torch.kernels.formats import tcq2_planar_to_canonical
from qpalette_tpu_torch.kernels.arith import (arith_gemv_plain,
                                              tcq2s_decode_gemv)
from qpalette_tpu_torch.kernels.arith_dequant import arith_dequant_plain
from qpalette_tpu_torch.ops.hadamard import hadamard_transform_t
from qpalette_tpu_torch.ops.packing import words_to_torch
from qpalette_tpu_torch.runtime.qlinear import LinearSpec, qlinear_apply

M, K = 64, 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(KV, seed, rows=2):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, ((M // 16) * (K // 16), 4 * KV),
                         dtype=np.uint32)
    x = rng.standard_normal((rows, K)).astype(np.float32)
    tr_pl = kf.tcq2_planar_weights(jnp.asarray(words), M, K, KV)
    return words, x, tr_pl


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@pytest.mark.parametrize("KV", [4, 6, 8])
def test_plain_matches_reference_kernel(KV):
    words, x, tr_pl = _case(KV, 200 + KV)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(fused.tcq2_decode_matmul(xb, tr_pl, KV, M, K,
                                              mode="sum2"))
    ref_a8 = np.asarray(fused.tcq2_decode_matmul(xb, tr_pl, KV, M, K,
                                                 a8=True, mode="sum2"))
    tw = words_to_torch(words)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tcq2s_decode_gemv(xt, tw, KV, M, K, a8=False).numpy()
    # exact: same decode, f32 sums in another order
    assert _rel(got, ref) < 1e-5
    got_a8 = tcq2s_decode_gemv(xt, tw, KV, M, K, a8=True).numpy()
    # a8 vs exact: activation quantization only (the bound of the
    # reference's test_a8_path_close_to_exact)
    assert _rel(got_a8, ref) < 0.05
    # at k=256 both sides quantize the whole of k with one scale, so the
    # int8 activations agree except at exact ties (|x/s| = j + 1/2, e.g.
    # a bf16 x equal to half the absmax), which XLA may round the other
    # way by forming s or x*(1/s) in another order; each flipped tie moves
    # y by at most s*256/147.8, well under 1% of max|y| here
    assert _rel(got_a8, ref_a8) < 1e-2


@pytest.mark.parametrize("KV,a8", [(4, False), (6, False), (6, True),
                                   (8, True)])
def test_fused_rotation_matches_reference(KV, a8):
    """su= (rotation fused into the reference kernel's prologue, f32 into
    the kernel) == the port's f32 rotation followed by the kernel."""
    words, x, tr_pl = _case(KV, 300 + KV, rows=1)
    rng = np.random.default_rng(KV)
    su = ((rng.standard_normal(K) > 0) * 2.0 - 1.0).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(fused.tcq2_decode_matmul(
        xb, tr_pl, KV, M, K, a8=a8, mode="sum2", su=jnp.asarray(su)))
    z = hadamard_transform_t(torch.from_numpy(x).to(torch.bfloat16).float()
                             * torch.from_numpy(su))
    got = tcq2s_decode_gemv(z, words_to_torch(words), KV, M, K, a8=a8)
    # exact: the rotation's f32 rounding (reference folds the scale into
    # its second factor) then bf16 rounding of x; a8: an int8 round tie
    # may flip between the two f32 rotations (the reference's own
    # fused-vs-explicit bound)
    assert _rel(got.numpy(), ref) < (0.02 if a8 else 1e-4)


@pytest.mark.parametrize("KV", [4, 6, 8])
def test_planar_inverse_is_exact(KV):
    words, _, tr_pl = _case(KV, 400 + KV)
    back = tcq2_planar_to_canonical(np.asarray(tr_pl), M, K, KV)
    assert back.dtype == np.uint32 and np.array_equal(back, words)


def test_planar_inverse_rejects_odd_kv():
    """Odd KV inverts from the reference's dense double-tile layout (even
    k/16) but not from its aligned fallback (odd k/16)."""
    words, _, tr_pl = _case(5, 405)
    back = tcq2_planar_to_canonical(np.asarray(tr_pl), M, K, 5)
    assert np.array_equal(back, words)
    k_odd = 208  # k/16 = 13
    rng = np.random.default_rng(406)
    w_odd = rng.integers(0, 1 << 32, ((M // 16) * (k_odd // 16), 20),
                         dtype=np.uint32)
    pl_odd = kf.tcq2_planar_weights(jnp.asarray(w_odd), M, k_odd, 5)
    with pytest.raises(ValueError):
        tcq2_planar_to_canonical(np.asarray(pl_odd), M, k_odd, 5)


@pytest.mark.parametrize("bad", ["kv", "m", "dtype", "rows", "shape"])
def test_wrapper_rejects_unsupported_input(bad):
    words, x, _ = _case(6, 500)
    tw, xt = words_to_torch(words), torch.from_numpy(x)
    args = dict(x=xt, trellis=tw, KV=6, m=M, k=K, a8=False)
    if bad == "kv":
        args.update(KV=11, trellis=torch.zeros((tw.shape[0], 44),
                                               dtype=torch.int32))
    elif bad == "m":
        args.update(m=M + 8)
    elif bad == "dtype":
        args.update(x=xt.double())
    elif bad == "rows":
        args.update(x=torch.zeros((257, K)))
    else:
        args.update(trellis=tw.to(torch.int64))
    with pytest.raises((ValueError, TypeError)):
        tcq2s_decode_gemv(**args)


def test_qlinear_row_cutoffs():
    """a8 above 256 rows runs 256-row chunks through the same kernel;
    exact above 256 rows dequantizes (K2) and takes an f32 product."""
    words, _, _ = _case(6, 600)
    rng = np.random.default_rng(601)
    z = torch.from_numpy(rng.standard_normal((300, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    p = {"trellis": words_to_torch(words),
         "wscale": torch.from_numpy(rng.random(M).astype(np.float32))}
    spec = LinearSpec("tcq2", K, M, KV=(6,), mode="sum2", impl="a8")
    y = qlinear_apply(spec, p, z, out_dtype=torch.float32)
    parts = [arith_gemv_plain(z[r:r + 256], p["trellis"], "sum2", 6, M, K,
                              True) for r in (0, 256)]
    want = torch.cat(parts) * p["wscale"][None, :]
    assert torch.equal(y, want)
    y = qlinear_apply(LinearSpec("tcq2", K, M, KV=(6,), mode="sum2",
                                 impl="exact"), p, z, out_dtype=torch.float32)
    w = arith_dequant_plain(p["trellis"], "sum2", 6, M, K)
    assert torch.equal(y, (z.float() @ w.float().T) * p["wscale"][None, :])


@pytest.mark.parametrize("kind", ["dense", "dense_rot"])
def test_qlinear_dense_kinds_match_reference(kind):
    rng = np.random.default_rng(700)
    w = rng.standard_normal((M, K)).astype(np.float32)
    z = rng.standard_normal((3, K)).astype(np.float32)
    su = ((rng.standard_normal(K) > 0) * 2.0 - 1.0).astype(np.float32)
    wscale = rng.random(M).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16), "wscale": jnp.asarray(wscale)}
    jz = jnp.asarray(z, jnp.bfloat16)
    want = np.asarray(jqlinear.qlinear_apply(
        jqlinear.LinearSpec(kind, K, M), jp, jz,
        pre_rot=(jnp.asarray(su), 1)).astype(jnp.float32))
    p = {"w": torch.from_numpy(w).to(torch.bfloat16),
         "wscale": torch.from_numpy(wscale)}
    got = qlinear_apply(LinearSpec(kind, K, M), p,
                        torch.from_numpy(z).to(torch.bfloat16),
                        pre_rot=torch.from_numpy(su))
    assert got.dtype == torch.bfloat16
    # both round the rotated activation and the output to bf16; f32 sums
    # in another order may move an output by one bf16 ulp (2^-8)
    assert _rel(got.float().numpy(), want) < 8e-3
