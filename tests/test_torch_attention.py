"""Port parity for the blockwise long-context attention: the port's
_attention_flash against the reference's on the same numpy inputs from a
seed, at small chunks (qc = tc = 16), for a Python-int offset (whole KV
chunks pruned), a 0-d and a per-row (B,) tensor offset (every chunk
scanned, masked), S < T with an offset and S not a multiple of qc (the
divisor fallback); and the dispatch of both sides' _attention just above
and at 2^22 query-key pairs, at LlamaConfig.tiny() widths.

Inputs are float32, so both sides keep float32 outputs: they differ only
in the order of float32 sums (the port multiplies heads-first chunks, the
reference scans einsums), measured below 3e-7 of max|out|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpalette_tpu.models import llama as jllama
from qpalette_tpu.models.llama import LlamaConfig as JConfig

from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.models.llama import LlamaConfig

TOL = 1e-5  # of max|out|
CFG, JCFG = LlamaConfig.tiny(), JConfig.tiny()  # 4 heads, 2 kv heads, d 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (as tests/test_torch_decode.py): parallel test
    workers, each with a thread a core, oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, T, seed):
    rng = np.random.default_rng(seed)
    H, hk, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, hk, D)).astype(np.float32),
            rng.standard_normal((B, T, hk, D)).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


# (B, S, T, offset, qc, tc): offset an int, "0d:<v>" a 0-d tensor, or a
# list of per-row offsets
CASES = {
    "int_pruned": (1, 64, 64, 0, 16, 16),
    "int_offset_s_lt_t": (2, 32, 64, 32, 16, 16),
    "zero_d": (2, 64, 64, "0d:0", 16, 16),
    "zero_d_s_lt_t": (1, 32, 64, "0d:32", 16, 16),
    "per_row": (2, 32, 64, [32, 5], 16, 16),
    "divisor_fallback": (1, 48, 64, 16, 32, 16),  # qc 32 -> 16
    "divisor_fallback_t": (1, 40, 40, 0, 16, 16),  # 16 -> 8 on both
}


def _offsets(off):
    if isinstance(off, str):
        v = int(off.split(":")[1])
        return jnp.int32(v), torch.tensor(v)
    if isinstance(off, list):
        return (jnp.asarray(off, jnp.int32),
                torch.tensor(off, dtype=torch.int64))
    return off, off


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_reference(name):
    B, S, T, off, qc, tc = CASES[name]
    q, k, v = _qkv(B, S, T, seed=sorted(CASES).index(name))
    joff, toff = _offsets(off)
    want = jllama._attention_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), joff, JCFG, qc=qc, tc=tc)
    got = llama._attention_flash(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), toff, CFG, qc=qc,
                                 tc=tc)
    assert got.shape == (B, S, CFG.num_heads * CFG.head_dim)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL
    # and the whole-logits attention of the port on the same inputs
    whole = llama._attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), toff, CFG)
    assert _rel(got.numpy(), whole.numpy()) < TOL


def test_pruning_skips_only_masked_chunks(monkeypatch):
    """An int offset prunes the KV chunks after each query chunk, a 0-d
    tensor of the same value scans them all: the same output either way,
    but fewer chunk products for the int."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, seed=9))
    products = []
    matmul = torch.Tensor.__matmul__

    def counted(a, b):
        products.append(1)
        return matmul(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", counted)
    pruned = llama._attention_flash(q, k, v, 0, CFG, qc=16, tc=16)
    n_pruned = len(products)
    products.clear()
    full = llama._attention_flash(q, k, v, torch.tensor(0), CFG, qc=16,
                                  tc=16)
    n_full = len(products)
    # 4 query chunks: 1 + 2 + 3 + 4 KV chunks pruned, 4 x 4 scanned; two
    # products (q k^T, p v) a chunk
    assert (n_pruned, n_full) == (2 * 10, 2 * 16)
    assert _rel(pruned.numpy(), full.numpy()) < TOL


@pytest.mark.parametrize("S,T,offset,flash", [
    (2048, 2560, 512, True),   # 5.2 M pairs: blockwise on both sides
    (2048, 2048, 0, False),    # 2^22 exactly: whole logits on both
])
def test_dispatch_at_threshold(S, T, offset, flash, monkeypatch):
    """Both sides' _attention at S*T just above 2^22 (the threshold
    untouched) take the blockwise path and agree; at 2^22 the port takes
    the whole logits."""
    assert llama._FLASH_MIN_CELLS == jllama._FLASH_MIN_CELLS == 1 << 22
    q, k, v = _qkv(1, S, T, seed=S + T)
    taken = []
    flash_fn = llama._attention_flash

    def spy(*a, **kw):
        taken.append(1)
        return flash_fn(*a, **kw)

    monkeypatch.setattr(llama, "_attention_flash", spy)
    got = llama._attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), offset, CFG)
    assert bool(taken) == flash
    want = jllama._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             offset, JCFG)
    assert _rel(got.numpy(), want) < TOL
