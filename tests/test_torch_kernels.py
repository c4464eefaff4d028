"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version; it is held
here against the JAX Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it), and the port's ``ref`` oracles are
held against the same.  Inputs come from seeded numpy and go to both
packages; both round them to bf16 the same way.

Tolerances: float32 2e-5, since the two sides sum in another order
(blocked online softmax in JAX, one softmax in the port); bf16 2e-2,
about two bf16 steps at magnitude 1, since both sides round the output to
bf16 from float32 values that differ in the last float32 bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port, jax_out, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(port.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 7, 128), (2, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, shape[-1:], "float32")
    want = jax_rmsnorm(jx, jw, block_rows=2, interpret=True)
    got = rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    _close(ref.rmsnorm_reference(tx, tw), want, dtype)


FLASH_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, block)
    (1, 16, 16, 2, 2, 16, True, None, 8),      # GQA 1 (MHA)
    (2, 64, 64, 4, 2, 32, True, None, 16),     # GQA 2
    (2, 64, 64, 4, 2, 32, False, None, 16),    # not causal
    (1, 33, 33, 8, 2, 64, True, None, 16),     # GQA 4, ragged S
    (1, 37, 37, 4, 1, 16, False, None, 16),    # MQA, ragged, not causal
    (2, 32, 128, 4, 4, 32, True, None, 16),    # kv_offset = 96
    (1, 48, 48, 4, 2, 32, True, 7, 16),        # window
    (1, 96, 96, 8, 2, 120, True, 64, 32),      # danube's head dim, window 64
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(case, dtype):
    b, sq, sk, h, kv, d, causal, window, block = case
    rng = np.random.default_rng(sq * 31 + d)
    jq, tq = _pair(rng, (b, sq, h, d), dtype)
    jk, tk = _pair(rng, (b, sk, kv, d), dtype)
    jv, tv = _pair(rng, (b, sk, kv, d), dtype)
    kw = dict(causal=causal, window=window, kv_offset=sk - sq)
    want = jax_flash_attention(jq, jk, jv, block_q=block, block_k=block,
                               interpret=True, **kw)
    _close(flash_attention(tq, tk, tv, **kw), want, dtype)
    _close(ref.mha_reference(tq, tk, tv, **kw), want, dtype)


DECODE_CASES = [
    # (B, H, KV, hd, C, pos, window): the step writes slot pos % C and
    # attends with cache_len = min(pos + 1, C), as `Attention.decode` does
    (2, 8, 4, 32, 64, 16, None),      # short prefix of a long buffer
    (1, 8, 8, 16, 32, 31, None),      # full, MHA
    (2, 16, 2, 16, 24, 24, None),     # ring just wrapped, GQA 8
    (2, 8, 2, 32, 24, 5 * 24 + 3, None),   # wrapped many times
    (2, 8, 4, 32, 64, 63, 30),        # window inside a full ring
    (1, 8, 2, 120, 130, 99, 64),      # danube's head dim, window 64
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(case, dtype):
    b, h, kv, hd, c, pos, window = case
    clen = min(pos + 1, c)
    rng = np.random.default_rng(c * 13 + pos)
    jq, tq = _pair(rng, (b, h, hd), dtype)
    jk, tk = _pair(rng, (b, c, kv, hd), dtype)
    jv, tv = _pair(rng, (b, c, kv, hd), dtype)
    want = jax_decode_attention(jq, jk, jv, clen, window=window, block_k=32,
                                interpret=True)
    lens = torch.tensor(clen, dtype=torch.int32)
    _close(decode_attention(tq, tk, tv, lens, window=window), want, dtype)
    _close(ref.decode_attention_ref(tq, tk, tv, lens, window=window), want, dtype)


@pytest.mark.parametrize("window", [None, 12])
def test_decode_attention_per_sequence_lengths_match_chunked(window):
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (3, 8, 32), "float32")
    jk, tk = _pair(rng, (3, 40, 4, 32), "float32")
    jv, tv = _pair(rng, (3, 40, 4, 32), "float32")
    lens = [1, 17, 40]
    want = jref.decode_attention_chunked(jq, jk, jv, jnp.asarray(lens), window=window,
                                         block_k=16)
    tlens = torch.tensor(lens, dtype=torch.int32)
    _close(decode_attention(tq, tk, tv, tlens, window=window), want, "float32")
    _close(ref.decode_attention_ref(tq, tk, tv, tlens, window=window), want, "float32")


def test_ops_dispatch_by_impl():
    rng = np.random.default_rng(6)
    _, q = _pair(rng, (1, 8, 4, 16), "float32")
    _, k = _pair(rng, (1, 8, 2, 16), "float32")
    assert torch.equal(ops.attention(q, k, k, impl="ref"), ref.mha_reference(q, k, k))
    assert torch.equal(ops.attention(q, k, k), flash_attention(q, k, k))
    w = torch.ones(16)
    assert torch.equal(ops.rmsnorm(q, w, impl="ref"), ref.rmsnorm_reference(q, w))
    with pytest.raises(ValueError):
        ops.rmsnorm(q, w, impl="pallas")
