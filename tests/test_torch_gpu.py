"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card: it is marked ``gpu`` and skips inside
the test (through the ``cuda`` fixture) when there is none, so every
worker collects the same tests.  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5, the two sides summing in another order; bf16
2e-2, about two bf16 steps at magnitude 1 (the output is rounded to bf16
on both sides, at values that may straddle a rounding boundary).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.models import lm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-5)


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 7, 128), (8, 2048), (3, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(1)
    x = _rand(rng, shape, dtype, cuda)
    w = _rand(rng, shape[-1:], torch.float32, cuda)
    before = rmsnorm.launches
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, rmsnorm_plain(x, w), dtype)


FLASH_SHAPES = [
    # (B, Sq, Sk, H, KV, D, causal, window)
    (1, 16, 16, 2, 2, 16, True, None),      # MHA, reduced() head dim
    (2, 64, 64, 4, 2, 32, True, None),      # GQA 2:1, tiny's head dim
    (1, 33, 33, 8, 1, 64, False, None),     # MQA 8:1, ragged, not causal
    (2, 32, 128, 4, 4, 32, True, None),     # Sk > Sq: kv_offset = 96
    (1, 100, 100, 8, 2, 120, True, 16),     # danube's head dim, window
    (2, 130, 130, 16, 2, 128, True, None),  # qwen's heads, 3 q tiles
    (1, 70, 70, 8, 2, 128, True, 64),       # window across tiles
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    b, sq, sk, h, kv, d, causal, window = shape
    rng = np.random.default_rng(sq * 7 + d)
    q = _rand(rng, (b, sq, h, d), dtype, cuda)
    k = _rand(rng, (b, sk, kv, d), dtype, cuda)
    v = _rand(rng, (b, sk, kv, d), dtype, cuda)
    kw = dict(causal=causal, window=window, kv_offset=sk - sq)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, **kw), dtype)


DECODE_SHAPES = [
    # (B, H, KV, hd, C, cache_len, window)
    (1, 8, 8, 16, 32, 32, None),            # MHA, full cache
    (2, 8, 4, 32, 64, 17, None),            # GQA 2:1, short prefix
    (3, 8, 2, 64, 48, 5, None),             # GQA 4:1
    (2, 16, 2, 128, 544, 544, None),        # qwen's heads, serving capacity
    (2, 16, 2, 128, 544, 100, None),
    (2, 32, 8, 120, 200, 200, 64),          # danube's heads, window
    (4, 16, 2, 128, 70, [1, 33, 64, 70], None),   # per-sequence lengths
    (3, 8, 2, 120, 90, [90, 40, 7], 30),          # per-sequence + window
    (1, 6, 2, 20, 130, 100, None),          # GQA 3, head dim 20: scalar loads
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, shape, dtype):
    b, h, kv, hd, c, clen, window = shape
    rng = np.random.default_rng(c * 11 + hd)
    q = _rand(rng, (b, h, hd), dtype, cuda)
    k = _rand(rng, (b, c, kv, hd), dtype, cuda)
    v = _rand(rng, (b, c, kv, hd), dtype, cuda)
    lens = torch.tensor(clen, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _close(got, decode_attention_plain(q, k, v, lens, window=window), dtype)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(16, device=cuda))
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):              # not contiguous
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(TypeError):               # a host int would need a sync
        decode_attention(torch.zeros(1, 4, 16, device=cuda),
                         torch.zeros(1, 8, 2, 16, device=cuda),
                         torch.zeros(1, 8, 2, 16, device=cuda), 3)


@pytest.mark.parametrize("name", ["tiny", "h2o-danube-3-4b-smoke"])
def test_model_kernel_route_matches_ref_route_on_card(cuda, name):
    """Prefill and decode through the kernels == the oracle route, float32,
    including the ring roll and wraparound of the windowed config."""
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    params = lm.init_params(cfg, device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 80))).to(cuda)
    counts = [f.launches for f in (rmsnorm, flash_attention, decode_attention)]
    out = {}
    for impl in (None, "ref"):
        logits, cache = lm.prefill(cfg, params, {"tokens": toks}, capacity=86, impl=impl)
        steps = [logits]
        tok = toks[:, -1:]
        for _ in range(4):
            logits, cache = lm.decode_step(cfg, params, cache, tok, impl=impl)
            steps.append(logits)
        out[impl] = steps
    for a, b in zip(out[None], out["ref"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    after = [f.launches for f in (rmsnorm, flash_attention, decode_attention)]
    assert all(a > b for a, b in zip(after, counts))
