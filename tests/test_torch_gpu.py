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
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain, out_residual,
                                              qkv_rope)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
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


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 7, 128), (8, 1024), (8, 2048),
                                   (3, 100)])
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


SUBLAYERS = [
    # (D, H, KV, hd): tiny (GQA 2), danube (GQA 4, hd 120), qwen (GQA 8)
    (256, 8, 4, 32),
    (3840, 32, 8, 120),
    (2048, 16, 2, 128),
]


def _sublayer(rng, D, H, KV, hd, C, bias, dtype, device, B=3):
    def mat(*shape, scale=1.0):
        return _rand(rng, shape, dtype, device) * scale

    w = dict(norm=1.0 + 0.1 * _rand(rng, (D,), torch.float32, device),
             wq=mat(D, H * hd, scale=D ** -0.5), wk=mat(D, KV * hd, scale=D ** -0.5),
             wv=mat(D, KV * hd, scale=D ** -0.5), wo=mat(H * hd, D, scale=(H * hd) ** -0.5),
             bq=mat(H * hd, scale=0.1) if bias else None,
             bk=mat(KV * hd, scale=0.1) if bias else None,
             bv=mat(KV * hd, scale=0.1) if bias else None)
    return mat(B, 1, D), mat(B, C, KV, hd), mat(B, C, KV, hd), w


@pytest.mark.parametrize("shape", SUBLAYERS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("pos", [5, 40, 83])        # C 40: growing, boundary, wrapped
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_chain_matches_plain(cuda, shape, bias, pos, dtype):
    D, H, KV, hd = shape
    rng = np.random.default_rng(D + pos)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 40, bias, dtype, cuda)
    kw = dict(w, n_heads=H, head_dim=hd, eps=1e-5, theta=10_000.0, scale=hd ** -0.5)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    want, k_new, v_new = fused_decode_plain(x[:, 0], k, v, p, **kw)
    k0, v0 = k.clone(), v.clone()
    before = (qkv_rope.launches, decode_attention.launches, out_residual.launches)
    got = fused_decode(x, k, v, p, **kw)
    torch.cuda.synchronize()
    after = (qkv_rope.launches, decode_attention.launches, out_residual.launches)
    assert after == tuple(n + 1 for n in before)
    assert got.shape == x.shape and got.dtype == dtype
    _close(got[:, 0], want, dtype)
    slot = pos % 40
    _close(k[:, slot], k_new, dtype)
    _close(v[:, slot], v_new, dtype)
    others = [i for i in range(40) if i != slot]
    assert torch.equal(k[:, others], k0[:, others]) and torch.equal(v[:, others], v0[:, others])


SSD_SHAPES = [
    # (B, L, H, P, N)
    (2, 16, 3, 8, 16),        # reduced(): P8 N16
    (1, 50, 2, 8, 16),        # ragged
    (2, 300, 4, 64, 128),     # mamba2-370m's P64 N128, ragged
    (1, 128, 32, 64, 128),    # mamba2-370m's heads, two whole chunks
]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["short", "long"])
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype, memory):
    """bf16 tolerance 5e-2 (as the JAX test's); in float32 1e-4 of the
    largest value, for y and the state alike, since the scan sums terms as
    large as that in another order than the plain version (an output near
    zero may end up ~1e-4 of the largest away).  b and c are strided slices
    of one projection, as in the model.  Short memory (dt ~ 0.8, a ~ -1)
    forgets the state within a chunk; long memory (dt ~ 0.02, a ~ -0.14,
    as trained steps are) carries it across chunks."""
    B, L, H, P, N = shape
    rng = np.random.default_rng(L * 3 + P)
    shift, log_a = (0.0, 0.0) if memory == "short" else (4.0, -2.0)
    x = _rand(rng, (B, L, H, P), dtype, cuda)
    dt = torch.nn.functional.softplus(_rand(rng, (B, L, H), torch.float32, cuda) - shift)
    a = -torch.exp(log_a + 0.5 * _rand(rng, (H,), torch.float32, cuda))
    bc = _rand(rng, (B, L, 2 * N + H), dtype, cuda)
    b, c = bc[..., :N], bc[..., N:2 * N]
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_s = ssd_scan_plain(x, dt, a, b, c)
    assert y.dtype == dtype and s.dtype == torch.float32
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    else:
        torch.testing.assert_close(y, want_y, atol=1e-4 * float(want_y.abs().max()), rtol=1e-4)
    torch.testing.assert_close(s, want_s, atol=1e-4 * float(want_s.abs().max()), rtol=1e-4)


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


@pytest.mark.parametrize("case", ["float16", "hd256", "rep16", "host_pos", "one_bias"])
def test_fused_decode_refuses_what_it_does_not_take(cuda, case):
    D, H, KV, hd, dtype = 64, 8, 2, 16, torch.float32
    if case == "float16":
        dtype = torch.float16
    if case == "hd256":
        hd = 256
    if case == "rep16":
        H, KV = 16, 1
    x, k, v, w = _sublayer(np.random.default_rng(0), D, H, KV, hd, 8, True, dtype, cuda)
    if case == "one_bias":
        w["bk"] = None
    pos = torch.tensor(3, dtype=torch.int32, device="cpu" if case == "host_pos" else cuda)
    before = (qkv_rope.launches, out_residual.launches)
    with pytest.raises(ValueError):
        fused_decode(x, k, v, pos, **w, n_heads=H, head_dim=hd)
    assert (qkv_rope.launches, out_residual.launches) == before


@pytest.mark.parametrize("case", ["P128", "N256", "mixed_dtype", "strided_x", "host_a"])
def test_ssd_scan_refuses_what_it_does_not_take(cuda, case):
    B, L, H, P, N = 1, 8, 2, 8, 16
    if case == "P128":
        P = 128
    if case == "N256":
        N = 256
    rng = np.random.default_rng(0)
    x = _rand(rng, (B, L, H, P), torch.float32, cuda)
    dt = torch.ones(B, L, H, device=cuda)
    a = -torch.ones(H, device="cpu" if case == "host_a" else cuda)
    b = _rand(rng, (B, L, N), torch.bfloat16 if case == "mixed_dtype" else torch.float32, cuda)
    if case == "strided_x":
        x = _rand(rng, (B, L, H, 2 * P), torch.float32, cuda)[..., ::2]
    before = ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, b)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("name", ["tiny", "h2o-danube-3-4b-smoke", "mamba2-370m-smoke"])
def test_model_kernel_route_matches_ref_route_on_card(cuda, name):
    """Prefill and decode through the kernels == the oracle route, float32,
    including the ring roll and wraparound of the windowed config, and the
    SSD scan of the Mamba2 config."""
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    params = lm.init_params(cfg, device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 80))).to(cuda)
    kernels = ((rmsnorm, ssd_scan) if cfg.attn is None else
               (rmsnorm, flash_attention, decode_attention, qkv_rope, out_residual))
    counts = [f.launches for f in kernels]
    composed = fd._composed_step.calls
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
    after = [f.launches for f in kernels]
    assert all(a > b for a, b in zip(after, counts))
    assert fd._composed_step.calls == composed          # the chain, never the composed step
