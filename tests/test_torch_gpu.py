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
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_backward,
                                                 flash_attention_forward, flash_attention_plain)
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain, out_residual,
                                              out_residual_plain, qkv_plain, qkv_rope)
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward, rmsnorm_gated,
                                         rmsnorm_gated_backward, rmsnorm_gated_plain,
                                         rmsnorm_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward, ssd_scan_plain
from repro_torch.models import blocks, lm

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


# the serving widths (mamba2-370m 1024, qwen 2048, danube 3840) at decode
# and prefill rows, rows off the persistent grid (5000), a width of a ragged
# number of pieces (1000), widths off 16 bytes (100, 1001: the wide kernel)
# and one wider than the row kernel holds (20000: the cluster kernel)
@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 7, 128), (8, 1024), (8, 2048),
                                   (3, 100), (4096, 1024), (4096, 2048), (5000, 2048), (8, 3840),
                                   (4096, 3840), (8, 1000), (3, 1001), (2, 20000)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_rows_off_16_bytes(cuda, dtype):
    rng = np.random.default_rng(3)
    x = _rand(rng, (8 * 2048 + 1,), dtype, cuda)[1:].view(8, 2048)
    assert x.data_ptr() % 16
    w = _rand(rng, (2048,), torch.float32, cuda)
    _close(rmsnorm(x, w), rmsnorm_plain(x, w), dtype)


def _forced(warps):
    """`norm_plan` with ``warps`` warps a row, for the row kernel."""
    def forced(rows, d, elem_bytes, *, gated, aligned, card):
        pieces = d * elem_bytes // 16
        units = 1 << (-(-pieces // (32 * warps)) - 1).bit_length()
        groups = rn.THREADS // 32 // warps
        return rn.NormPlan(warps, units, groups, min(-(-rows // groups), 2 * card.sms))
    return forced


# qwen's width in each split the row kernel takes: 1-4 pieces a lane
@pytest.mark.parametrize("dtype,warps", [(torch.bfloat16, 2), (torch.bfloat16, 4),
                                         (torch.bfloat16, 8), (torch.float32, 4),
                                         (torch.float32, 8)])
@pytest.mark.parametrize("rows", [8, 1000])
def test_rmsnorm_kernel_with_a_row_split_across_warps(cuda, monkeypatch, warps, rows, dtype):
    """qwen's width split over 2-8 warps a row, which add their sums in
    shared memory; 1000 rows walk the grid several times, so the two sum
    slots alternate."""
    monkeypatch.setattr(rn, "norm_plan", _forced(warps))
    rng = np.random.default_rng(4)
    x = _rand(rng, (rows, 2048), dtype, cuda)
    w = _rand(rng, (2048,), torch.float32, cuda)
    _close(rmsnorm(x, w), rmsnorm_plain(x, w), dtype)


def _gated_inputs(rng, lead, heads, width, dtype, device):
    """y, xh (*lead, H, P), d_skip (H,), z: the second half of a (*lead,
    2 H P) projection as ``torch.chunk`` gives it, and the norm weight."""
    di = heads * width
    y = _rand(rng, (*lead, heads, width), dtype, device)
    xh = _rand(rng, (*lead, heads, width), dtype, device)
    d_skip = 1.0 + 0.1 * _rand(rng, (heads,), torch.float32, device)
    z = torch.chunk(_rand(rng, (*lead, 2 * di), dtype, device), 2, dim=-1)[1]
    return y, xh, d_skip, z, 1.0 + 0.1 * _rand(rng, (di,), torch.float32, device)


# mamba2-370m's decode and prefill (H32 P64, z's rows 4096 apart), the
# reduced config's widths (H16 P8), a width beyond the row kernel (5120:
# mamba2-2.7b's, the cluster kernel) and one off 16 bytes (15: the wide
# kernel)
@pytest.mark.parametrize("lead,heads,width", [((8,), 32, 64), ((8, 512), 32, 64), ((2, 3), 16, 8),
                                              ((3,), 80, 64), ((2, 2), 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_kernel_matches_plain(cuda, lead, heads, width, dtype):
    args = _gated_inputs(np.random.default_rng(5), lead, heads, width, dtype, cuda)
    before = rmsnorm_gated.launches
    got = rmsnorm_gated(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_gated.launches == before + 1
    assert got.dtype == dtype and got.shape == args[3].shape and got.is_contiguous()
    _close(got, rmsnorm_gated_plain(*args, eps=1e-5), dtype)


@pytest.mark.parametrize("case", ["uneven_z", "mixed_dtype", "d_skip_shape", "float16"])
def test_rmsnorm_gated_refuses_what_it_does_not_take(cuda, case):
    dtype = torch.float16 if case == "float16" else torch.float32
    y, xh, d_skip, z, w = _gated_inputs(np.random.default_rng(0), (2, 3), 4, 8, dtype, cuda)
    if case == "uneven_z":
        z = torch.zeros(2, 4, 32, device=cuda)[:, :3]
    if case == "mixed_dtype":
        xh = xh.to(torch.bfloat16)
    if case == "d_skip_shape":
        d_skip = d_skip[:2]
    before = rmsnorm_gated.launches
    with pytest.raises(ValueError):
        rmsnorm_gated(y, xh, d_skip, z, w)
    assert rmsnorm_gated.launches == before


FLASH_SHAPES = [
    # (B, Sq, Sk, H, KV, D, causal, window)
    (1, 16, 16, 2, 2, 16, True, None),      # MHA, reduced() head dim
    (2, 64, 64, 4, 2, 32, True, None),      # GQA 2:1, tiny's head dim
    (1, 33, 33, 8, 1, 64, False, None),     # MQA 8:1, ragged, not causal
    (2, 32, 128, 4, 4, 32, True, None),     # Sk > Sq: kv_offset = 96
    (1, 100, 100, 8, 2, 120, True, 16),     # danube's head dim, window
    (2, 130, 130, 16, 2, 128, True, None),  # qwen's heads, 3 q tiles
    (1, 70, 70, 8, 2, 128, True, 64),       # window across tiles
    (1, 1, 1, 4, 2, 64, True, None),        # one row, one key
    (1, 15, 15, 4, 2, 32, True, None),      # Sq, Sk off 16
    (2, 17, 17, 8, 2, 128, True, None),     # just past 16
    (1, 129, 129, 16, 2, 128, True, None),  # just past two 64-row tiles
    (2, 70, 200, 8, 2, 64, True, None),     # causal, kv_offset 130, Sq off the tile
    (1, 90, 90, 10, 2, 128, True, None),    # GQA 5
    (2, 77, 77, 14, 2, 64, True, None),     # GQA 7
    (1, 150, 150, 4, 2, 64, True, 40),      # D 64, window across a tile boundary
    # seamless-m4t-medium's heads (H16 KV16 D64), not causal: the encoder's
    # self-attention (Sq = Sk) and cross-attention (Sq != Sk, no kv_offset)
    (1, 1024, 1024, 16, 16, 64, False, None),
    (2, 128, 1024, 16, 16, 64, False, None),    # Sq < Sk
    (1, 300, 100, 16, 16, 64, False, None),     # Sq > Sk
    (2, 64, 1000, 16, 16, 64, False, None),     # a ragged Sk
    (1, 77, 33, 16, 16, 64, False, None),       # both ragged, Sq > Sk
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
    # the split edges: at these shapes the plan takes splits of L = 32 slots
    # (B * KV * ceil(C / 64) blocks stay under any H100's SM count), so C 100
    # is 3 whole splits and a short one
    (2, 8, 2, 128, 100, 1, None),           # one live slot
    (2, 8, 2, 128, 100, 31, None),          # L - 1
    (2, 8, 2, 128, 100, 32, None),          # L
    (2, 8, 2, 128, 100, 33, None),          # L + 1
    (2, 8, 2, 128, 100, 70, 30),            # window [40, 70): splits 1 and 2
    (4, 16, 2, 128, 200, [1, 200, 64, 97], None),   # whole splits empty
    (2, 10, 2, 128, 90, 90, None),          # GQA 5
    (2, 12, 2, 64, 90, 57, None),           # GQA 6
    (1, 14, 2, 120, 130, 130, 50),          # GQA 7, danube's head dim, window
    # seamless-m4t-medium's cross-attention decode: GQA 1, hd 64, over the
    # 1024 encoder frames, and a ragged number of them
    (8, 16, 16, 64, 1024, 1024, None),
    (8, 16, 16, 64, 1000, 1000, None),
    (2, 16, 16, 64, 1024, [1024, 1000], None),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_back_to_back_calls_reset_the_merge_counters(cuda, dtype):
    """Calls in a row with other lengths and windows on one workspace, each
    result checked after the last: every call finds its merge counters at
    0, and leaves them there."""
    b, h, kv, hd, c = 3, 8, 2, 128, 150
    rng = np.random.default_rng(5)
    q = _rand(rng, (b, h, hd), dtype, cuda)
    k = _rand(rng, (b, c, kv, hd), dtype, cuda)
    v = _rand(rng, (b, c, kv, hd), dtype, cuda)
    cases = [(150, None), (1, None), (33, None), ([5, 150, 64], None), (100, 40),
             ([150, 1, 97], 20), (150, None)]
    lens = [torch.tensor(n, dtype=torch.int32, device=cuda) for n, _ in cases]
    before = decode_attention.launches
    outs = [decode_attention(q, k, v, n, window=w) for n, (_, w) in zip(lens, cases)]
    torch.cuda.synchronize()
    assert decode_attention.launches == before + len(cases)
    for n, (_, w), got in zip(lens, cases, outs):
        _close(got, decode_attention_plain(q, k, v, n, window=w), dtype)
    plan = da.split_plan(b, kv, c, torch.cuda.get_device_properties(cuda).multi_processor_count)
    ws = da._workspace(q.device, torch.cuda.current_stream(cuda).cuda_stream,
                       da.workspace_shapes(b, kv, h // kv, hd, plan))
    assert plan.splits > 1 and int(ws["tickets"].abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_two_streams_at_once(cuda, dtype):
    """Two streams launching decode attention at one shape, back to back
    and at once (the pipeline's stages and replicas do so): each stream
    has its own partial sums and merge counters, so every result holds to
    the plain version, and both workspaces end with their counters at 0."""
    b, h, kv, hd, c = 8, 16, 2, 128, 544            # qwen2.5-3b's decode
    rng = np.random.default_rng(9)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    calls = [[(_rand(rng, (b, h, hd), dtype, cuda), _rand(rng, (b, c, kv, hd), dtype, cuda),
               _rand(rng, (b, c, kv, hd), dtype, cuda),
               torch.tensor(n, dtype=torch.int32, device=cuda))
              for n in (544, 1, 300, [5, 544, 64, 97, 200, 1, 433, 12])]
             for _ in streams]
    torch.cuda.synchronize()
    outs = [[], []]
    for i in range(len(calls[0])):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[s].append(decode_attention(*calls[s][i]))
    torch.cuda.synchronize()
    for s in range(2):
        for args, got in zip(calls[s], outs[s]):
            _close(got, decode_attention_plain(*args), dtype)
    plan = da.split_plan(b, kv, c, torch.cuda.get_device_properties(cuda).multi_processor_count)
    shapes = da.workspace_shapes(b, kv, h // kv, hd, plan)
    dev = calls[0][0][0].device
    ws = [da._workspace(dev, stream.cuda_stream, shapes) for stream in streams]
    assert ws[0]["tickets"].data_ptr() != ws[1]["tickets"].data_ptr()
    assert all(int(w["tickets"].abs().sum()) == 0 for w in ws)


SUBLAYERS = [
    # (D, H, KV, hd): tiny (GQA 2), danube (GQA 4, hd 120), qwen (GQA 8),
    # seamless-m4t-medium's decoder (GQA 1, hd 64)
    (256, 8, 4, 32),
    (3840, 32, 8, 120),
    (2048, 16, 2, 128),
    (1024, 16, 16, 64),
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
@pytest.mark.parametrize("batch", [3, 1, 8, 11])    # 11: two batch groups of the GEMVs
def test_fused_decode_chain_matches_plain(cuda, shape, bias, pos, dtype, batch):
    D, H, KV, hd = shape
    rng = np.random.default_rng(D + pos)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 40, bias, dtype, cuda, B=batch)
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


# (D, H, KV, hd, bias): SUBLAYERS' shapes, the reduced configs' hd 16, an
# odd hd (the unrotated tail column, plain loads into the ring)
QKV_SHAPES = [(256, 8, 4, 32, True), (3840, 32, 8, 120, False), (2048, 16, 2, 128, True),
              (2048, 16, 2, 128, False), (64, 4, 2, 16, True), (96, 4, 2, 15, True),
              (1024, 16, 16, 64, False)]


@pytest.mark.parametrize("shape", QKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8, 11])
def test_qkv_rope_kernel_matches_plain_rows(cuda, shape, dtype, batch):
    """q, the k and v rows in slot pos % C and cache_len against
    `qkv_plain`; every other slot untouched."""
    D, H, KV, hd, bias = shape
    rng = np.random.default_rng(D + hd + batch)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 24, bias, dtype, cuda, B=batch)
    pos = torch.tensor(30, dtype=torch.int32, device=cuda)
    kw = {n: w[n] for n in ("norm", "wq", "wk", "wv", "bq", "bk", "bv")}
    k0, v0 = k.clone(), v.clone()
    before = qkv_rope.launches
    q, clen = qkv_rope(x[:, 0], k, v, pos, **kw, n_heads=H, eps=1e-5, theta=1e4)
    torch.cuda.synchronize()
    assert qkv_rope.launches == before + 1 and int(clen) == 24
    wq, wk, wv = qkv_plain(x[:, 0], pos, **kw, n_heads=H, head_dim=hd, eps=1e-5, theta=1e4)
    _close(q, wq, dtype)
    _close(k[:, 30 % 24], wk, dtype)
    _close(v[:, 30 % 24], wv, dtype)
    rest = [i for i in range(24) if i != 30 % 24]
    assert torch.equal(k[:, rest], k0[:, rest]) and torch.equal(v[:, rest], v0[:, rest])


@pytest.mark.parametrize("shape", [(8, 2048, 2048), (1, 2048, 2048), (11, 4096, 2048),
                                   (8, 3840, 3840), (3, 256, 256), (2, 64, 64), (4, 60, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_residual_kernel_matches_plain(cuda, shape, dtype):
    """x + o @ wo for o (B, K), wo (K, D): qwen's and danube's shapes, more
    than one batch group, and widths off 16 columns (plain loads)."""
    B, K, D = shape
    rng = np.random.default_rng(B + K + D)
    o, wo, x = (_rand(rng, (B, K), dtype, cuda), _rand(rng, (K, D), dtype, cuda) * K ** -0.5,
                _rand(rng, (B, D), dtype, cuda))
    before = out_residual.launches
    got = out_residual(o, wo, x)
    torch.cuda.synchronize()
    assert out_residual.launches == before + 1
    _close(got, out_residual_plain(o, wo, x), dtype)
    _close(got, x.float() + o.float() @ wo.float(), dtype)


# nemotron-4-15b's and deepseek-coder-33b's serving shapes: the chain's two
# GEMVs at widths 6144 and 7168 (64 and 72 qkv tiles, 48 and 56 out tiles)
# at B 8 and B 16 (two batch groups, where deepseek-coder-33b's qkv_rope
# takes two splits so that its block fits shared memory), decode attention
# and flash prefill at H48/KV8 and H56/KV8, hd 128
LARGE = ("nemotron-4-15b", "deepseek-coder-33b")


def _large_shape(name):
    """(d_model, heads, KV heads, head dim) of a registered config."""
    cfg = get_config(name)
    return cfg.d_model, cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim


@pytest.mark.parametrize("name", LARGE)
@pytest.mark.parametrize("batch", [8, 16])
def test_chain_gemvs_at_the_large_dense_shapes(cuda, name, batch):
    D, H, KV, hd = _large_shape(name)
    dtype = torch.bfloat16
    rng = np.random.default_rng(D + batch)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 48, False, dtype, cuda, B=batch)
    pos = torch.tensor(47, dtype=torch.int32, device=cuda)
    kw = {n: w[n] for n in ("norm", "wq", "wk", "wv", "bq", "bk", "bv")}
    before = (qkv_rope.launches, out_residual.launches)
    q, clen = qkv_rope(x[:, 0], k, v, pos, **kw, n_heads=H, eps=1e-5, theta=1e4)
    o = _rand(rng, (batch, H * hd), dtype, cuda)
    got = out_residual(o, w["wo"], x[:, 0])
    torch.cuda.synchronize()
    assert (qkv_rope.launches, out_residual.launches) == (before[0] + 1, before[1] + 1)
    assert int(clen) == 48
    wq, wk, wv = qkv_plain(x[:, 0], pos, **kw, n_heads=H, head_dim=hd, eps=1e-5, theta=1e4)
    _close(q, wq, dtype)
    _close(k[:, 47], wk, dtype)
    _close(v[:, 47], wv, dtype)
    _close(got, out_residual_plain(o, w["wo"], x[:, 0]), dtype)


@pytest.mark.parametrize("name", LARGE)
def test_attention_kernels_at_the_large_dense_heads(cuda, name):
    _, H, KV, hd = _large_shape(name)
    dtype = torch.bfloat16
    rng = np.random.default_rng(H)
    q, k, v = (_rand(rng, (2, 300, n, hd), dtype, cuda) for n in (H, KV, KV))
    _close(flash_attention(q, k, v), flash_attention_plain(q, k, v), dtype)
    q = _rand(rng, (8, H, hd), dtype, cuda)
    kc, vc = (_rand(rng, (8, 544, KV, hd), dtype, cuda) for _ in range(2))
    for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
        clen = torch.tensor(lens, dtype=torch.int32, device=cuda)
        _close(decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen), dtype)


SSD_SHAPES = [
    # (B, L, H, P, N)
    (2, 16, 3, 8, 16),        # reduced(): P8 N16
    (1, 50, 2, 8, 16),        # ragged
    (2, 300, 4, 64, 128),     # mamba2-370m's P64 N128, ragged
    (1, 128, 32, 64, 128),    # mamba2-370m's heads, two whole chunks
    # the edges of the kernel's chunk of 64 tokens, in both load paths (b and
    # c rows 2N + H elements apart: tensor copies where that is a multiple
    # of 8 elements, 16 bytes; element loads where it is not)
    (2, 1, 8, 64, 128),       # L 1: one token, 63 rows of zero fill
    (1, 63, 4, 64, 128),      # one short of a chunk; element loads
    (2, 65, 32, 64, 128),     # one past: a second chunk of one token
    (8, 512, 32, 64, 128),    # mamba2-370m's serving prefill
    (2, 130, 8, 24, 48),      # P and N off the 16-wide mma tiles
    (2, 70, 3, 20, 40),       # P off 8 elements: x and y element by element too
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


def test_decode_attention_op_refuses_a_host_length(cuda):
    """`ops.decode_attention` (cross-attention decode) with card tensors and
    the length as an int or a CPU tensor raises and launches nothing: no
    plain-version fallback."""
    from repro_torch.kernels import ops
    q, kc = torch.zeros(2, 16, 64, device=cuda), torch.zeros(2, 100, 16, 64, device=cuda)
    before = decode_attention.launches
    with pytest.raises(TypeError):
        ops.decode_attention(q, kc, kc, 100)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, kc, kc, torch.tensor(100, dtype=torch.int32))
    assert decode_attention.launches == before
    ops.decode_attention(q, kc, kc, torch.tensor(100, dtype=torch.int32, device=cuda))
    assert decode_attention.launches == before + 1


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
    kernels = ((rmsnorm, rmsnorm_gated, ssd_scan) if cfg.attn is None else
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


def _prefix_batch(cfg, device, b=2, s=80, seed=2):
    """Tokens and labels, and the frames (an encoder-decoder, 100 of them)
    or the prefix embeddings (the prefix frontend), from a seed."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(device)
             for k in ("tokens", "labels")}
    if cfg.encdec:
        batch["frames"] = _rand(rng, (b, 100, cfg.d_model), torch.float32, device)
    else:
        batch["prefix_embeds"] = _rand(rng, (b, cfg.num_prefix, cfg.d_model), torch.float32,
                                       device)
    return batch


@pytest.mark.parametrize("name", ["seamless-m4t-medium-smoke", "internvl2-26b-smoke"])
def test_prefix_families_kernel_route_matches_ref_route_on_card(cuda, name):
    """float32: prefill (the encoder not causal, the cross-attention at Sq
    != Sk; or the prefix ahead of the tokens) and 4 decode steps (the chain
    and, for the encoder-decoder, decode attention over the cross cache)
    through the kernels == the oracle route; the cross caches untouched by
    decode; then the loss and every gradient through the backward kernels
    within 1e-4 of the leaf's largest entry."""
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    params = lm.init_params(cfg, device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(0))
    batch = _prefix_batch(cfg, cuda)
    kernels = (rmsnorm, flash_attention, decode_attention, qkv_rope, out_residual)
    counts = [f.launches for f in kernels]
    out = {}
    for impl in (None, "ref"):
        logits, cache = lm.prefill(cfg, params, batch, capacity=cfg.num_prefix + 86, impl=impl)
        cross = [(c["cross_k"].clone(), c["cross_v"].clone()) for c in cache["layers"]
                 if "cross_k" in c]
        steps = [logits]
        tok = batch["tokens"][:, -1:]
        for _ in range(4):
            logits, cache = lm.decode_step(cfg, params, cache, tok, impl=impl)
            steps.append(logits)
        assert all(torch.equal(k, c["cross_k"]) and torch.equal(v, c["cross_v"])
                   for (k, v), c in zip(cross, cache["layers"]))
        out[impl] = steps
    for a, b in zip(out[None], out["ref"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert all(a > b for a, b in zip((f.launches for f in kernels), counts))
    grads = {}
    for impl in (None, "ref"):
        model = lm.init_params(cfg, device=cuda, param_dtype=torch.float32,
                               generator=torch.Generator(device=cuda).manual_seed(0))
        before = flash_attention_backward.launches
        loss, _ = lm.loss_fn(cfg, model, batch, impl=impl)
        loss.backward()
        assert (flash_attention_backward.launches > before) == (impl is None)
        grads[impl] = float(loss), {k: p.grad for k, p in model.named_parameters()}
    assert grads[None][0] == pytest.approx(grads["ref"][0], rel=1e-5)
    for k, g in grads[None][1].items():
        want = grads["ref"][1][k]
        torch.testing.assert_close(g, want, atol=1e-4 * float(want.abs().max()) + 1e-12,
                                   rtol=0, msg=k)


# the llama4 MoE decoders (phase 15 of chip_smoke.py): their attention, H40
# KV8 hd128 (GQA 5) at d_model 5120 (maverick's is scout's), the MoE
# sublayer with drops and its decode step
MOE_ARCH = "llama4-scout-17b-a16e"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [8, 16])
def test_chain_at_the_moe_width(cuda, dtype, batch):
    D, H, KV, hd = _large_shape(MOE_ARCH)
    rng = np.random.default_rng(D + batch)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 48, False, dtype, cuda, B=batch)
    kw = dict(w, n_heads=H, head_dim=hd, eps=1e-5, theta=5e5, scale=hd ** -0.5)
    p = torch.tensor(47, dtype=torch.int32, device=cuda)
    want, k_new, v_new = fused_decode_plain(x[:, 0], k, v, p, **kw)
    before = (qkv_rope.launches, out_residual.launches)
    got = fused_decode(x, k, v, p, **kw)
    torch.cuda.synchronize()
    assert (qkv_rope.launches, out_residual.launches) == (before[0] + 1, before[1] + 1)
    _close(got[:, 0], want, dtype)
    _close(k[:, 47], k_new, dtype)
    _close(v[:, 47], v_new, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_moe_heads(cuda, dtype):
    """Flash causal over the prefill bucket (B8 S512) and a ragged length,
    decode attention over C544 at ragged lengths."""
    _, H, KV, hd = _large_shape(MOE_ARCH)
    rng = np.random.default_rng(H + KV)
    for b, s in ((8, 512), (2, 300)):
        q, k, v = (_rand(rng, (b, s, n, hd), dtype, cuda) for n in (H, KV, KV))
        _close(flash_attention(q, k, v), flash_attention_plain(q, k, v), dtype)
    q = _rand(rng, (8, H, hd), dtype, cuda)
    kc, vc = (_rand(rng, (8, 544, KV, hd), dtype, cuda) for _ in range(2))
    for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
        clen = torch.tensor(lens, dtype=torch.int32, device=cuda)
        _close(decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen), dtype)


def _moe_layer(device, top_k=2, capacity_factor=1.25, compute_dtype="float32"):
    """scout-smoke's MoE sublayer (4 experts), random from a seed, its router
    at fan-in scale so that routing is decisive."""
    cfg = get_config(MOE_ARCH + "-smoke")
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype, moe=dataclasses.replace(
        cfg.moe, top_k=top_k, capacity_factor=capacity_factor))
    layer = blocks.MoE(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        layer.router.mul_(cfg.d_model ** -0.5 / 0.02)
    return cfg, layer


@pytest.mark.parametrize("capacity_factor", [1.25, 0.26])
def test_moe_kernel_route_matches_ref_route_with_drops(cuda, capacity_factor):
    """float32, top-2, rows led by pad positions: the kernel route (the norm
    kernel) equals the oracle route within 1e-5, with the same expert
    choices and kept masks, tokens dropped."""
    cfg, layer = _moe_layer(cuda, capacity_factor=capacity_factor)
    rng = np.random.default_rng(4)
    x = _rand(rng, (3, 64, cfg.d_model), torch.float32, cuda)
    x[1, :20] = x[0, 0]
    x[2, :40] = x[0, 0]
    before = rmsnorm.launches
    with torch.no_grad():
        got, want = layer(x), layer(x, impl="ref")
        rk, rr = layer.routing(x), layer.routing(x, impl="ref")
    torch.cuda.synchronize()
    assert rmsnorm.launches > before
    assert torch.equal(rk["experts"], rr["experts"]) and torch.equal(rk["kept"], rr["kept"])
    assert not bool(rk["kept"].all())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_moe_decode_makes_no_host_sync(cuda):
    """`MoE.decode` in bf16 under ``set_sync_debug_mode("error")``: routing,
    dispatch, the experts and combine stay on the device."""
    cfg, layer = _moe_layer(cuda, top_k=1, compute_dtype="bfloat16")
    x = _rand(np.random.default_rng(5), (8, 1, cfg.d_model), torch.bfloat16, cuda)
    with torch.no_grad():
        want = layer.decode(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = layer.decode(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e-smoke", "llama4-maverick-400b-a17b-smoke"])
def test_moe_models_kernel_route_matches_ref_route_on_card(cuda, name):
    """float32: a prefill of prompts led by pad token 0 and 4 decode steps
    through the kernels == the oracle route (1e-4); the loss and every
    gradient (router and experts included) within 1e-4 of each leaf's
    largest entry."""
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    params = lm.init_params(cfg, device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 48))).to(cuda)
    toks[1, :20] = 0
    kernels = (rmsnorm, flash_attention, decode_attention, qkv_rope, out_residual)
    counts = [f.launches for f in kernels]
    out = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            logits, cache = lm.prefill(cfg, params, {"tokens": toks}, capacity=52, impl=impl)
            steps = [logits]
            for _ in range(4):
                logits, cache = lm.decode_step(cfg, params, cache, toks[:, -1:], impl=impl)
                steps.append(logits)
            out[impl] = steps
    for a, b in zip(out[None], out["ref"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert all(a > b for a, b in zip((f.launches for f in kernels), counts))
    batch = {"tokens": toks, "labels": toks}
    grads = {}
    for impl in (None, "ref"):
        model = lm.init_params(cfg, device=cuda, param_dtype=torch.float32,
                               generator=torch.Generator(device=cuda).manual_seed(0))
        loss, _ = lm.loss_fn(cfg, model, batch, impl=impl)
        loss.backward()
        grads[impl] = float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}
    assert grads[None][0] == pytest.approx(grads["ref"][0], rel=1e-5)
    for k, g in grads[None][1].items():
        want = grads["ref"][1][k]
        torch.testing.assert_close(g, want, atol=1e-4 * float(want.abs().max()) + 1e-12,
                                   rtol=0, msg=k)


def test_mamba_layer_bf16_kernel_route_matches_ref_route_at_full_width(cuda):
    """One mamba2-370m block at full width in bf16: a prefill of 8 x 512
    tokens, then 4 decode steps, the kernel route (rmsnorm, the SSD scan,
    the gated norm) against ``impl="ref"``, each route on its own caches.
    The block's output is held to 0.02 + 0.02 |ref|, two bf16 steps at its
    magnitude, as every bf16 kernel check: both routes round it once to
    bf16, and what differs inside (the order of the scan's and the norms'
    sums, which moves single bf16 roundings of y and of the normalised gate)
    reaches it through the output projection, a sum over 2048 inputs at
    weights of 2048^-1/2.  The SSD state carried into the decode steps is
    checked through their outputs."""
    from repro_torch.models.blocks import Mamba

    cfg = get_config("mamba2-370m")
    layer = Mamba(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(6)
    x = _rand(rng, (8, 512, cfg.d_model), torch.bfloat16, cuda)
    steps = [_rand(rng, (8, 1, cfg.d_model), torch.bfloat16, cuda) for _ in range(4)]
    counts = (rmsnorm.launches, rmsnorm_gated.launches, ssd_scan.launches)
    out = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            y, (conv, ssm) = layer(x, impl=impl)
            cache = {"conv": conv.clone(), "ssm": ssm.clone()}
            out[impl] = [y] + [layer.decode(t, cache, impl=impl)[0] for t in steps]
    assert (rmsnorm.launches, rmsnorm_gated.launches, ssd_scan.launches) == (
        counts[0] + 5, counts[1] + 5, counts[2] + 1)
    for a, b in zip(out[None], out["ref"]):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", ["tiny", "h2o-danube-3-4b-smoke", "mamba2-370m-smoke"])
def test_pipeline_matches_single_device_server_on_card(cuda, name, overlap):
    """`DecodePipeline` on the card, each (stage, replica) on its own
    stream, against the single-device `LMServer` on the same weights in
    bf16: the same kernels on the same rows, so the tokens are equal;
    no first launch inside the serve; overlapped, the ops run on several
    streams.  The window config's prompts and tokens run past its window."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config(name)
    shape = ShapeCfg("decode_test", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=2 * cfg.n_layers + 4, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    params = lm.init_params(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, rng.integers(40, 100)).tolist(),
                    max_new=int(rng.integers(20, 30))) for i in range(8)]
    want = LMServer(cfg, max_batch=4, params=params, device=cuda).serve(reqs)
    pipe = DecodePipeline(cfg, stg, plan, params=params, device=cuda, overlap=overlap,
                          fusion_plan="auto")
    pipe.check_pos = True
    srv = LMServer(cfg, max_batch=4, pipeline=pipe, device=cuda)
    got = srv.serve(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert pipe.compile_stats.late == 0
    assert (srv.last_run.streams_used > 1) if overlap else (srv.last_run.streams_used == 1)


def test_pipeline_close_frees_its_lanes_cublas_workspaces(cuda):
    """A pipelined serve on its worker threads and streams makes a cuBLAS
    workspace for each (thread, stream) pair that runs a product; after
    `DecodePipeline.close()`, with the pipeline and its server dropped, the
    memory allocated is back within 64 MB of where it was before the
    pipeline was built."""
    import gc

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config("qwen2.5-3b-smoke")
    shape = ShapeCfg("decode_test", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=2 * cfg.n_layers + 4, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    params = lm.init_params(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, rng.integers(40, 100)).tolist(),
                    max_new=16) for i in range(8)]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pipe = DecodePipeline(cfg, stg, plan, params=params, device=cuda)
    srv = LMServer(cfg, max_batch=4, pipeline=pipe, device=cuda)
    srv.serve(reqs)
    assert srv.last_run.streams_used > 1
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    pipe.close()
    del srv, pipe
    gc.collect()
    left = torch.cuda.memory_allocated() - before
    assert left < 64 << 20, f"{left} bytes left after close (the serve grew it by {grown})"


def _chaos(name, device):
    """A reduced config on the card with two replicas forced on the first
    period's blocks (``blocks00`` has a survivor), its requests, and the
    single-device server's completions on the same weights."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import as_selection
    from repro_torch.runtime.server import LMServer, Request

    cfg = get_config(name)
    shape = ShapeCfg("decode_test", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=2 * cfg.n_layers + 4, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    sel = as_selection(plan)
    for n in stg.topo_order():
        if n.startswith("block") and int(n[5:]) < len(cfg.block_pattern):
            sel.set(n, sel.choices[n][0], 2)
    params = lm.init_params(cfg, device=device,
                            generator=torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, rng.integers(20, 60)).tolist(),
                    max_new=16) for i in range(8)]
    want = [c.tokens for c in LMServer(cfg, max_batch=4, params=params,
                                       device=device).serve(reqs)]
    return cfg, shape, stg, plan, sel, params, reqs, want


DRILLS = ["crash_at_token", "crash_at_op", "migration", "resume_same", "resume_transfer",
          "resume_replay"]


@pytest.mark.parametrize("drill", DRILLS)
@pytest.mark.parametrize("name", ["qwen2.5-3b-smoke", "mamba2-370m-smoke"])
def test_failover_drills_on_card(cuda, name, drill):
    """The pipeline overlapped on its streams, against the single-device
    server on the same weights: a replica crash (the moved group's cache
    replayed on the survivor's lane and stream), a health-driven
    migration (the cache handed to the new owner's stream), and an
    admission pause resumed on the same pipeline, on a new one with the
    same stage spans (caches handed to its streams) and on one with other
    spans (caches replayed).  Each gives the same tokens, with no first
    launch inside the serves."""
    from repro_torch.runtime.failures import ReplicaFaultPlan
    from repro_torch.runtime.pipeline import DecodePipeline, HealthController, Tracer

    cfg, shape, stg, plan, sel, params, reqs, want = _chaos(name, cuda)
    pipe = DecodePipeline(cfg, stg, sel, params=params, device=cuda)
    prompts, max_new = [r.prompt for r in reqs], [r.max_new for r in reqs]
    pipes = [pipe]
    if drill.startswith("crash"):
        spec = "blocks00:r1@tok6=crash" if drill == "crash_at_token" else "blocks00:r0@op3=crash"
        inj = ReplicaFaultPlan.parse(spec)
        res = pipe.serve(prompts, max_new, group_size=4, injector=inj)
        assert inj.fired == 1 and len(res.failovers) == 1
    elif drill == "migration":
        tr = Tracer()
        # a tick at every retirement: on the card the stalled op is nearly
        # all of its group's step, so a sparser tick mostly finds the
        # group in flight there, where it may not move
        hc = HealthController(tracer=tr, threshold=1.5, min_samples=4, check_every=1,
                              replan_after=2)
        res = pipe.serve(prompts, max_new, group_size=4, tracer=tr, health=hc,
                         injector=ReplicaFaultPlan.parse("blocks00:r0@op1=stall:0.03x999"))
        assert hc.migrations >= 1 and hc.replan_advice
    else:
        paused = pipe.serve(prompts, max_new, group_size=4, pause_after_tokens=5)
        assert paused.paused
        succ = pipe if drill == "resume_same" else DecodePipeline(
            cfg, stg, sel, params=params, device=cuda) if drill == "resume_transfer" \
            else DecodePipeline(cfg, stg, plan, params=params, device=cuda,
                                periods_per_stage=2)
        pipes.append(succ)
        res = succ.resume(paused.resume_state)
    assert res.tokens == want
    assert res.streams_used > 1
    assert all(p.compile_stats.late == 0 for p in pipes)
    for p in set(pipes):
        p.close()


# -- the backward kernels ---------------------------------------------------
# (B, S, H, KV, D, window, kv_offset[, causal]): the head dims 16, 32, 64,
# 120 and 128, GQA 1, 2, 5, 6, 7 and 8 (bf16: clusters of that many
# blocks), windows across tiles, a key offset (Sk = S + kv_offset), ragged
# lengths, causal and not; and shapes the bf16 wgmma kernels do not take,
# which run on the CUDA-core kernels (a head dim off 16 bytes, GQA 16)
BWD_SHAPES = [
    (1, 64, 4, 4, 16, None, 0),          # MHA, one tile
    (2, 100, 4, 2, 32, None, 0),         # GQA 2, ragged
    (1, 129, 10, 2, 64, None, 0),        # GQA 5, just past two tiles
    (2, 150, 12, 2, 120, 40, 0),         # danube's head dim, GQA 6, window across a tile
    (1, 200, 14, 2, 128, None, 0),       # qwen's head dim, GQA 7
    (1, 96, 16, 2, 128, None, 0),        # GQA 8
    (1, 70, 8, 2, 64, None, 130),        # kv_offset 130: Sk 200
    (1, 300, 8, 8, 120, 256, 0),         # danube's window of 256
    (2, 17, 4, 1, 128, 5, 3),            # a tiny window, an offset, one KV head
    (1, 129, 12, 2, 128, None, 0, False),   # not causal, GQA 6, ragged
    (2, 200, 16, 2, 120, 64, 0, False),     # not causal with a window, GQA 8
    (1, 200, 4, 4, 32, None, 7, False),     # not causal, an offset
    (1, 129, 4, 2, 100, None, 0),        # a head dim off 16 bytes: the CUDA-core kernels
    (1, 100, 16, 1, 64, 30, 0),          # GQA 16: the CUDA-core kernels
    # seamless-m4t-medium's heads (H16 KV16 D64), not causal: the encoder's
    # shape, and cross-attention's Sq != Sk (Sk = S + offset; no mask reads
    # the offset when not causal)
    (2, 1024, 16, 16, 64, None, 0, False),
    (2, 512, 16, 16, 64, None, 512, False),     # Sq 512, Sk 1024
    (1, 1024, 16, 16, 64, None, -24, False),    # Sq 1024, Sk 1000
    (1, 200, 16, 16, 64, None, -137, False),    # Sq 200, Sk 63: Sq > Sk, ragged
    (1, 100, 48, 8, 128, None, 0),              # internvl2-26b's heads, GQA 6
]
# float32: the kernel and the plain version's autograd sum float32 products
# in another order; bf16: both take bf16 inputs and round each gradient to
# bf16 once, and the kernel also rounds P and dS's inputs as they are stored
# (o is the forward's bf16 output), about three bf16 steps at the gradient's
# largest entry
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _attn_inputs(shape, dtype, cuda, seed=0):
    b, s, h, kv, d, window, off, *causal = shape
    rng = np.random.default_rng(seed + s + d)
    q = _rand(rng, (b, s, h, d), dtype, cuda)
    k = _rand(rng, (b, s + off, kv, d), dtype, cuda)
    v = _rand(rng, (b, s + off, kv, d), dtype, cuda)
    do = _rand(rng, (b, s, h, d), dtype, cuda)
    return q, k, v, do, dict(causal=causal[0] if causal else True, window=window,
                             kv_offset=off)


def _grads(fn, q, k, v, do, kw):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(do)
    return out.detach(), [t.grad for t in leaves]


def _close_scaled(got, want, tol, floor=0.0):
    torch.testing.assert_close(got.float(), want.float(),
                               atol=tol * float(want.float().abs().max()) + floor, rtol=tol)


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_autograd(cuda, shape, dtype):
    q, k, v, do, kw = _attn_inputs(shape, dtype, cuda)
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    out, got = _grads(flash_attention, q, k, v, do, kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.launches) == (fwd + 1, bwd + 1)
    want_out, want = _grads(flash_attention_plain, q, k, v, do, kw)
    _close(out, want_out, dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close_scaled(g, w, BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_logsumexp(cuda, dtype):
    b, s, h, kv, d, window, off = shape = (2, 150, 12, 2, 120, 40, 5)
    q, k, v, _, kw = _attn_inputs(shape, dtype, cuda)
    _, lse = flash_attention_forward(q, k, v, **kw, with_lse=True)
    rep, sk = h // kv, s + off
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5,
                          k.float().repeat_interleave(rep, dim=2))
    qpos = torch.arange(s, device=cuda)[:, None] + off
    kpos = torch.arange(sk, device=cuda)[None, :]
    live = (kpos <= qpos) & (kpos > qpos - window)
    want = torch.logsumexp(torch.where(live, logits, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


# GQA 7, 2 and 8 (bf16: clusters of 7, 2 and 8 blocks), head dims 128 and
# 120, and a window
@pytest.mark.parametrize("shape", [(2, 200, 14, 2, 128, None, 0), (2, 200, 4, 2, 128, None, 0),
                                   (1, 256, 16, 2, 128, None, 0), (2, 150, 12, 2, 120, 40, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(cuda, shape, dtype):
    q, k, v, do, kw = _attn_inputs(shape, dtype, cuda)
    out, lse = flash_attention_forward(q, k, v, **kw, with_lse=True)
    first = flash_attention_backward(q, k, v, out, do, lse, **kw)
    second = flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    rng = np.random.default_rng(5)
    x, g = _rand(rng, (4096, 2048), dtype, cuda), _rand(rng, (4096, 2048), dtype, cuda)
    w = _rand(rng, (2048,), torch.float32, cuda)
    first, second = rmsnorm_backward(x, w, g), rmsnorm_backward(x, w, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_backward_on_a_thread_new_to_cuda(cuda):
    """Autograd runs a backward on a device thread of its own, where the
    backward's first call may be the thread's first CUDA call (its outputs
    come from PyTorch's cache): the bf16 kernels' tensor maps must encode
    there too, and the gradients equal those made on the main thread."""
    import threading

    q, k, v, do, kw = _attn_inputs((1, 200, 8, 2, 128, None, 0), torch.bfloat16, cuda)
    out, lse = flash_attention_forward(q, k, v, **kw, with_lse=True)
    want = flash_attention_backward(q, k, v, out, do, lse, **kw)
    flash_attention_backward(q, k, v, out, do, lse, **kw)   # its outputs go back to the cache
    got = {}

    def run():
        try:
            got["grads"] = flash_attention_backward(q, k, v, out, do, lse, **kw)
        except Exception as e:   # reported below, on the test's thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], want))


# qwen's width at its training rows and at 8 rows, a width of a ragged
# number of 16-byte pieces, widths off 16 bytes, one that takes 8 warps a
# row (4096; float32: a CTA of 16 warps) and ones wider than the row kernel
# (3840 float32, 20000: the cluster kernel)
@pytest.mark.parametrize("shape", [(8192, 2048), (8, 1000), (3, 1001), (2, 20000), (5, 3840),
                                   (2, 7, 128), (8, 2048), (4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_plain_autograd(cuda, shape, dtype):
    rng = np.random.default_rng(7)
    x = _rand(rng, shape, dtype, cuda).requires_grad_(True)
    w = (1.0 + 0.1 * _rand(rng, shape[-1:], torch.float32, cuda)).requires_grad_(True)
    g = _rand(rng, shape, dtype, cuda)
    fwd, bwd = rmsnorm.launches, rmsnorm_backward.launches
    rmsnorm(x, w).backward(g)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_backward.launches) == (fwd + 1, bwd + 1)
    got = (x.grad, w.grad)
    x.grad = w.grad = None
    rmsnorm_plain(x, w).backward(g)
    # dx as the forward's tolerance; dw sums the rows' float32 terms in
    # another order (8192 of them at most)
    _close_scaled(got[0], x.grad, BWD_TOL[dtype])
    _close_scaled(got[1], w.grad, 1e-4 if dtype == torch.float32 else BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_takes_rows_off_16_bytes(cuda, dtype):
    rng = np.random.default_rng(3)
    x = _rand(rng, (8 * 2048 + 1,), dtype, cuda)[1:].view(8, 2048)
    assert x.data_ptr() % 16
    w = _rand(rng, (2048,), torch.float32, cuda)
    g = _rand(rng, (8, 2048), dtype, cuda)
    dx, dw = rmsnorm_backward(x, w, g)
    xl, wl = x.detach().clone().requires_grad_(True), w.clone().requires_grad_(True)
    rmsnorm_plain(xl, wl).backward(g)
    _close_scaled(dx, xl.grad, BWD_TOL[dtype])
    _close_scaled(dw, wl.grad, 1e-4 if dtype == torch.float32 else BWD_TOL[dtype])


# the SSD scan's backward at mamba2-370m's training shape (B2 L4096 H32 P64
# N128), a ragged length, the edges of the kernels' chunk of 64 tokens (L 1,
# L 65), the reduced config's widths (P8 N16) and P, N off the thread tiles;
# head counts 3, 6 and 9, odd and not powers of two; b and c are column
# slices of one projection, as `Mamba._proj` gives them
SSD_BWD_SHAPES = [(2, 4096, 32, 64, 128), (2, 129, 32, 64, 128), (2, 1, 32, 64, 128),
                  (2, 65, 32, 64, 128), (2, 100, 16, 8, 16), (2, 70, 3, 20, 40),
                  (2, 200, 6, 64, 128), (1, 130, 9, 64, 128)]
# the backward kernels against the plain version's autograd, a share of the
# gradient's largest entry: float32, sums of float32 products over up to
# 4096 tokens and 32 heads in another order; bf16, both round each gradient
# to bf16 once from float32 values that differ in their last bits.  da at L
# 1 is 0 in exact arithmetic (no token decays another): the plain version
# gives float32 noise of the terms that cancel there (up to 1.8e-4 seen), so
# it is held to 0, within float32 noise of its own
MAMBA_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
VANISHING = 1e-5


def _ssd_bwd_inputs(shape, dtype, cuda, memory="long"):
    B, L, H, P, N = shape
    rng = np.random.default_rng(L * 5 + P)
    shift, log_a = (0.0, 0.0) if memory == "short" else (4.0, -2.0)
    x = _rand(rng, (B, L, H, P), dtype, cuda)
    dt = torch.nn.functional.softplus(_rand(rng, (B, L, H), torch.float32, cuda) - shift)
    a = -torch.exp(log_a + 0.5 * _rand(rng, (H,), torch.float32, cuda))
    bc = _rand(rng, (B, L, 2 * N + H), dtype, cuda)
    return x, dt, a, bc, _rand(rng, (B, L, H, P), dtype, cuda), _rand(rng, (B, H, P, N),
                                                                       torch.float32, cuda)


def _ssd_grads(fn, x, dt, a, bc, dy, ds):
    """Gradients of x, dt, a and the projection bc, whose column slices are
    b and c; ds None: the loss does not use the final state."""
    n = (bc.shape[-1] - x.shape[2]) // 2
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, a, bc)]
    y, s = fn(*leaves[:3], leaves[3][..., :n], leaves[3][..., n:2 * n])
    torch.autograd.backward([y] if ds is None else [y, s], [dy] if ds is None else [dy, ds])
    return [t.grad for t in leaves]


@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["short", "long"])
def test_ssd_scan_backward_matches_plain_autograd(cuda, shape, dtype, memory):
    x, dt, a, bc, dy, ds = _ssd_bwd_inputs(shape, dtype, cuda, memory)
    fwd, bwd = ssd_scan.launches, ssd_scan_backward.launches
    got = _ssd_grads(ssd_scan, x, dt, a, bc, dy, ds)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_backward.launches) == (fwd + 1, bwd + 1)
    want = _ssd_grads(ssd_scan_plain, x, dt, a, bc, dy, ds)
    if shape[1] == 1:
        want[2] = torch.zeros_like(want[2])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_scaled(g, w, MAMBA_BWD_TOL[dtype], VANISHING)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_is_deterministic_without_a_state_gradient(cuda, dtype):
    """Two calls give the same bits (no atomics: db and dc are summed over
    the heads in order); a loss that does not use the final state gets the
    gradients of a zero state gradient, from one backward call."""
    x, dt, a, bc, dy, _ = _ssd_bwd_inputs((2, 300, 32, 64, 128), dtype, cuda)
    n = 128
    first = ssd_scan_backward(x, dt, a, bc[..., :n], bc[..., n:2 * n], dy)
    second = ssd_scan_backward(x, dt, a, bc[..., :n], bc[..., n:2 * n], dy)
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    before = ssd_scan_backward.launches
    got = _ssd_grads(ssd_scan, x, dt, a, bc, dy, None)
    assert ssd_scan_backward.launches == before + 1
    want = _ssd_grads(ssd_scan_plain, x, dt, a, bc, dy, None)
    for g, w in zip(got, want):
        _close_scaled(g, w, MAMBA_BWD_TOL[dtype])
    assert all(torch.equal(g, f) for g, f in zip(got[:3], first[:3]))
    assert torch.equal(got[3][..., :n], first[3]) and torch.equal(got[3][..., n:2 * n], first[4])


@pytest.mark.parametrize("shape", [(8, 4096, 32, 64, 128), (1, 16384, 32, 64, 128)])
def test_ssd_scan_backward_on_a_grid_larger_than_the_card(cuda, shape):
    """The states pass at B 8 (512 chains, a block each: four times the
    card's SMs) and at L 16384 (chains of 256 chunks), and the chunk kernel
    at 4096 blocks: against the plain autograd."""
    x, dt, a, bc, dy, _ = _ssd_bwd_inputs(shape, torch.bfloat16, cuda)
    got = _ssd_grads(ssd_scan, x, dt, a, bc, dy, None)
    want = _ssd_grads(ssd_scan_plain, x, dt, a, bc, dy, None)
    for g, w in zip(got, want):
        _close_scaled(g, w, MAMBA_BWD_TOL[torch.bfloat16])


def test_ssd_scan_backward_on_two_streams_at_once(cuda):
    """Two streams run the backward on one shape at once: each gives the
    bits of the same call alone."""
    n = 128
    cases = [_ssd_bwd_inputs((2, 1000, 32, 64, 128), torch.bfloat16, cuda) for _ in range(2)]
    cases[1] = tuple(t * 0.5 for t in cases[1][:1]) + cases[1][1:]
    args = [(x, dt, a, bc[..., :n], bc[..., n:2 * n], dy) for x, dt, a, bc, dy, _ in cases]
    alone = [ssd_scan_backward(*a_) for a_ in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in args]
    outs = [None, None]
    for _ in range(3):
        for i, (st, a_) in enumerate(zip(streams, args)):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                outs[i] = ssd_scan_backward(*a_)
        torch.cuda.synchronize()
        for got, want in zip(outs, alone):
            assert all(torch.equal(p, q) for p, q in zip(got, want))


def _gated_bwd_inputs(lead, h, p, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed + h * p)
    return (_rand(rng, (*lead, h, p), dtype, cuda), _rand(rng, (*lead, h, p), dtype, cuda),
            1.0 + 0.1 * _rand(rng, (h,), torch.float32, cuda),
            _rand(rng, (*lead, 2 * h * p), dtype, cuda),
            1.0 + 0.1 * _rand(rng, (h * p,), torch.float32, cuda),
            _rand(rng, (*lead, h * p), dtype, cuda))


def _gated_grads(fn, y, xh, d, xz, w, g):
    """Gradients of y, xh, d_skip, the projection xz (z its second half, as
    ``torch.chunk`` gives it) and w."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (y, xh, d, xz, w)]
    fn(*leaves[:3], torch.chunk(leaves[3], 2, dim=-1)[1], leaves[4]).backward(g)
    return [t.grad for t in leaves]


# (lead, H, P): mamba2-370m's training rows (8192 of 2048) and a decode
# step's 8, a width of a ragged number of pieces (1000), mamba2-2.7b's width
# (5120: the cluster kernel) and a width off 16 bytes (60: the wide kernel)
@pytest.mark.parametrize("lead,h,p", [((2, 4096), 32, 64), ((8,), 32, 64), ((3, 5), 4, 250),
                                      ((2, 3), 80, 64), ((4, 7), 3, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_backward_matches_plain_autograd(cuda, lead, h, p, dtype):
    y, xh, d, xz, w, g = _gated_bwd_inputs(lead, h, p, dtype, cuda)
    fwd, bwd = rmsnorm_gated.launches, rmsnorm_gated_backward.launches
    got = _gated_grads(rmsnorm_gated, y, xh, d, xz, w, g)
    torch.cuda.synchronize()
    assert (rmsnorm_gated.launches, rmsnorm_gated_backward.launches) == (fwd + 1, bwd + 1)
    want = _gated_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
    for got_, want_ in zip(got, want):
        assert got_.dtype == want_.dtype and got_.shape == want_.shape
        _close_scaled(got_, want_, MAMBA_BWD_TOL[dtype])


# rows and widths either side of the gated backward's plan changes: 131 and
# 132 rows (a row's warps double below the SM count), 265 and 793 (one
# row more than the 264 blocks, two blocks an SM, take at once, and than
# three rounds of them); widths of 1024 (4 warps a row), 2048 (8) and 2056
# (past 8 warps: the cluster kernel, 4 CTAs of 8 warps below 132 rows, a
# CTA of 16 warps from 132)
@pytest.mark.parametrize("rows", [131, 132, 265, 793])
@pytest.mark.parametrize("h,p", [(16, 64), (32, 64), (8, 257)])
def test_rmsnorm_gated_backward_either_side_of_its_plan(cuda, rows, h, p):
    y, xh, d, xz, w, g = _gated_bwd_inputs((rows,), h, p, torch.bfloat16, cuda, seed=rows)
    got = _gated_grads(rmsnorm_gated, y, xh, d, xz, w, g)
    want = _gated_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
    for got_, want_ in zip(got, want):
        _close_scaled(got_, want_, MAMBA_BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_backward_is_deterministic_and_takes_rows_off_16_bytes(cuda, dtype):
    y, xh, d, xz, w, g = _gated_bwd_inputs((2, 512), 32, 64, dtype, cuda)
    z = torch.chunk(xz, 2, dim=-1)[1]
    first = rmsnorm_gated_backward(y, xh, d, z, w, g)
    second = rmsnorm_gated_backward(y, xh, d, z, w, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    y_off = torch.empty(y.numel() + 1, dtype=dtype, device=cuda)[1:].view(y.shape)
    y_off.copy_(y)
    assert y_off.data_ptr() % 16
    got = rmsnorm_gated_backward(y_off, xh, d, z, w, g)      # the wide kernel
    leaves = [t.detach().clone().requires_grad_(True) for t in (y, xh, d, z, w)]
    rmsnorm_gated_plain(*leaves).backward(g)
    for got_, leaf in zip(got, leaves):
        _close_scaled(got_, leaf.grad, MAMBA_BWD_TOL[dtype])


def test_kernels_without_backward_refuse_grad(cuda):
    """Decode attention and the fused chain, which serve only, raise on
    inputs that require grad (no silent detach, no plain-version fallback)
    and launch nothing."""
    rng = np.random.default_rng(0)
    f32 = torch.float32
    q = _rand(rng, (1, 4, 16), f32, cuda).requires_grad_(True)
    kc = _rand(rng, (1, 8, 2, 16), f32, cuda)
    before = decode_attention.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_attention(q, kc, kc, torch.tensor(3, dtype=torch.int32, device=cuda))
    assert decode_attention.launches == before
    xd, k, v, wts = _sublayer(rng, 64, 8, 2, 16, 8, True, f32, cuda)
    wts["wq"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_decode(xd, k, v, torch.tensor(3, dtype=torch.int32, device=cuda), **wts,
                     n_heads=8, head_dim=16)
    with torch.no_grad():                        # without grad the same calls run
        decode_attention(q, kc, kc, torch.tensor(3, dtype=torch.int32, device=cuda))


def test_serving_launches_unchanged_without_grad(cuda):
    """No input requires grad, or grad is off: one forward launch each, no
    backward, and no logsumexp kept."""
    q, k, v, _, kw = _attn_inputs((1, 64, 4, 2, 64, None, 0), torch.bfloat16, cuda)
    x, w = q.reshape(-1, 64), torch.ones(64, device=cuda)
    counts = lambda: (flash_attention.launches, flash_attention_backward.launches,  # noqa: E731
                      rmsnorm.launches, rmsnorm_backward.launches)
    before = counts()
    out = flash_attention(q, k, v, **kw)
    rmsnorm(x, w)
    with torch.no_grad():
        flash_attention(q.requires_grad_(True), k, v, **kw)
        rmsnorm(x, w.requires_grad_(True))
    assert out.grad_fn is None
    after = counts()
    assert after == (before[0] + 2, before[1], before[2] + 2, before[3])


def _train_grads(cfg, device, impl=None, seed=0):
    model = lm.init_params(cfg, device=device, param_dtype=torch.float32,
                           generator=torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96))).to(device)
             for k in ("tokens", "labels")}
    loss, _ = lm.loss_fn(cfg, model, batch, impl=impl)
    loss.backward()
    return float(loss), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["tiny", "qwen2.5-3b-smoke", "h2o-danube-3-4b-smoke",
                                  "mamba2-370m-smoke"])
def test_training_kernel_route_matches_ref_route_on_card(cuda, name):
    """Loss and every gradient leaf of the kernel route (the forward and
    backward kernels of flash attention and rmsnorm; for mamba2-370m, of
    rmsnorm, the SSD scan and the gated norm) against ``impl="ref"``,
    float32 compute, within 1e-4 of the leaf's largest entry."""
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    kernels = ((rmsnorm, rmsnorm_backward, ssd_scan, ssd_scan_backward, rmsnorm_gated,
                rmsnorm_gated_backward) if name.startswith("mamba") else
               (flash_attention, flash_attention_backward, rmsnorm, rmsnorm_backward))
    counts = [f.launches for f in kernels]
    loss, got = _train_grads(cfg, cuda)
    after = [f.launches for f in kernels]
    assert all(a > b for a, b in zip(after, counts))
    want_loss, want = _train_grads(cfg, cuda, impl="ref")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for k, g in got.items():
        torch.testing.assert_close(g, want[k], atol=1e-4 * float(want[k].abs().max()) + 1e-12,
                                   rtol=0, msg=k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_training_remat_modes_are_bitwise_on_card(cuda, compute_dtype):
    """The recomputation under ``full`` and ``dots`` launches the same
    deterministic kernels on the same inputs: the gradients are bitwise
    those of ``none``."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b-smoke"), compute_dtype=compute_dtype)
    loss, want = _train_grads(dataclasses.replace(cfg, remat="none"), cuda)
    for remat in ("full", "dots"):
        got_loss, got = _train_grads(dataclasses.replace(cfg, remat=remat), cuda)
        assert got_loss == loss
        assert all(torch.equal(got[k], want[k]) for k in want), remat


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba_training_remat_modes_are_bitwise_on_card(cuda, compute_dtype):
    """mamba2-370m-smoke: the SSD scan's and the gated norm's backward
    kernels are deterministic, so the recomputation under ``full`` gives
    the gradients of ``none`` bitwise."""
    cfg = dataclasses.replace(get_config("mamba2-370m-smoke"), compute_dtype=compute_dtype)
    loss, want = _train_grads(dataclasses.replace(cfg, remat="none"), cuda)
    got_loss, got = _train_grads(dataclasses.replace(cfg, remat="full"), cuda)
    assert got_loss == loss
    assert all(torch.equal(got[k], want[k]) for k in want)


# ===========================================================================
# the microbatch pipeline (`lm_pipe.LMPipeline`) on the card
# ===========================================================================
def _lm_pipeline(name, device, layers=4, **kw):
    """A reduced config at ``layers`` layers, its training-shape plan with
    two replicas on every block node (so several streams run each stage),
    its pipeline on ``device`` and 6 microbatches of (2, 64) tokens."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import LMPipeline, as_selection

    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    shape = ShapeCfg("pipe_train_test", 64, 12, "train")
    plan = planner.plan(cfg, shape, chips=2 * layers + 4, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    sel = as_selection(plan)
    for n in stg.topo_order():
        if n.startswith("block"):
            sel.set(n, sel.choices[n][0], 2)
    rng = np.random.default_rng(3)
    mbs = [rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32) for _ in range(6)]
    return cfg, LMPipeline(cfg, stg, sel, device=device, **kw), mbs


def _pipe_loss(lg):
    return torch.mean(lg.float() ** 2)


@pytest.mark.parametrize("name", ["qwen2.5-3b-smoke", "mamba2-370m-smoke"])
def test_lm_pipeline_1f1b_on_streams_matches_the_oracle(cuda, name):
    """1F1B overlapped, each stage on its own stream and each (stage,
    replica) on its own lane thread, against the sequential oracle on one
    stream: the same kernels on the same inputs folded in the same order,
    so losses and every gradient leaf bitwise equal; so are ``overlap=False`` and interleaved
    1F1B; no first call inside a run; several streams ran ops; the serve
    equals ``reference()`` bitwise."""
    from repro_torch.runtime.pipeline import interleaved_1f1b

    cfg, pipe, mbs = _lm_pipeline(name, cuda)
    want, want_losses = pipe.sequential(mbs, loss_fn=_pipe_loss)
    runs = [pipe.run(mbs, train=True, loss_fn=_pipe_loss),
            pipe.run(mbs, train=True, loss_fn=_pipe_loss, overlap=False),
            pipe.run(mbs, train=True, loss_fn=_pipe_loss, schedule=interleaved_1f1b(3, 6, 2))]
    assert runs[0].streams_used > 1 and runs[1].streams_used == 1
    for res in runs:
        assert res.losses == want_losses
        for stage, tree in res.grads.items():
            assert all(torch.equal(g, want[stage][k]) for k, g in tree.items()), stage
    served = pipe.run(mbs)
    assert all(torch.equal(a, b) for a, b in zip(served.outputs, pipe.reference(mbs)))
    assert pipe.compile_stats.late == 0
    pipe.close()


def test_lm_pipeline_close_gives_its_memory_back(cuda):
    """After a 1F1B run on its lanes and streams, `close()` and dropping
    the pipeline and its result bring the memory allocated back within 64
    MB of where it was before the pipeline was built (the lanes' and the
    autograd thread's cuBLAS workspaces included)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cfg, pipe, mbs = _lm_pipeline("qwen2.5-3b-smoke", cuda)
    res = pipe.run(mbs, train=True, loss_fn=_pipe_loss)
    assert res.streams_used > 1
    pipe.close()
    del pipe, res
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    assert left < 64 << 20, f"{left} bytes left after close"


def test_lm_pipeline_backward_op_on_a_thread_new_to_cuda(cuda):
    """A stage's B op body run on a thread whose first CUDA call it is
    (autograd then runs the backward kernels on its device thread, the
    gradients' tensor maps encoded there): its gradients equal those of
    the same op on the main thread, bitwise."""
    import threading

    from repro_torch.runtime.pipeline import lm_pipe

    cfg, pipe, mbs = _lm_pipeline("qwen2.5-3b-smoke", cuda, overlap=False)
    st = pipe.stages[1]
    x = pipe.stages[0].module(torch.from_numpy(mbs[0]).to(cuda, torch.long)).detach()
    y_bar = torch.randn(x.shape, device=cuda).to(x.dtype)

    def op():
        fwd = lm_pipe._fwd_op(st, 0, x, True, True, cuda).payload
        return lm_pipe._bwd_op(st, 0, fwd[1], y_bar, None, None, cuda).payload

    want = op()
    got = {}

    def run():
        try:
            got["out"] = op()
        except Exception as e:   # reported below, on the test's thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    torch.cuda.synchronize()
    assert "error" not in got, got.get("error")
    (pb, xb, _), (pb_want, xb_want, _) = got["out"], want
    assert torch.equal(xb, xb_want)
    assert all(torch.equal(a, b) for a, b in zip(pb, pb_want))
    pipe.close()


# the hybrid (phase 16 of chip_smoke.py): jamba-1.5-large's shapes, 256 SSM
# heads of 64 (N 128, width 16384), attention H64 KV8 hd128 (GQA 8) at
# d_model 8192; and its first two layers at full width, kernel route
# against the oracle route
JAMBA = "jamba-1.5-large-398b"


def _jamba_mamba():
    cfg = get_config(JAMBA)
    return cfg.mamba.n_ssm_heads(cfg.d_model), cfg.mamba.head_dim, cfg.mamba.d_state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [512, 300])
def test_ssd_scan_at_the_hybrid_heads(cuda, dtype, length):
    """The scan at jamba's prefill (B8, 256 heads) and a ragged length,
    long memory; tolerances as `test_ssd_scan_kernel_matches_plain`."""
    H, P, N = _jamba_mamba()
    x, dt, a, bc, _, _ = _ssd_bwd_inputs((8, length, H, P, N), dtype, cuda)
    b, c = bc[..., :N], bc[..., N:2 * N]
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_s = ssd_scan_plain(x, dt, a, b, c)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    else:
        torch.testing.assert_close(y, want_y, atol=1e-4 * float(want_y.abs().max()), rtol=1e-4)
    torch.testing.assert_close(s, want_s, atol=1e-4 * float(want_s.abs().max()), rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_at_the_hybrid_heads(cuda, dtype):
    """One sequence of 4096 over jamba's 256 heads."""
    H, P, N = _jamba_mamba()
    x, dt, a, bc, dy, _ = _ssd_bwd_inputs((1, 4096, H, P, N), dtype, cuda)
    got = _ssd_grads(ssd_scan, x, dt, a, bc, dy, None)
    want = _ssd_grads(ssd_scan_plain, x, dt, a, bc, dy, None)
    for g, w in zip(got, want):
        _close_scaled(g, w, MAMBA_BWD_TOL[dtype], VANISHING)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(8,), (8, 512)])
def test_gated_norm_at_the_hybrid_width(cuda, dtype, lead):
    H, P, _ = _jamba_mamba()
    y, xh, d, xz, w, _ = _gated_bwd_inputs(lead, H, P, dtype, cuda)
    z = torch.chunk(xz, 2, dim=-1)[1]
    _close(rmsnorm_gated(y, xh, d, z, w), rmsnorm_gated_plain(y, xh, d, z, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_norm_backward_at_the_hybrid_width(cuda, dtype):
    H, P, _ = _jamba_mamba()
    y, xh, d, xz, w, g = _gated_bwd_inputs((1, 4096), H, P, dtype, cuda)
    got = _gated_grads(rmsnorm_gated, y, xh, d, xz, w, g)
    want = _gated_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
    for got_, want_ in zip(got, want):
        _close_scaled(got_, want_, MAMBA_BWD_TOL[dtype])


def _cluster_route(fn, args, counter):
    """``fn(*args)``, and whether it launched the cluster kernel that
    ``counter`` counts (its count moved by one)."""
    before = counter.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return out, counter.launches - before


# jamba's Mamba2 width (16384) at a decode step's 8 rows and at 4096, and
# the gated forms either side of their plans' limits: the gated gradient's
# row kernel (2048 | 2056: 8 warps of one piece), the gated forward's (4096
# | 4104 in bf16, 2048 | 2056 in float32: the cluster kernel past it), and
# the gradient's cluster (16384 | 16392 in bf16: 8 CTAs of one piece;
# float32 16384 is past it; the forward's cluster holds 16392 in bf16 and
# 16384 in float32, 16392 in float32 goes to the wide kernel); each forward
# (its route by the counters) and gradient against the plain version's
# autograd
@pytest.mark.parametrize("lead,h,p", [((8,), 256, 64), ((1, 4096), 256, 64), ((5,), 8, 256),
                                      ((133,), 8, 257), ((7,), 64, 64), ((7,), 8, 513),
                                      ((9,), 4, 4098), ((300,), 4, 4098)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_norm_either_side_of_the_cluster_plan(cuda, lead, h, p, dtype):
    y, xh, d, xz, w, g = _gated_bwd_inputs(lead, h, p, dtype, cuda)
    z = torch.chunk(xz, 2, dim=-1)[1]
    rows, elem = int(np.prod(lead)), torch.finfo(dtype).bits // 8
    card = rn.card_of(cuda.index or 0)
    plan = rn.norm_bwd_plan(rows, h * p, elem, aligned=True, card=card, gated=True)
    fplan = rn.norm_plan(rows, h * p, elem, gated=True, aligned=True, card=card)
    wide = rn.rmsnorm_gated_wide.launches
    out, launched = _cluster_route(rmsnorm_gated, (y, xh, d, z, w), rn.rmsnorm_gated_cluster)
    assert launched == fplan.cluster
    assert rn.rmsnorm_gated_wide.launches - wide == (fplan.warps == 0)
    _close(out, rmsnorm_gated_plain(y, xh, d, z, w), dtype)
    got, launched = _cluster_route(lambda *a: _gated_grads(rmsnorm_gated, *a),
                                   (y, xh, d, xz, w, g), rn.rmsnorm_gated_bwd_cluster)
    assert launched == plan.cluster
    want = _gated_grads(rmsnorm_gated_plain, y, xh, d, xz, w, g)
    for got_, want_ in zip(got, want):
        _close_scaled(got_, want_, MAMBA_BWD_TOL[dtype])


# the plain gradient either side of its row kernel (4096 | 4104: 8 warps of
# two pieces), at the llama4 decoders' 5120 and jamba's 8192 (2 CTAs a row,
# 4 at 8 rows), and either side of the cluster's limit (32768 | 32776 in
# bf16: 8 CTAs of two pieces; float32 16384 | 16388)
@pytest.mark.parametrize("rows,d", [(8, 4096), (300, 4096), (8, 4104), (300, 4104), (8, 5120),
                                    (4096, 5120), (8, 8192), (4096, 8192), (8, 16384),
                                    (3, 16388), (3, 32768), (3, 32776)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_either_side_of_the_cluster_plan(cuda, rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = _rand(rng, (rows, d), dtype, cuda).requires_grad_(True)
    w = (1.0 + 0.1 * _rand(rng, (d,), torch.float32, cuda)).requires_grad_(True)
    g = _rand(rng, (rows, d), dtype, cuda)
    plan = rn.norm_bwd_plan(rows, d, x.element_size(), aligned=True,
                            card=rn.card_of(cuda.index or 0))
    _, launched = _cluster_route(lambda: rmsnorm(x, w).backward(g), (), rn.rmsnorm_bwd_cluster)
    assert launched == plan.cluster
    got = (x.grad, w.grad)
    x.grad = w.grad = None
    rmsnorm_plain(x, w).backward(g)
    _close_scaled(got[0], x.grad, BWD_TOL[dtype])
    _close_scaled(got[1], w.grad, 1e-4 if dtype == torch.float32 else BWD_TOL[dtype])


# the plain forward either side of its row kernel (8192 | 8200 bf16, 4096 |
# 4100 float32: 8 warps of four pieces) and of its cluster's limit (65536 |
# 65544 bf16, 32768 | 32772 float32: 8 CTAs of 8 warps of four pieces),
# below and above the SM count; its route by the counters
@pytest.mark.parametrize("rows", [3, 8, 300])
@pytest.mark.parametrize("d,dtype", [(8192, torch.bfloat16), (8200, torch.bfloat16),
                                     (65536, torch.bfloat16), (65544, torch.bfloat16),
                                     (4096, torch.float32), (4100, torch.float32),
                                     (32768, torch.float32), (32772, torch.float32)])
def test_rmsnorm_forward_either_side_of_the_cluster_plan(cuda, rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = _rand(rng, (rows, d), dtype, cuda)
    w = 1.0 + 0.1 * _rand(rng, (d,), torch.float32, cuda)
    plan = rn.norm_plan(rows, d, x.element_size(), gated=False, aligned=True,
                        card=rn.card_of(cuda.index or 0))
    wide = rn.rmsnorm_wide.launches
    out, launched = _cluster_route(rmsnorm, (x, w), rn.rmsnorm_cluster)
    assert launched == plan.cluster
    assert rn.rmsnorm_wide.launches - wide == (plan.warps == 0)
    _close(out, rmsnorm_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_kernels_give_the_same_bits_twice(cuda, dtype):
    """The cluster kernels, called twice on the same inputs, give the same
    bits (fixed-order sums, no atomics): jamba's gated gradient at 16384
    (bf16; float32 takes the wide kernel there) and the plain gradient at
    16384 over 4096 rows; both forwards at 16384 over 4096 rows."""
    y, xh, d, xz, w, g = _gated_bwd_inputs((4096,), 256, 64, dtype, cuda)
    args = (y, xh, d, torch.chunk(xz, 2, dim=-1)[1], w, g)
    first = rmsnorm_gated_backward(*args)
    second = rmsnorm_gated_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first, launched = _cluster_route(rmsnorm_gated, args[:5], rn.rmsnorm_gated_cluster)
    assert launched == 1 and torch.equal(first, rmsnorm_gated(*args[:5]))
    rng = np.random.default_rng(9)
    x, g = _rand(rng, (4096, 16384), dtype, cuda), _rand(rng, (4096, 16384), dtype, cuda)
    wn = _rand(rng, (16384,), torch.float32, cuda)
    first, launched = _cluster_route(rmsnorm_backward, (x, wn, g), rn.rmsnorm_bwd_cluster)
    assert launched == 1
    assert all(torch.equal(a, b) for a, b in zip(first, rmsnorm_backward(x, wn, g)))
    first, launched = _cluster_route(rmsnorm, (x, wn), rn.rmsnorm_cluster)
    assert launched == 1 and torch.equal(first, rmsnorm(x, wn))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_and_norm_at_the_hybrid_shapes(cuda, dtype):
    """rmsnorm over a decode step's 8 rows of 8192; flash causal over the
    prefill bucket (B8 S512 H64 KV8 D128) and its backward; decode
    attention over C544 at ragged lengths."""
    D, H, KV, hd = _large_shape(JAMBA)
    rng = np.random.default_rng(D + H)
    x, w = _rand(rng, (8, D), dtype, cuda), _rand(rng, (D,), torch.float32, cuda)
    _close(rmsnorm(x, w), rmsnorm_plain(x, w), dtype)
    q, k, v = (_rand(rng, (8, 512, n, hd), dtype, cuda) for n in (H, KV, KV))
    do = _rand(rng, (8, 512, H, hd), dtype, cuda)
    out, got = _grads(flash_attention, q, k, v, do, {})
    want_out, want = _grads(flash_attention_plain, q, k, v, do, {})
    _close(out, want_out, dtype)
    for g, w_ in zip(got, want):
        _close_scaled(g, w_, BWD_TOL[dtype])
    q = _rand(rng, (8, H, hd), dtype, cuda)
    kc, vc = (_rand(rng, (8, 544, KV, hd), dtype, cuda) for _ in range(2))
    for lens in (544, [1, 37, 100, 255, 256, 400, 543, 544]):
        clen = torch.tensor(lens, dtype=torch.int32, device=cuda)
        _close(decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [8, 16])
def test_chain_at_the_hybrid_width(cuda, dtype, batch):
    D, H, KV, hd = _large_shape(JAMBA)
    rng = np.random.default_rng(D + batch)
    x, k, v, w = _sublayer(rng, D, H, KV, hd, 48, False, dtype, cuda, B=batch)
    kw = dict(w, n_heads=H, head_dim=hd, eps=1e-5, theta=1e4, scale=hd ** -0.5)
    p = torch.tensor(47, dtype=torch.int32, device=cuda)
    want, k_new, v_new = fused_decode_plain(x[:, 0], k, v, p, **kw)
    got = fused_decode(x, k, v, p, **kw)
    _close(got[:, 0], want, dtype)
    _close(k[:, 47], k_new, dtype)
    _close(v[:, 47], v_new, dtype)


def test_hybrid_cut_kernel_route_matches_ref_route(cuda):
    """jamba's first two layers (attention/dense, mamba/moe) at full width
    in float32 (47.6 GB): prefill of two padded prompts and 4 decode steps,
    logits within 1e-3 under both routes, every kernel of the path
    launched on the kernel route and none on the oracle route."""
    from repro_torch.configs import first_layers
    cfg = dataclasses.replace(first_layers(get_config(JAMBA), 2), compute_dtype="float32")
    model = lm.init_params(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = np.zeros((2, 128), np.int64)
    toks[0] = rng.integers(2, cfg.vocab, 128)
    toks[1, 50:] = rng.integers(2, cfg.vocab, 78)
    feed = [torch.from_numpy(rng.integers(2, cfg.vocab, (2, 1))).to(cuda) for _ in range(4)]
    kernels = (flash_attention, ssd_scan, rmsnorm_gated, qkv_rope, out_residual)
    out = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            counts = [f.launches for f in kernels]
            logits, cache = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks).to(cuda)},
                                       capacity=132, impl=impl)
            steps = [logits]
            for tok in feed:
                logits, cache = lm.decode_step(cfg, model, cache, tok, impl=impl)
                steps.append(logits)
            torch.cuda.synchronize()
            launched = [f.launches > c for f, c in zip(kernels, counts)]
            assert all(launched) if impl is None else not any(launched)
            out[impl] = steps
    for a, b in zip(out[None], out["ref"]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


def test_mesh_phase_at_a_two_layer_cut(cuda):
    """``chip_smoke.py``'s phase 18, (a) to (e), at qwen2.5-3b's full width
    cut to 2 layers: 3 `train_loop` steps without and with a (1, 1) mesh
    (NCCL, world 1) and ``fsdp=True``, equal losses; one serving round
    without and with ``mesh=``, equal tokens; each meshed run launched
    every kernel of its path and called no plain version."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, n).tolist() for n in rng.integers(64, 401, 8)]
    tokens, rounds, placed = smoke.mesh_phase(cfg, prompts, "test", seq=1024, global_batch=4,
                                              grad_accum=2, max_new=8)
    assert len(tokens) == 8 and all(1 <= len(t) <= 8 for t in tokens)
    assert set(rounds) == {"train", "serve"}
    assert all(n > 0 for r in rounds.values() for n in r.values()), rounds
    assert placed["local_bytes"] > 0 and placed["allocated_growth_bytes"] > 0, placed


def test_ranks_phase_at_a_two_layer_cut(cuda):
    """``chip_smoke.py``'s phase 19 at qwen2.5-3b's and mamba2-370m's full
    width, training cut to 2 layers and serving to 4: two processes share
    the card as the ranks of a gloo pool; 1F1B and interleaved training
    bitwise the one-rank pipeline's, two-rank serving tokens equal to the
    one-rank pipeline's; the drills (iv) at 2 layers a stage (1 after
    the rescale), every drill's tokens equal the uninterrupted two-rank
    serve's, each crash one failover, a slice
    migrated from rank 1 to rank 0, the successor on rank 0 alone; every
    rank launching the kernels of its stages and no plain version; the
    training crash escalating, the next 1F1B run bitwise the first."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke                    # by name: the spawned ranks import it

    rng = np.random.default_rng(0)
    prompts = {name: [rng.integers(2, get_config(name).vocab, n).tolist()
                      for n in rng.integers(64, 401, 8)]
               for name in ("qwen2.5-3b", "mamba2-370m")}
    tokens, rounds = chip_smoke.ranks_phase("test", prompts, layers=2, serve_layers=4)
    assert set(tokens) == set(prompts) | {"drills"}
    assert all(len(t) == 8 and all(1 <= len(x) <= 32 for x in t) for t in tokens.values())
    drills = [k for k in rounds if k.startswith("drill ")]
    assert set(rounds) - set(drills) == {"train 1f1b", "train interleaved",
                                         "serve qwen2.5-3b", "serve mamba2-370m"}
    assert all(set(by_rank) == {0, 1} for k, by_rank in rounds.items()
               if not k.startswith("drill ")), rounds
    assert len(drills) == 9, drills
    assert set(rounds["drill crash blocks01:r1@tok6"]) == {0, 1}
    assert set(rounds["drill resume on the successor, rank 0 alone"]) == {0}
