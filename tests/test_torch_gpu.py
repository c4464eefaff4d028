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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain, out_residual,
                                              out_residual_plain, qkv_plain, qkv_rope)
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_gated, rmsnorm_gated_plain,
                                         rmsnorm_plain)
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


# the serving widths (mamba2-370m 1024, qwen 2048, danube 3840) at decode
# and prefill rows, rows off the persistent grid (5000), a width of a ragged
# number of pieces (1000), widths off 16 bytes (100, 1001) and one wider
# than the row kernel holds (20000): the wide kernel
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
# mamba2-2.7b's) and one off 16 bytes (15): the wide kernel
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
              (2048, 16, 2, 128, False), (64, 4, 2, 16, True), (96, 4, 2, 15, True)]


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
