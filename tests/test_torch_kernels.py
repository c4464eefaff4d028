"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version; it is held
here against the JAX Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it), and the port's ``ref`` oracles are
held against the same.  Inputs come from seeded numpy and go to both
packages; both round them to bf16 the same way.

Tolerances: float32 2e-5, since the two sides sum in another order
(blocked online softmax in JAX, one softmax in the port); bf16 2e-2,
about two bf16 steps at magnitude 1, since both sides round the output to
bf16 from float32 values that differ in the last float32 bits.  The
attention sublayer takes 5e-5 in float32, as ``tests/test_kernels.py``
holds the JAX step, since it sums two more products of width D; the SSD
scan takes that file's 1e-4 (float32) and 5e-2 (bf16): its state sums
over the whole sequence and its bf16 inputs are rounded before the scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.fused_decode import _fused_pallas_step
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import blocks as jax_blocks
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (MAX_SPLITS, MIN_SPLIT, SplitPlan,
                                                  decode_attention, split_plan,
                                                  workspace_shapes)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels.fused_decode import (SHARED_LIMIT, GemvPlan, _composed_step,
                                              attn_decode_step, fused_decode_plain, gemv_plan,
                                              out_residual, qkv_rope, shared_bytes, tile_width)
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import (MAX_UNITS, REGISTERS, THREADS, WIDE, Card, NormPlan,
                                         _row_stride, norm_bwd_plan, norm_plan, rmsnorm,
                                         rmsnorm_gated)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port, jax_out, dtype, f32_tol=2e-5):
    tol = 2e-2 if dtype == "bfloat16" else f32_tol
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


# (lead, H, P): a prefill's (B, S) and a decode step's (B,) at small widths
GATED_SHAPES = [((2, 5), 4, 8), ((3,), 4, 8), ((2, 3), 2, 16), ((1,), 3, 4)]


@pytest.mark.parametrize("lead,heads,width", GATED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gated_matches_jax_composition(lead, heads, width, dtype):
    """The gated wrapper (its plain version on the CPU) against the JAX
    block's body: y + xh * d_skip, times silu(z), then the Pallas rmsnorm in
    interpret mode; z is the second half of one projection, as
    ``torch.chunk`` gives it, so its rows lie 2 * H * P apart."""
    rng = np.random.default_rng(8)
    di = heads * width
    jy, ty = _pair(rng, (*lead, heads, width), dtype)
    jxh, txh = _pair(rng, (*lead, heads, width), dtype)
    jd, td = _pair(rng, (heads,), "float32")
    jxz, txz = _pair(rng, (*lead, 2 * di), dtype)
    jw, tw = _pair(rng, (di,), "float32")
    jz, tz = jxz[..., di:], torch.chunk(txz, 2, dim=-1)[1]
    assert tz.stride(-2) == 2 * di
    g = (jy + jxh * jd[:, None].astype(jxh.dtype)).reshape(*lead, di) * jax.nn.silu(jz)
    want = jax_rmsnorm(g, jw, eps=1e-5, block_rows=2, interpret=True)
    got = rmsnorm_gated(ty, txh, td, tz, tw, eps=1e-5)
    assert got.dtype == ty.dtype and got.shape == tz.shape
    _close(got, want, dtype)


NORM_CARD = Card(sms=132, threads=2048, registers=65536)   # an H100


@pytest.mark.parametrize("rows", [1, 8, 131, 132, 1000, 4096, 5000])
@pytest.mark.parametrize("d,elem,gated", [(1024, 2, False), (2048, 2, False), (3840, 2, False),
                                          (1000, 2, False), (8192, 2, False), (2048, 4, False),
                                          (4096, 4, False), (2048, 2, True), (2048, 4, True),
                                          (4096, 2, True), (16, 2, False), (24, 4, True)])
def test_norm_plan_covers_the_row_within_its_limits(rows, d, elem, gated):
    plan = norm_plan(rows, d, elem, gated=gated, aligned=True, card=NORM_CARD)
    pieces = d * elem // 16
    assert plan.warps & (plan.warps - 1) == 0 and plan.units & (plan.units - 1) == 0
    # the lanes hold the row, and half as many warps a row would not (a
    # quarter as many, where the rows are fewer than the SMs and the plan
    # doubles the warps)
    assert 32 * plan.warps * plan.units >= pieces and plan.units <= MAX_UNITS[gated]
    fewest = plan.warps // 2 if rows < 132 and plan.warps > 1 else plan.warps
    assert fewest == 1 or 32 * (fewest // 2) * MAX_UNITS[gated] < pieces
    assert rows >= 132 or plan.warps == 8 or 32 * plan.warps * MAX_UNITS[gated] >= 2 * pieces
    assert plan.units == 1 or 32 * plan.warps * (plan.units // 2) < pieces
    threads = 32 * plan.warps * plan.groups
    assert threads <= THREADS
    # grid-stride: every row once; at most the blocks that fit the card at once
    cover = np.zeros(rows, np.int64)
    for b in range(plan.blocks):
        for g in range(plan.groups):
            cover[b * plan.groups + g::plan.blocks * plan.groups] += 1
    assert (cover == 1).all()
    fit = min(2048 // threads, 65536 // (REGISTERS * threads))
    assert plan.blocks <= 132 * fit
    # few rows spread one row group a block over the SMs
    assert rows >= 2 * 132 or plan.groups == 1


@pytest.mark.parametrize("d,elem,gated,aligned", [(100, 2, False, True), (1001, 4, False, True),
                                                  (2048, 2, False, False), (65544, 2, False, True),
                                                  (32772, 4, False, True), (32776, 2, True, True),
                                                  (16392, 4, True, True), (2048, 2, True, False)])
def test_norm_plan_sends_what_the_row_kernel_does_not_take_to_the_wide_kernel(
        d, elem, gated, aligned):
    """Rows off 16 bytes (in width or address), and rows past 8 CTAs of 8
    warps (plain: 65536 bf16, 32768 float32; gated: 32768, 16384): the wide
    kernel."""
    assert norm_plan(8, d, elem, gated=gated, aligned=aligned, card=NORM_CARD) == WIDE


@pytest.mark.parametrize("d,elem,gated", [(20000, 2, False), (8200, 2, False), (4100, 4, False),
                                          (5120, 2, True)])
def test_norm_plan_takes_aligned_forward_rows_past_8_warps_to_the_cluster_kernel(d, elem, gated):
    """Aligned forward rows that 8 warps do not hold, which went to the wide
    kernel before the forward's cluster kernel: at 8 rows, a cluster of
    CTAs of 8 warps a row whose lanes hold it within `MAX_UNITS`."""
    plan = norm_plan(8, d, elem, gated=gated, aligned=True, card=NORM_CARD)
    assert plan.cluster and plan.warps == 8 and 2 <= plan.ctas <= rn.MAX_CTAS
    assert plan.units <= MAX_UNITS[gated]
    assert 32 * plan.warps * plan.ctas * plan.units * 16 >= d * elem


def test_norm_plan_at_the_serving_shapes():
    """qwen2.5-3b's prefill (4096 x 2048 bf16): 2 warps a row, 4 pieces a
    lane, 4 rows a block, two blocks an SM (the launch bounds' 128
    registers); its decode (8 rows): 8 blocks of a row of 4 warps, 2 pieces
    a lane; mamba2-370m's pre-norm at decode (8 x 1024): 2 warps, 2 pieces;
    its gated norm (2048 wide, at most two pieces a lane): 4 warps a row at
    prefill, 8 at decode; danube's 3840: 4 warps a row."""
    assert norm_plan(4096, 2048, 2, gated=False, aligned=True, card=NORM_CARD) == \
        NormPlan(2, 4, 4, 264)
    assert norm_plan(8, 2048, 2, gated=False, aligned=True, card=NORM_CARD) == NormPlan(4, 2, 1, 8)
    assert norm_plan(8, 1024, 2, gated=False, aligned=True, card=NORM_CARD) == NormPlan(2, 2, 1, 8)
    assert norm_plan(4096, 2048, 2, gated=True, aligned=True, card=NORM_CARD) == \
        NormPlan(4, 2, 2, 264)
    assert norm_plan(8, 2048, 2, gated=True, aligned=True, card=NORM_CARD) == NormPlan(8, 1, 1, 8)
    assert norm_plan(4096, 3840, 2, gated=False, aligned=True, card=NORM_CARD) == \
        NormPlan(4, 4, 2, 264)


@pytest.mark.parametrize("rows", [1, 8, 131, 1000, 4096, 8192])
@pytest.mark.parametrize("d,elem", [(2048, 2), (4096, 2), (1000, 2), (3840, 2), (128, 2),
                                    (16, 2), (2048, 4), (1024, 4), (24, 4)])
def test_norm_bwd_plan_covers_every_row_once_within_its_limits(rows, d, elem):
    """The backward's row kernel holds x and g, two pieces at most a lane:
    its lanes hold the row, its row groups take every row once, its block
    fits the launch bounds and its row groups' dw shares fit the shared
    memory it folds them in; one partial row of dw a block."""
    plan = norm_bwd_plan(rows, d, elem, aligned=True, card=NORM_CARD)
    pieces = d * elem // 16
    assert plan.warps and plan.units <= MAX_UNITS[True] == 2
    assert 32 * plan.warps * plan.units >= pieces
    assert 32 * plan.warps * plan.groups <= THREADS
    assert plan.groups * d <= rn.FOLD_FLOATS
    cover = np.zeros(rows, np.int64)
    for b in range(plan.blocks):
        for g in range(plan.groups):
            cover[b * plan.groups + g::plan.blocks * plan.groups] += 1
    assert (cover == 1).all()
    assert plan == norm_plan(rows, d, elem, gated=True, aligned=True, card=NORM_CARD)


@pytest.mark.parametrize("rows,d,elem,aligned", [(8, 100, 2, True), (3, 1001, 4, True),
                                                 (8, 2048, 2, False), (2, 40000, 2, True),
                                                 (4096, 32776, 2, True), (5, 16392, 4, True),
                                                 (1000, 8200, 2, False)])
def test_norm_bwd_plan_sends_what_the_row_kernel_does_not_take_to_the_wide_kernel(
        rows, d, elem, aligned):
    """Rows off 16 bytes, or too wide for 8 CTAs of 8 warps of two pieces
    (past 4096 pieces: 32768 bf16, 16384 float32): the wide kernel, a block
    a row at a time, at most two blocks an SM; a partial row of dw a
    block."""
    assert norm_bwd_plan(rows, d, elem, aligned=aligned, card=NORM_CARD) == \
        NormPlan(0, 0, 0, min(rows, 2 * 132))


@pytest.mark.parametrize("rows,d,elem", [(2, 20000, 2), (4096, 4096, 4), (5, 3840, 4),
                                         (1000, 8200, 2)])
def test_norm_bwd_plan_takes_aligned_rows_past_8_warps_to_the_cluster_kernel(rows, d, elem):
    """Aligned rows that 8 warps of two pieces do not hold, which went to
    the wide kernel before the cluster kernel: a CTA of 16 warps or a
    cluster of CTAs of 8 a row."""
    plan = norm_bwd_plan(rows, d, elem, aligned=True, card=NORM_CARD)
    assert plan.cluster and (plan.warps, plan.ctas > 1) in ((8, True), (16, False))
    assert 32 * plan.warps * plan.ctas * plan.units * 16 >= d * elem


def test_norm_bwd_plan_at_the_training_shapes():
    """qwen2.5-3b's training rows (8192 of 2048 bf16): 4 warps a row, 2
    pieces a lane, 2 rows a block, 264 blocks; 8 rows: 8 blocks of a row
    of 8 warps; (4096, 4096): 8 warps, 2 pieces."""
    assert norm_bwd_plan(8192, 2048, 2, aligned=True, card=NORM_CARD) == NormPlan(4, 2, 2, 264)
    assert norm_bwd_plan(8, 2048, 2, aligned=True, card=NORM_CARD) == NormPlan(8, 1, 1, 8)
    assert norm_bwd_plan(4096, 4096, 2, aligned=True, card=NORM_CARD) == NormPlan(8, 2, 1, 264)


# the four forms (forward, gated forward, gradient, gated gradient): widths
# either side of the row kernels' limits (2056, 4104, 8200), the llama4
# decoders' (5120) and jamba's model and Mamba2 widths (8192, 16384); rows
# of a decode step, below and at the SM count, and of training
CLUSTER_FORMS = {"forward": (False, False), "gated forward": (True, False),
                 "gradient": (False, True), "gated gradient": (True, True)}


@pytest.mark.parametrize("form", list(CLUSTER_FORMS))
@pytest.mark.parametrize("d", [2056, 4104, 5120, 8192, 8200, 16384])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("rows", [8, 131, 132, 4096])
def test_cluster_plan_covers_each_aligned_row_past_the_row_kernel(form, d, elem, rows):
    """An aligned row that 8 warps do not hold goes to the cluster kernel:
    the fewest CTAs of 16 warps, at most one (the gated forward: two), where
    they hold the row and the rows are at least the SMs, else a cluster of
    CTAs of 8 warps.  Its lanes hold the row within the row kernels' units;
    the cluster is the fewest CTAs that do (twice as many below the SM
    count), at most 8, else the wide kernel; as many clusters as fit the
    card at once, or as there are rows; grid-stride over the clusters takes
    every row once.  A row the row kernel holds keeps its plan; a forward's
    row past 8 warps goes to the cluster kernel as a gradient's does,
    within ``MAX_UNITS[gated]``."""
    gated, backward = CLUSTER_FORMS[form]
    pieces = d * elem // 16
    limit = (rn.GATED_BWD_UNITS if gated and backward else MAX_UNITS[gated or backward])
    if backward:
        plan = norm_bwd_plan(rows, d, elem, aligned=True, card=NORM_CARD, gated=gated)
    else:
        plan = norm_plan(rows, d, elem, gated=gated, aligned=True, card=NORM_CARD)
    if pieces <= THREADS * limit:          # the row kernel's
        assert not plan.cluster and plan.warps
        return
    most16 = 2 if gated and not backward else 1      # CTAs of 16 warps a row at most
    sixteen = rows >= 132 and pieces <= most16 * 2 * THREADS * limit
    lanes = 2 * THREADS if sixteen else THREADS
    fewest = -(-pieces // (lanes * limit))
    if fewest > rn.MAX_CTAS:
        assert plan == (WIDE if not backward else NormPlan(0, 0, 0, min(rows, 2 * 132)))
        return
    assert plan.cluster and plan.warps == lanes // 32 and plan.groups == 1
    assert plan.ctas == (fewest if rows >= 132 else min(rn.MAX_CTAS, 2 * fewest))
    assert plan.ctas <= most16 if sixteen else 2 <= plan.ctas <= rn.MAX_CTAS == 8
    assert plan.units <= limit and plan.units & (plan.units - 1) == 0
    assert lanes * plan.ctas * plan.units >= pieces                  # the lanes hold the row
    assert plan.units == 1 or lanes * plan.ctas * (plan.units // 2) < pieces
    clusters = plan.blocks // plan.ctas
    assert plan.blocks == clusters * plan.ctas and 1 <= clusters <= rows
    fit = min(2048 // lanes, 65536 // (REGISTERS * lanes))
    assert plan.blocks <= 132 * fit                                   # one wave at most
    cover = np.zeros(rows, np.int64)
    for c in range(clusters):
        cover[c::clusters] += 1
    assert (cover == 1).all()


def test_cluster_plan_at_jamba_and_the_large_decoders_training_rows():
    """jamba's gated gradient (4096 rows of 16384 bf16): 8 CTAs of 8 warps
    a row, 33 clusters at most; its model width and the large decoders'
    (5120-8192) in the plain gradient: a CTA of 16 warps, two pieces a
    lane, one an SM; at a decode step's 8 rows, 4 CTAs of 8 warps."""
    assert norm_bwd_plan(4096, 16384, 2, aligned=True, card=NORM_CARD, gated=True) == \
        NormPlan(8, 1, 1, 264, 8)
    assert norm_bwd_plan(8, 16384, 2, aligned=True, card=NORM_CARD, gated=True) == \
        NormPlan(8, 1, 1, 64, 8)
    for d in (5120, 6144, 7168, 8192):
        assert norm_bwd_plan(8192, d, 2, aligned=True, card=NORM_CARD) == \
            NormPlan(16, 2, 1, 132, 1)
        assert norm_bwd_plan(8, d, 2, aligned=True, card=NORM_CARD) == NormPlan(8, 1, 1, 32, 4)


def test_norm_plan_at_jamba_s_forward_rows():
    """The forwards past the row kernel on an H100: jamba's gated norm (16384)
    in bf16 at prefill, 2 CTAs of 16 warps of two pieces, one an SM; at
    decode, 8 CTAs of 8 warps of one piece; in float32, 8 CTAs of 8 warps of
    two pieces, 33 clusters at most; the plain norm at 16384 bf16 and 8192
    float32 over 4096 rows, a CTA of 16 warps of four pieces, one an SM;
    8192 float32 at 8 rows, 4 CTAs of 8 warps of two pieces."""
    def plan(rows, d, elem, gated):
        return norm_plan(rows, d, elem, gated=gated, aligned=True, card=NORM_CARD)
    assert plan(4096, 16384, 2, True) == NormPlan(16, 2, 1, 132, 2)
    assert plan(8, 16384, 2, True) == NormPlan(8, 1, 1, 64, 8)
    assert plan(4096, 16384, 4, True) == NormPlan(8, 2, 1, 264, 8)
    assert plan(4096, 16384, 2, False) == NormPlan(16, 4, 1, 132, 1)
    assert plan(4096, 8192, 4, False) == NormPlan(16, 4, 1, 132, 1)
    assert plan(8, 8192, 4, False) == NormPlan(8, 2, 1, 32, 4)


def test_row_stride_reads_column_slices_and_refuses_uneven_rows():
    xz = torch.zeros(2, 5, 16)
    assert _row_stride(torch.chunk(xz, 2, dim=-1)[1]) == 16
    assert _row_stride(torch.chunk(xz[:, :1], 2, dim=-1)[1]) == 80    # (2, 1) rows
    assert _row_stride(xz[:, 0]) == 80
    assert _row_stride(xz) == 16
    assert _row_stride(torch.zeros(8)) == 8
    assert _row_stride(xz.view(10, 16)[::2]) == 32
    assert _row_stride(xz[:, ::2]) is None                 # (2, 3) rows: 32 apart, then 80
    assert _row_stride(xz[:, :3]) is None                  # (2, 3) rows: 80 between sequences
    assert _row_stride(xz.transpose(1, 2)) is None         # last dim strided


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


# (B, Sq, Sk, H, KV, D): qwen2.5-3b's and danube's training heads, each GQA
# ratio the models use and more, head dims 16-128, ragged lengths
BWD_PLAN_SHAPES = [(2, 4096, 4096, 16, 2, 128), (1, 1024, 1024, 32, 8, 120),
                   (2, 200, 200, 14, 2, 128), (1, 129, 129, 10, 2, 64), (2, 150, 150, 12, 2, 120),
                   (1, 64, 64, 4, 4, 16), (2, 100, 100, 4, 2, 32), (1, 70, 200, 8, 2, 64),
                   (2, 17, 20, 4, 1, 128), (1, 300, 300, 8, 8, 120), (3, 257, 513, 6, 1, 96)]


@pytest.mark.parametrize("shape", BWD_PLAN_SHAPES)
def test_bwd_plan_clusters_cover_every_key_tile_and_row_once(shape):
    """bf16's dK/dV grid: every (sequence, KV head, 128-key tile) is one
    cluster, of the KV head's query heads in head order, at most 8 blocks;
    the cluster's blocks split the tile's 128 rows between them, each row
    once; the dQ grid takes every (sequence, head, 128-query tile) once;
    the row arrays are whole 64-row slices; both kernels fit 227 KB."""
    b, sq, sk, h, kv, d = shape
    plan = fa.bwd_plan(b, sq, sk, h, kv, d, bf16=True, aligned=True)
    assert plan.route == fa.WGMMA and plan.head_pad in (64, 128) and plan.head_pad >= d
    assert plan.cluster == h // kv <= fa.MAX_CLUSTER
    gx, gy = plan.dkdv_grid
    assert gx % plan.cluster == 0
    seen = {}
    for x in range(gx):
        for y in range(gy):
            bi, head = divmod(x, h)
            cluster, rank = divmod(x, plan.cluster)
            assert head // (h // kv) == cluster % kv and head % plan.cluster == rank
            seen.setdefault((bi, head // (h // kv), y), []).append(head)
    assert sorted(seen) == [(bi, g, t) for bi in range(b) for g in range(kv)
                            for t in range(-(-sk // fa.KEY_TILE))]
    assert all(heads == list(range(g * (h // kv), (g + 1) * (h // kv)))
               for (_, g, _), heads in seen.items())
    rows = np.zeros(fa.KEY_TILE, np.int64)
    for r in fa.cluster_rows(plan.cluster):
        rows[r.start:r.stop] += 1
    assert (rows == 1).all()
    assert plan.dq_grid == (b * h, -(-sq // fa.QUERY_TILE))
    assert plan.rows_pad % fa.STEP == 0 and 0 <= plan.rows_pad - sq < fa.STEP
    assert max(plan.dkdv_smem, plan.dq_smem) <= fa.MAX_SHARED


@pytest.mark.parametrize("head_pad,dkdv,dq", [(64, 74_792, 66_600), (128, 140_328, 132_136)])
def test_bwd_shared_budget_by_head_dim(head_pad, dkdv, dq):
    """The wgmma kernels' shared memory as the source lays it out: under the
    227 KB a block may use, one block an SM (the blocks are 384 threads at
    up to 240 registers)."""
    assert fa.dkdv_shared_bytes(head_pad) == dkdv <= fa.MAX_SHARED
    assert fa.dq_shared_bytes(head_pad) == dq <= fa.MAX_SHARED


@pytest.mark.parametrize("shape,bf16,aligned", [((1, 64, 64, 4, 2, 100), True, True),
                                                ((1, 64, 64, 16, 1, 64), True, True),
                                                ((1, 64, 64, 4, 2, 128), True, False),
                                                ((2, 4096, 4096, 16, 2, 128), False, True)])
def test_bwd_plan_sends_what_wgmma_does_not_take_to_the_cuda_cores(shape, bf16, aligned):
    """A head dim off 16 bytes, more than 8 query heads a KV head (no
    portable cluster), an input off 16 bytes, and float32: the CUDA-core
    kernels, dK/dV a block per (64 keys, KV head), dQ per (64 queries,
    head)."""
    b, sq, sk, h, kv, d = shape
    assert fa.bwd_plan(b, sq, sk, h, kv, d, bf16=bf16, aligned=aligned) == fa.BwdPlan(
        fa.CUDA_CORES, d, 1, (-(-sk // 64), kv, b), (-(-sq // 64), h, b), sq, 0, 0)


@pytest.mark.parametrize("sq,sk,causal,window,off", [
    (64, 64, True, 0, 0), (129, 129, True, 0, 0), (150, 150, True, 40, 0), (70, 200, True, 0, 130),
    (300, 300, True, 256, 0), (17, 20, True, 5, 3), (200, 200, False, 0, 0),
    (129, 129, False, 40, 0), (257, 300, True, 100, 43)])
def test_bwd_tile_walk_computes_every_live_pair_once(sq, sk, causal, window, off):
    """The wgmma kernels' walk, as the source has it: a dK/dV block's two
    warpgroups (64 keys each) over the query tiles from qbeg to qend, a dQ
    block's (64 queries each) over the key tiles from kbeg to kend, each
    skipping tiles where no pair is live and masking only where some pair
    is dead: each computes every live (key, query) pair once and no other.
    Rows past Sq have P 0 from their padded logsumexp, rows past Sk are
    not stored (dK/dV) or zero (dQ)."""
    kt, qt = fa.KEY_TILE, fa.STEP
    qs, ks = np.arange(sq), np.arange(sk)
    qpos = qs[None, :] + off
    live = (ks[:, None] <= qpos) | (not causal)
    if window:
        live &= ks[:, None] > qpos - window
    dkdv = np.zeros((sk, sq), np.int64)
    for k0 in range(0, sk, kt):
        nk = min(kt, sk - k0)
        qbeg = max(0, k0 - off) if causal else 0
        qend = min(sq, k0 + nk - 1 + window - off) if window else sq
        for kw in (k0, k0 + 64):
            for q0 in range(qbeg // qt * qt, qend if qend > qbeg else 0, qt):
                if kw >= sk or (causal and kw > q0 + qt - 1 + off) or (
                        window and kw + 63 <= q0 + off - window):
                    continue
                edge = (causal and kw + 63 > q0 + off) or (window and kw <= q0 + qt - 1 + off - window)
                k_, q_ = np.arange(kw, min(kw + 64, sk)), np.arange(q0, min(q0 + qt, sq))
                dead = (causal & (k_[:, None] > q_[None, :] + off)) | (
                    (window > 0) & (k_[:, None] <= q_[None, :] + off - window))
                dkdv[k_[0]:k_[-1] + 1, q_[0]:q_[-1] + 1] += ~(bool(edge) & dead) if len(q_) else 0
    dq = np.zeros((sk, sq), np.int64)
    for q0 in range(0, sq, fa.QUERY_TILE):
        nq = min(fa.QUERY_TILE, sq - q0)
        kend = min(sk, q0 + nq + off) if causal else sk
        kbeg = max(0, q0 + off - window + 1) if window else 0
        for qw in (q0, q0 + 64):
            for k0 in range(kbeg // qt * qt, kend if kend > kbeg else 0, qt):
                if qw >= sq or (causal and k0 > qw + 63 + off) or (
                        window and k0 + qt - 1 <= qw + off - window):
                    continue
                edge = k0 + qt > sk or (causal and k0 + qt - 1 > qw + off) or (
                    window and k0 <= qw + 63 + off - window)
                q_, k_ = np.arange(qw, min(qw + 64, sq)), np.arange(k0, min(k0 + qt, sk))
                dead = (causal & (k_[:, None] > q_[None, :] + off)) | (
                    (window > 0) & (k_[:, None] <= q_[None, :] + off - window))
                dq[k_[0]:k_[-1] + 1, q_[0]:q_[-1] + 1] += ~(bool(edge) & dead) if len(q_) else 0
    np.testing.assert_array_equal(dkdv, live.astype(np.int64))
    np.testing.assert_array_equal(dq, live.astype(np.int64))


def test_backward_wrappers_raise_on_shapes_they_do_not_take(monkeypatch):
    """Past the device check, the backward wrappers refuse, with their
    messages and before any launch, a dtype or shape the kernels do not
    take."""
    monkeypatch.setattr(build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(build, "call", lambda *a: pytest.fail("launched"))
    z = torch.zeros
    q, kv, lse = z(1, 8, 4, 64), z(1, 8, 2, 64), z(1, 4, 8)
    with pytest.raises(ValueError, match="q .B,Sq,H,D. and k, v .B,Sk,KV,D. of one dtype"):
        fa.flash_attention_backward(q, z(1, 8, 3, 64), z(1, 8, 3, 64), q, q, lse)
    with pytest.raises(ValueError, match="D <= 128"):
        big = z(1, 8, 2, 160)
        fa.flash_attention_backward(z(1, 8, 4, 160), big, big, z(1, 8, 4, 160), z(1, 8, 4, 160),
                                    lse)
    with pytest.raises(ValueError, match="o and do as q"):
        fa.flash_attention_backward(q, kv, kv, q, q, z(1, 4, 7))
    with pytest.raises(ValueError, match="o and do as q"):
        fa.flash_attention_backward(q, kv, kv, q.bfloat16(), q, lse)
    x, w = z(8, 2048), z(2048)
    with pytest.raises(ValueError, match="g as x"):
        rn.rmsnorm_backward(x, w, z(8, 1024))
    with pytest.raises(ValueError, match="g as x"):
        rn.rmsnorm_backward(x, w, x.bfloat16())
    with pytest.raises(ValueError, match="width <= 50000"):
        rn.rmsnorm_backward(z(2, 60_000), z(60_000), z(2, 60_000))
    with pytest.raises(ValueError, match="w float32"):
        rn.rmsnorm_backward(x, w.bfloat16(), x)


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


SPLIT_GRID = [
    # (B, KV, C, SMs): C = 1 and C < L, the split edges, qwen2.5-3b's serving
    # shapes (B 8, KV 2, C 544) and danube's (KV 8, C 544 and its window
    # 4096), a batch that fills the card alone, a cache long enough to hit
    # the split cap, and a card of few SMs
    (1, 1, 1, 132), (2, 2, 20, 132), (2, 2, 31, 132), (2, 2, 32, 132), (2, 2, 33, 132),
    (8, 2, 544, 132), (8, 8, 544, 132), (8, 8, 4096, 132), (64, 8, 544, 132),
    (1, 1, 100_000, 132), (3, 2, 150, 132), (8, 2, 544, 8), (1, 2, 545, 1),
]


@pytest.mark.parametrize("batch,kv,capacity,sms", SPLIT_GRID)
def test_split_plan_covers_the_cache_once(batch, kv, capacity, sms):
    plan = split_plan(batch, kv, capacity, sms)
    assert 1 <= plan.splits <= MAX_SPLITS and plan.length >= MIN_SPLIT
    # the kernel's ranges: split s takes [s * length, min((s + 1) * length, C))
    ranges = [(s * plan.length, min((s + 1) * plan.length, capacity))
              for s in range(plan.splits)]
    assert all(lo < hi for lo, hi in ranges)                 # no split is empty
    cover = np.zeros(capacity, np.int64)
    for lo, hi in ranges:
        assert hi - lo <= plan.length
        cover[lo:hi] += 1
    assert (cover == 1).all()                                # [0, C) exactly once
    rep, hd = 7, 120
    assert workspace_shapes(batch, kv, rep, hd, plan) == {
        "acc": (batch * kv, plan.splits, rep, hd), "ml": (batch * kv, plan.splits, rep, 2),
        "tickets": (batch * kv,)}


def test_split_plan_at_qwen_serving_shape():
    """B 8, KV 2, C 544 on 132 SMs: 9 splits of 64 slots, 144 blocks, one
    doubling short of leaving SMs idle (5 splits, 80 blocks)."""
    assert split_plan(8, 2, 544, 132) == SplitPlan(64, 9)
    assert split_plan(8, 2, 544, 80) == SplitPlan(128, 5)


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


def _sublayer(name, dtype, B=3, C=16, seed=13):
    """Attention-sublayer weights (biases random where the config has them),
    a token x (B, D) and caches (B, C, KV, hd), seeded numpy, as a JAX and
    a torch keyword set."""
    cfg = jax_get_config(name)
    a = cfg.attn
    D, H, KV, hd = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    rng = np.random.default_rng(seed)

    def mat(*shape, scale=1.0):
        return rng.normal(scale=scale, size=shape).astype(np.float32)

    w = {"norm": 1.0 + mat(D, scale=0.1), "wq": mat(D, H * hd, scale=D ** -0.5),
         "wk": mat(D, KV * hd, scale=D ** -0.5), "wv": mat(D, KV * hd, scale=D ** -0.5),
         "wo": mat(H * hd, D, scale=(H * hd) ** -0.5)}
    if a.qkv_bias:
        w.update(bq=mat(H * hd, scale=0.1), bk=mat(KV * hd, scale=0.1),
                 bv=mat(KV * hd, scale=0.1))
    data = {"x": mat(B, D), "k": mat(B, C, KV, hd, scale=0.1), "v": mat(B, C, KV, hd, scale=0.1)}
    jdt, tdt = DTYPES[dtype]
    jw = {k: jnp.asarray(v, jnp.float32 if k == "norm" else jdt) for k, v in w.items()}
    tw = {k: torch.from_numpy(v).to(torch.float32 if k == "norm" else tdt)
          for k, v in w.items()}
    jd = {k: jnp.asarray(v, jdt) for k, v in data.items()}
    td = {k: torch.from_numpy(v).to(tdt) for k, v in data.items()}
    static = dict(n_heads=H, head_dim=hd, eps=cfg.norm_eps)
    return cfg, jw, tw, jd, td, static, a.rope_theta


def _bias_kw(w):
    return {k: w.get(k) for k in ("bq", "bk", "bv")}


@pytest.mark.parametrize("pos", [0, 3, 15, 16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decode_plain_matches_pallas(pos, dtype):
    """The plain version == the JAX `_fused_kernel` in interpret mode, in
    the growing (pos < C), boundary (pos == C) and wrapped states: out,
    and the new rows against the slot the JAX step wrote."""
    _, jw, tw, jd, td, static, theta = _sublayer("tiny", dtype)
    kw = dict(static, theta=theta, scale=static["head_dim"] ** -0.5)
    jw_kw = {k: jw[k] for k in ("norm", "wq", "wk", "wv", "wo")}
    out, kc, vc = _fused_pallas_step(jd["x"], jd["k"], jd["v"], jnp.int32(pos), **jw_kw,
                                     **_bias_kw(jw), interpret=True, **kw)
    got, k_new, v_new = fused_decode_plain(
        td["x"], td["k"], td["v"], torch.tensor(pos, dtype=torch.int32),
        **{k: tw[k] for k in ("norm", "wq", "wk", "wv", "wo")}, **_bias_kw(tw), **kw)
    assert got.dtype == td["x"].dtype and k_new.dtype == td["k"].dtype
    slot = pos % td["k"].shape[1]
    _close(got, out[:, 0], dtype, 5e-5)
    _close(k_new, kc[:, slot], dtype, 5e-5)
    _close(v_new, vc[:, slot], dtype, 5e-5)


def _attn_params(w):
    return {k: w[k] for k in ("norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv") if k in w}


@pytest.mark.parametrize("name", ["tiny", "qwen2.5-3b-smoke"])
@pytest.mark.parametrize("pos", [2, 16, 37])
def test_attn_decode_step_matches_jax_ref_body(name, pos):
    """The port's step on the CPU (the plain version plus the slot write)
    == the JAX op-by-op `attn_decode(impl="ref")`: out and both caches."""
    cfg, jw, tw, jd, td, static, theta = _sublayer(name, "float32", seed=pos)
    jx = jd["x"][:, None]
    want, jc = jax_blocks.attn_decode(_attn_params(jw), cfg, jx, {"k": jd["k"], "v": jd["v"]},
                                      jnp.int32(pos), impl="ref")
    k, v = td["k"].clone(), td["v"].clone()
    got = attn_decode_step(td["x"][:, None], k, v, torch.tensor(pos, dtype=torch.int32),
                           **_attn_params(tw), n_heads=static["n_heads"],
                           head_dim=static["head_dim"], eps=static["eps"], rope_theta=theta)
    _close(got, want, "float32", 5e-5)
    _close(k, jc["k"], "float32", 5e-5)
    _close(v, jc["v"], "float32", 5e-5)


@pytest.mark.parametrize("pos", [0, 16, 40])
def test_composed_step_matches_plain(pos):
    _, _, tw, _, td, static, theta = _sublayer("qwen2.5-3b-smoke", "float32")
    kw = dict(**{k: tw[k] for k in ("norm", "wq", "wk", "wv", "wo")}, **_bias_kw(tw),
              **static, theta=theta, scale=static["head_dim"] ** -0.5)
    p = torch.tensor(pos, dtype=torch.int32)
    want, k_new, v_new = fused_decode_plain(td["x"], td["k"], td["v"], p, **kw)
    k, v = td["k"].clone(), td["v"].clone()
    got = _composed_step(td["x"][:, None], k, v, p, **kw)
    slot = pos % k.shape[1]
    torch.testing.assert_close(got[:, 0], want, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(k[:, slot], k_new, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(v[:, slot], v_new, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("pos", [0, 15, 16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_steps_on_cpu_match_pallas(pos, dtype):
    """The chain as the card runs it, from the wrappers' plain versions on
    the CPU: `qkv_rope` writes the slot and gives q and cache_len, decode
    attention reads the updated cache, `out_residual` adds the residual;
    == the JAX `_fused_kernel` in interpret mode, out and both caches.  The
    bf16 tolerance takes the chain's two extra roundings (q and o to
    bf16)."""
    _, jw, tw, jd, td, static, theta = _sublayer("tiny", dtype)
    hd = static["head_dim"]
    kw = dict(static, theta=theta, scale=hd ** -0.5)
    jw_kw = {k: jw[k] for k in ("norm", "wq", "wk", "wv", "wo")}
    out, kc, vc = _fused_pallas_step(jd["x"], jd["k"], jd["v"], jnp.int32(pos), **jw_kw,
                                     **_bias_kw(jw), interpret=True, **kw)
    k, v = td["k"].clone(), td["v"].clone()
    p = torch.tensor(pos, dtype=torch.int32)
    q, clen = qkv_rope(td["x"], k, v, p, **{n: tw[n] for n in ("norm", "wq", "wk", "wv")},
                       **_bias_kw(tw), n_heads=static["n_heads"], eps=static["eps"],
                       theta=theta)
    assert int(clen) == min(pos + 1, k.shape[1]) and q.dtype == td["x"].dtype
    o = decode_attention(q, k, v, clen, scale=hd ** -0.5)
    got = out_residual(o.reshape(o.shape[0], -1), tw["wo"], td["x"])
    _close(got, out[:, 0], dtype, 5e-5)
    _close(k, kc, dtype, 5e-5)
    _close(v, vc, dtype, 5e-5)


# (tiles, width, K) of both GEMVs at the port's dense configs: tiny (hd 32),
# reduced (hd 16, D 64), qwen2.5-3b (20 heads, D 2048), danube (48 heads of
# hd 120, D 3840); qkv_rope's tiles are heads, out_residual's 128 columns
GEMV_SHAPES = {"tiny qkv": (16, 32, 256), "tiny out": (2, 128, 256),
               "reduced qkv": (8, 16, 64), "reduced out": (1, 64, 64),
               "qwen qkv": (20, 128, 2048), "qwen out": (16, 128, 2048),
               "danube qkv": (48, 128, 3840), "danube out": (30, 128, 3840)}


@pytest.mark.parametrize("shape", list(GEMV_SHAPES))
@pytest.mark.parametrize("batch", [1, 8, 11])
@pytest.mark.parametrize("sms", [132, 8])
def test_gemv_plan_covers_every_row_once(shape, batch, sms):
    tiles, width, rows = GEMV_SHAPES[shape]
    groups = -(-batch // 8)
    norm = shape.endswith("qkv")
    for dtype in (torch.bfloat16, torch.float32):
        plan = gemv_plan(tiles, width, rows, groups, sms, dtype=dtype, norm=norm)
        assert plan.width == width
        # a power of two up to a portable cluster of 8
        assert 1 <= plan.splits <= fd.MAX_SPLITS and plan.splits & (plan.splits - 1) == 0
        # the kernels' ranges: split s takes rows [s * slice, min((s + 1) * slice, K))
        cover = np.zeros(rows, np.int64)
        for s in range(plan.splits):
            cover[s * plan.slice:min((s + 1) * plan.slice, rows)] += 1
        assert (cover == 1).all()
        assert plan.splits == 1 or plan.slice % 16 == 0      # whole mma steps, 16-byte x loads
        # 7/8 of the SMs get a block, unless the cluster or the mma step forbids
        # more splits; with half as many splits they would not
        blocks = tiles * plan.splits * groups
        assert 8 * blocks >= 7 * sms or plan.splits == fd.MAX_SPLITS or rows <= plan.splits * 16
        assert plan.splits == 1 or 8 * blocks // 2 < 7 * sms
        # the sums a block receives fit its buffer
        assert plan.splits * -(-8 // plan.splits) <= fd.RECV_ROWS
        assert shared_bytes(plan, dtype, norm) <= SHARED_LIMIT


@pytest.mark.parametrize("columns,width", [(1, 16), (16, 16), (17, 32), (32, 32), (120, 128),
                                           (128, 128), (2048, 128), (64, 64)])
def test_tile_width_holds_a_head_or_caps_at_128(columns, width):
    assert tile_width(columns) == width


def test_gemv_plan_at_qwen_serving_shape():
    """B 8 on 132 SMs: qkv_rope 20 heads x 8 splits of 256 rows (160
    blocks), out_residual 16 tiles of 128 columns x 8 (128 blocks), danube's
    48 heads and 30 tiles x 4; each block's shared memory leaves room for
    two on an SM."""
    bf = torch.bfloat16
    assert gemv_plan(20, 128, 2048, 1, 132, dtype=bf, norm=True) == GemvPlan(128, 256, 8)
    assert gemv_plan(16, 128, 2048, 1, 132, dtype=bf, norm=False) == GemvPlan(128, 256, 8)
    assert gemv_plan(48, 128, 3840, 1, 132, dtype=bf, norm=True) == GemvPlan(128, 960, 4)
    assert gemv_plan(30, 128, 3840, 1, 132, dtype=bf, norm=False) == GemvPlan(128, 960, 4)
    for tiles, rows, norm in ((20, 2048, True), (16, 2048, False), (48, 3840, True),
                              (30, 3840, False)):
        plan = gemv_plan(tiles, 128, rows, 1, 132, dtype=bf, norm=norm)
        assert 2 * (shared_bytes(plan, bf, norm) + 1024) <= 233_472


SSD_SHAPES = [
    # (B, L, H, P, N, chunk), as tests/test_kernels.py
    (1, 16, 1, 4, 8, 4),
    (2, 64, 3, 8, 16, 16),
    (1, 50, 2, 16, 32, 16),   # ragged
    (2, 128, 4, 64, 128, 32),  # production-like dims
    # the CUDA kernel's chunk of 64 tokens (its plain version is what the
    # card tests hold it to): one token, one short of a chunk, one past
    (1, 1, 2, 8, 16, 64),
    (1, 63, 2, 24, 48, 64),
    (2, 65, 3, 8, 16, 64),
]


def _ssd_inputs(shape, dtype):
    b, l, h, p, n, _ = shape
    rng = np.random.default_rng(sum(shape) * 7 + len(dtype))
    jdt, tdt = DTYPES[dtype]
    arrays = {"x": rng.normal(size=(b, l, h, p)), "dt": rng.uniform(0.05, 0.8, size=(b, l, h)),
              "b": rng.normal(size=(b, l, n)), "c": rng.normal(size=(b, l, n))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    jax_in = [jnp.asarray(arrays[k], jdt) for k in ("x", "dt")] + [jnp.asarray(a)] + \
        [jnp.asarray(arrays[k], jdt) for k in ("b", "c")]
    torch_in = [torch.from_numpy(arrays[k]).to(tdt) for k in ("x", "dt")] + \
        [torch.from_numpy(a)] + [torch.from_numpy(arrays[k]).to(tdt) for k in ("b", "c")]
    return jax_in, torch_in


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(shape, dtype):
    chunk = shape[-1]
    jin, tin = _ssd_inputs(shape, dtype)
    want_y, want_s = jax_ssd_scan(*jin, chunk=chunk, interpret=True)
    ref_y, ref_s = jref.ssd_reference(*jin)
    got_y, got_s = ssd_scan(*tin, chunk=chunk)          # the plain version on the CPU
    assert got_y.dtype == tin[0].dtype and got_s.dtype == torch.float32
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    for want, oracle, got in ((want_y, ref_y, got_y), (want_s, ref_s, got_s)):
        for w in (want, oracle):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                       atol=tol, rtol=tol)
    torch.testing.assert_close(ssd_scan_plain(*tin, chunk=chunk)[1], got_s)


def test_ssd_oracles_match_jax():
    jin, tin = _ssd_inputs((2, 37, 3, 8, 16, 8), "float32")
    for jfn, tfn in ((jref.ssd_reference, ref.ssd_reference),
                     (lambda *a: jref.ssd_chunked(*a, chunk=8),
                      lambda *a: ref.ssd_chunked(*a, chunk=8))):
        jy, js = jfn(*jin)
        ty, ts = tfn(*tin)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    d_skip = np.linspace(0.5, 1.5, 3).astype(np.float32)
    jy, _ = jref.ssd_chunked(*jin, chunk=8, d_skip=jnp.asarray(d_skip))
    ty, _ = ref.ssd_chunked(*tin, chunk=8, d_skip=torch.from_numpy(d_skip))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_ssd_decode_step_matches_jax():
    jin, tin = _ssd_inputs((2, 5, 3, 8, 16, 8), "float32")
    rng = np.random.default_rng(9)
    s0 = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, 3).astype(np.float32)
    jx, jdt, ja, jb, jc = jin
    tx, tdt, ta, tb, tc = tin
    js, ts = jnp.asarray(s0), torch.from_numpy(s0)
    for t in range(5):
        jy, js = jref.ssd_decode_step(js, jx[:, t], jdt[:, t], ja, jb[:, t], jc[:, t],
                                      d_skip=jnp.asarray(d_skip))
        ty, ts = ref.ssd_decode_step(ts, tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t],
                                     d_skip=torch.from_numpy(d_skip))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)


def test_ops_ssd_dispatch_by_impl():
    _, tin = _ssd_inputs((1, 20, 2, 8, 16, 8), "float32")
    want = ref.ssd_chunked(*tin, chunk=8)
    for impl in (None, "ref"):
        got = ops.ssd(*tin, chunk=8, impl=impl)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        ops.ssd(*tin, impl="pallas")
