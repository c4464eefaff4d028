"""Single-token attention-sublayer step for decode: the CUDA chain
``csrc/fused_decode.cu`` and its plain version.

One decode token through an attention sublayer: rmsnorm -> Q/K/V
projections (+bias) -> rope at ``pos`` -> attention over the ring cache
with the fresh token -> output projection -> residual; ring slot ``pos %
C`` of both caches is written in place.  ``pos`` is a () int32 device
tensor and ``cache_len = min(pos + 1, C)`` is computed on the device, so
the step makes no host sync and allocates no cache.

  * `attn_decode_step` sends CUDA tensors through `fused_decode`, the
    chain that replaces the Pallas TPU kernel `_fused_kernel`
    (``repro/kernels/fused_decode.py``): `qkv_rope` (norm, projections,
    rope, slot write), the `decode_attention` kernel over the updated
    cache, and `out_residual` (output projection + residual); three
    launches, each counted by its wrapper.  CPU tensors go through
    `fused_decode_plain`, the function of `_fused_kernel` in plain
    PyTorch, and their slot is written from its ``k_new``/``v_new``.
    `qkv_rope` and `out_residual` on CPU tensors run their plain
    versions, `qkv_plain` and `out_residual_plain`.
  * The two GEMV kernels cut each output tile's weight rows into splits
    (`gemv_plan`, on the host from the shapes and the SM count); the splits
    of a tile run as one thread block cluster and add their sums in shared
    memory, so a call needs no workspace.
  * `_composed_step` is the same sublayer as torch matmuls around the
    rmsnorm and decode-attention kernels, as the JAX module keeps its own;
    it is off the serving path and serves as the chain's yardstick.  It
    counts its calls, so a run can show it never took them.

The JAX kernel's VMEM budget (`_fits_vmem`) is a TPU limit and is not
carried over: the chain takes every dense config of the port at full
width.  Shapes it does not take raise.  The rope math is a local copy of
``models.common.rope``: kernels do not import models.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .decode_attention import MAX_HEAD_DIM, MAX_REP, _sm_count, decode_attention
from .ref import NEG_INF
from .rmsnorm import rmsnorm

__all__ = ["attn_decode_step", "fused_decode", "fused_decode_plain", "out_residual",
           "out_residual_plain", "qkv_plain", "qkv_rope"]

_QKV_ARGS = [build.P] * 13 + [build.I] * 9 + [build.F, build.F, build.P]
_OUT_ARGS = [build.P] * 4 + [build.I] * 6 + [build.P]

# The GEMV kernels' blocking, as in fused_decode.cu
BATCH_GROUP = 8         # batch rows a block: the n = 8 side of the mma
STAGE_BYTES = 16 * 1024  # weight bytes a stage
RING_BYTES = 88 * 1024  # weight bytes in flight a block
K_STEP = 16             # weight rows an mma; a split is a whole number of them
MAX_WIDTH = 128         # output columns a tile, at most
OUT_WIDTH = 128         # out_residual's tiles: 128 columns (256-byte rows of bf16)
RED_FLOATS = 2048
MAX_SPLITS = 8          # blocks a cluster, the portable most
RECV_ROWS = 16          # rows of sums a block receives, at most (splits x ceil(8 / splits))
SHARED_LIMIT = 232_448  # shared memory a block may have on the H100 (227 KB)


class GemvPlan(NamedTuple):
    """Tile t takes output columns [t * width, t * width + width) (in the
    Q/K/V kernel, the columns of head t); split s, block s of the tile's
    cluster, its weight rows [s * slice, min((s + 1) * slice, K)), which
    may be empty."""
    width: int
    slice: int
    splits: int


def tile_width(columns: int) -> int:
    """The power of two from 16 that holds ``columns`` output columns, at
    most MAX_WIDTH: a head (hd <= 128) in qkv_rope, D in out_residual."""
    width = 16
    while width < min(columns, MAX_WIDTH):
        width *= 2
    return width


def gemv_plan(tiles: int, width: int, rows: int, groups: int, sm_count: int, *,
              dtype: torch.dtype, norm: bool) -> GemvPlan:
    """The fewest splits of the ``rows`` weight rows, a power of two up to
    MAX_SPLITS (a portable cluster), that give 7/8 of the SMs a block
    (tiles x splits x batch groups), none shorter than K_STEP rows.  On the
    card this took the best of the split counts timed at both models'
    shapes (H100 80GB HBM3 at 700 W, chip_smoke.py's gemv_scaling): 8 for
    qwen2.5-3b's GEMVs (20 heads, 16 tiles; its qkv_rope 0.0124 ms at 8,
    0.0128 at 4, 0.0150 at 6), 4 for danube's (48 heads, 30 tiles; its
    qkv_rope ~0.026 ms at 4, 0.034 at 8, 0.032 at 2): fewer splits leave
    SMs idle, more than fill the card stack blocks on an SM.

    A block holds its split's slice of x's rows (and, with ``norm``, of the
    norm's weight) in shared memory, so a wide row cut into few splits can
    overflow it: deepseek-coder-33b's 7168 rows at two batch groups, where
    the rule above takes one split, need 238,880 bytes.  Where the rule's
    count does not fit, the splits double until `shared_bytes` of
    ``dtype`` fits SHARED_LIMIT; past MAX_SPLITS this raises."""
    def plan_of(splits):
        slice_ = -(-rows // splits)
        if splits > 1:
            slice_ = -(-slice_ // K_STEP) * K_STEP
        return GemvPlan(width, slice_, splits)

    splits = 1
    while splits < MAX_SPLITS and 8 * tiles * groups * splits < 7 * sm_count \
            and rows > splits * K_STEP:
        splits *= 2
    plan = plan_of(splits)
    while shared_bytes(plan, dtype, norm) > SHARED_LIMIT:
        if splits >= MAX_SPLITS:
            raise ValueError(
                f"fused_decode: no split of {rows} weight rows into at most {MAX_SPLITS} "
                f"fits a block's {SHARED_LIMIT} bytes of shared memory ({dtype}, tile "
                f"width {width}, norm={norm}: {shared_bytes(plan, dtype, norm)} bytes at "
                f"{splits} splits)")
        splits *= 2
        plan = plan_of(splits)
    return plan


def shared_bytes(plan: GemvPlan, dtype: torch.dtype, norm: bool) -> int:
    """A block's dynamic shared memory, as ``Layout`` in fused_decode.cu
    computes it: the ring of weight stages (reused for the sums), x's rows
    and (in qkv_rope) the norm's slice, 32 floats of sums of squares, the
    sums the cluster sends."""
    elem = torch.empty((), dtype=dtype).element_size()
    pad = 16 // elem
    rows = STAGE_BYTES // (plan.width * elem)        # weight rows a stage
    stages = RING_BYTES // (STAGE_BYTES + STAGE_BYTES // MAX_WIDTH * pad)
    ring = max(stages * rows * (plan.width + pad) * elem, RED_FLOATS * 4)
    ksp = -(-plan.slice // rows) * rows + pad
    return (-(-ring // 16) * 16 + BATCH_GROUP * ksp * elem + (ksp * 4 if norm else 0)
            + (32 + RECV_ROWS * plan.width) * 4)


def _rope_host(x, positions, theta):
    """(B, S, heads, hd) rope at positions (S,): the non-interleaved halves
    rotated by float32 angles, an odd tail passed through, cast back."""
    d = x.shape[-1]
    d2 = d // 2
    freq = theta ** (-torch.arange(0, d2, dtype=torch.float32, device=x.device) / d2)
    ang = positions[..., None].float() * freq
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * d2 < d:
        rot = torch.cat([rot, x[..., 2 * d2:].float()], dim=-1)
    return rot.to(x.dtype)


def qkv_plain(x2, pos, *, norm, wq, wk, wv, bq, bk, bv, n_heads, head_dim, eps, theta):
    """The norm, projections and rope of `qkv_rope` in plain PyTorch:
    float32 q (B, H, hd), k and v (B, KV, hd), q and k roped at pos."""
    B, _ = x2.shape
    kv = wk.shape[1] // head_dim
    x = x2.float()
    rms = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    h = x * rms * norm.float()

    def proj(w, b, rows):
        y = h @ w.float()
        if b is not None:
            y = y + b.float()
        return y.reshape(B, rows, head_dim)

    pos = torch.as_tensor(pos, device=x2.device).reshape(1)
    q, k, v = proj(wq, bq, n_heads), proj(wk, bk, kv), proj(wv, bv, kv)
    return (_rope_host(q[:, None], pos, theta)[:, 0], _rope_host(k[:, None], pos, theta)[:, 0],
            v)


def out_residual_plain(o, wo, x2):
    """x2 + o @ wo in plain PyTorch, float32 inside."""
    return (x2.float() + o.float() @ wo.float()).to(x2.dtype)


def fused_decode_plain(x2, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo, bq, bk, bv,
                       n_heads, head_dim, eps, theta, scale):
    """The function of `_fused_kernel` in plain PyTorch, float32 inside.

    x2 (B, D); caches (B, C, KV, hd), read only; pos an int or a () integer
    tensor.  Attends over the old cache with the stale slot ``pos % C``
    masked plus the fresh token's column.  Returns out (B, D) in x2's
    dtype and the new rows k_new, v_new (B, KV, hd) in the caches' dtype."""
    B, _ = x2.shape
    cap, kv = k_cache.shape[1], k_cache.shape[2]
    rep = n_heads // kv
    dev = x2.device
    x = x2.float()
    q, k, v = qkv_plain(x2, pos, norm=norm, wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
                        n_heads=n_heads, head_dim=head_dim, eps=eps, theta=theta)
    q = q * scale
    pos = torch.as_tensor(pos, device=dev)

    idx = torch.arange(cap, device=dev)
    live = (idx < torch.clamp(pos, max=cap)) & (idx != torch.remainder(pos, cap))
    qg = q.reshape(B, kv, rep, head_dim)
    s = torch.einsum("bgrd,bcgd->bgrc", qg, k_cache.float())
    s = torch.where(live, s, NEG_INF)
    s_cur = torch.einsum("bgrd,bgd->bgr", qg, k)[..., None]         # fresh token's column
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_cur)
    p, p_cur = torch.exp(s - m), torch.exp(s_cur - m)
    o = torch.einsum("bgrc,bcgd->bgrd", p, v_cache.float()) + p_cur * v[:, :, None, :]
    o = o / (p.sum(dim=-1, keepdim=True) + p_cur)
    out = x + o.reshape(B, n_heads * head_dim) @ wo.float()
    return out.to(x2.dtype), k.to(k_cache.dtype), v.to(v_cache.dtype)


def _check_chain(x2, k_cache, v_cache, pos, norm, wq, wk, wv, wo, biases, n_heads,
                 head_dim):
    tensors = [x2, k_cache, v_cache, pos, norm, wq, wk, wv, wo] + [b for b in biases
                                                                   if b is not None]
    build.check_cuda("fused_decode", *tensors)
    B, D = x2.shape
    _, cap, kv, hd = k_cache.shape
    dt = x2.dtype
    ok = (dt in build.DTYPE_SUFFIX and hd == head_dim and 1 <= hd <= MAX_HEAD_DIM
          and kv >= 1 and n_heads % kv == 0 and n_heads // kv <= MAX_REP and cap >= 1
          and k_cache.shape == (B, cap, kv, hd) and v_cache.shape == k_cache.shape
          and all(t.dtype == dt for t in (k_cache, v_cache, wq, wk, wv, wo))
          and norm.dtype == torch.float32 and norm.shape == (D,)
          and wq.shape == (D, n_heads * hd) and wk.shape == (D, kv * hd)
          and wv.shape == wk.shape and wo.shape == (n_heads * hd, D)
          and pos.dtype == torch.int32 and pos.shape == ())
    if any(b is not None for b in biases):
        bq, bk, bv = biases
        ok = ok and all(b is not None and b.dtype == dt for b in biases) and \
            bq.shape == (n_heads * hd,) and bk.shape == (kv * hd,) and bv.shape == bk.shape
    if not ok:
        raise ValueError(
            f"fused_decode: x (B,D) and caches (B,C,KV,hd) of one dtype (bf16/float32), "
            f"weights of that dtype, norm float32 (D,), pos an int32 () tensor, H/KV a "
            f"whole number <= {MAX_REP}, hd <= {MAX_HEAD_DIM}, biases all or none; got x "
            f"{dt} {tuple(x2.shape)}, cache {k_cache.dtype} {tuple(k_cache.shape)}, "
            f"wq {wq.dtype} {tuple(wq.shape)}, wk {tuple(wk.shape)}, wo {tuple(wo.shape)}, "
            f"norm {norm.dtype}, pos {pos.dtype} {tuple(pos.shape)}, n_heads {n_heads}")


def qkv_rope(x2, k_cache, v_cache, pos, *, norm, wq, wk, wv, bq, bk, bv, n_heads, eps,
             theta):
    """Chain step (i): q (B, H, hd) and a () int32 ``cache_len = min(pos +
    1, C)``; the roped k row and the v row land in slot ``pos % C`` of the
    caches.  Arguments as `fused_decode`'s, checked there for CUDA tensors;
    CPU tensors take `qkv_plain`."""
    B, D = x2.shape
    _, cap, kv, hd = k_cache.shape
    if x2.device.type == "cpu":
        q, k, v = qkv_plain(x2, pos, norm=norm, wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
                            n_heads=n_heads, head_dim=hd, eps=eps, theta=theta)
        slot = torch.remainder(torch.as_tensor(pos).reshape(1), cap).long()
        k_cache.index_copy_(1, slot, k[:, None].to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v[:, None].to(v_cache.dtype))
        return q.to(x2.dtype), torch.clamp(torch.as_tensor(pos, dtype=torch.int32) + 1, max=cap)
    q = torch.empty((B, n_heads, hd), dtype=x2.dtype, device=x2.device)
    clen = torch.empty((), dtype=torch.int32, device=x2.device)
    bias = [0 if b is None else b.data_ptr() for b in (bq, bk, bv)]
    plan = gemv_plan(n_heads + 2 * kv, tile_width(hd), D, -(-B // BATCH_GROUP),
                     _sm_count(x2.device.index), dtype=x2.dtype, norm=True)
    build.call(f"fused_qkv_rope_{build.DTYPE_SUFFIX[x2.dtype]}", _QKV_ARGS,
               x2.data_ptr(), norm.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
               *bias, pos.data_ptr(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               clen.data_ptr(), B, D, n_heads, kv, hd, cap, plan.width, plan.slice,
               plan.splits, eps, theta, build.stream(x2.device))
    build.count(qkv_rope)
    return q, clen


def out_residual(o, wo, x2):
    """Chain step (iii): x2 + o @ wo for o (B, H*hd), x2 (B, D); checked
    by `fused_decode` for CUDA tensors, `out_residual_plain` for CPU ones."""
    if x2.device.type == "cpu":
        return out_residual_plain(o, wo, x2)
    B, K = o.shape
    D = x2.shape[1]
    out = torch.empty_like(x2)
    width = min(OUT_WIDTH, tile_width(D))
    plan = gemv_plan(-(-D // width), width, K, -(-B // BATCH_GROUP), _sm_count(x2.device.index),
                     dtype=x2.dtype, norm=False)
    build.call(f"fused_out_residual_{build.DTYPE_SUFFIX[x2.dtype]}", _OUT_ARGS,
               o.data_ptr(), wo.data_ptr(), x2.data_ptr(), out.data_ptr(), B, K, D,
               plan.width, plan.slice, plan.splits, build.stream(x2.device))
    build.count(out_residual)
    return out


qkv_rope.launches = 0       # kernel launches, for showing a run went through them
out_residual.launches = 0


def fused_decode(x, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo, bq=None, bk=None,
                 bv=None, n_heads, head_dim, eps=1e-5, theta=10_000.0, scale=None):
    """The chain on the card: x (B, 1, D) -> out (B, 1, D); slot ``pos %
    C`` of both caches is written in place.  Raises on a shape, dtype or
    device the kernels do not take."""
    B, _, D = x.shape
    x2 = x.reshape(B, D)
    build.refuse_grad("fused_decode", x, norm, wq, wk, wv, wo, bq, bk, bv)
    _check_chain(x2, k_cache, v_cache, pos, norm, wq, wk, wv, wo, (bq, bk, bv), n_heads,
                 head_dim)
    scale = scale if scale is not None else head_dim ** -0.5
    q, clen = qkv_rope(x2, k_cache, v_cache, pos, norm=norm, wq=wq, wk=wk, wv=wv, bq=bq,
                       bk=bk, bv=bv, n_heads=n_heads, eps=eps, theta=theta)
    o = decode_attention(q, k_cache, v_cache, clen, scale=scale)
    return out_residual(o.reshape(B, n_heads * head_dim), wo, x2).reshape(B, 1, D)


def _composed_step(x, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo,
                   bq, bk, bv, n_heads, head_dim, eps, theta, scale):
    build.count(_composed_step, "calls")
    B = x.shape[0]
    cap = k_cache.shape[1]
    kv_heads = wk.shape[1] // head_dim
    h = rmsnorm(x, norm, eps=eps)
    q = h @ wq
    k = h @ wk
    v = h @ wv
    if bq is not None:
        q = q + bq
        k = k + bk
        v = v + bv
    positions = pos.reshape(1)
    q = _rope_host(q.view(B, 1, n_heads, head_dim), positions, theta)
    k = _rope_host(k.view(B, 1, kv_heads, head_dim), positions, theta)
    v = v.view(B, 1, kv_heads, head_dim)
    slot = torch.remainder(positions, cap).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    cache_len = torch.clamp(pos + 1, max=cap)
    o = decode_attention(q[:, 0], k_cache, v_cache, cache_len, scale=scale)
    return x + o.reshape(B, 1, -1) @ wo


_composed_step.calls = 0    # calls, for showing a run never took it


def attn_decode_step(x, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo,
                     bq=None, bk=None, bv=None, n_heads, head_dim,
                     eps=1e-5, rope_theta=10_000.0):
    """One-token attention sublayer: x (B, 1, D) and pos, a () int32 device
    tensor -> out (B, 1, D); slot ``pos % C`` of both caches (B, C, KV, hd)
    is written in place.  CUDA tensors take the chain, CPU tensors the
    plain version."""
    kw = dict(norm=norm, wq=wq, wk=wk, wv=wv, wo=wo, bq=bq, bk=bk, bv=bv, n_heads=n_heads,
              head_dim=head_dim, eps=eps, theta=rope_theta, scale=head_dim ** -0.5)
    if x.device.type != "cpu":
        return fused_decode(x, k_cache, v_cache, pos, **kw)
    B, _, D = x.shape
    out, k_new, v_new = fused_decode_plain(x.reshape(B, D), k_cache, v_cache, pos, **kw)
    slot = torch.remainder(pos.reshape(1), k_cache.shape[1]).long()
    k_cache.index_copy_(1, slot, k_new[:, None])
    v_cache.index_copy_(1, slot, v_new[:, None])
    return out.reshape(B, 1, D)
