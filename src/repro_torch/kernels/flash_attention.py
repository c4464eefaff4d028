"""Prefill and training attention: the CUDA kernels ``csrc/flash_attention.cu``
and their plain version.

Forward attention in the JAX layout, q (B, Sq, H, D) and k, v (B, Sk, KV,
D), GQA with H a multiple of KV.  With qpos = q index + ``kv_offset``, key
kpos takes part when kpos < Sk, kpos <= qpos if ``causal``, and kpos >
qpos - ``window`` with a window.

The forward kernel replaces the Pallas TPU kernel `_flash_kernel`
(``repro/kernels/flash_attention.py``).  ``flash_attention`` launches it
for CUDA tensors and runs the plain version for CPU tensors: bf16 runs on
the tensor cores (``mma.sync``), float32 on the CUDA cores.  When an input
requires grad, the call goes through `_FlashAttention`: the forward kernel
also writes each row's logsumexp, and the backward is the hand-written
kernels of `flash_attention_backward` (the JAX package has no backward
kernel; it trains through its composed tiers), launched as `bwd_plan`
lays them out: bf16 on ``wgmma`` with tensor copies and GQA's sum in a
thread block cluster, float32 (and shapes those kernels do not take) on
the CUDA cores.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import NEG_INF

__all__ = ["BwdPlan", "bwd_plan", "flash_attention", "flash_attention_backward",
           "flash_attention_forward", "flash_attention_plain"]

MAX_HEAD_DIM = 128   # the kernels' register tiles hold 128 output columns

_ARGS = [build.P] * 5 + [build.I] * 6 + [build.F] + [build.I] * 3 + [build.P]
_BWD_ARGS = [build.P] * 10 + [build.I] * 6 + [build.F] + [build.I] * 5 + [build.P]

# the backward's launches (csrc/flash_attention.cu): its routes, and its passes
CUDA_CORES, WGMMA = 0, 1
ROWS_PASS, DKDV_PASS, DQ_PASS = 1, 2, 4
ALL_PASSES = ROWS_PASS | DKDV_PASS | DQ_PASS

# the wgmma kernels' tiles, as the source has them
KEY_TILE = 128       # keys a dK/dV block (64 a warpgroup)
QUERY_TILE = 128     # queries a dQ block (64 a warpgroup)
STEP = 64            # queries a dK/dV step; keys a dQ step
RING = 2             # stages of their copy rings
MAX_CLUSTER = 8      # blocks a cluster, the portable most: query heads a KV head
MAX_SHARED = 232_448   # bytes of shared memory a block of the H100 may use (227 KB)


class BwdPlan(NamedTuple):
    """The launches of one backward call.  ``route`` WGMMA: the row pass,
    then the dK/dV kernel on ``dkdv_grid`` (B * H, key tiles of 128) in
    clusters of ``cluster`` blocks, the query heads of one KV head, and the
    dQ kernel on ``dq_grid`` (B * H, query tiles of 128); head dims padded
    to ``head_pad`` (64 or 128), the row arrays to ``rows_pad`` rows.
    ``route`` CUDA_CORES: the CUDA-core kernels on their grids (64-row
    tiles; dK/dV a block per (key tile, KV head)), ``cluster`` 1."""
    route: int
    head_pad: int
    cluster: int
    dkdv_grid: tuple
    dq_grid: tuple
    rows_pad: int
    dkdv_smem: int
    dq_smem: int


def dkdv_shared_bytes(head_pad: int) -> int:
    """The wgmma dK/dV kernel's shared memory (``DkdvLayout`` in the source):
    K and V of 128 keys, a ring of Q and dO tiles of 64 rows with their
    rows' lse and Dv, and over all of these, once the loop is done, the
    float32 dK and dV (rows of head_pad + 8); its barriers; 1 KB of
    alignment."""
    kv_tile, q_tile = KEY_TILE * head_pad * 2, STEP * head_pad * 2
    loop = 2 * kv_tile + RING * (2 * q_tile + 2 * STEP * 4)
    red = 2 * KEY_TILE * (head_pad + 8) * 4
    return max(loop, red) + (2 * RING + 1) * 8 + 1024


def dq_shared_bytes(head_pad: int) -> int:
    """The wgmma dQ kernel's (``DqLayout``): Q and dO of 128 queries, a ring
    of K and V tiles of 64 rows, its barriers, 1 KB of alignment."""
    return (2 * QUERY_TILE * head_pad * 2 + RING * 2 * STEP * head_pad * 2 + (2 * RING + 1) * 8
            + 1024)


def bwd_plan(b: int, sq: int, sk: int, h: int, kv: int, d: int, *, bf16: bool,
             aligned: bool) -> BwdPlan:
    """bf16 inputs whose head dim is whole 16-byte pieces, at 16-byte
    aligned addresses, with at most 8 query heads a KV head go to the wgmma
    kernels; everything else to the CUDA-core kernels."""
    if bf16 and aligned and d % 8 == 0 and h // kv <= MAX_CLUSTER:
        pad = 64 if d <= 64 else 128
        return BwdPlan(WGMMA, pad, h // kv, (b * h, -(-sk // KEY_TILE)),
                       (b * h, -(-sq // QUERY_TILE)), -(-sq // STEP) * STEP,
                       dkdv_shared_bytes(pad), dq_shared_bytes(pad))
    return BwdPlan(CUDA_CORES, d, 1, (-(-sk // STEP), kv, b), (-(-sq // STEP), h, b), sq, 0, 0)


def cluster_rows(cluster: int) -> list[range]:
    """The key rows of a key tile that each block of a dK/dV cluster sums and
    stores, by rank."""
    per = -(-KEY_TILE // cluster)
    return [range(min(KEY_TILE, r * per), min(KEY_TILE, (r + 1) * per)) for r in range(cluster)]


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                          scale: float | None = None, kv_offset: int = 0):
    """The kernel's function in plain PyTorch, float32 inside, GQA by
    grouping the query heads instead of repeating the KV heads."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, sq, kv, rep, d) * scale
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    s = torch.where(live, s, NEG_INF)
    o = torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _check(name, q, k, v):
    build.check_cuda(name, q, k, v)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if (q.dtype not in build.DTYPE_SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype
            or k.shape != (b, sk, kv, d) or v.shape != k.shape or h % kv
            or d > MAX_HEAD_DIM):
        raise ValueError(
            f"{name}: q (B,Sq,H,D) and k, v (B,Sk,KV,D) of one dtype "
            f"(bf16/float32), KV dividing H, D <= {MAX_HEAD_DIM}; got q {q.dtype} "
            f"{tuple(q.shape)}, k {k.dtype} {tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention_forward(q, k, v, *, causal: bool = True, window: int | None = None,
                            scale: float | None = None, kv_offset: int = 0,
                            with_lse: bool = False):
    """One launch of the forward kernel on CUDA tensors: the output and,
    ``with_lse``, each row's logsumexp of the scaled live logits, float32
    (B, H, Sq) (+inf for a row with no live key)."""
    _check("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        build.call(f"flash_attention_{build.DTYPE_SUFFIX[q.dtype]}", _ARGS,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if with_lse else None, b, sq, sk, h, kv, d, scale,
                   int(causal), window or 0, kv_offset, build.stream(q.device))
        build.count(flash_attention)
    return out, lse


def flash_attention_backward(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int | None = None, scale: float | None = None,
                             kv_offset: int = 0, passes: int = ALL_PASSES):
    """dq, dk, dv of the forward for CUDA tensors, from its output ``o`` and
    logsumexp ``lse``.  One call launches, as `bwd_plan` lays them out, the
    row pass (Dv = rowsum(dO o)), the dK/dV kernel and the dQ kernel of
    ``csrc/flash_attention.cu``, which use no atomics: bf16 on wgmma, GQA's
    sum over a KV head's query heads taken in head order inside a thread
    block cluster; float32 on the CUDA cores.  ``passes`` launches only
    some of the three (for timing them apart); the others' outputs are then
    left unwritten."""
    _check("flash_attention_backward", q, k, v)
    build.check_cuda("flash_attention_backward", q, o, do, lse)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_backward: o and do as q {tuple(q.shape)} "
                         f"{q.dtype}, lse float32 ({b}, {h}, {sq}); got o {o.dtype} "
                         f"{tuple(o.shape)}, do {do.dtype} {tuple(do.shape)}, lse "
                         f"{lse.dtype} {tuple(lse.shape)}")
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    plan = bwd_plan(b, sq, sk, h, kv, d, bf16=q.dtype == torch.bfloat16,
                    aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do)))
    # Dv and, on the wgmma route, the logsumexp in log2 units, a row each
    rows = torch.empty((2, b, h, plan.rows_pad), dtype=torch.float32, device=q.device)
    build.call(f"flash_attention_bwd_{build.DTYPE_SUFFIX[q.dtype]}", _BWD_ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
               lse.data_ptr(), rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               b, sq, sk, h, kv, d, scale, int(causal), window or 0, kv_offset, plan.route,
               passes, build.stream(q.device))
    build.count(flash_attention_backward)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its logsumexp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_offset):
        out, lse = flash_attention_forward(q, k, v, causal=causal, window=window,
                                           scale=scale, kv_offset=kv_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale, kv_offset=kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do.contiguous(), lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, kv_offset: int = 0):
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D).  On the card,
    differentiable through the backward kernel when an input requires
    grad; otherwise one forward launch, as serving runs it."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_offset=kv_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, kv_offset)
    return flash_attention_forward(q, k, v, causal=causal, window=window, scale=scale,
                                   kv_offset=kv_offset)[0]


flash_attention.launches = 0            # forward kernel launches
flash_attention_backward.launches = 0   # backward calls (three launches each)
