"""Prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version.

Forward attention in the JAX layout, q (B, Sq, H, D) and k, v (B, Sk, KV,
D), GQA with H a multiple of KV.  With qpos = q index + ``kv_offset``, key
kpos takes part when kpos < Sk, kpos <= qpos if ``causal``, and kpos >
qpos - ``window`` with a window.

The kernel replaces the Pallas TPU kernel `_flash_kernel`
(``repro/kernels/flash_attention.py``).  ``flash_attention`` launches it
for CUDA tensors and runs the plain version for CPU tensors: bf16 runs on
the tensor cores (``mma.sync``), float32 on the CUDA cores.
"""
from __future__ import annotations

import torch

from . import build
from .ref import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain"]

MAX_HEAD_DIM = 128   # the kernel's register tile holds 128 output columns

_ARGS = [build.P, build.P, build.P, build.P, build.I, build.I, build.I, build.I,
         build.I, build.I, build.F, build.I, build.I, build.I, build.P]


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


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, kv_offset: int = 0):
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) -> (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_offset=kv_offset)
    build.check_cuda("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if (q.dtype not in build.DTYPE_SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype
            or k.shape != (b, sk, kv, d) or v.shape != k.shape or h % kv
            or d > MAX_HEAD_DIM):
        raise ValueError(
            f"flash_attention: q (B,Sq,H,D) and k, v (B,Sk,KV,D) of one dtype "
            f"(bf16/float32), KV dividing H, D <= {MAX_HEAD_DIM}; got q {q.dtype} "
            f"{tuple(q.shape)}, k {k.dtype} {tuple(k.shape)}, v {tuple(v.shape)}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.call(f"flash_attention_{build.DTYPE_SUFFIX[q.dtype]}", _ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, sq, sk, h, kv, d, scale, int(causal), window or 0, kv_offset,
               build.stream(q.device))
    build.count(flash_attention)
    return out


flash_attention.launches = 0   # kernel launches, for showing a run went through it
