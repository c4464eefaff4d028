"""Plain PyTorch oracles, ported from ``repro.kernels.ref``.

The simplest correct definition of each op the slice's kernels compute:
attention materialises every logit and repeats the KV heads for GQA.
``ops`` runs these under ``impl="ref"`` on either device; the tests hold
the kernels' plain versions against the JAX package's kernels with them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, kv_offset: int = 0):
    """Multi-head attention oracle.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H a multiple of KV (GQA).
    ``kv_offset``: absolute position of q[0] minus k[0] (decode: Sk-Sq).
    ``window``: sliding-window width (attend to the last `window` keys).
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         window: int | None = None, scale: float | None = None):
    """Single-token decode attention over a (possibly ring-buffered) cache.

    q: (B, H, D); caches: (B, C, KV, D); cache_len: the number of valid
    slots, an int or a () or (B,) integer tensor.  Once a ring buffer has
    wrapped, callers pass cache_len == capacity.
    """
    b, h, d = q.shape
    _, c, kv, _ = k_cache.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    kf = torch.repeat_interleave(k_cache.float(), rep, dim=2)
    vf = torch.repeat_interleave(v_cache.float(), rep, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float() * scale, kf)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    idx = torch.arange(c, device=q.device)[None, :]
    mask = idx < clen                                   # (1 or B, C)
    if window is not None:
        mask &= idx >= clen - window
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vf)
    return out.to(q.dtype)


def rmsnorm_reference(x, w, eps: float = 1e-5):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)
