"""Single-token attention-sublayer step for decode, composed route.

One decode token through an attention sublayer: rmsnorm -> Q/K/V
projections (+bias) -> rope at ``pos`` -> ring-slot write -> decode
attention -> output projection -> residual.  Ported from
``repro/kernels/fused_decode.py``'s `_composed_step`.  The projections are
plain ``torch.matmul``, outside any kernel, as the JAX package leaves them
to XLA; the norm and the attention are this package's CUDA kernels on the
card.  The ring slot ``pos % C`` is written in place with a device index
and the attention reads ``cache_len = min(pos + 1, C)`` from device
memory, so the step makes no host sync and allocates no cache.

The JAX module's single-kernel sublayer (`_fused_kernel`) is not ported
yet, so every shape takes this route.  The rope math is a local copy of
``models.common.rope``: kernels do not import models.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention
from .rmsnorm import rmsnorm


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


def _composed_step(x, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo,
                   bq, bk, bv, n_heads, head_dim, eps, theta, scale):
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


def attn_decode_step(x, k_cache, v_cache, pos, *, norm, wq, wk, wv, wo,
                     bq=None, bk=None, bv=None, n_heads, head_dim,
                     eps=1e-5, rope_theta=10_000.0):
    """One-token attention sublayer: x (B, 1, D) and pos, a () int32 device
    tensor -> out (B, 1, D); slot ``pos % C`` of both caches (B, C, KV, hd)
    is written in place."""
    return _composed_step(
        x, k_cache, v_cache, pos, norm=norm, wq=wq, wk=wk, wv=wv, wo=wo,
        bq=bq, bk=bk, bv=bv, n_heads=n_heads, head_dim=head_dim, eps=eps,
        theta=rope_theta, scale=head_dim ** -0.5)
