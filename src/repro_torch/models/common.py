"""Shared model utilities: dtypes, init, norm, rope, activations, the LM loss.

Ported from ``repro/models/common.py``.  Parity with the JAX package goes
through ``bridge.py`` (its PRNG streams cannot be matched); `dense_init`
gives shape-compatible random weights on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from .. import sharding_ctx as sc
from ..kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(shape, dtype, *, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (at +-2) fan-in init, drawn in float32 on
    ``device`` from ``generator`` (which lives on that device)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    # inverse-CDF sampling of the standard normal truncated to [-2, 2]
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2)).clamp_(-2, 2).mul_(scale)
    return t.to(dtype)


def rmsnorm(x, w, eps: float = 1e-5, impl: str | None = None):
    return ops.rmsnorm(x, w, eps=eps, impl=impl)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding.  x: (..., S, H, D) with positions (..., S): the
    non-interleaved halves rotate by float32 angles, an odd head-dim tail
    passes through, and the result is cast back to x's dtype."""
    d = x.shape[-1]
    d2 = d // 2
    freq = theta ** (-torch.arange(0, d2, dtype=torch.float32, device=x.device) / d2)
    angles = positions[..., None].float() * freq               # (..., S, d2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, d2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * d2 < d:
        rot = torch.cat([rot, x[..., 2 * d2:].float()], dim=-1)
    return rot.to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":      # jax.nn.gelu's default is the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def _chunk_nll(xc, head_c, lc, mc):
    xc = sc.act(xc, "dp", None, None)
    logits = sc.act((xc @ head_c).float(), "dp", None, "tp")
    lse = torch.logsumexp(logits, dim=-1)
    if hasattr(logits, "placements"):
        # a DTensor split over the vocabulary: the label's logit as a masked
        # sum (exact: one term and zeros), which each vocab shard takes
        # locally; DTensor's gather on a split dim is not used
        pick = lc[..., None] == torch.arange(logits.shape[-1], device=lc.device)
        ll = torch.where(pick, logits, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
    return ((lse - ll) * mc).sum(), mc.sum()


def chunked_lm_loss(x, head, labels, mask=None, chunk: int = 512):
    """LM cross-entropy without keeping (B, S, V) logits: the mean of the
    masked next-token losses, over chunks of ``chunk`` positions.

    x: (B, S, D) final hidden states; head: (D, V), cast once to x's dtype;
    labels: (B, S) integers; mask: (B, S) 0/1 or None.  Each chunk's
    float32 logits are recomputed in the backward pass (``checkpoint``, as
    the JAX package's ``@jax.checkpoint``): autograd keeps no chunk's
    (B, chunk, V) logits, 1.2 GB a micro-batch of B 2 at qwen2.5-3b's
    vocabulary over seq 4096.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    nb = -(-S // chunk)
    pad = nb * chunk - S
    labels = labels.long()
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device) if mask is None
            else mask.float())
    if pad:
        x = sc.pad(x, (0, 0, 0, pad))
        labels = sc.pad(labels, (0, pad))
        mask = sc.pad(mask, (0, pad))
    head_c = head.to(x.dtype)
    nll = cnt = 0.0
    for i in range(nb):
        sl = slice(i * chunk, (i + 1) * chunk)
        a, b = ckpt.checkpoint(_chunk_nll, x[:, sl], head_c, labels[:, sl], mask[:, sl],
                               use_reentrant=False)
        nll = nll + a
        cnt = cnt + b
    return nll / torch.clamp(cnt, min=1.0)
