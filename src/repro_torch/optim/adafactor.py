"""Adafactor (Shazeer & Stern, 2018), factored second moments, ported from
``repro/optim/adafactor.py``: the same update, on ``dict[name, Tensor]``,
in place.  A tensor with ``ndim >= 2`` whose last two dims are both at
least ``min_dim_size_to_factor`` keeps a row and a column moment; any
other tensor a full one.  Weight decay takes the rank in the JAX layout
(`api.jax_rank`).  The JAX package clips each update by the RMS of a
whole stacked leaf (every layer period at once); the port clips each
layer's tensor by its own: the same update on the same tensors, another
one on a stacked model.  No config the port trains uses Adafactor (the
400B-class configs that do are MoE, not ported)."""
from __future__ import annotations

import numpy as np
import torch

from .api import Optimizer, jax_rank


def adafactor(lr, *, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def factored(p) -> bool:
        return p.ndim >= 2 and min(p.shape[-2:]) >= min_dim_size_to_factor

    def init_leaf(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    def init(params: dict) -> dict:
        return {"f": {k: init_leaf(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int):
        t = np.float32(step) + np.float32(1)
        beta = float(min(np.float32(1) - t ** np.float32(-0.8), np.float32(decay)))
        lr_t = float(lr_fn(step))
        for k, p in params.items():
            s = state["f"][k]
            g = grads[k].float()
            g2 = torch.square(g) + eps
            if factored(p):
                s["vr"].mul_(beta).add_(g2.mean(dim=-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(dim=-2), alpha=1 - beta)
                vr, vc = s["vr"], s["vc"]
                denom = (vr[..., None] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=eps)) * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(torch.clamp(s["v"], min=eps))
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            newp = p.float() - lr_t * u
            if weight_decay and jax_rank(k, p) >= 2:
                newp = newp - lr_t * weight_decay * p.float()
            p.copy_(newp.to(p.dtype))
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")
