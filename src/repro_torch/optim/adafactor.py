"""Adafactor (Shazeer & Stern, 2018), factored second moments, ported from
``repro/optim/adafactor.py``: the same update, on ``dict[name, Tensor]``,
in place.  A tensor with ``ndim >= 2`` whose last two dims are both at
least ``min_dim_size_to_factor`` keeps a row and a column moment; any
other tensor a full one.  Weight decay takes the rank in the JAX layout
(`api.jax_rank`).

The update is clipped to an RMS of at most ``clip_threshold``, the RMS
taken over one JAX leaf.  The JAX package stacks a layer's tensor over
the layer periods, so one leaf there is every port tensor of the same
name at layers ``p * len(pattern) + i``, all periods p: ``leaf_groups``
(names -> lists of names, `api.jax_leaf_groups` of the config, which
`api.get_optimizer` passes given ``cfg``) says which tensors share a
clip.  Without it each tensor is a leaf of its own, as the embedding,
the head and the final norm are, and as the LM pipeline's stage
parameters are in the JAX package too.  The moments need no grouping:
they are factored over the last two axes, so each period's are its own
there as well."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .api import Optimizer, jax_rank


def adafactor(lr, *, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128,
              leaf_groups: Callable[[list], list] | None = None) -> Optimizer:
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

    def step_of(g, s, p, beta):
        """Updates ``p``'s moments ``s`` in place; returns its unclipped update."""
        g2 = torch.square(g) + eps
        if factored(p):
            s["vr"].mul_(beta).add_(g2.mean(dim=-1), alpha=1 - beta)
            s["vc"].mul_(beta).add_(g2.mean(dim=-2), alpha=1 - beta)
            vr, vc = s["vr"], s["vc"]
            denom = (vr[..., None] / torch.clamp(
                vr.mean(dim=-1, keepdim=True)[..., None], min=eps)) * vc[..., None, :]
            return g * torch.rsqrt(torch.clamp(denom, min=eps))
        s["v"].mul_(beta).add_(g2, alpha=1 - beta)
        return g * torch.rsqrt(torch.clamp(s["v"], min=eps))

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int):
        t = np.float32(step) + np.float32(1)
        beta = float(min(np.float32(1) - t ** np.float32(-0.8), np.float32(decay)))
        lr_t = float(lr_fn(step))
        groups = leaf_groups(list(params)) if leaf_groups else [[k] for k in params]
        for group in groups:
            updates = [step_of(grads[k].float(), state["f"][k], params[k], beta) for k in group]
            # update clipping (RMS <= clip_threshold) over the whole JAX leaf
            sq = sum(torch.sum(torch.square(u)) for u in updates)
            rms = torch.sqrt(sq / sum(u.numel() for u in updates) + 1e-30)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for k, u in zip(group, updates):
                p = params[k]
                newp = p.float() - lr_t * (u / scale)
                if weight_decay and jax_rank(k, p) >= 2:
                    newp = newp - lr_t * weight_decay * p.float()
                p.copy_(newp.to(p.dtype))
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")
