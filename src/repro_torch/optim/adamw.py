"""AdamW with decoupled weight decay and global-norm clipping, ported from
``repro/optim/adamw.py``: the same update, on ``dict[name, Tensor]``.

  * gradients scaled by ``min(1, clip_norm / max(global norm, 1e-9))``;
  * bias correction with ``t = step + 1``; ``eps`` outside the square root;
  * decoupled decay on tensors with ``ndim >= 2`` only, the rank taken in
    the JAX layout (`api.jax_rank`: a layer's norm and biases are decayed);
  * float32 ``m`` and ``v``; the result cast back to the parameter's dtype.

``torch.optim.AdamW`` differs (no clipping, decay on every tensor).  The
update runs leaf by leaf in place, so its scratch is one leaf's size.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import Optimizer, jax_rank


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32, on the device."""
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params: dict) -> dict:
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int):
        scale = 1.0
        if clip_norm is not None:
            gnorm = global_norm(grads.values())
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        t = np.float32(step) + np.float32(1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr_t = float(lr_fn(step))
        for k, p in params.items():
            m, v = state["m"][k], state["v"][k]
            g = grads[k].float() * scale
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g.square_(), alpha=1 - b2)
            denom = (v / bc2).sqrt_().add_(eps)
            step_val = (m / bc1).div_(denom)
            if jax_rank(k, p) >= 2:
                step_val.add_(p.float(), alpha=weight_decay)
            p.copy_((p.float() - lr_t * step_val).to(p.dtype))
        return params, state

    return Optimizer(init=init, update=update, name="adamw")
