"""The training step, ported from ``repro/launch/steps.py``
(`make_train_step`; the JAX package's prefill and decode steps are the
port's `models.lm.prefill` / `decode_step`, and it has no abstract specs:
PyTorch runs eagerly).

``train_step(model, opt_state, step, batch)`` updates the model's
parameters and ``opt_state`` in place and returns the metrics.  Batch
leaves are device tensors shaped (accum, micro_batch, seq).  Each
micro-batch's loss is differentiated in turn; with float32 masters the
gradients accumulate in float32 in ``.grad`` (the first micro-batch's
gradient, then each next one added, as JAX's ``_tree_add`` over zeros),
then the sum is divided by ``accum`` and one optimizer update is applied.
A parameter the loss does not reach (the norm of a width-0 MLP, as in
mamba2-370m) gets a zero gradient, as ``jax.grad`` gives it, and takes the
optimizer's update (its weight decay) like every other.  The gradients
stay in ``.grad`` after the step, for inspection.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..optim import cosine_schedule, get_optimizer


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, warmup: int = 2000,
                    total_steps: int = 100_000, grad_accum: int | None = None,
                    impl: str | None = None):
    """(optimizer, train_step) for ``cfg``: ``cfg.optimizer`` on the cosine
    schedule, as the JAX package wires it."""
    opt = get_optimizer(cfg.optimizer, cosine_schedule(lr, warmup, total_steps), cfg=cfg)
    accum = grad_accum or cfg.grad_accum

    def train_step(model: lm.LM, opt_state: dict, step: int, batch: dict) -> dict:
        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        if not params:
            raise ValueError("the model has no trainable parameters: build it with "
                             "param_dtype (lm.init_params / bridge.from_jax)")
        for p in params.values():
            p.grad = None
        if batch["tokens"].shape[0] != accum:
            raise ValueError(f"batch leading dim {batch['tokens'].shape[0]} != accum {accum}")
        lsum = 0.0
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss, _ = lm.loss_fn(cfg, model, mb, impl=impl)
            loss.backward()
            lsum = lsum + loss.detach()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in params.items()}
        if accum > 1:
            for g in grads.values():
                g.div_(accum)
        opt.update(grads, opt_state, params, step)
        return {"loss": lsum / accum, "step": step + 1}

    return opt, train_step
