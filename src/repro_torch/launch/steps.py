"""Step builders and their abstract inputs, ported from
``repro/launch/steps.py``.

``make_train_step`` gives ``train_step(model, opt_state, step, batch)``,
which updates the model's parameters and ``opt_state`` in place and
returns the metrics.  Batch leaves are tensors shaped (accum,
micro_batch, seq).  Each micro-batch's loss is differentiated in turn;
with float32 masters the gradients accumulate in float32 in ``.grad``
(the first micro-batch's gradient, then each next one added, as JAX's
``_tree_add`` over zeros), then the sum is divided by ``accum`` and one
optimizer update is applied.  A parameter the loss does not reach (the
norm of a width-0 MLP, as in mamba2-370m) gets a zero gradient, as
``jax.grad`` gives it, and takes the optimizer's update (its weight
decay) like every other.  The gradients stay in ``.grad`` after the
step, for inspection.  Under a mesh the parameters are DTensors, and
each gradient is redistributed to its parameter's placements before the
update, as GSPMD gives a gradient its parameter's sharding.
``make_prefill_step`` and ``make_decode_step``
wrap `models.lm.prefill` and ``decode_step``.

The abstract inputs are the JAX package's ``jax.ShapeDtypeStruct``
stand-ins on the ``meta`` device: tensors with a shape and a dtype and no
storage.  `abstract_params` is an `models.lm.LM` built there,
`abstract_opt_state` the optimizer's state of it, `abstract_cache`
``lm.init_cache`` there, `batch_struct` the batch; `input_specs` gives a
cell's step with all of them, as a `StepBundle`.  Nothing is allocated,
so a config no card holds (jamba-1.5-large-398b: 398 B parameters) is
described at full size; `analysis.step_cost.count_step` runs the bundle
to count its FLOPs and bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..models import lm
from ..models.common import dtype_of
from ..optim import cosine_schedule, get_optimizer

META = torch.device("meta")


@dataclass
class StepBundle:
    """A step function and the abstract arguments (meta tensors, an `LM`
    on the meta device) to run or count it with."""
    fn: Callable
    arg_specs: tuple
    kind: str


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
            elif hasattr(p, "placements") and p.grad.placements != p.placements:
                # a DTensor's gradient, partial where its use was split, takes
                # the parameter's layout (a reduce-scatter or an all-reduce)
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        grads = {k: p.grad for k, p in params.items()}
        if accum > 1:
            for g in grads.values():
                g.div_(accum)
        opt.update(grads, opt_state, params, step)
        return {"loss": lsum / accum, "step": step + 1}

    return opt, train_step


def make_prefill_step(cfg: ModelConfig, *, capacity: int | None = None,
                      impl: str | None = None):
    """(model, ``step(params, batch) -> (logits, cache)``): `lm.prefill`
    with no gradient, the cache at ``capacity``."""
    model = lm.build_model(cfg, impl=impl)

    def step(params, batch):
        with torch.no_grad():
            return lm.prefill(cfg, params, batch, capacity=capacity, impl=impl)

    return model, step


def make_decode_step(cfg: ModelConfig, *, impl: str | None = None):
    """(model, ``decode(params, cache, tokens) -> (logits, cache)``):
    `lm.decode_step` with no gradient, the cache updated in place."""
    model = lm.build_model(cfg, impl=impl)

    def decode(params, cache, tokens):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens)

    return model, decode


# ===========================================================================
# abstract inputs (meta tensors: no allocation)
# ===========================================================================
def batch_struct(cfg: ModelConfig, shape: ShapeCfg, *, accum: int | None = None) -> dict:
    """A cell's training or prefill batch: int32 ``tokens`` (and ``labels``
    to train) of (B, S - prefix) or, with ``accum``, (accum, B / accum, S
    - prefix); bf16 ``prefix_embeds`` / ``frames`` where the config reads
    them."""
    B, S = shape.global_batch, shape.seq_len
    n_text = S - (cfg.num_prefix if cfg.frontend == "vit_stub" else 0)
    lead = (accum, B // accum) if accum else (B,)

    def make(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=META)
    batch: dict[str, Any] = {"tokens": make(*lead, n_text)}
    if shape.kind == "train":
        batch["labels"] = make(*lead, n_text)
    if cfg.frontend == "vit_stub":
        batch["prefix_embeds"] = make(*lead, cfg.num_prefix, cfg.d_model, dtype=torch.bfloat16)
    if cfg.encdec:
        batch["frames"] = make(*lead, cfg.num_prefix, cfg.d_model, dtype=torch.bfloat16)
    return batch


def abstract_params(cfg: ModelConfig, *, serving: bool = False) -> lm.LM:
    """The model's parameters on the meta device: the ``cfg.param_dtype``
    masters JAX ``init_params`` makes, or with ``serving`` the weights the
    server holds (the compute dtype, no gradients)."""
    if serving:
        return lm.LM(cfg, device=META)
    return lm.LM(cfg, device=META, param_dtype=dtype_of(cfg.param_dtype))


def abstract_opt_state(opt, params: lm.LM) -> dict:
    """``opt.init`` of the parameters' names and meta tensors."""
    return opt.init(dict(params.named_parameters()))


def abstract_cache(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """`lm.init_cache` for the cell's batch at its length, in bf16 (the
    JAX package's default), on the meta device."""
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=torch.bfloat16,
                         device=META)


def input_specs(cfg: ModelConfig, shape: ShapeCfg, *, impl: str | None = None,
                serving: bool = False) -> StepBundle:
    """The cell's step and its whole abstract argument tuple: train
    ``(params, opt_state, step, batch)`` (accum ``cfg.grad_accum``),
    prefill ``(params, batch)`` (capacity the sequence), decode ``(params,
    cache, tokens)`` (the cache at the sequence's length, tokens (B, 1)).
    ``serving``: as `abstract_params` (prefill and decode cells)."""
    if shape.kind == "train":
        opt, fn = make_train_step(cfg, impl=impl)
        params = abstract_params(cfg)
        batch = batch_struct(cfg, shape, accum=cfg.grad_accum)
        return StepBundle(fn, (params, abstract_opt_state(opt, params), 0, batch), "train")
    params = abstract_params(cfg, serving=serving)
    if shape.kind == "prefill":
        _, fn = make_prefill_step(cfg, capacity=shape.seq_len, impl=impl)
        return StepBundle(fn, (params, batch_struct(cfg, shape)), "prefill")
    _, fn = make_decode_step(cfg, impl=impl)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META)
    return StepBundle(fn, (params, abstract_cache(cfg, shape), tokens), "decode")
