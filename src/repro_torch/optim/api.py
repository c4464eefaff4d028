"""Minimal optimizer API, ported from ``repro/optim/api.py``.

The JAX optimizer is a pair of pure functions over pytrees; the port's
works on ``dict[name, Tensor]`` keyed by the names of
``model.named_parameters()`` and updates in place: at 3.4 B float32
parameters a second copy of the parameters or the moments would not fit
the card beside them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params, step)``
    writes the new parameters and state into ``params`` and ``state`` and
    returns them.  ``step`` is the host's step count (an int), as the JAX
    update's ``step`` argument."""

    init: Callable
    update: Callable
    name: str = "opt"


def get_optimizer(name: str, lr, *, cfg=None, **kw) -> Optimizer:
    """``cfg``: the model's config, for Adafactor's clip over the JAX
    leaves (`jax_leaf_groups`)."""
    from .adafactor import adafactor
    from .adamw import adamw
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        if cfg is not None:
            kw.setdefault("leaf_groups", functools.partial(jax_leaf_groups, cfg))
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name}")


def jax_rank(name: str, p) -> int:
    """The rank the JAX package's optimizer sees for parameter ``name``: it
    stacks each layer's leaves over layer periods, so a leaf under
    ``layers.`` or ``enc_layers.`` has one more axis there (a layer's norm
    or bias is a matrix, and AdamW decays it)."""
    return p.ndim + (1 if name.startswith(("layers.", "enc_layers.")) else 0)


def jax_leaf_groups(cfg, names) -> list:
    """``names`` (the port's parameter names) grouped into the JAX
    package's leaves: layer ``p * len(pattern) + i`` under ``layers.`` or
    ``enc_layers.`` is period p of the leaf ``<stack>.pos<i>.<rest>``, so
    each group holds one name at every period, in period order; every
    other name is a group of its own."""
    n = len(cfg.block_pattern)
    groups: dict = {}
    for name in names:
        stack, _, rest = name.partition(".")
        layer, _, leaf = rest.partition(".")
        key = (stack, int(layer) % n, leaf) if stack in ("layers", "enc_layers") else name
        groups.setdefault(key, []).append(name)
    return [sorted(g, key=lambda k: int(k.split(".")[1])) if len(g) > 1 else g
            for g in groups.values()]
