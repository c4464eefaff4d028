"""Minimal optimizer API, ported from ``repro/optim/api.py``.

The JAX optimizer is a pair of pure functions over pytrees; the port's
works on ``dict[name, Tensor]`` keyed by the names of
``model.named_parameters()`` and updates in place: at 3.4 B float32
parameters a second copy of the parameters or the moments would not fit
the card beside them.
"""
from __future__ import annotations

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


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    from .adafactor import adafactor
    from .adamw import adamw
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name}")


def jax_rank(name: str, p) -> int:
    """The rank the JAX package's optimizer sees for parameter ``name``: it
    stacks each layer's leaves over layer periods, so a leaf under
    ``layers.`` or ``enc_layers.`` has one more axis there (a layer's norm
    or bias is a matrix, and AdamW decays it)."""
    return p.ndim + (1 if name.startswith(("layers.", "enc_layers.")) else 0)
