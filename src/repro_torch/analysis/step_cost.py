"""Whole-step FLOP and byte counts by running the step on the meta device.

The port of ``repro/analysis/jaxpr_cost.py``.  The JAX package traces a
step into a jaxpr and walks it; the port runs the step itself, on
tensors of the ``meta`` device (`launch.steps.input_specs`: shapes and
dtypes, no storage), under a ``TorchDispatchMode`` that sees every ATen
op the step dispatches.  Python loops run, so they need no trip-count
rule; a train step's backward is counted as autograd runs it, the
recomputation of ``torch.utils.checkpoint`` included.  Count the plain
versions (``impl="ref"``): on the meta device the kernels' wrappers would
take the card's route, and the JAX count traces its oracles too.

flops:       2*M*N*K per matrix product (``mm``, ``addmm``, ``bmm``,
             ``baddbmm``, ``mv``, ``dot``; batch dimensions included).
major_bytes: operand and result bytes of those products (not the added
             term of ``addmm``/``baddbmm``, which JAX adds in a separate
             op; a broadcast axis once) and of the gathers, scatters and indexed writes
             (`MAJOR`), the counterparts of the JAX count's
             ``dot_general``, ``gather``, ``scatter``, ``scatter-add`` and
             ``dynamic_update_slice``.  Elementwise chains are left out,
             as there.

``count_step(fn, *args)`` returns a `Cost`; its ``by_op`` splits both
counts by ATen op, for comparing op classes with the JAX count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

# matrix products: (op, index of the first factor)
PRODUCTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
            _aten.dot.default: 0, _aten.addmm.default: 1, _aten.baddbmm.default: 1}

# gathers, scatters and indexed writes: every tensor operand and result
MAJOR = {
    _aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
    _aten.embedding.default, _aten.take.default,
    _aten.index_add.default, _aten.index_add_.default, _aten.index_copy.default,
    _aten.index_copy_.default, _aten.index_put.default, _aten.index_put_.default,
    _aten._index_put_impl_.default, _aten.scatter.src, _aten.scatter_.src,
    _aten.scatter.value, _aten.scatter_.value, _aten.scatter_add.default,
    _aten.scatter_add_.default, _aten.embedding_dense_backward.default,
}


def _nbytes(t) -> float:
    """The bytes of the distinct elements ``t`` addresses: a broadcast
    (stride-0) axis counts once, as ``torch.matmul`` hands ``bmm`` a
    weight expanded over the batch that it reads from one copy."""
    if not isinstance(t, torch.Tensor):
        return 0.0
    return float(math.prod(n for n, s in zip(t.shape, t.stride()) if s)) * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's arguments or result (lists of indices included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _product_flops(func, args) -> float:
    a, b = args[PRODUCTS[func]], args[PRODUCTS[func] + 1]
    if func is _aten.dot.default:
        return 2.0 * a.shape[0]
    if func is _aten.mv.default:
        return 2.0 * a.shape[0] * a.shape[1]
    *batch, m, k = a.shape
    return 2.0 * math.prod(batch) * m * k * b.shape[-1]


@dataclass
class Cost:
    flops: float = 0.0
    major_bytes: float = 0.0
    by_op: dict = field(default_factory=dict)      # ATen op name -> [flops, bytes]


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def _add(self, func, flops: float, nbytes: float) -> None:
        entry = self.cost.by_op.setdefault(func.name(), [0.0, 0.0])
        entry[0] += flops
        entry[1] += nbytes
        self.cost.flops += flops
        self.cost.major_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            # operands before the call: an in-place product (``out=``) does
            # not change them
            first = PRODUCTS[func]
            operands = sum(_nbytes(t) for t in args[first:first + 2])
            out = func(*args, **kwargs)
            self._add(func, _product_flops(func, args), operands + _nbytes(out))
            return out
        if func in MAJOR:
            operands = sum(_nbytes(t) for t in _tensors(list(args) + list(kwargs.values())))
            out = func(*args, **kwargs)
            self._add(func, 0.0, operands + sum(_nbytes(t) for t in _tensors(out)))
            return out
        return func(*args, **kwargs)


def count_step(fn, *args) -> Cost:
    """Run ``fn(*args)`` once (meta tensors: nothing is computed or
    allocated) and count its global FLOPs and major bytes."""
    with _Counter() as counter:
        fn(*args)
    return counter.cost
