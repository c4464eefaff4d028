"""The collective traffic of one step, counted as an eager meshed step
issues it.

The port of ``repro/analysis/hlo.py`` (``collect``) and of
``repro/analysis/roofline.py``'s ``parse_collectives``.  The JAX package
parses the partitioned HLO of a compiled step; the port has no HLO, so
it runs the step (on a ``DeviceMesh``, with ``meta`` local tensors or
real ones) under a ``TorchDispatchMode`` that sees every collective the
step issues on this rank: the functional collectives DTensor and the
model code call (``_c10d_functional``: ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` and their coalesced forms), the in-place ``c10d``
ones (``dist.all_reduce`` in the sorted MoE's within-expert sum), and the
``send`` of each ``batch_isend_irecv`` hop of the int8 ring, the
counterpart of a ``collective-permute`` (its ``recv`` is the same hop's
other end and is not counted again).  ``wait_tensor`` and
``_wrap_tensor_autograd`` move nothing.

Every rank of an SPMD step issues the same collectives, so this rank's
are the step's.  Each op is priced as JAX prices it, on the per-device
result bytes at the op's group size g (taken from its process group; a
group of 1 moves nothing and is skipped, as JAX skips g <= 1): all-reduce
2(g-1)/g, all-gather (g-1)/g of the gathered result, reduce-scatter
(g-1) times the scattered result, all-to-all (g-1)/g, permute 1x; then
times ``n_devices`` for the whole mesh's traffic.  Python loops run, so
there is no trip count to multiply (``hlo.py``'s while-loop walk has no
counterpart).

Where DTensor, the port's code and XLA's partitioner choose differently,
the two counts differ by class (``tests/test_torch_dryrun.py`` holds the
rest equal, on four computations and, role by role, on the reduced
qwen2.5-3b decode and train steps at (2, 4)):

1. **A reshard between two split dims.**  On a CPU mesh DTensor turns
   ``Shard(i) -> Shard(j)`` into an all-gather and a local chunk ("CPU
   process group does not support alltoall yet"); XLA emits an
   all-to-all.  The MoE's own ``all_to_all_single`` is not affected.
2. **A sum over several mesh dims.**  ``(Partial, Partial) -> Replicate``
   runs one all-reduce a mesh dim; XLA runs one over the flattened group.
3. **The dtype on the wire.**  XLA's CPU backend moves bf16 collectives
   as float32 (the tensor-parallel partial sums, the FSDP weight
   gathers): twice the bytes, the same elements.
4. **Combined collectives.**  XLA's combiner merges independent
   collectives of one step into one op (the sorted MoE's two rounds'
   within-expert sums; a train step's gradient, norm and loss sums);
   eager code issues each: more ops, the same bytes.
5. **A product over a split contraction.**  Where a hidden split over
   "model" meets a replicated weight (the MoE's shared expert), XLA
   gathers the hidden first (an all-gather); DTensor multiplies the
   shards and all-reduces the partial result: the same bytes, twice the
   wire.
6. **A cache split over its capacity** (decode).  The port gathers each
   layer's K/V cache whole (`ops.decode_attention`'s ``local_map``: its
   kernel takes the whole cache); XLA scores each shard and all-reduces
   the softmax's max, sum and output, with a few small all-gathers,
   all-to-alls and permutes for the new slot.
7. **An embedding over a split vocabulary.**  The port gathers the table
   whole for every lookup (`sharding_ctx.lookup`) and reduce-scatters its
   gradient; XLA looks up in each shard, masked, and all-reduces the
   (B, S, D) rows.
8. **The loss over split logits.**  The port gathers the logits whole
   over "model" (and the head's weight over the data axes) in
   ``chunked_lm_loss``; XLA all-reduces the max and sum statistics.
9. **The output's layout.**  The JAX dry run pins the decode logits
   replicated (``out_shardings``), an all-gather; the port returns them
   as the step made them.
10. **FSDP gradients.**  DTensor reduce-scatters each gradient to its
    parameter's layout; XLA all-reduces them (combined, class 4).
11. **Rematerialisation.**  The JAX train step recomputes checkpointed
    forward parts in its backward, their collectives with them; the
    eager step does not.

Classes 6-8 are the port's own choices and move far more than XLA would
(6 and 7 are 0.976 of the reduced qwen2.5-3b decode step's wire bytes);
at production widths they decide the collective term.  DTensor's choices
are its version's: the same step counts other collectives under
another torch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from .roofline import CollectiveStats

# schema name -> (kind, where the result is): "out" the op's result, or the
# index of the argument that holds it (the in-place c10d ops)
OPS = {
    "_c10d_functional::all_reduce": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out"),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 0),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d::alltoall_": ("all-to-all", 0),
    "c10d::alltoall_base_": ("all-to-all", 0),
    "c10d::send": ("collective-permute", 0),
}

# the per-device wire bytes of one op of each kind, from its per-device
# result bytes b at group size g (``roofline.parse_collectives``)
RING = {
    "all-reduce": lambda b, g: 2 * (g - 1) / g * b,
    "all-gather": lambda b, g: (g - 1) / g * b,
    "reduce-scatter": lambda b, g: (g - 1) * b,
    "all-to-all": lambda b, g: (g - 1) / g * b,
    "collective-permute": lambda b, g: b,
}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _group_size(func, args) -> int:
    """The size of the op's process group: a functional op names it (its
    last string argument), a c10d op passes it (boxed)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    names = [a for a in args if isinstance(a, str)]
    if not names:
        raise TypeError(f"{func}: no process group among its arguments "
                        f"{[type(a).__name__ for a in args]}")
    return _resolve_process_group(names[-1]).size()


class _Counter(TorchDispatchMode):
    def __init__(self, n_devices: int):
        super().__init__()
        self.n = n_devices
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: the collectives it issues to reshard its
            # arguments then come back here on local tensors (called from
            # here, they would run with this mode off, unseen)
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        op = OPS.get(func._schema.name)
        if op is not None:
            kind, where = op
            g = _group_size(func, args)
            if g > 1:
                result = out if where == "out" else args[where]
                b = float(sum(t.numel() * t.element_size() for t in _tensors(result)))
                st = self.stats
                st.op_bytes[kind] = st.op_bytes.get(kind, 0.0) + b * self.n
                st.wire_bytes[kind] = st.wire_bytes.get(kind, 0.0) + RING[kind](b, g) * self.n
                st.counts[kind] = st.counts.get(kind, 0) + 1
        return out


def count_collectives(fn, *args, n_devices: int) -> CollectiveStats:
    """Run ``fn(*args)`` once on this rank and count the collectives it
    issues, as the whole ``n_devices`` mesh's traffic."""
    with _Counter(n_devices) as counter:
        fn(*args)
    return counter.stats
