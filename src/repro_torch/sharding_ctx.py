"""Activation-sharding context, threaded through model code; ported from
``repro/sharding_ctx.py``.

Dependency-free (models must not import the launcher).  When active, the
model pins key activation layouts, so DTensor's sharding propagation
keeps the batch sharded where the JAX package pins it with
``with_sharding_constraint``.  Model code calls the module-level `act`
helper with symbolic axes:

    q = sc.act(q, "dp", None, "tp", None)     # (B, S, H, hd)

which is a no-op unless a `ShardCtx` is activated.  Symbols: ``"dp"`` =
the data axes (batch), ``"tp"`` = the model axis.  Axes that do not
divide the dim are dropped per-dim (small models / odd head counts stay
unsharded rather than erroring).

The SPMD difference: a pin is ``DTensor.redistribute`` to the spec's
placements (a collective where the layout changes), applied eagerly at
the call.  A plain tensor passes through unchanged, so the one-device
path, and the constants model code makes (positions, masks), are not
touched; while a context over a ``DeviceMesh`` is active, DTensor treats
such plain tensors as replicated (``implicit_replication``), which they
are: every rank makes the same ones.  With no context a pin costs one
``None`` check.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ShardCtx:
    mesh: Any                     # a DeviceMesh, or launch.mesh.AbstractMesh
    dp: tuple[str, ...]           # data axes (batch)
    tp: str = "model"
    sp: bool = False              # Megatron-style sequence parallelism:
                                  # residual stream's seq dim sharded over tp
    ep_data: bool = False         # experts live on the data axes (a2a
                                  # dispatch); False: experts on the model
                                  # axis (the naive EP baseline)

    def _resolve(self, ax):
        if ax == "dp":
            return self.dp
        if ax == "tp":
            return self.tp
        if ax == "sp":
            return self.tp if self.sp else None
        if ax == "ep":
            return ("data",) if self.ep_data else self.tp
        if ax == "ep_tok":            # token dim of the dispatched tensor
            return None if self.ep_data else self.dp
        return ax

    def _size(self, axis: str) -> int:
        from .launch.mesh import axis_sizes
        return axis_sizes(self.mesh)[axis]

    def _ok(self, dim: int, axes) -> bool:
        if axes is None:
            return False
        n = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= self._size(a)
        return dim % n == 0

    def spec(self, shape, *axes):
        """The PartitionSpec `pin` gives a tensor of ``shape``."""
        from .launch.sharding import PartitionSpec
        spec = []
        for dim, ax in zip(shape, axes):
            ax = self._resolve(ax)
            spec.append(ax if self._ok(dim, ax) else None)
        while len(spec) < len(shape):
            spec.append(None)
        return PartitionSpec(*spec)

    def pin(self, x, *axes):
        """Lay x out as ``axes`` say (axes[i] is the mesh axis, or None, for
        dim i): a DTensor is redistributed; anything else passes."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        from .launch.sharding import to_placements
        want = to_placements(self.spec(x.shape, *axes), self.mesh)
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(self.mesh, want)

    def batch(self, x):
        return self.pin(x, "dp")

    def batch_seq(self, x):
        """(B, S, D): batch over dp, features replicated."""
        return self.pin(x, "dp", None, None)

    def logits(self, x):
        """(B, S, V): batch over dp, vocab over tp."""
        return self.pin(x, "dp", None, "tp")

    def n_devices(self) -> int:
        from .launch.mesh import mesh_device_count
        return mesh_device_count(self.mesh)


# -- module-level activation (used by model code without signature churn) ---
_ACTIVE: ShardCtx | None = None


@contextlib.contextmanager
def activate(ctx: ShardCtx | None):
    """Make ``ctx`` the active sharding context; over a ``DeviceMesh``,
    plain tensors meeting DTensors count as replicated meanwhile."""
    global _ACTIVE
    old = _ACTIVE
    _ACTIVE = ctx
    try:
        if ctx is not None and hasattr(ctx.mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                yield ctx
        else:
            yield ctx
    finally:
        _ACTIVE = old


def current() -> ShardCtx | None:
    return _ACTIVE


def act(x, *axes):
    """Pin an activation if a context is active; identity otherwise."""
    if _ACTIVE is None or x is None:
        return x
    return _ACTIVE.pin(x, *axes)


def heads(x, n: int):
    """x (..., n * d) laid out so that a view of its last dim as (n, d)
    splits no group: the mesh dims that split the last dim are replicated
    where their shards do not divide ``n`` (the all-gather GSPMD inserts
    at such a reshape; DTensor refuses the view).  Where they divide,
    the layout stays.  Identity with no context and on a plain tensor."""
    if _ACTIVE is None or x is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim % x.ndim == last]
    shards = 1
    for i in split:
        shards *= x.device_mesh.size(i)
    if n % shards == 0:
        return x
    placements = [Replicate() if i in split else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, placements)


def lookup(table, ids):
    """``table[ids]``: rows (..., D) of ``table`` (V, D).  Under a context,
    on a DTensor table, each rank looks its own ids up in the whole table
    (gathered over the mesh dims that split it, as an FSDP weight is), the
    rows laid out as the ids are; the table's gradient is a partial sum
    over the mesh dims that split the ids, reduced to the table's layout.
    DTensor's own ``index_put`` strategy (the lookup's backward) fails for
    ids split over the data axes in some torch versions (2.11)."""
    if _ACTIVE is None:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim)
    by_ids = list(ids.placements)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in by_ids]
    return local_map(lambda t, i: t[i], out_placements=by_ids,
                     in_placements=([Replicate()] * mesh.ndim, by_ids),
                     in_grad_placements=(grad, by_ids), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def pad(x, pads, value: float = 0.0):
    """``F.pad(x, pads, value=value)``.  Under a context, on a DTensor each
    rank pads its own shard, the padded dims made whole first (the seq dim
    under sequence parallelism); DTensor's own strategy for it fails in
    some torch versions (2.11)."""
    import torch.nn.functional as F
    if _ACTIVE is None:
        return F.pad(x, pads, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(x, DTensor):
        return F.pad(x, pads, value=value)
    padded = {x.ndim - 1 - i for i in range(len(pads) // 2) if pads[2 * i] or pads[2 * i + 1]}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in padded else p for p in x.placements]
    return local_map(lambda t: F.pad(t, pads, value=value), out_placements=pl,
                     in_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def merge_heads(x):
    """x (..., n, d) as (..., n * d).  Under a context, on a DTensor, the
    mesh dims that split d are replicated first (a view cannot merge a
    split inner dim; some torch versions, 2.11, refuse to), and the
    gradient is brought back to the merged tensor's own layout before the
    view's backward, which would split it inside a group where the
    product after the merge splits it over a mesh dim that does not divide
    ``n`` (GSPMD gathers it there)."""
    if _ACTIVE is None:
        return x.flatten(-2)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.flatten(-2)
    inner = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1 else p
             for p in x.placements]
    if inner != list(x.placements):
        x = x.redistribute(x.device_mesh, inner)
    flat = x.flatten(-2)
    return flat.redistribute(flat.device_mesh, flat.placements)


def _capacity_shard(cache, new):
    """For a DTensor ``cache`` (B, C, ...): its local shard, ``new`` (B, n,
    ...) laid out as the cache is on every dim but C and taken local, and
    the first of the C slots the shard holds (mesh dims that split C do so
    in mesh order, major to minor).  None on a rank outside the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    splits_c = [i for i, p in enumerate(cache.placements) if isinstance(p, Shard) and p.dim == 1]
    want = [Replicate() if i in splits_c else p for i, p in enumerate(cache.placements)]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim)
    chunk, offset = cache.shape[1], 0
    for i in splits_c:
        chunk //= mesh.size(i)
        offset += coord[i] * chunk
    return cache.to_local(), new.redistribute(mesh, want).to_local(), offset


def write_slot(cache, slot, new) -> None:
    """``cache[:, slot] = new`` in place: cache (B, C, ...), new (B, 1, ...),
    slot a (1,) long device index.  On a DTensor cache each rank writes its
    own shard, as GSPMD's ``dynamic_update_slice`` does: where mesh dims
    split C, the rank whose range holds the slot writes it (a masked
    write: no host sync, no collective).  DTensor's own in-place
    ``index_copy_`` relabels a sharded cache as replicated and keeps the
    shard."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, new)
        return
    got = _capacity_shard(cache, new)
    if got is None:
        return
    import torch
    local, new, offset = got
    slot = slot.to_local() if isinstance(slot, DTensor) else slot
    if local.shape[1] == cache.shape[1]:
        local.index_copy_(1, slot, new)
        return
    idx = slot - offset
    inside = ((idx >= 0) & (idx < local.shape[1])).view(1, 1, *([1] * (local.ndim - 2)))
    idx = idx.clamp(0, local.shape[1] - 1)
    local.index_copy_(1, idx, torch.where(inside, new, local.index_select(1, idx)))


def write_prefix(cache, new) -> None:
    """``cache[:, :n] = new`` in place, n = ``new.shape[1]`` <= C.  On a
    DTensor cache each rank copies its own range of the n slots (a slice
    of a DTensor along a split dim is a copy, which a write would miss)."""
    from torch.distributed.tensor import DTensor
    n = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :n].copy_(new)
        return
    got = _capacity_shard(cache, new)
    if got is None:
        return
    local, new, offset = got
    end = min(local.shape[1], n - offset)
    if end > 0:
        local[:, :end].copy_(new[:, offset:offset + end])


def place_cache(cfg, cache):
    """A fresh decode cache (`models.lm.init_cache`) placed by
    `launch.sharding.cache_specs` (the default policy) when a context over
    a ``DeviceMesh`` is active; as it is otherwise."""
    ctx = _ACTIVE
    if ctx is None or not hasattr(ctx.mesh, "mesh_dim_names"):
        return cache
    from .launch import sharding as shd
    specs = shd.cache_specs(ctx.mesh, cache, cfg, shd.ShardingPolicy())
    return shd.tree_map(lambda t, s: shd.place(t, shd.NamedSharding(ctx.mesh, s)),
                        cache, specs)


def from_mesh(mesh, *, sp: bool = False, ep_data: bool = False) -> ShardCtx:
    """Build a ShardCtx from a mesh with ("pod",)? "data" + "model" axes."""
    from .launch.mesh import axis_names
    dp = tuple(a for a in axis_names(mesh) if a != "model")
    return ShardCtx(mesh=mesh, dp=dp, tp="model", sp=sp, ep_data=ep_data)
