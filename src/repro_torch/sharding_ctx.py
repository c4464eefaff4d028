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
