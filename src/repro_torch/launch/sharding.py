"""Sharding rules: parameter, optimizer, batch and cache partition specs,
ported from ``repro/launch/sharding.py``, and their DTensor placements.

Name-based rules over parameter paths (t5x-style).  Policy:
  * TP over "model": attention head projections, MLP hidden, experts (EP),
    vocab (embedding rows / head columns), mamba inner dim.
  * FSDP over "data" (+"pod"): the non-TP matrix dim of every large weight,
    applied only when divisible (vocab is pre-padded so it always is).
  * Everything 1-D (norms, biases vectors) replicated.
Optimizer state inherits its parameter's spec.

A spec is a `PartitionSpec`: one entry a tensor dim, each None, an axis
name or a tuple of axis names, as in JAX.  `to_placements` turns it into
DTensor placements, one a mesh dim: ``Shard(d)`` where the mesh axis
appears in dim d's entry, ``Replicate()`` elsewhere.  A dim sharded over
("pod", "data") takes ``Shard(d)`` on both mesh dims, in mesh order,
which is JAX's major-to-minor.

The port's layers are unstacked (``layers.<i>.<part>.<name>``; a cache is
a list with one entry a layer), so the spec of a layer's leaf is JAX's
spec of the stacked leaf with its leading period entry dropped: the rules
read the same body dims.  Trees are the port's: an ``nn.Module`` (its
``named_parameters``), or nested dicts and lists of tensors, whose keys
are joined with "." into the path the rules read.

Every function takes an `AbstractMesh` or a ``DeviceMesh``; only
`NamedSharding.placements` users that build DTensors need a process group.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch
from torch import nn

from ..configs.base import ModelConfig
from .mesh import axis_names, axis_sizes, data_axes


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: a tuple with one entry a
    tensor dim.  As JAX's, it stores a one-axis tuple entry as the axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True            # shard params/opt-state over the data axes
    tp: bool = True              # tensor/expert parallelism over "model"
    seq_shard_cache: bool = False  # long-context: shard cache seq over data
    ep_axis: str = "model"       # "model": experts on the model axis (+FSDP
                                 # over data)  |  "data": experts on the data
                                 # axis + within-expert TP over model (a2a
                                 # dispatch; expert weights never gathered)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim, in mesh
    order.  An axis of size 1 splits nothing and stays ``Replicate()``
    (DTensor refuses some views of a dim "split" over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = [Replicate() for _ in names]
    taken = set()
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for i in pos:
            if i in taken:
                raise ValueError(f"spec {spec}: mesh axis {names[i]} shards two dims")
            taken.add(i)
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``jax.device_put(x, sharding)`` in SPMD: every rank holds the whole of
    ``x`` (the same values: a seeded init, a restored checkpoint, a host
    batch) and keeps its own shard, with no communication.  A DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


# -- trees -------------------------------------------------------------------
def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a module (its parameters), dict, list or
    tuple tree; the result keeps the tree's shape (a module gives a dict of
    its parameter names).  None leaves stay None."""
    if isinstance(tree, nn.Module):
        return {k: fn(f"{prefix}{k}", p) for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _divisible(dim: int, mesh, axes) -> bool:
    if not axes:
        return True
    sizes = axis_sizes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return dim % n == 0


def param_spec(path: str, shape, mesh, cfg: ModelConfig,
               policy: ShardingPolicy) -> PartitionSpec:
    """PartitionSpec for one parameter leaf of the port's layout: JAX's
    rule, read on the leaf's own dims (a layer's leaf has no period dim)."""
    ndim = len(shape)
    dp = data_axes(mesh)
    fs = dp if policy.fsdp else None
    tp = "model" if policy.tp else None

    def spec(*axes):
        """Drop axes that don't divide; pad rank with None."""
        out = []
        for dim, ax in zip(shape, axes):
            if ax is None:
                out.append(None)
            elif _divisible(dim, mesh, ax):
                out.append(ax)
            else:
                out.append(None)
        while len(out) < ndim:
            out.append(None)
        return P(*out)

    name = path.rsplit(".", 1)[-1]

    if name == "embed":
        return spec(tp, fs)                      # (V, D): vocab TP, d FSDP
    if name == "head":
        return spec(fs, tp)                      # (D, V)
    if "experts" in path and name in ("w_gate", "w_up"):
        if policy.ep_axis == "data":
            return spec(("data",), None, tp)     # (E, D, F): EP over "data",
        return spec(tp, fs, None)                # expert-TP over "model"
    if "experts" in path and name == "w_down":
        if policy.ep_axis == "data":
            return spec(("data",), tp, None)     # (E, F, D)
        return spec(tp, None, fs)
    if name in ("w_gate", "w_up", "wq", "wk", "wv", "w_xz"):
        return spec(fs, tp)                      # (D, out): column-parallel
    if name in ("w_down", "wo", "w_out"):
        return spec(tp, fs)                      # (in, D): row-parallel
    if name == "w_bcdt":
        return spec(fs, None)                    # small projections
    if name == "router":
        return spec(None, None)
    if name == "conv_w":
        return spec(None, tp)                    # (d_conv, d_inner)
    if name in ("bq", "bk", "bv"):
        return spec(tp)
    if name == "gate_norm":
        return spec(tp)                          # (d_inner,)
    return spec(*([None] * ndim))                # norms, scalars: replicate


def tree_pspecs(tree, mesh, cfg: ModelConfig, policy: ShardingPolicy):
    """Spec tree for a params-like tree: an `LM` (on any device, ``meta``
    included) gives {name: spec}; an optimizer state its nested dicts."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh, cfg, policy), tree)


def named(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def tree_shardings(tree, mesh, cfg: ModelConfig, policy: ShardingPolicy):
    return named(mesh, tree_pspecs(tree, mesh, cfg, policy))


def stage_param_specs(stage: str, tree, mesh, cfg: ModelConfig,
                      policy: ShardingPolicy | None = None):
    """Spec tree for one pipeline stage's parameters over its sub-mesh.

    The stage modules (`runtime.pipeline.lm_pipe.build_lm_stages`) reuse
    the block naming the rules key off (wq/wo/w_up/...), plus two
    stage-local outliers: the embed stage's table is "emb" (the (V, D)
    embedding rule) and the head stage's projection is "w_out", which
    would otherwise hit the mamba row-parallel rule; as the (D, V)
    unembedding it takes the "head" rule instead.  FSDP defaults off: a
    stage sub-mesh's "data" axis has size 1."""
    policy = policy or ShardingPolicy(fsdp=False, tp=True)

    def leaf_spec(path, leaf):
        name = path.rsplit(".", 1)[-1]
        if stage == "embed" and name == "emb":
            path = "embed"
        elif stage == "head" and name == "w_out":
            path = "head"
        return param_spec(path, tuple(leaf.shape), mesh, cfg, policy)

    return tree_map_with_path(leaf_spec, tree)


def stage_param_shardings(stage: str, tree, mesh, cfg: ModelConfig,
                          policy: ShardingPolicy | None = None):
    return named(mesh, stage_param_specs(stage, tree, mesh, cfg, policy))


# -- activations / batches ---------------------------------------------------
def _prod(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_specs(mesh, batch_tree, *, accum: bool = False):
    """Token batches: batch dim over the data axes.  With gradient
    accumulation the leading dim is the accumulation index (unsharded) and
    the batch dim is second."""
    dp = data_axes(mesh)

    def spec(path, leaf):
        batch_axis = 1 if accum else 0
        axes = [None] * len(leaf.shape)
        if leaf.shape[batch_axis] % _prod(mesh, dp) == 0:
            axes[batch_axis] = dp
        else:
            warnings.warn(
                f"batch dim {leaf.shape[batch_axis]} does not divide the "
                f"data axes (x{_prod(mesh, dp)}): batch will be REPLICATED "
                f"— lower grad_accum so microbatch >= dp (measured 46x "
                f"collective blow-up on qwen tp1; EXPERIMENTS.md §Perf)",
                stacklevel=2)
        return P(*axes)

    return tree_map_with_path(spec, batch_tree)


def _cache_rule(path: str, shape, mesh, policy: ShardingPolicy) -> PartitionSpec:
    """JAX's rule for a cache leaf of the stacked layout (periods, B, ...)."""
    dp = data_axes(mesh)
    ndp = _prod(mesh, dp)
    name = path.rsplit(".", 1)[-1]
    is_kv = name in ("k", "v", "cross_k", "cross_v")
    axes: list = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % ndp == 0:
        axes[1] = dp
    elif policy.seq_shard_cache and is_kv:
        # (periods, B, C, KV, hd): batch unshardable (long-context B=1):
        # shard capacity over the data axes instead
        if len(shape) >= 3 and shape[2] % ndp == 0:
            axes[2] = dp
    # model axis: prefer kv heads; else shard the capacity dim
    # (flash-decoding-style sequence-parallel cache)
    mdl = axis_sizes(mesh)["model"]
    if len(shape) == 5 and shape[3] % mdl == 0:
        axes[3] = "model"
    elif is_kv and len(shape) >= 3 and axes[2] is None and shape[2] % mdl == 0:
        axes[2] = "model"
    elif name == "conv" and len(shape) == 4 and shape[3] % mdl == 0:
        axes[3] = "model"          # mamba conv history: d_inner over tp
    return P(*axes)


def cache_specs(mesh, cache_tree, cfg: ModelConfig, policy: ShardingPolicy):
    """Decode caches (`models.lm.init_cache`).  A layer's leaf takes JAX's
    spec of the stacked leaf with the period entry dropped: batch over the
    data axes where it divides, else (``seq_shard_cache``) the capacity;
    KV heads over "model" where they divide, else the capacity.  ``pos``
    and ``cross_len`` are replicated scalars."""
    def spec(path, leaf):
        if not path.startswith("layers."):
            return P()
        return P(*_cache_rule(path, (1, *leaf.shape), mesh, policy)[1:])

    return tree_map_with_path(spec, cache_tree)


# -- placing a model ---------------------------------------------------------
def distribute_params(model: nn.Module, shardings: dict) -> nn.Module:
    """Replaces each parameter of ``model`` by a DTensor parameter placed by
    ``shardings`` ({name: NamedSharding}, `tree_shardings` of the model),
    in place; ``requires_grad`` is kept.  Returns the model."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(place(p.detach(), shardings[name]),
                                        requires_grad=p.requires_grad))
    return model
