"""Elastic scaling: re-plan and reshard when the chip budget changes;
ported from ``repro/runtime/elastic.py``.

The paper's motivation is exactly this ("scaling a program to a larger or
smaller processor array requires manually re-programming all objects and
channels"); here the planner re-solves the trade-off and the checkpoint
layer reshards the state.

A trainer (`rescale`, `reshard_tree`):

    1. drain + checkpoint (atomic)
    2. planner.replan(cfg, shape, old_plan, new_chips)  -> new ExecutionPlan
    3. build the new mesh and shardings; restore the checkpoint against
       them (restore_checkpoint(..., shardings=new))   -> resharded state
    4. resume the step loop

The SPMD difference: JAX builds the new mesh over any devices of its one
process; here the new ``DeviceMesh`` covers the ranks ``ranks`` of the
running world, every rank of the world takes part in building it, and a
rank outside it holds no shard (its local tensors are empty) until a
later rescale takes it back in.

A live serving pool (`rescale_serving`): the planner re-solves for the new
budget and a successor `DecodePipeline` is built on the same weights,
ready to adopt the drained pool's live state; over ranks, on a subset of
the pool's ranks, with the weights a rank lacks moved to it rank to rank.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeCfg
from ..core import planner
from ..launch import sharding as shd


@dataclass
class RescaleResult:
    plan: planner.PlanResult
    execution: planner.ExecutionPlan
    mesh: object
    diff: dict

    def summary(self) -> str:
        o, n = self.diff["chips"]
        return (f"rescale: {o:.0f} -> {n:.0f} chips, "
                f"throughput x{self.diff['throughput_ratio']:.2f}, "
                f"{len(self.diff['stages_changed'])} stages re-laid-out, "
                f"mesh {self.execution.mesh_shape}")


def plan_for_chips(cfg: ModelConfig, shape: ShapeCfg, chips: int,
                   engine: str = "heuristic") -> planner.PlanResult:
    return planner.plan(cfg, shape, chips=chips, engine=engine)


def rescale(cfg: ModelConfig, shape: ShapeCfg, old_plan: planner.PlanResult, *,
            new_chips: int, ranks=None, engine: str = "heuristic",
            device: str = "cuda") -> RescaleResult:
    """Re-plan for ``new_chips`` and build the new mesh.

    ``ranks``: the ranks to build the mesh over (all of the world by
    default; after a repair, the surviving slice).  The logical (dp, tp)
    comes from the plan projected onto however many ranks there are.
    Every rank of the world calls this."""
    import torch.distributed as dist

    from ..launch.mesh import device_mesh
    new_plan, diff = planner.replan(cfg, shape, old_plan, new_chips=new_chips,
                                    engine=engine)
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    ex = planner.to_execution(new_plan, cfg=cfg, chips=len(ranks))
    mesh = device_mesh(ex.mesh_shape, ex.mesh_axes, ranks=ranks, device=device)
    return RescaleResult(plan=new_plan, execution=ex, mesh=mesh, diff=diff)


def reshard_tree(tree, mesh, cfg: ModelConfig, policy: shd.ShardingPolicy | None = None):
    """Places an existing (restored) tree on a new mesh: its full tensors
    (every rank holds them) or DTensors on another mesh of the same
    ranks.  Returns (tree, shardings)."""
    policy = policy or shd.ShardingPolicy()
    sh = shd.tree_shardings(tree, mesh, cfg, policy)
    return shd.tree_map(_reshard, tree, sh), sh


def _reshard(x, sharding):
    if hasattr(x, "full_tensor") and x.device_mesh != sharding.mesh:
        x = x.full_tensor()
    return shd.place(x, sharding)


@dataclass
class ServingRescale:
    """A re-planned serving pipeline, ready to adopt a drained pool's
    live state via ``pipe.resume(state)``."""
    pipe: object                    # the new DecodePipeline
    plan: planner.PlanResult
    diff: dict

    def summary(self) -> str:
        o, n = self.diff["chips"]
        return (f"serving rescale: {o:.0f} -> {n:.0f} chips, "
                f"throughput x{self.diff['throughput_ratio']:.2f}, "
                f"{len(self.diff['stages_changed'])} stages re-laid-out")


def rescale_serving(pipe, cfg: ModelConfig, shape: ShapeCfg,
                    old_plan: planner.PlanResult, *, new_chips: int, stg,
                    devices=None, engine: str = "heuristic",
                    periods_per_stage: int | None = None,
                    measured_ratio: dict[str, float] | None = None,
                    **plan_kw) -> ServingRescale:
    """Re-plan a *serving* pool for ``new_chips`` and build the successor
    pipeline on the same weights.

    The live-rescale protocol (no request dropped):

        1. old run drains:  ``res = pipe.serve(..., pause_after_tokens=N)``
           — admission pauses, in-flight groups park with caches resident,
           ``res.resume_state`` exports them.
        2. ``rs = rescale_serving(pipe, cfg, shape, old_plan,
           new_chips=..., stg=stg)`` — this function: one solver call and
           a new `DecodePipeline` over the re-planned placement *sharing*
           ``pipe.params`` (the same `LM`: no weight is copied).
        3. ``rs.pipe.resume(res.resume_state)`` — parked groups' cache
           slices are adopted (handed off when stage spans match,
           replayed from token history when the cut points moved) and
           decoding continues to completion.

    ``measured_ratio`` (e.g. a `HealthController.replan_advice`) routes
    straggler measurements into the re-solve — the measurement-guided
    re-planning loop of the paper, closed over a live pool.  Advice keys
    may be *pipeline stage* names (what the controller observes —
    ``blocks00`` may group several graph nodes) or graph node names;
    stage keys fan out to every graph node the stage owns via
    ``pipe.graph_stage_map()`` before they reach the solver.
    ``plan_kw``: the planner options the old plan was made with (``hw``,
    ``max_tp``), which ``stg`` was built with too; they pass to
    ``planner.replan``.  ``devices``: where the successor runs (default:
    ``pipe``'s device, or over ranks ``pipe``'s pool).

    Over ranks (``pipe`` on a `launch.mesh.RankPool`, called on its
    controller while every other rank runs ``pipe.work()``): ``devices`` is
    a subset of the pool's ranks that keeps its controller first.  The
    controller alone re-plans and sends the plan to every rank, which
    builds the successor on a pool of its own groups (a member's worker
    runs beside ``pipe``'s, and ``pipe.work()`` returns once both closed);
    each weight a successor rank lacks moves to it from a rank that holds
    it, and a rank that leaves lets its weights go.  Then
    ``rs.pipe.resume(state)`` adopts the parked slices, through ``pipe``
    where one changes rank: close ``pipe`` after it."""
    if measured_ratio:
        stage_of = pipe.graph_stage_map()        # graph node -> stage name
        fanned: dict[str, float] = {}
        for key, ratio in measured_ratio.items():
            owners = [n for n, s in stage_of.items() if s == key] or [key]
            for n in owners:
                fanned[n] = max(fanned.get(n, 1.0), ratio)
        measured_ratio = fanned
    new_plan, diff = planner.replan(cfg, shape, old_plan,
                                    new_chips=new_chips, engine=engine,
                                    measured_ratio=measured_ratio, **plan_kw)
    kw = dict(periods_per_stage=(pipe.periods_per_stage
                                 if periods_per_stage is None else periods_per_stage),
              seed=pipe.seed, overlap=pipe.overlap, replica_queue=pipe.replica_queue,
              workers=pipe.workers, temperature=pipe.temperature,
              fusion_plan=pipe.fusion_plan, impl=pipe.impl, warmup=pipe.warmup)
    if pipe.pool is not None:
        ranks = pipe.pool.ranks if devices is None else devices
        return ServingRescale(pipe=pipe._successor(stg, new_plan, list(ranks), kw),
                              plan=new_plan, diff=diff)
    from .pipeline.decode import DecodePipeline
    new_pipe = DecodePipeline(
        cfg, stg, new_plan,
        devices=devices if devices is not None else [pipe.device],
        params=pipe.params, **kw)
    return ServingRescale(pipe=new_pipe, plan=new_plan, diff=diff)
