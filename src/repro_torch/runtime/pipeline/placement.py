"""Placement: partition the device set into per-stage slices.

Copied from ``repro/runtime/pipeline/placement.py``, unchanged apart from
its imports.

The solver's ``Selection`` says, per composite node, *which* implementation
and *how many* round-robin replicas.  Spatial execution gives each replica
its own slice of the device set, sized to the implementation's
tensor-parallel degree (LM impls carry ``tp`` in their meta / ``tpK`` name;
paper-style PE libraries map one replica to one PE worker).  Fork/join
routing between stages with mismatched replica counts is round-robin by
token index, as the JAX package's ``core/transform.py`` builds its trees.

When the physical device pool is smaller than the plan's chip demand the
placement *oversubscribes*: slices wrap around the pool round-robin and the
executor time-shares them: on one card every slice is the card, and its
stages share it through their own CUDA streams.  ``Placement.oversubscription``
reports the folding factor so measurements can be caveated.

Over a `launch.mesh.RankPool` (a process a device) the pool is its ranks:
slices hold ranks, and a plan wanting more chips than the pool has ranks
folds onto them round-robin as onto devices, its stages sharing a rank's
device through their own streams.  A rank pool's slices are its ranks
already: ``StageSlice.resolve`` is for integer placements made without a
pool.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from ...core.stg import STG, Impl, Selection


def tp_of(impl: Impl) -> int:
    """Tensor-parallel degree (devices per replica) of an implementation.

    LM libraries (graphs/lm_graph.py) encode it as meta["tp"] / name "tpK";
    paper PE libraries (jpeg/streamit) are single-worker per replica.
    """
    if impl.meta and "tp" in impl.meta:
        return int(impl.meta["tp"])
    if impl.name.startswith("tp") and impl.name[2:].isdigit():
        return int(impl.name[2:])
    return 1


@dataclass(frozen=True)
class StageSlice:
    """One replica of one stage, pinned to a tuple of devices."""
    stage: str                 # logical (pre-materialisation) node name
    worker: str                # materialised node name (stage or stage@k)
    replica: int
    tp: int
    devices: tuple             # device handles (ints for the "enough
                               # hardware" default, torch.device otherwise)

    @property
    def chips(self) -> int:
        return self.tp

    @property
    def distinct(self) -> bool:
        """True when the slice owns ``tp`` *different* devices — the
        precondition for building a per-stage sub-mesh and actually
        sharding params over the slice.  A small pool folds a tp>1 slice
        onto repeated devices (oversubscription), where sub-mesh
        construction is invalid and the executor falls back to
        single-device placement."""
        return len(set(self.devices)) == len(self.devices)

    def resolve(self, pool: Sequence[Any]) -> tuple:
        """Device handles of this slice against a concrete pool: integer
        placements (the "enough hardware" default) index into ``pool``
        round-robin; real handles pass through."""
        return tuple(pool[d % len(pool)] if isinstance(d, int) else d
                     for d in self.devices)


@dataclass
class Placement:
    """Device assignment for every worker of a materialised STG."""
    slices: dict[str, StageSlice] = field(default_factory=dict)   # worker -> slice
    n_devices: int = 0
    demand: int = 0            # total devices the plan wants
    oversubscription: float = 1.0

    def slice_of(self, worker: str) -> StageSlice:
        return self.slices[worker]

    def replicas_of(self, stage: str) -> list[StageSlice]:
        out = [s for s in self.slices.values() if s.stage == stage]
        return sorted(out, key=lambda s: s.replica)

    def device_load(self) -> dict[Any, int]:
        """Workers per device — >1 anywhere means time-sharing."""
        load: dict[Any, int] = {}
        for s in self.slices.values():
            for d in s.devices:
                load[d] = load.get(d, 0) + 1
        return load

    def summary(self) -> str:
        stages: dict[str, list[StageSlice]] = {}
        for s in self.slices.values():
            stages.setdefault(s.stage, []).append(s)
        rows = []
        for name in sorted(stages):
            sl = sorted(stages[name], key=lambda s: s.replica)
            rows.append(f"  {name}: {len(sl)} replica(s) x tp{sl[0].tp} "
                        f"-> devices {[s.devices for s in sl]}")
        head = (f"placement: {self.demand} chip(s) wanted on "
                f"{self.n_devices} device(s), x{self.oversubscription:.1f} "
                f"oversubscribed")
        return head + "\n" + "\n".join(rows)


def place(stg: STG, sel: Selection, devices: Sequence[Any] | int | None = None,
          *, replica_map: dict[str, list[str]] | None = None) -> Placement:
    """Assign every worker a device slice, in topological stage order.

    ``stg``/``sel`` are the *logical* graph and selection (replicas still
    counts, not materialised nodes).  ``replica_map`` (from
    ``transform.materialize``) names the materialised workers; without it
    the canonical ``name@k`` naming is assumed.  ``devices`` is a device
    list or a pool size (defaults to exactly the plan's demand — the
    "enough hardware" placement).
    """
    demand = 0
    per_stage: list[tuple[str, Impl, int]] = []
    for name in stg.topo_order():
        impl = sel.impl_of(stg, name)
        nr = sel.replicas(name)
        tp = tp_of(impl)
        per_stage.append((name, impl, nr))
        demand += tp * nr

    if devices is None:
        pool: list[Any] = list(range(max(1, demand)))
    elif isinstance(devices, int):
        pool = list(range(devices))
    else:
        pool = list(devices)
    if not pool:
        raise ValueError("empty device pool")

    pl = Placement(n_devices=len(pool), demand=demand)
    cursor = 0
    for name, impl, nr in per_stage:
        tp = tp_of(impl)
        workers = (replica_map or {}).get(
            name, [name] if nr == 1 else [f"{name}@{k}" for k in range(nr)])
        if len(workers) != nr:
            raise ValueError(f"stage {name}: {nr} replicas but "
                             f"{len(workers)} workers in replica_map")
        for k, w in enumerate(workers):
            devs = tuple(pool[(cursor + j) % len(pool)] for j in range(tp))
            cursor += tp
            pl.slices[w] = StageSlice(stage=name, worker=w, replica=k,
                                      tp=tp, devices=devs)
    pl.oversubscription = max(1.0, demand / len(pool))
    return pl
