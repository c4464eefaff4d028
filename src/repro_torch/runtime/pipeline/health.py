"""Straggler-driven self-healing: the control loop between observability
and mitigation.

Ported from ``repro/runtime/pipeline/health.py``, unchanged but for the
note on its users: here only `DecodePipeline.serve` runs on the engine.

The observability layer can already *see* a sick replica —
`runtime.straggler.detect_replica_stragglers` flags any replica whose
median retire latency drifts past ``threshold`` x its peers.  This module
closes the loop: `HealthController.tick` runs inside the engine's retire
path (every ``check_every`` retirements, via ``Engine(on_tick=...)``),
folds the live trace into a metrics registry, and acts on what it finds:

  1. **Rebalance** — ask the flagged stage's program to shed work off the
     slow replica (``prog.shed_replica(rep, n)``: migrate up to ``n``
     resident groups onto the least-loaded healthy peer).  This is cheap
     and reversible — the replica stays in rotation for its remaining
     groups, it just carries fewer of them.
  2. **Escalate** — a replica flagged on ``replan_after`` consecutive
     ticks is not noise, it is a systematically slow part; per the
     paper's measurement-guided flow the right response is a *re-plan*
     with measured ratios, not more migration.  The controller distills
     the straggler reports into a per-stage measured/analytic ratio dict
     (`replan_advice`) shaped for ``planner.replan(measured_ratio=...)``
     and invokes ``replan_fn(advice)`` when one is attached.  It never
     calls the planner itself: swapping a plan means draining and
     resharding (see `runtime.elastic.rescale_serving`), a decision the
     serving layer owns.

The controller is deliberately engine-agnostic: it only needs
``engine.programs`` (for ``shed_replica``) and a tracer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..straggler import StragglerReport, detect_replica_stragglers
from .metrics import registry_from_trace
from .trace import Tracer


@dataclass
class HealthController:
    """Periodic straggler check + mitigation, driven by the engine.

    Wire it with ``Engine(..., on_tick=hc.tick, tick_every=hc.check_every)``
    — `DecodePipeline.serve(health=hc)` does exactly that.  After the run,
    ``migrations`` counts groups moved off slow replicas, ``strikes``
    holds per-(stage, replica) consecutive-flag counts, and
    ``replan_advice`` (when escalation triggered) is the measured-ratio
    dict to feed ``planner.replan(measured_ratio=...)``.
    """
    tracer: Tracer
    threshold: float = 1.5
    min_samples: int = 8
    check_every: int = 32
    migrate_per_tick: int = 1
    replan_after: int = 2
    replan_fn: object | None = None     # callable(advice: dict) | None
    migrations: int = 0
    ticks: int = 0
    strikes: dict[tuple, int] = field(default_factory=dict)
    reports: list[StragglerReport] = field(default_factory=list)
    replan_advice: dict | None = None
    log: list[str] = field(default_factory=list)

    def tick(self, engine) -> list[StragglerReport]:
        """One health check: detect, rebalance, maybe escalate."""
        self.ticks += 1
        reg = registry_from_trace(self.tracer)
        found = detect_replica_stragglers(
            reg, threshold=self.threshold, min_samples=self.min_samples)
        self.reports.extend(found)
        flagged = {(r.stage, r.replica) for r in found}
        # a clean tick clears a replica's strike count: "consecutive" is
        # the difference between a GC pause and a sick part
        for key in [k for k in self.strikes if k not in flagged]:
            self.strikes.pop(key)
        by_name = {p.name: p for p in getattr(engine, "programs", [])
                   if hasattr(p, "name")}
        for r in found:
            self.strikes[(r.stage, r.replica)] = \
                self.strikes.get((r.stage, r.replica), 0) + 1
            prog = by_name.get(r.stage)
            shed = getattr(prog, "shed_replica", None)
            if shed is not None and self.migrate_per_tick > 0:
                moved = shed(r.replica, self.migrate_per_tick)
                self.migrations += moved
                if moved:
                    self.log.append(
                        f"tick {self.ticks}: moved {moved} group(s) off "
                        f"{r.stage}/r{r.replica} ({r.describe()})")
        if any(n >= self.replan_after for n in self.strikes.values()):
            self.replan_advice = self._advice()
            if self.replan_fn is not None:
                self.replan_fn(self.replan_advice)
        return found

    def _advice(self) -> dict[str, float]:
        """Per-stage measured slowdown ratios for the planner.

        A stage with a straggling replica effectively runs at the
        straggler's pace for the groups it owns; the advice reports the
        worst observed replica-vs-peer ratio per stage so the re-solve
        sizes that stage as if every op cost that much more."""
        advice: dict[str, float] = {}
        for r in self.reports:
            advice[r.stage] = max(advice.get(r.stage, 1.0), r.ratio)
        return advice
