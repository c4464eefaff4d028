"""Straggler detection & mitigation hooks.

Copied whole from ``repro/runtime/straggler.py`` (it imports no JAX).

Two granularities live here:

  * `StragglerMonitor` — pod-scale step-time outliers under synchronous
    data parallelism (rolling median of step durations per host);
  * `detect_replica_stragglers` — pipeline-scale replica outliers from
    the observability layer's per-(stage, replica) retire-latency
    histograms (`runtime.pipeline.metrics.registry_from_trace`).

Pod-scale rationale: with synchronous data parallelism one slow host sets
the step time for all N.  The monitor keeps a rolling median of step
durations (per host when per-host timings are available — multi-host
deployments feed heartbeat times; single-process runs feed their own) and
flags steps slower than ``threshold``x the median.  Mitigation is a
pluggable callback; the default logs and counts.  Real deployments attach
actions like: demote the host from the next slice assignment (elastic
re-plan, see runtime.elastic), or switch the data loader to skip-straggler
mode (drop the slowest host's microbatch — bounded staleness).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StragglerEvent:
    step: int
    host: int
    duration: float
    median: float

    @property
    def slowdown(self) -> float:
        return self.duration / max(self.median, 1e-9)


@dataclass
class StragglerMonitor:
    window: int = 32
    threshold: float = 2.5
    warmup_steps: int = 3          # compile/first-touch steps are not stragglers
    on_straggler: Callable[[StragglerEvent], None] | None = None
    registry: object | None = None  # optional MetricsRegistry: counts firings
    _history: list[float] = field(default_factory=list)
    events: list[StragglerEvent] = field(default_factory=list)
    observed: int = 0

    def observe(self, step: int, duration: float | dict[int, float]) -> list[StragglerEvent]:
        """Feed one step's duration (or {host: duration}).  Returns events
        flagged for this step."""
        per_host = duration if isinstance(duration, dict) else {0: duration}
        self.observed += 1
        flagged: list[StragglerEvent] = []
        # one median per observe: flagging and the healthy-filter below must
        # judge against the same pre-update baseline
        med = statistics.median(self._history) if self._history else 0.0
        if self._history and self.observed > self.warmup_steps:
            for host, dur in per_host.items():
                if dur > self.threshold * med:
                    ev = StragglerEvent(step=step, host=host, duration=dur,
                                        median=med)
                    flagged.append(ev)
                    self.events.append(ev)
                    if self.registry is not None:
                        self.registry.counter("straggler.flagged",
                                              host=str(host)).inc()
                    if self.on_straggler is not None:
                        self.on_straggler(ev)
        if self.observed > self.warmup_steps:
            # the median tracks healthy steps; don't let stragglers poison it
            healthy = [d for d in per_host.values()
                       if not self._history or d <= self.threshold * med]
            self._history.extend(healthy or per_host.values())
        else:
            self._history.extend(per_host.values())
        if len(self._history) > self.window:
            self._history = self._history[-self.window:]
        return flagged

    def new_incarnation(self) -> None:
        """Restart boundary: the next ``warmup_steps`` steps recompile and
        must not be flagged."""
        self.observed = 0
        self._history.clear()

    @property
    def median(self) -> float:
        return statistics.median(self._history) if self._history else 0.0


@dataclass
class StragglerReport:
    """One flagged replica."""
    stage: str
    replica: int
    p50_us: float              # this replica's median retire latency
    peer_p50_us: float         # median of the OTHER replicas' medians
    samples: int

    @property
    def ratio(self) -> float:
        return self.p50_us / self.peer_p50_us if self.peer_p50_us > 0 else 1.0

    def describe(self) -> str:
        return (f"{self.stage}/r{self.replica}: p50 {self.p50_us:.0f}us vs "
                f"peer median {self.peer_p50_us:.0f}us "
                f"(x{self.ratio:.2f}, {self.samples} samples)")


def detect_replica_stragglers(registry, *,
                              threshold: float = 1.5,
                              min_samples: int = 8) -> list[StragglerReport]:
    """Flag replicas whose median retire latency exceeds ``threshold`` x
    the median of its *peers'* medians (leave-self-out).

    Medians on both sides deliberately: a straggler is a *shifted
    distribution*, not a tail event — one slow op (a late compile, a GC
    pause) moves a mean or a p99 but not a median, and the
    median-of-medians baseline keeps the straggler itself from dragging
    the reference the way a pooled mean would.  The baseline excludes
    the replica under judgement: with exactly two replicas an inclusive
    median-of-medians IS the slower replica's own median, which made a
    2-replica stage's straggler structurally undetectable.  Replicas
    with fewer than ``min_samples`` observations are skipped (a replica
    that retired three ops has no distribution to judge).  Stages with a
    single replica are skipped — there are no peers to lag behind.

    Returns reports sorted worst-first; empty when nothing is flagged.
    """
    # (stage, replica) -> Histogram, from the registry's labelled metrics
    # (lazy import: runtime.pipeline.__init__ re-exports this module)
    from .pipeline.metrics import Histogram
    by_stage: dict[str, dict[int, Histogram]] = {}
    for labels, metric in registry.find("pipeline.retire_latency_us"):
        ld = dict(labels)
        try:
            rep = int(ld.get("replica", -1))
        except (TypeError, ValueError):
            continue
        stage = ld.get("stage")
        if stage is None or rep < 0 or not isinstance(metric, Histogram):
            continue
        by_stage.setdefault(stage, {})[rep] = metric

    out: list[StragglerReport] = []
    for stage, reps in by_stage.items():
        eligible = {r: h for r, h in reps.items() if h.count >= min_samples}
        if len(eligible) < 2:
            continue
        medians = {r: h.percentile(50) for r, h in eligible.items()}
        for r, p50 in medians.items():
            peers = sorted(v for k, v in medians.items() if k != r)
            peer_p50 = peers[len(peers) // 2]
            if peer_p50 <= 0:
                continue
            if p50 > threshold * peer_p50:
                out.append(StragglerReport(
                    stage=stage, replica=r, p50_us=p50,
                    peer_p50_us=peer_p50, samples=eligible[r].count))
    out.sort(key=lambda s: -s.ratio)
    return out
