"""Metrics registry over the tracer: counters, gauges, histograms — and
the stall-based bottleneck attribution they enable.

Copied from ``repro/runtime/pipeline/metrics.py``; the port adds the
rank counters of a pipeline over ranks (``pipeline.rank_host_s``).

`trace.Tracer` records *events*; this module turns them into *numbers*:

  * `MetricsRegistry` — a small labelled counters/gauges/histograms
    store (`registry_from_trace` populates one from a tracer's
    aggregates: per-stage busy/utilization, wait time by reason,
    retire-latency histograms per (stage, replica) — the histograms
    `runtime.straggler.detect_replica_stragglers` consumes).
  * `attribute_bottleneck` — the paper's bottleneck-vs-excess-capacity
    signal read from measurements instead of the analytic model: a
    credit wait on an edge blames the edge's *consumer* (it is too slow
    to drain), a starve blames the *producer* (too slow to fill), so the
    stage with the most blamed time is the measured bottleneck and
    stages with large own-wait time have excess capacity.  Feed the
    resulting ranking to ``planner.replan(measured_ratio=...)`` as a
    second calibration source next to completion-stream ratios.
  * `serving_slo` — per-request serving percentiles (queue wait, TTFT,
    inter-token gap p50/p95/p99) as one flat milliseconds dict, the
    shape `ServeRunResult.slo()` / `LMServer` / ``bench_serve`` report
    and ``tools/bench_compare.py`` diffs warn-only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .trace import WAIT_CREDIT, WAIT_REORDER, WAIT_STARVE, Tracer

_SAMPLE_CAP = 4096


@dataclass
class Counter:
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


@dataclass
class Gauge:
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Bounded-memory latency histogram: exact percentiles while under
    ``_SAMPLE_CAP`` samples, a deterministic ring reservoir beyond it
    (count/sum/max stay exact either way)."""

    __slots__ = ("samples", "count", "total", "vmax")

    def __init__(self):
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v
        if len(self.samples) < _SAMPLE_CAP:
            self.samples.append(v)
        else:
            self.samples[self.count % _SAMPLE_CAP] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "max": self.vmax if self.count else float("nan")}


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation noise)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]


class MetricsRegistry:
    """Labelled metric store: ``registry.counter("x", stage="embed")``
    creates-or-returns the Counter for that (name, labels) pair."""

    def __init__(self):
        self._m: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        m = self._m.get(key)
        if m is None:
            m = self._m[key] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name}{labels} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def find(self, name: str) -> list[tuple[dict, object]]:
        """All (labels, metric) pairs registered under ``name``."""
        return [(dict(key[1]), m) for key, m in self._m.items()
                if key[0] == name]

    def to_dict(self) -> dict:
        out: dict = {}
        for (name, labels), m in sorted(self._m.items(),
                                        key=lambda kv: kv[0]):
            val = m.summary() if isinstance(m, Histogram) else m.value
            out.setdefault(name, []).append(
                {"labels": dict(labels), "value": val})
        return out


# ===========================================================================
# tracer -> registry
# ===========================================================================
def registry_from_trace(tracer: Tracer,
                        wall_s: float | None = None) -> MetricsRegistry:
    """Fold a tracer's aggregates into a registry: per-stage busy time
    and utilization (needs ``wall_s`` — the run's makespan in the
    tracer's time unit), wait counters by (stage, reason), and
    retire-latency histograms per (stage, replica), and over ranks each
    stage's op host seconds by rank."""
    reg = MetricsRegistry()
    stage_busy: dict[str, float] = {}
    for track, busy in tracer.busy.items():
        stage, _, rep = track.rpartition("/r")
        reg.counter("pipeline.busy_s", stage=stage, replica=rep).inc(busy)
        stage_busy[stage] = stage_busy.get(stage, 0.0) + busy
    for (stage, reason, edge), s in tracer.wait_s.items():
        reg.counter("pipeline.wait_s", stage=stage, reason=reason).inc(s)
        if edge:
            reg.counter("pipeline.edge_wait_s", edge=edge,
                        reason=reason).inc(s)
    for (stage, rep), samples in tracer.retire_samples.items():
        h = reg.histogram("pipeline.retire_latency_us",
                          stage=stage, replica=str(rep))
        for dt in samples:
            h.observe(dt * 1e6)
    for (stage, rank), s in tracer.rank_host_s.items():
        reg.counter("pipeline.rank_host_s", stage=stage, rank=str(rank)).inc(s)
    for (stage, rep, t_fault, t_rec, n_replayed) in tracer.failovers:
        reg.counter("pipeline.failovers", stage=stage,
                    replica=str(rep)).inc()
        reg.counter("pipeline.replayed_ops", stage=stage,
                    replica=str(rep)).inc(n_replayed)
        reg.histogram("pipeline.recovery_s", stage=stage).observe(
            t_rec - t_fault)
    if wall_s and wall_s > 0:
        n_reps: dict[str, int] = {}
        for track in tracer.busy:
            stage, _, _rep = track.rpartition("/r")
            n_reps[stage] = n_reps.get(stage, 0) + 1
        for stage, busy in stage_busy.items():
            reg.gauge("pipeline.utilization", stage=stage).set(
                min(1.0, busy / (wall_s * n_reps[stage])))
    return reg


# ===========================================================================
# stall-based bottleneck attribution
# ===========================================================================
@dataclass
class BlameEntry:
    stage: str
    blamed: float = 0.0       # wait time this stage *caused* elsewhere
    own_wait: float = 0.0     # wait time this stage *suffered* itself
    busy: float = 0.0         # op time dispatch->retire across replicas

    @property
    def excess(self) -> float:
        """Positive when the stage waits more than it makes others wait —
        the paper's excess-capacity side of the signal."""
        return self.own_wait - self.blamed


def attribute_bottleneck(tracer: Tracer) -> list[BlameEntry]:
    """Rank stages by the wait time they *caused*, descending.

    A credit wait on edge e (producer blocked pushing) means e's consumer
    drains too slowly — blame ``dst``.  A starve on e (consumer blocked
    popping) means e's producer fills too slowly — blame ``src``.
    Reorder waits blame nobody: the tokens exist, a replica retired out
    of order.  Edges the tracer never saw registered (no ``watch_fifo``
    src/dst) contribute to ``own_wait`` only."""
    blame: dict[str, BlameEntry] = {}

    def entry(stage: str) -> BlameEntry:
        e = blame.get(stage)
        if e is None:
            e = blame[stage] = BlameEntry(stage=stage)
        return e

    for (stage, reason, edge), s in tracer.wait_s.items():
        entry(stage).own_wait += s
        w = tracer.fifo_watch.get(edge)
        if w is None or reason == WAIT_REORDER:
            continue
        if reason == WAIT_CREDIT and w.dst:
            entry(w.dst).blamed += s
        elif reason == WAIT_STARVE and w.src:
            entry(w.src).blamed += s
    for track, b in tracer.busy.items():
        stage, sep, rep = track.rpartition("/r")
        if sep and rep.isdigit() and stage in blame:
            blame[stage].busy += b
    return sorted(blame.values(), key=lambda e: -e.blamed)


def stall_bottleneck(tracer: Tracer) -> str | None:
    """The stage the measurements blame most, or None without any waits.

    Blame alone misattributes around an under-sized edge: a producer
    credit-blocked on a burst-rate FIFO blames the consumer even when
    the consumer is nearly idle (the producer itself is the slow stage
    and the edge just can't absorb its burst).  A stage can only be a
    bottleneck while it is *computing*, so the verdict is the stage
    maximising min(blamed, busy) — blame capped by the time the stage
    actually spent busy.  Falls back to raw blame when the trace has no
    op spans (waits-only traces)."""
    ranked = attribute_bottleneck(tracer)
    if not ranked:
        return None
    if any(e.busy > 0 for e in ranked):
        best = max(ranked, key=lambda e: min(e.blamed, e.busy))
        return best.stage if min(best.blamed, best.busy) > 0 else None
    return ranked[0].stage if ranked[0].blamed > 0 else None


# ===========================================================================
# serving SLOs
# ===========================================================================
def serving_slo(queue_wait_s, ttft_s, token_gap_s) -> dict:
    """Per-request serving percentiles as one flat milliseconds dict —
    the SLO block `ServeRunResult.slo()` reports and bench_serve emits."""
    out: dict[str, float] = {}
    for prefix, xs in (("queue_wait", queue_wait_s), ("ttft", ttft_s),
                       ("token_gap", token_gap_s)):
        for p in (50, 95, 99):
            out[f"{prefix}_p{p}_ms"] = percentile(xs, p) * 1e3
    return out
