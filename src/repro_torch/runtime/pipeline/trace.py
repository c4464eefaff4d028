"""Structured pipeline tracing: a ring-buffer tracer both drivers feed.

Copied from ``repro/runtime/pipeline/trace.py``; the port adds `Tracer.op_rank`,
the rank each op of a pipeline over ranks ran on.

The paper's loop — find the bottleneck or the excess capacity, then
reselect/replicate/split — needs *measured evidence* of where time goes.
`PipelineReport` says how fast each stage ran; this module says **why**:
which ops occupied which replica when, which stage sat blocked pushing
into a full FIFO (credit wait — the downstream party is too slow), which
sat blocked on an empty input (starve — the upstream party is), and how
every channel's occupancy evolved.  TAPA-style FIFO instrumentation for
a software pipeline.

Design constraints, in order:

  * **Low overhead.**  Events are `NamedTuple`s appended to a bounded
    ``collections.deque`` — no locks (the drivers emit from one thread),
    no formatting, no timestamps beyond what the driver already read.
    Tracing is strictly opt-in: every hook in the engine/channels is a
    ``if tracer is not None`` guard, so the default path executes the
    exact pre-trace instruction stream.  The serve smoke bench asserts
    the enabled-tracing tokens/s penalty stays under 3%.
  * **One event model for both clock domains.**  The tracer hooks into
    the shared `engine.Driver` base, so the wall-clock `Engine` and the
    virtual-clock `EventLoop` emit the *same* typed events for the same
    `Program` — `track_sequences()` is driver-invariant (the property
    `tests/test_trace.py` pins), only the timestamps differ (seconds
    vs cycles).
  * **Ring buffer + aggregates.**  The ring keeps the last ``capacity``
    events for export/diagnostics; monotone aggregates (busy seconds,
    wait seconds by (stage, reason, edge), retire-latency samples per
    (stage, replica)) are accumulated separately so long runs do not
    lose their totals to ring eviction.  `metrics.registry_from_trace`
    turns the aggregates into a counters/gauges/histograms registry.

Export is Chrome-trace / Perfetto JSON (`to_chrome_trace` / `save`):
one duration track per (stage, replica) — op spans dispatch→retire, the
replica's busy/idle profile — one "waits" track per stage with the
blocked spans and their reason, and one counter track per watched FIFO
with its occupancy after every push/pop.  Open the file at
https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

# event kinds ---------------------------------------------------------------
EV_DISPATCH = "dispatch"     # op handed to its replica
EV_RETIRE = "retire"         # op complete; t0 carries the dispatch time
EV_WAIT = "wait"             # a stage's blocked span closed (name = reason)
EV_PUSH = "push"             # fifo gained tokens; value = occupancy after
EV_POP = "pop"               # fifo lost tokens; value = occupancy after
EV_FAILOVER = "failover"     # a replica died and its work moved; t0 is
#                              the fault time, t the recovery-complete
#                              time, value the number of replayed ops

# wait reasons (the bottleneck-vs-excess-capacity signal) -------------------
WAIT_CREDIT = "credit"       # output fifo full: the DOWNSTREAM side is slow
WAIT_STARVE = "starve"       # input fifo empty: the UPSTREAM side is slow
WAIT_REORDER = "reorder"     # input empty but tokens sit in the driver's
#                              reorder buffer — an out-of-order replica
#                              retirement, not a rate mismatch
WAIT_DEP = "dep"             # intra-stage dependency (B before its own F)
WAIT_BLOCKED = "blocked"     # program gave no reason


class TraceEvent(NamedTuple):
    """One typed event.  ``track`` is ``"<stage>/r<replica>"`` for op
    events, the stage name for waits, and the fifo label for push/pop.
    ``t``/``t0`` are run-relative (seconds under the wall clock, cycles
    under the virtual one)."""
    kind: str
    track: str
    t: float
    name: str = ""           # op kind (F/B/P/D/N) or wait reason
    seq: int = -1
    chunk: int = 0
    t0: float = 0.0          # span start (retire / wait events)
    value: int = -1          # fifo occupancy after the event
    edge: str = ""           # blocking fifo label (wait events)


@dataclass
class FifoWatch:
    """Registry entry for one watched fifo: its identity for counter
    tracks, capacity for the occupancy invariant, and the producing /
    consuming stage names for bottleneck attribution."""
    label: str
    fifo: object
    capacity: int
    src: str | None = None
    dst: str | None = None


_SAMPLE_CAP = 4096           # retire-latency samples kept per replica


class Tracer:
    """Ring-buffer event collector shared by every driver and channel of
    one run (or one session — aggregates accumulate across runs that
    reuse the tracer).  Thread-safety: both drivers emit from their
    scheduling thread; ``deque.append`` is atomic, so concurrent fifo
    events from a worker (there are none today) would not corrupt it."""

    def __init__(self, capacity: int = 65536):
        self.events: deque[TraceEvent] = deque(maxlen=capacity)
        self.capacity = capacity
        self._clock = None                     # bound by the driver
        # monotone aggregates (survive ring eviction)
        self.busy: dict[str, float] = {}               # track -> busy time
        self.wait_s: dict[tuple, float] = {}           # (stage, reason, edge)
        self.retire_samples: dict[tuple, list] = {}    # (stage, rep) -> [dt]
        self.n_dispatch: dict[str, int] = {}           # track -> count
        self.n_retire: dict[str, int] = {}
        self.failovers: list[tuple] = []   # (stage, rep, t_fault, t_rec, n)
        self.fifo_watch: dict[str, FifoWatch] = {}     # label -> watch entry
        self.virtual = False
        # a pipeline over ranks: the rank each op track ran on, and the host
        # seconds its op bodies took there (reported by the rank's worker)
        self.rank_of: dict[str, int] = {}              # track -> rank
        self.rank_host_s: dict[tuple, float] = {}      # (stage, rank) -> s

    # -- clock binding (drivers call at run start) --------------------------
    def bind_wall(self, t0: float) -> None:
        self._clock = lambda: time.perf_counter() - t0
        self.virtual = False

    def bind_virtual(self, loop) -> None:
        self._clock = lambda: loop.now
        self.virtual = True

    def now(self) -> float:
        return self._clock() if self._clock is not None else 0.0

    # -- emit hooks (hot path: tuple build + deque append) ------------------
    def op_dispatch(self, stage: str, rep: int, kind: str, seq: int,
                    chunk: int, t: float) -> None:
        track = f"{stage}/r{rep}"
        self.events.append(TraceEvent(EV_DISPATCH, track, t, kind,
                                      seq, chunk))
        self.n_dispatch[track] = self.n_dispatch.get(track, 0) + 1

    def op_retire(self, stage: str, rep: int, kind: str, seq: int,
                  chunk: int, t0: float, t: float) -> None:
        track = f"{stage}/r{rep}"
        self.events.append(TraceEvent(EV_RETIRE, track, t, kind,
                                      seq, chunk, t0))
        self.n_retire[track] = self.n_retire.get(track, 0) + 1
        self.busy[track] = self.busy.get(track, 0.0) + (t - t0)
        samples = self.retire_samples.setdefault((stage, rep), [])
        if len(samples) < _SAMPLE_CAP:
            samples.append(t - t0)
        else:                                  # deterministic ring reservoir
            samples[self.n_retire[track] % _SAMPLE_CAP] = t - t0

    def op_rank(self, stage: str, rep: int, rank: int, host_s: float) -> None:
        """An op of (``stage``, ``rep``) ran on ``rank``, its body taking
        ``host_s`` of that rank's host time: the controller merges each
        rank's report into its own trace, whose spans (dispatch to
        retirement, on the controller's clock) cover the op on every rank."""
        self.rank_of[f"{stage}/r{rep}"] = rank
        key = (stage, rank)
        self.rank_host_s[key] = self.rank_host_s.get(key, 0.0) + host_s

    def wait(self, stage: str, reason: str, edge: str,
             t0: float, t: float) -> None:
        self.events.append(TraceEvent(EV_WAIT, stage, t, reason,
                                      t0=t0, edge=edge))
        key = (stage, reason, edge)
        self.wait_s[key] = self.wait_s.get(key, 0.0) + (t - t0)

    def fifo_event(self, kind: str, label: str, occupancy: int) -> None:
        self.events.append(TraceEvent(kind, label, self.now(),
                                      value=occupancy))

    def failover(self, stage: str, rep: int, kind: str, t_fault: float,
                 t_recovered: float, n_replayed: int) -> None:
        """One replica died and its work was adopted by survivors: span
        from fault detection to routing/caches/replay-queue restored
        (the replayed ops themselves complete later, on the engine's
        normal clock)."""
        self.events.append(TraceEvent(EV_FAILOVER, f"{stage}/r{rep}",
                                      t_recovered, kind, seq=n_replayed,
                                      t0=t_fault))
        self.failovers.append((stage, rep, t_fault, t_recovered, n_replayed))

    # -- fifo registration ---------------------------------------------------
    def watch_fifo(self, fifo, label: str, *, src: str | None = None,
                   dst: str | None = None) -> None:
        """Attach this tracer to ``fifo``: every push/pop emits a counter
        event under ``label``; ``src``/``dst`` name the producing and
        consuming stages (`metrics.attribute_bottleneck` needs them to
        blame the right party for a wait)."""
        fifo.tracer = self
        fifo.label = label
        self.fifo_watch[label] = FifoWatch(
            label=label, fifo=fifo, capacity=fifo.capacity,
            src=src, dst=dst)

    # -- derived views -------------------------------------------------------
    def stage_wait_s(self) -> dict[str, dict[str, float]]:
        """Per-stage blocked time by reason, summed over edges — the raw
        material for `measure`'s stall/starve columns."""
        out: dict[str, dict[str, float]] = {}
        for (stage, reason, _edge), s in self.wait_s.items():
            d = out.setdefault(stage, {})
            d[reason] = d.get(reason, 0.0) + s
        return out

    def track_sequences(self) -> dict[str, list[tuple]]:
        """Per-track event sequences with timestamps stripped — the
        driver-invariant view (wall and virtual clocks emit identical
        sequences for the same `Program`).  Wait events are excluded:
        *when* a driver observes blockage is clock policy, not program
        semantics."""
        out: dict[str, list[tuple]] = {}
        for ev in self.events:
            if ev.kind == EV_WAIT:
                continue
            out.setdefault(ev.track, []).append(
                (ev.kind, ev.name, ev.seq, ev.chunk, ev.value))
        return out

    def fifo_snapshot(self) -> list[str]:
        """Occupancy of every watched fifo right now — the deadlock
        report's who-holds-what line."""
        out = []
        for label, w in sorted(self.fifo_watch.items()):
            f = w.fifo
            line = f"{label}: {len(f)}/{f.capacity}"
            if f.inflight_slots:
                line += f" (+{f.inflight_slots} in flight)"
            out.append(line)
        return out

    def tail(self, stage: str | None = None, n: int = 8) -> list[TraceEvent]:
        """The last ``n`` events, optionally only those on ``stage``'s
        tracks — what each stuck party last did before a hang."""
        if stage is None:
            evs = list(self.events)
        else:
            evs = [ev for ev in self.events
                   if ev.track == stage or ev.track.startswith(stage + "/")]
        return evs[-n:]

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome-trace / Perfetto JSON: "X" duration slices on one track
        per (stage, replica) (op spans) plus one per stage (wait spans),
        and "C" counter tracks for fifo occupancy."""
        tids: dict[str, int] = {}
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "virtual clock (cycles as us)"
                     if self.virtual else "pipeline"}}]

        def tid(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids) + 1
                rank = self.rank_of.get(track)
                events.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                               "args": {"name": track if rank is None
                                        else f"{track} @ rank {rank}"}})
            return t

        # cycles export 1:1 as us — relative spans are what matter
        scale = 1.0 if self.virtual else 1e6
        for ev in self.events:
            if ev.kind == EV_RETIRE:
                events.append({
                    "name": f"{ev.name}{ev.seq}", "ph": "X", "pid": 0,
                    "tid": tid(ev.track), "ts": ev.t0 * scale,
                    "dur": max(0.0, (ev.t - ev.t0)) * scale,
                    "args": {"seq": ev.seq, "chunk": ev.chunk}})
            elif ev.kind == EV_WAIT:
                events.append({
                    "name": ev.name, "ph": "X", "pid": 0,
                    "tid": tid(f"{ev.track}/waits"), "ts": ev.t0 * scale,
                    "dur": max(0.0, (ev.t - ev.t0)) * scale,
                    "args": {"edge": ev.edge}})
            elif ev.kind in (EV_PUSH, EV_POP):
                events.append({
                    "name": f"fifo {ev.track}", "ph": "C", "pid": 0,
                    "ts": ev.t * scale,
                    "args": {"occupancy": ev.value}})
            elif ev.kind == EV_FAILOVER:
                events.append({
                    "name": f"failover ({ev.name})", "ph": "X", "pid": 0,
                    "tid": tid(ev.track), "ts": ev.t0 * scale,
                    "dur": max(0.0, (ev.t - ev.t0)) * scale,
                    "args": {"replayed_ops": ev.seq}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path
