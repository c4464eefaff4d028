"""Deterministic failure injection for fault-tolerance tests/drills.

Copied whole from ``repro/runtime/failures.py``; the port's engine
(`pipeline.engine.Engine`) raises `PipelineFailure` and catches
`ReplicaFault`.  The port has only the wall-clock driver.

At real pod scale, failures arrive as ICI timeouts, host kernel panics and
preemptions; the runtime's contract is the same either way: the step loop
dies, the job controller restarts it, and training resumes from the last
committed checkpoint with identical data order.  The injector reproduces
that contract deterministically so it can be asserted in CI.

Two granularities live here:

  * `FailureInjector` — step-granularity crashes/stalls for the training
    step loop (the resilient-trainer drill: die, restart, resume from
    checkpoint).  ``new_incarnation()`` re-arms the schedule so a
    multi-restart drill can kill the *same* step twice — a replaced node
    and a flaky node are different fault models, and only the caller
    knows which one a drill wants.
  * `ReplicaFaultPlan` — op-granularity faults against a specific
    ``(stage, replica)`` of a running pipeline.  Both executor drivers
    (`pipeline.engine.Engine` and the JAX package's `EventLoop`) consult the plan right
    before every op dispatch, so a chaos drill fires at a deterministic
    point in the op stream on either clock domain.  ``crash`` marks the
    replica dead and triggers the engine's failover path; ``stall:<s>``
    wraps the op body in a host-side sleep (a straggler — wall-clock
    driver only; the virtual clock has no host time to burn, so stalls
    are recorded as skipped there).

`PipelineFailure` is the *structured* escalation the engine raises when
failover is impossible (a single-replica stage died, or a program has no
failover hook): it carries the failed (stage, replica), the fault kind,
and the same diagnostic bundle the deadlock report prints — fifo
occupancy, per-stage wait reasons, schedule positions, trace tail — so
an unrecoverable fault surfaces as evidence, not as a hang.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class SimulatedNodeFailure(RuntimeError):
    """A node 'died' (injected). The trainer must not catch this per-step;
    only the resilient wrapper restarts from the last checkpoint."""


class ReplicaFault(RuntimeError):
    """One pipeline replica 'died' (injected or real): raised from an op
    body, or synthesised by the driver when a `ReplicaFaultPlan` entry
    fires.  The engine converts it into failover (surviving replicas
    adopt the dead one's work) or a `PipelineFailure` escalation."""

    def __init__(self, message: str, *, stage: str = "", replica: int = -1):
        super().__init__(message)
        self.stage = stage
        self.replica = replica


class PipelineFailure(RuntimeError):
    """An unrecoverable pipeline fault, with evidence attached.

    ``stage``/``replica`` name the party that died; ``reason`` is the
    fault kind ("crash", "stall:..", or a backend-specific string);
    ``diagnostics`` is the engine's forensic bundle (fifo occupancy,
    wait reasons, schedule positions, failover history, trace tail) —
    the same material the deadlock report prints, structured."""

    def __init__(self, message: str, *, stage: str = "", replica: int = -1,
                 reason: str = "replica-fault",
                 diagnostics: dict | None = None):
        super().__init__(message)
        self.stage = stage
        self.replica = replica
        self.reason = reason
        self.diagnostics = dict(diagnostics or {})

    def describe(self) -> str:
        lines = [f"pipeline failure at {self.stage}/r{self.replica} "
                 f"({self.reason}): {self}"]
        for key, val in sorted(self.diagnostics.items()):
            lines.append(f"  {key}: {val}")
        return "\n".join(lines)


@dataclass
class FailureInjector:
    """Schedule: {step: kind}; kind in {"crash", "stall:<seconds>"}.

    ``crash``  — raise SimulatedNodeFailure before the step executes.
    ``stall:x``— sleep x seconds (a straggler; the monitor should flag it).
    Each entry fires once *per incarnation*: within one incarnation a
    re-scheduled step does not re-fire (a replaced node stays replaced),
    but `new_incarnation()` / `reset()` re-arms the schedule so a
    multi-restart drill can model a flaky node that keeps failing after
    every restart.  ``log`` records (incarnation, step, kind) for every
    firing across the drill.
    """
    schedule: dict[int, str] = field(default_factory=dict)
    fired: set[int] = field(default_factory=set)
    log: list[tuple[int, int, str]] = field(default_factory=list)
    incarnation: int = 0

    def maybe_fail(self, step: int) -> None:
        kind = self.schedule.get(step)
        if kind is None or step in self.fired:
            return
        self.fired.add(step)
        self.log.append((self.incarnation, step, kind))
        if kind == "crash":
            raise SimulatedNodeFailure(f"injected node failure at step {step}")
        if kind.startswith("stall:"):
            time.sleep(float(kind.split(":", 1)[1]))
            return
        raise ValueError(f"unknown failure kind {kind!r}")

    def reset(self) -> None:
        """Re-arm every schedule entry (the drill's restart boundary):
        ``fired`` is per-incarnation state, not drill-lifetime state."""
        self.fired.clear()
        self.incarnation += 1

    # restart-boundary alias, mirroring StragglerMonitor.new_incarnation
    new_incarnation = reset


# ===========================================================================
# op-granularity replica faults (pipeline chaos drills)
# ===========================================================================
@dataclass
class ReplicaFaultSpec:
    """Kill or stall ``(stage, replica)`` at a chosen point in its op
    stream.  ``unit`` selects the trigger coordinate: ``"op"`` counts the
    replica's own dispatches (the Nth op this replica runs), ``"tok"``
    watches the global sequence number (the Nth token/op of the whole
    stream — what a serving drill means by "kill r1 at token 64").
    ``repeat`` lets a stall recur (a persistently slow replica); a crash
    is permanent after one firing regardless."""
    stage: str
    replica: int
    at: int
    unit: str = "op"             # "op" | "tok"
    kind: str = "crash"          # "crash" | "stall:<seconds>"
    repeat: int = 1

    def describe(self) -> str:
        return f"{self.stage}:r{self.replica}@{self.unit}{self.at}={self.kind}"

    @property
    def stall_s(self) -> float:
        return float(self.kind.split(":", 1)[1]) \
            if self.kind.startswith("stall:") else 0.0


@dataclass
class ReplicaFaultPlan:
    """A deterministic chaos schedule over pipeline op dispatches.

    Drivers call ``check(stage, replica, seq)`` before every dispatch;
    the plan counts that replica's dispatches and returns the first
    armed `ReplicaFaultSpec` whose trigger is reached (``None``
    otherwise).  Like `FailureInjector`, entries fire once per
    incarnation (``repeat`` raises the per-incarnation budget for
    stalls) and ``reset()``/``new_incarnation()`` re-arms them."""
    faults: list[ReplicaFaultSpec] = field(default_factory=list)
    log: list[tuple] = field(default_factory=list)
    incarnation: int = 0
    _fired: dict[int, int] = field(default_factory=dict)   # spec idx -> count
    _dispatched: dict[tuple, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, *specs: str) -> "ReplicaFaultPlan":
        """Build a plan from compact drill strings, e.g.
        ``"blocks00:r1@tok64=crash"`` or ``"embed:r0@op8=stall:0.05x16"``
        (``x16`` = repeat budget).  Grammar:
        ``<stage>:r<replica>@<op|tok><N>=<crash|stall:<s>[x<repeat>]>``.
        """
        out = []
        for spec in specs:
            try:
                where, kind = spec.split("=", 1)
                stage, at_part = where.split(":r", 1)
                rep, trigger = at_part.split("@", 1)
                unit = "tok" if trigger.startswith("tok") else "op"
                if not trigger.startswith(unit):
                    raise ValueError(f"trigger {trigger!r}")
                at = int(trigger[len(unit):])
                repeat = 1
                if kind.startswith("stall:") and "x" in kind.split(":", 1)[1]:
                    secs, reps = kind.split(":", 1)[1].split("x", 1)
                    kind, repeat = f"stall:{secs}", int(reps)
                if kind.startswith("stall:"):
                    float(kind.split(":", 1)[1])
                elif kind != "crash":
                    raise ValueError(f"kind {kind!r}")
                out.append(ReplicaFaultSpec(
                    stage=stage, replica=int(rep), at=at, unit=unit,
                    kind=kind, repeat=repeat))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault spec {spec!r} (want "
                    f"'<stage>:r<N>@<op|tok><K>=<crash|stall:<s>[xR]>'): {e}"
                ) from e
        return cls(faults=out)

    def check(self, stage: str, replica: int,
              seq: int) -> ReplicaFaultSpec | None:
        """Account one imminent dispatch on ``(stage, replica)`` and
        return the spec to fire now, if any."""
        key = (stage, replica)
        nth = self._dispatched[key] = self._dispatched.get(key, 0) + 1
        for i, spec in enumerate(self.faults):
            if spec.stage != stage or spec.replica != replica:
                continue
            budget = 1 if spec.kind == "crash" else max(1, spec.repeat)
            if self._fired.get(i, 0) >= budget:
                continue
            coord = nth if spec.unit == "op" else seq
            if coord >= spec.at:
                self._fired[i] = self._fired.get(i, 0) + 1
                self.log.append((self.incarnation, stage, replica, seq,
                                 spec.kind))
                return spec
        return None

    @property
    def fired(self) -> int:
        """Total firings this incarnation (drills assert the fault
        actually happened — a chaos run that never fired is vacuous)."""
        return sum(self._fired.values())

    def reset(self) -> None:
        """Restart boundary: re-arm every spec and restart the per-replica
        dispatch counters for the next incarnation."""
        self._fired.clear()
        self._dispatched.clear()
        self.incarnation += 1

    new_incarnation = reset
