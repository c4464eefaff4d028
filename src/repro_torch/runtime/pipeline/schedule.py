"""Microbatch pipeline schedules as first-class plan objects.

The paper's tool keeps *what* a node computes separate from *how* its
implementation is scheduled onto the array; this module does the same for
microbatch pipelines.  A `Schedule` is **data**, not executor control
flow: per physical stage, the ordered stream of ``SchedOp(kind, mb,
chunk)`` operations the stage executes — built by the free functions here
(`fill_drain`, `one_f_one_b`, `interleaved_1f1b`) and *consumed* by
executor programs.  Neither clock domain generates schedules: a
microbatch pipeline takes ``schedule=`` and runs whatever object it is
handed, and the same object runs under the virtual-clock driver
through `ScheduleProgram` / `simulate_schedule` (schedule dynamics —
bubble fraction, stalls — measured without touching hardware).  New
schedules (zero-bubble, looped serving) drop in without touching either
driver.

``chunk`` is the virtual-stage index of interleaved/looped schedules: a
physical stage hosting ``v`` chunks executes model stage ``chunk *
n_stages + s`` for each op — round-robin, so chunk 0 of every physical
stage covers the first ``n_stages`` model stages, chunk 1 the next, and
the activation/gradient edges remain the plain linear chain of model
stages.  Plain schedules use ``chunk == 0`` everywhere.

Copied from ``repro/runtime/pipeline/schedule.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

from .channels import Fifo
from .engine import (Engine, EventLoopStats, Op, describe_position,
                     run_event_loop)


class SchedOp(NamedTuple):
    """One scheduled operation: forward ("F") or backward ("B") of
    microbatch ``mb`` on virtual-stage ``chunk`` of its physical stage."""
    kind: str
    mb: int
    chunk: int = 0

    def describe(self) -> str:
        return f"{self.kind}(mb={self.mb},chunk={self.chunk})"


def _check_shape(n_stages: int, n_micro: int, n_chunks: int = 1) -> None:
    """The one shape gate every schedule factory and bubble model uses —
    including the ``n_micro < n_stages`` warmup degeneracy, which is legal
    (warmup simply saturates at ``n_micro``) but must be *handled*, never
    silently produce a stage with more warmup forwards than microbatches."""
    if n_stages < 1 or n_micro < 1 or n_chunks < 1:
        raise ValueError(f"bad schedule shape: {n_stages} stage(s) x "
                         f"{n_micro} microbatch(es) x {n_chunks} chunk(s)")


@dataclass
class Schedule:
    """A pipeline schedule as a first-class plan object.

    ``stage_ops[s]`` is physical stage ``s``'s ordered op stream;
    ``live_bounds[s]`` is the *analytic* in-flight-activation ceiling the
    stream is guaranteed to respect (checked by `validate`, asserted at
    runtime by the executors).  ``n_stages`` counts physical stages
    (programs); the model is cut into ``n_stages * n_chunks`` model
    stages, model stage of (s, chunk) being ``chunk * n_stages + s``.
    """
    name: str
    n_stages: int
    n_micro: int
    n_chunks: int
    stage_ops: list[list[SchedOp]]
    live_bounds: list[int] = field(default_factory=list)

    @property
    def n_model_stages(self) -> int:
        return self.n_stages * self.n_chunks

    @property
    def trains(self) -> bool:
        return any(op.kind == "B" for ops in self.stage_ops for op in ops)

    def model_stage(self, s: int, chunk: int) -> int:
        return chunk * self.n_stages + s

    def __len__(self) -> int:
        return self.n_stages

    def __getitem__(self, s: int) -> list[SchedOp]:
        return self.stage_ops[s]

    def __iter__(self):
        return iter(self.stage_ops)

    def flatten(self) -> list[tuple[int, SchedOp]]:
        """Every (physical stage, op) pair, stage-major in schedule order."""
        return [(s, op) for s, ops in enumerate(self.stage_ops)
                for op in ops]

    def validate(self) -> "Schedule":
        """Structural invariants every executable schedule must satisfy:
        each stage's stream covers every (mb, chunk) forward exactly once
        (and, for training schedules, every backward exactly once, each
        after its forward), and in-flight activations never exceed the
        declared ``live_bounds``.  Returns self, so factories end with
        ``return sched.validate()``."""
        if len(self.stage_ops) != self.n_stages:
            raise ValueError(f"{self.name}: {len(self.stage_ops)} op "
                             f"streams for {self.n_stages} stages")
        want_f = {(mb, c) for mb in range(self.n_micro)
                  for c in range(self.n_chunks)}
        for s, ops in enumerate(self.stage_ops):
            fs = [(op.mb, op.chunk) for op in ops if op.kind == "F"]
            bs = [(op.mb, op.chunk) for op in ops if op.kind == "B"]
            if len(fs) + len(bs) != len(ops):
                bad = {op.kind for op in ops} - {"F", "B"}
                raise ValueError(f"{self.name}: stage {s} has op kinds {bad}")
            if set(fs) != want_f or len(fs) != len(want_f):
                raise ValueError(
                    f"{self.name}: stage {s} forwards cover "
                    f"{len(set(fs))}/{len(want_f)} (mb, chunk) pairs "
                    f"({len(fs)} ops)")
            if bs and (set(bs) != want_f or len(bs) != len(want_f)):
                raise ValueError(
                    f"{self.name}: stage {s} backwards cover "
                    f"{len(set(bs))}/{len(want_f)} (mb, chunk) pairs")
            seen_f = set()
            for op in ops:
                if op.kind == "F":
                    seen_f.add((op.mb, op.chunk))
                elif (op.mb, op.chunk) not in seen_f:
                    raise ValueError(
                        f"{self.name}: stage {s} schedules B(mb={op.mb}, "
                        f"chunk={op.chunk}) before its F")
            live = max_live_activations(ops)
            bound = self.live_bounds[s] if self.live_bounds else live
            if live > bound:
                raise ValueError(
                    f"{self.name}: stage {s} holds {live} live "
                    f"activations, bound is {bound}")
        return self


def fill_drain(n_stages: int, n_micro: int) -> Schedule:
    """GPipe-style forward streaming: every stage runs all forwards in
    microbatch order — exactly the streaming order, so serving uses this."""
    _check_shape(n_stages, n_micro)
    ops = [[SchedOp("F", mb) for mb in range(n_micro)]
           for _ in range(n_stages)]
    return Schedule("fill_drain", n_stages, n_micro, 1, ops,
                    [n_micro] * n_stages).validate()


def one_f_one_b(n_stages: int, n_micro: int) -> Schedule:
    """1F1B (PipeDream-flush): stage s runs ``min(n_stages - s, n_micro)``
    warmup forwards, alternates B/F in steady state, then drains remaining
    backwards — bounding in-flight activations per stage to
    ``min(n_stages - s, n_micro)``.  ``n_micro < n_stages`` degenerates
    honestly: warmup saturates at ``n_micro`` and the steady phase is
    empty (pure fill-then-drain)."""
    _check_shape(n_stages, n_micro)
    stage_ops: list[list[SchedOp]] = []
    bounds: list[int] = []
    for s in range(n_stages):
        warmup = min(n_stages - s, n_micro)
        ops = [SchedOp("F", mb) for mb in range(warmup)]
        nf, nb = warmup, 0
        while nf < n_micro:                 # steady: one B then one F
            ops.append(SchedOp("B", nb)); nb += 1
            ops.append(SchedOp("F", nf)); nf += 1
        while nb < n_micro:                 # drain
            ops.append(SchedOp("B", nb)); nb += 1
        stage_ops.append(ops)
        bounds.append(warmup)
    return Schedule("one_f_one_b", n_stages, n_micro, 1, stage_ops,
                    bounds).validate()


def interleaved_1f1b(n_stages: int, n_micro: int, v: int) -> Schedule:
    """Interleaved (looped) 1F1B with ``v`` virtual chunks per physical
    stage — the Megatron-LM schedule.  The model is cut into
    ``n_stages * v`` chunks assigned round-robin (physical stage s hosts
    model stages ``c * n_stages + s``), so each warmup/drain element is
    one chunk (1/v of a stage's per-microbatch work) and the pipeline
    bubble shrinks by ~v (see `interleaved_bubble`), at the cost of up to
    ``(v - 1) * n_stages`` extra in-flight activations per stage.

    ``v == 1`` returns plain `one_f_one_b`.  For ``v > 1``,
    ``n_micro`` must be a multiple of ``n_stages`` (microbatches stream
    in groups of ``n_stages`` per chunk); ``n_micro == n_stages`` runs
    the all-warmup degenerate form.
    """
    _check_shape(n_stages, n_micro, v)
    if v == 1:
        return one_f_one_b(n_stages, n_micro)
    p, m = n_stages, n_micro
    if m % p:
        raise ValueError(
            f"interleaved_1f1b: n_micro={m} must be a multiple of "
            f"n_stages={p} (microbatches stream in groups of n_stages "
            f"per chunk)")
    total = m * v

    def f_id(k: int) -> tuple[int, int]:      # k-th forward -> (mb, chunk)
        return (k // (p * v)) * p + k % p, (k // p) % v

    def b_id(k: int) -> tuple[int, int]:      # k-th backward -> (mb, chunk)
        return (k // (p * v)) * p + k % p, v - 1 - (k // p) % v

    stage_ops: list[list[SchedOp]] = []
    bounds: list[int] = []
    for r in range(p):
        # m == p cannot sustain a steady phase: run all-warmup (Megatron's
        # special case) — fill everything, then drain everything
        warmup = total if m == p else \
            min(total, (p - r - 1) * 2 + (v - 1) * p)
        ops = [SchedOp("F", *f_id(k)) for k in range(warmup)]
        for j in range(total - warmup):       # steady: F then B
            ops.append(SchedOp("F", *f_id(warmup + j)))
            ops.append(SchedOp("B", *b_id(j)))
        for j in range(total - warmup, total):  # drain
            ops.append(SchedOp("B", *b_id(j)))
        stage_ops.append(ops)
        bounds.append(min(total, warmup + (1 if total > warmup else 0)))
    return Schedule(f"interleaved_1f1b(v={v})", p, m, v, stage_ops,
                    bounds).validate()


# ===========================================================================
# analytic bubble models
# ===========================================================================
def fill_drain_bubble(n_stages: int, n_micro: int) -> float:
    """Analytic pipeline-bubble fraction of a fill-drain stream: of the
    ``n_micro + n_stages - 1`` slot-times the last stage observes, the
    first ``n_stages - 1`` are ramp (no output) — the idle share a
    perfectly overlapped executor could at best recover by hiding
    transfers and host dispatch inside compute."""
    _check_shape(n_stages, n_micro)
    return (n_stages - 1) / (n_stages - 1 + n_micro)


def interleaved_bubble(n_stages: int, n_micro: int, v: int = 1) -> float:
    """Analytic bubble-fraction ceiling of (interleaved) 1F1B: warmup +
    drain idle ``(n_stages - 1)`` *chunk*-times per stage against
    ``v * n_micro`` chunk-times of useful work, so

        bubble = (p - 1) / (v * m + p - 1)

    ``v == 1`` is plain 1F1B's bubble (equal to fill-drain's — 1F1B
    bounds memory, not bubble); larger ``v`` divides the warmup/drain
    cost by the chunk count, the measurable payoff `simulate_schedule`
    and ``bench_pipeline`` line this ceiling up against."""
    _check_shape(n_stages, n_micro, v)
    return (n_stages - 1) / (v * n_micro + n_stages - 1)


# ===========================================================================
# live-activation accounting
# ===========================================================================
def max_live_activations(ops: list) -> int:
    """Peak forwards-minus-backwards over one stage's op stream — the
    activation (vjp residual) count the stage must hold."""
    live = peak = 0
    for op in ops:
        live += 1 if op[0] == "F" else -1
        peak = max(peak, live)
    return peak


def max_live_by_chunk(ops: list) -> dict[int, int]:
    """Chunk-aware live-activation peaks: per virtual chunk, the most
    (mb, chunk) activations simultaneously held — what the interleaved
    *and* plain 1F1B runtime asserts check (plain schedules are the
    single-chunk special case)."""
    live: dict[int, int] = {}
    peak: dict[int, int] = {}
    for op in ops:
        c = op.chunk if isinstance(op, SchedOp) else \
            (op[2] if len(op) > 2 else 0)
        live[c] = live.get(c, 0) + (1 if op[0] == "F" else -1)
        peak[c] = max(peak.get(c, 0), live[c])
    return peak


# ===========================================================================
# the schedule made executable: one Program, either driver
# ===========================================================================
class ScheduleProgram:
    """One physical stage's op stream as an engine `Program`, with a cost
    model standing in for the stage body.

    This is the schedule *itself* running on the executor core: real
    bounded FIFOs between model stages (activations forward, gradients
    backward), real credit accounting, op-by-op dispatch — only the
    compute is abstract (``cost(s, op)`` time units per op).  The same
    program objects run under **either driver**: `engine.run_event_loop`
    advances a virtual clock by each op's cost (deterministic schedule
    dynamics — the bubble measurement `bench_pipeline` reports), and
    `engine.Engine` executes the identical streams under the wall clock
    (optionally sleeping ``cost * wall_scale`` per op) — the two-drivers
    contract the engine tests pin.
    """

    def __init__(self, s: int, schedule: Schedule, acts: list[Fifo],
                 grds: list[Fifo], *, cost: Callable[[int, SchedOp], float],
                 trace: list, wall_scale: float = 0.0):
        self.s = s
        self.schedule = schedule
        self.name = f"stage{s}"
        self.n_replicas = 1
        self.ops = schedule.stage_ops[s]
        self.pos = 0
        self.acts = acts
        self.grds = grds
        self.cost = cost
        self.trace = trace
        self.wall_scale = wall_scale
        self.free_at = 0.0
        self.stall_mark = -1
        self.wait_reason = None   # (reason, fifo) of the last deferral
        self._f_done: dict[tuple[int, int], float] = {}   # (chunk, mb)
        self._peers: list[str] = [f"stage{r}"
                                  for r in range(schedule.n_stages)]
        self.M = schedule.n_model_stages

    def pending(self) -> int:
        return len(self.ops) - self.pos

    def peek(self) -> Op | None:
        if self.pos >= len(self.ops):
            return None
        k = self.ops[self.pos]
        return Op(stage=self.s, kind=k.kind, seq=k.mb, rep=0, chunk=k.chunk,
                  is_firing=(k.kind == "F"))

    def _model_stage(self, op: Op) -> int:
        return self.schedule.model_stage(self.s, op.chunk)

    def ready(self, op: Op, count_stall: bool = False) -> float | None:
        """Stalls are counted once per deferred op (``stall_mark`` dedup)
        under EITHER driver — same semantics as the decode programs —
        so FifoStats agree between a wall-clock and a virtual-clock run
        of the same schedule."""
        i, mb, M = self._model_stage(op), op.seq, self.M
        if op.kind == "F":
            t = 0.0
            if i > 0:
                rt = self.acts[i - 1].ready_time(1)
                if rt is None:
                    self.wait_reason = ("starve", self.acts[i - 1])
                    return None
                t = rt
            if i < M - 1 and not self.acts[i].can_push(1):
                if self.stall_mark != self.pos:
                    self.stall_mark = self.pos
                    self.acts[i].note_stall()
                self.wait_reason = ("credit", self.acts[i])
                return None
        else:
            done = self._f_done.get((op.chunk, mb))
            if done is None:
                self.wait_reason = ("dep", None)
                return None                    # own forward not retired yet
            t = done
            if i < M - 1:
                rt = self.grds[i].ready_time(1)
                if rt is None:
                    self.wait_reason = ("starve", self.grds[i])
                    return None
                t = max(t, rt)
            if i > 0 and not self.grds[i - 1].can_push(1):
                if self.stall_mark != self.pos:
                    self.stall_mark = self.pos
                    self.grds[i - 1].note_stall()
                self.wait_reason = ("credit", self.grds[i - 1])
                return None
        return max(t, self.free_at)

    def dispatch(self, op: Op, driver):
        i, mb, M = self._model_stage(op), op.seq, self.M
        if op.kind == "F":
            if i > 0:
                got, _ = self.acts[i - 1].pop_hold(1)[0]
                assert got == mb, f"act order broke: {got}!={mb}"
                op.releases.append((self.acts[i - 1], 1))
            if i < M - 1:
                self.acts[i].reserve(1)
        else:
            if i < M - 1:
                got, _ = self.grds[i].pop_hold(1)[0]
                assert got == mb, f"grd order broke: {got}!={mb}"
                op.releases.append((self.grds[i], 1))
            if i > 0:
                self.grds[i - 1].reserve(1)
        self.pos += 1
        c = self.cost(self.s, self.ops[self.pos - 1])
        if driver.virtual:
            start = driver.now
            return (lambda: start + c), ()
        dt = c * self.wall_scale

        def body():
            if dt > 0:
                time.sleep(dt)
            return time.perf_counter()
        return body, ()

    def retire(self, op: Op, result, driver) -> float:
        t_done = result
        i, mb, M = self._model_stage(op), op.seq, self.M
        if op.kind == "F":
            self._f_done[(op.chunk, mb)] = t_done
            if i < M - 1:
                driver.ordered_push(self.acts[i], mb, (mb, i), t_done)
        else:
            del self._f_done[(op.chunk, mb)]
            if i > 0:
                driver.ordered_push(self.grds[i - 1], mb, (mb, i), t_done)
        self.free_at = t_done
        driver.note_busy(self.name, t_done - op.t_dispatch)
        self.trace.append((self.s, op.kind, mb, op.chunk,
                           op.t_dispatch, t_done))
        driver.wake(*self._peers)
        return t_done

    def describe(self) -> str:
        return describe_position(self.name, self.pos, self.ops,
                                 SchedOp.describe)


def schedule_programs(schedule: Schedule, *,
                      f_cost: float | Callable = 1.0,
                      b_cost: float | Callable | None = None,
                      capacity_blocks: int = 4,
                      wall_scale: float = 0.0
                      ) -> tuple[list[ScheduleProgram], list]:
    """Build the programs + FIFO edges that execute ``schedule`` under
    either driver.  Costs are time units per op — scalars or callables
    ``(stage, op) -> float``; ``b_cost`` defaults to ``f_cost``.
    Returns ``(programs, trace)`` — the shared trace list fills with
    ``(stage, kind, mb, chunk, t_start, t_done)`` rows as ops retire."""
    fc = f_cost if callable(f_cost) else (lambda s, op: f_cost)
    bc = (b_cost if callable(b_cost) else (lambda s, op: b_cost)) \
        if b_cost is not None else fc

    def cost(s: int, op: SchedOp) -> float:
        return fc(s, op) if op.kind == "F" else bc(s, op)

    M = schedule.n_model_stages
    acts = [Fifo(block=1, capacity_blocks=capacity_blocks)
            for _ in range(M - 1)]
    grds = [Fifo(block=1, capacity_blocks=capacity_blocks)
            for _ in range(M - 1)] if schedule.trains else []
    trace: list = []
    programs = [ScheduleProgram(s, schedule, acts, grds, cost=cost,
                                trace=trace, wall_scale=wall_scale)
                for s in range(schedule.n_stages)]
    return programs, trace


@dataclass
class ScheduleRun:
    """One schedule execution under the virtual clock: the measured
    counterpart of the analytic bubble models."""
    schedule: Schedule
    makespan: float
    busy: dict[str, float]
    trace: list
    stats: EventLoopStats

    @property
    def bubble(self) -> float:
        """Measured bubble fraction (`measure.measured_bubble` over the
        event-loop stats): the idle share of the run's total stage-time
        budget — directly comparable to `interleaved_bubble` /
        `fill_drain_bubble` ceilings."""
        from .measure import measured_bubble
        return measured_bubble(self.stats)


def simulate_schedule(schedule: Schedule, *,
                      f_cost: float | Callable = 1.0,
                      b_cost: float | Callable | None = None,
                      capacity_blocks: int = 4,
                      tracer=None) -> ScheduleRun:
    """Execute ``schedule`` under the virtual-clock driver and measure
    its dynamics — dependency stalls, backpressure, and the realised
    bubble fraction — with per-op costs instead of hardware.  Raises if
    the schedule wedges (an infeasible op order deadlocks the FIFOs)
    rather than returning a silently truncated run."""
    programs, trace = schedule_programs(
        schedule, f_cost=f_cost, b_cost=b_cost,
        capacity_blocks=capacity_blocks)
    if tracer is not None:
        for i in range(len(programs[0].acts)):
            tracer.watch_fifo(programs[0].acts[i], f"act{i}",
                              src=f"stage{i}", dst=f"stage{i + 1}")
        for i in range(len(programs[0].grds)):
            tracer.watch_fifo(programs[0].grds[i], f"grd{i}",
                              src=f"stage{i + 1}", dst=f"stage{i}")
    stats = run_event_loop({p.name: p for p in programs}, tracer=tracer)
    stuck = [p.describe() for p in programs if p.pending()]
    if stuck:
        raise RuntimeError(
            f"schedule {schedule.name} wedged under simulation — "
            f"infeasible op order or undersized buffers ({'; '.join(stuck)})")
    return ScheduleRun(schedule=schedule, makespan=stats.cycles,
                       busy=dict(stats.busy_cycles), trace=trace,
                       stats=stats)
