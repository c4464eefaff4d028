"""The executor core: one Program protocol and two clock drivers.

Copied from ``repro/runtime/pipeline/engine.py``: `Program`, `Op`,
`Driver`, `Engine`, `EngineResult`, the deadlock diagnostics, replica
failover and the virtual-clock `EventLoop`, with the names and behaviour
unchanged.  What changes is how an op says its device work is done: a
`DeviceWatch`, a CUDA event recorded on the stage's stream after the op
body, where the JAX package watches a `jax.Array`.

  * A `Program` is an op stream with ``ready``/``dispatch``/``retire``
    semantics: ``peek`` exposes the next scheduled `Op`, ``ready``
    answers whether it could run (any non-None; ``None`` = blocked on
    tokens/credits), ``dispatch`` consumes inputs, reserves output
    credits, and returns a thunk, and ``retire`` pushes outputs and
    returns the op's completion timestamp.  The driver owns *when*; the
    program owns *what*.  Op queues may grow while the driver runs
    (decode schedules ops as sampled tokens stream back), so termination
    is pending-or-inflight, not a precomputed op count.

  * **`Engine`** — the asynchronous overlapped scheduler.  Scans programs
    downstream-first, hands dispatched ops to worker threads (`Lanes`; or
    runs them inline under ``overlap=False``), retires them on completion
    events, releases channel credits (also on failure — no leaked slots),
    and records completion-time streams.  An op body may return an
    `AsyncResult` — "launched on the device, not complete": the worker
    returns immediately (no per-op host sync) and the engine retires the
    op when its watch set reports ready, so a worker launches the next op
    while the previous one still runs.  Backends: `decode.DecodePipeline`
    (prefill/decode serving) and `schedule.ScheduleProgram`.

  * **`run_event_loop`** (virtual clock) — the discrete-event driver.
    Owns the heap, candidate re-queueing, wake-set propagation, and the
    firing/cycle caps; programs own rates, busy clocks, and token
    semantics.  Backends: the host interpreter's per-node programs and
    `schedule.ScheduleProgram` (schedules simulated as data).  A program
    written once runs under either clock and emits the same events.

  * **Failover.**  A `failures.ReplicaFaultPlan` (``injector=``) is
    consulted before every dispatch: a firing ``crash`` kills the op's
    replica, a ``stall`` wraps the op body in a host-side sleep; an op
    body may also raise `failures.ReplicaFault`.  `_replica_fault`
    drains the dead replica's ops (their outputs discarded, their
    credits freed) and hands them, each with its ``Op.recover`` payload,
    to the program's ``fail_replica`` hook, which remaps routing and
    queues their replay under the original sequence numbers; with no
    hook or no survivor it raises `failures.PipelineFailure` carrying
    `diagnostic_bundle`.  ``on_tick`` runs every ``tick_every``
    retirements (the `health.HealthController` attachment point), and a
    deadlock report cross-references the static preflight's report
    (``static_report``).

Against the JAX engine, the worker threads are `Lanes`: each (stage,
replica) keeps one thread, where the JAX engine hands every op to any
thread of one pool.  PyTorch keeps a cuBLAS handle a thread and a cuBLAS
workspace a (handle, stream); with a lane a (stage, replica), the pairs a
serve reaches are the ones a warm-up on the same lanes made.  An op's
device work runs on its (stage, replica)'s CUDA stream, so a drained op
may still be running there after its body returned: the program's
``fail_replica`` orders what it drops or rebuilds after that stream
(`decode.DecodePipeline`).  The lanes belong to the caller and outlive a
`PipelineFailure`: the next run on them starts clean.

Over ranks (`remote`), the controller's engine runs the same programs; an
op body there only posts the op's commands (`RemoteLanes` runs it inline)
and returns a `RemoteWatch`, ready when the ranks of the op's slice have
reported it done; the work runs on each rank's own `Lanes`.  Such a program
has a ``stall_s`` slot, which the engine fills with an injected stall before
``dispatch`` so that the command carries it (the op's lane on its rank
sleeps, not the scheduler), and a ``drain_lost`` hook, which
`_replica_fault` calls before ``fail_replica`` so that the lost ops'
commands are waited home, their reports dropped and what they made freed on
their rank.

The measurement surface is per-stage streams of completion (or firing)
times whose steady-state gap is the stage's measured inverse throughput
(`steady_inverse`); a replicated stage's streams merge, so the measured
value reads ii/nr in either clock domain.
"""
from __future__ import annotations

import heapq
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import torch

from ..failures import PipelineFailure, ReplicaFault
from .channels import Fifo


def steady_inverse(samples: Iterable[float], warmup_frac: float = 0.25,
                   min_samples: int = 4) -> float:
    """Steady-state gap of one completion/firing-time stream: drop the
    pipeline-fill ramp, then average the remaining inter-event gaps.
    Raises ValueError below ``min_samples`` — callers decide their own
    degraded fallback (or skip the stage)."""
    ts = sorted(samples)
    if len(ts) < min_samples:
        raise ValueError(f"too few samples ({len(ts)} < {min_samples})")
    k = max(1, int(len(ts) * warmup_frac))
    window = ts[k:]
    if len(window) < 2 or window[-1] <= window[0]:
        raise ValueError("degenerate completion stream (no measurable gap)")
    return (window[-1] - window[0]) / (len(window) - 1)


# ===========================================================================
# the one protocol
# ===========================================================================
@dataclass
class Op:
    """One dispatched firing, in flight between dispatch and retirement.

    ``seq`` orders the op on every edge it crosses (microbatch index for
    LM pipelines, global stream index for decode); ``chunk`` is the
    virtual-stage index for interleaved schedules (0 for plain ones);
    ``releases`` lists (fifo, n) credits the driver frees at retirement —
    also on *failed* ops, so a raising stage body cannot leak channel
    slots."""
    stage: int
    kind: str
    seq: int
    rep: int
    chunk: int = 0
    t_dispatch: float = 0.0
    releases: list = field(default_factory=list)       # (Fifo, n)
    is_firing: bool = True       # contributes to the stage's completion
    #                              stream (microbatch pipelines: forward
    #                              ops only)
    recover: tuple | None = None  # program-defined replay payload: what
    #                               `fail_replica` needs to re-issue this
    #                               op on a surviving replica (inputs were
    #                               consumed at dispatch; a lost op cannot
    #                               re-pop them)


@runtime_checkable
class Program(Protocol):
    """The one per-stage interface both clock domains drive.

    The driver owns *when*; the program owns *what*: which op comes next
    (``peek``), when its data/credits allow it to run (``ready`` — claim
    nothing; return the earliest feasible time under a virtual clock,
    any non-None under the wall clock, None when blocked;
    ``count_stall`` marks re-checks where a deferral is a real producer
    stall, not a readiness probe), how to run it (``dispatch`` — consume
    inputs, reserve output credits, return a thunk safe to run on a
    worker thread), and what its completion means (``retire`` — push
    outputs via ``driver.ordered_push``, return the op's completion
    timestamp).  ``describe`` is the deadlock/wedge diagnostic: it names
    the stage's schedule position — next op index and (kind, mb, chunk)
    — so a stall points at the schedule line, not just a FIFO."""

    name: str
    n_replicas: int

    def pending(self) -> int: ...
    def peek(self) -> Op | None: ...
    def ready(self, op: Op, count_stall: bool = False) -> float | None: ...
    def dispatch(self, op: Op, driver: "Driver") -> tuple[Callable, tuple]: ...
    def retire(self, op: Op, result: Any, driver: "Driver") -> float: ...
    def describe(self) -> str: ...


# the historical name for wall-clock programs; same protocol now
StageProgram = Program


class DeviceWatch:
    """The completion future of an op body's device work: a CUDA event
    recorded on the current stream of ``device``, after everything the
    body launched there.  ``is_ready`` polls it (``Event.query``),
    ``block_until_ready`` waits for it (``Event.synchronize``).  On the
    CPU the work is done when the body returns, so the watch is complete
    at once."""

    __slots__ = ("event",)

    def __init__(self, device):
        self.event = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def block_until_ready(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class RemoteWatch:
    """The completion future of an op whose body runs on other ranks
    (`remote.Controller`): ready once every rank of its slice reported it
    done, polled as a `DeviceWatch` is (``is_ready`` takes the reports
    that came, without waiting).  A rank's reported failure raises here,
    naming the rank and the op; ``block_until_ready`` waits within the
    pool's time limit."""

    __slots__ = ("ctl", "cid", "ranks", "what")

    def __init__(self, ctl, cid: int, ranks, what: str):
        self.ctl, self.cid, self.ranks, self.what = ctl, cid, tuple(ranks), what

    def is_ready(self) -> bool:
        self.ctl.poll()
        return self.ctl.done(self.cid, self.ranks)

    def block_until_ready(self) -> None:
        self.ctl.wait(self.cid, self.ranks, self.what, take=False)


class AsyncResult:
    """An op body's non-blocking return: device work was *launched* but
    not awaited.  ``payload`` is the tuple ``retire`` expects minus its
    trailing completion timestamp (the engine appends one when completion
    is observed); ``watch`` is a small list of duck-typed completion
    futures — objects with ``is_ready()`` / ``block_until_ready()``, a
    `DeviceWatch` — whose readiness marks the op complete.  One watch an
    op body: an event recorded after its last launch on its stream covers
    everything before it there, and the engine polls the watch set every
    sweep."""

    __slots__ = ("payload", "watch")

    def __init__(self, payload: tuple, watch: list):
        self.payload = payload
        self.watch = list(watch)

    def is_ready(self) -> bool:
        return all(w.is_ready() for w in self.watch)

    def block(self) -> None:
        for w in self.watch:
            w.block_until_ready()


def describe_position(name: str, pos: int, ops, fmt: Callable) -> str:
    """The shared ``Program.describe`` diagnostic line: a stage's schedule
    position — next op index and the op itself (``fmt``-rendered) — so
    every backend's deadlock/wedge report points at the same place."""
    if pos >= len(ops):
        return f"{name}: done {pos}/{len(ops)}"
    return f"{name}: op {pos}/{len(ops)} next={fmt(ops[pos])}"


class Driver:
    """What every clock domain offers its programs: per-edge reorder
    buffers (slots are reserved at dispatch, so deferred pushes cannot
    overflow, and each fifo stays seq-sorted no matter which replica
    retires first), wake hooks (virtual domain: which programs to
    re-examine after a retirement; wall domain: a no-op — the engine
    rescans every sweep), busy accounting, and the shared tracing hook:
    a `trace.Tracer` attached here makes BOTH drivers emit the same
    typed event stream (op dispatch/retire spans, credit/starve/reorder
    waits) for the same `Program`."""

    virtual: bool = False

    def __init__(self, tracer=None):
        self._reorder: dict[int, tuple[dict, list]] = {}
        self.t0 = 0.0
        self.tracer = tracer

    def ordered_push(self, fifo: Fifo, seq: int, tok, t_done: float) -> None:
        """Stage an out-of-order completion so ``fifo`` receives tokens in
        seq order (slots were reserved at dispatch; cannot overflow)."""
        pend, nxt = self._reorder.setdefault(id(fifo), ({}, [0]))
        pend[seq] = (tok, t_done)
        while nxt[0] in pend:
            tok_i, t_i = pend.pop(nxt[0])
            fifo.push_reserved([(nxt[0], tok_i)], t_i)
            nxt[0] += 1

    def wake(self, *names: str) -> None:
        pass

    def note_busy(self, name: str, amount: float) -> None:
        pass

    def reorder_occupancy(self) -> int:
        """Tokens parked in reorder buffers across every edge — 0 at
        quiescence.  A permanently missing seq (a dead replica whose op
        was never replayed) shows up here as a stuck nonzero count, which
        is why failover re-issues lost ops under their *original*
        sequence numbers."""
        return sum(len(pend) for pend, _ in self._reorder.values())

    def wait_reason_of(self, prog) -> tuple[str, str]:
        """Classify why ``prog`` just deferred: programs leave a
        ``wait_reason = (reason, fifo)`` breadcrumb when ``ready``
        returns None; the driver refines an input-empty wait into a
        *reorder* wait when the tokens exist but sit in its reorder
        buffer (an out-of-order replica retirement, not a rate
        mismatch).  Returns ``(reason, edge_label)``."""
        r = getattr(prog, "wait_reason", None)
        if not r:
            return ("blocked", "")
        reason, fifo = r
        label = getattr(fifo, "label", None) or "" if fifo is not None else ""
        if reason == "starve" and fifo is not None:
            pend = self._reorder.get(id(fifo))
            if pend and pend[0]:
                reason = "reorder"
        return (reason, label)

    def idle_reason_of(self, prog) -> tuple[str, str] | None:
        """Why ``prog``'s op queue is *empty* (vs ``wait_reason_of``,
        which explains a deferred nonempty queue).  Programs whose ops
        are scheduled by upstream traffic (decode stages waiting on the
        head's token loop) expose an optional ``idle_reason()`` hook
        returning ``(reason, fifo)`` or None; without it — or once the
        program reports the stream over — an empty queue is not a wait.
        This is what puts the *source* stage (embed) into
        ``stage_wait_s``: its queue refills and its feedback token land
        in the same head retirement, so the nonempty-queue wait path
        never fires for it."""
        hook = getattr(prog, "idle_reason", None)
        if hook is None:
            return None
        r = hook()
        if r is None:
            return None
        reason, fifo = r
        label = getattr(fifo, "label", None) or "" if fifo is not None else ""
        return (reason, label)


# ===========================================================================
# wall-clock driver: asynchronous overlapped scheduler
# ===========================================================================
@dataclass
class EngineResult:
    """The generic half of an execution's result: per-stage timing streams
    and op bookkeeping.  Backends embed/alias these fields into their own
    result types (`LMPipelineResult`, `ServeRunResult`)."""
    stage_seconds: dict[str, float] = field(default_factory=dict)
    stage_firings: dict[str, int] = field(default_factory=dict)
    stage_done_s: dict[str, list[float]] = field(default_factory=dict)
    stage_dispatch_s: dict[str, float] = field(default_factory=dict)
    # host wall time spent *inside* op bodies (device_put + program
    # dispatch) per stage — the host-overhead share of stage time, kept
    # separate so dispatch cost is visible data, not folded into the
    # measured inverse throughput
    op_trace: list = field(default_factory=list)
    # (stage, kind, seq, replica, t_dispatch, t_done) run-relative
    max_inflight: int = 0
    wall_s: float = 0.0
    stage_wait_s: dict[str, dict[str, float]] = field(default_factory=dict)
    # stage -> {reason: seconds blocked} — credit (output full) vs starve
    # (input empty) vs reorder attribution; populated only when the run
    # was traced (the accounting rides the tracer's enable flag so the
    # default path stays untouched)
    failovers: list = field(default_factory=list)
    # one dict per survived replica fault: {stage, replica, kind,
    # t_fault_s, recovery_s, replayed_ops} — the drill's recovery-time
    # and tokens-lost evidence

    def stage_inverse_us(self, name: str) -> float:
        """Steady-state microseconds per firing of one stage (merged
        replica completion streams -> effective ii/nr).  Runs too short
        for a steady state fall back to mean in-flight latency per op —
        a degraded mode callers should not calibrate on."""
        try:
            return steady_inverse(self.stage_done_s.get(name, ())) * 1e6
        except ValueError:
            n = self.stage_firings.get(name, 0)
            return (self.stage_seconds.get(name, 0.0) / n * 1e6
                    if n else float("nan"))

    def stage_host_us(self, name: str) -> float:
        """Host-side dispatch microseconds per firing of one stage: wall
        time its op bodies spent on the host (transfers issued, program
        dispatched) divided by firings — the overhead the async executor
        hides under device compute, surfaced as its own number."""
        n = self.stage_firings.get(name, 0)
        return (self.stage_dispatch_s.get(name, 0.0) / n * 1e6
                if n else float("nan"))


def _stalled(fn: Callable, stall_s: float) -> Callable:
    """Wrap an op body in a host-side sleep — the injected-straggler
    shape: the replica is alive but every firing it runs is slow."""
    def wrapped(*args):
        time.sleep(stall_s)
        return fn(*args)
    return wrapped


class Lanes:
    """The engine's worker threads: ``n`` lanes of one thread each, and
    every (stage, replica) on one lane for good (``lane``).  An op body
    thus always runs on the thread that the (stage, replica)'s warm-up
    ran on.  Threads start at a lane's first op and live until
    ``close``."""

    def __init__(self, replicas: list[int], n: int):
        self.n = max(1, n)
        self._base = [sum(replicas[:s]) for s in range(len(replicas))]
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"lane{i}")
                       for i in range(self.n)]

    def lane(self, stage: int, rep: int) -> int:
        return (self._base[stage] + rep) % self.n

    def submit(self, stage: int, rep: int, fn, *args):
        return self._pools[self.lane(stage, rep)].submit(fn, *args)

    def relayout(self, replicas: list[int]) -> "Lanes":
        """The same threads under another numbering of (stage, replica):
        a microbatch pipeline's interleaved schedule runs several built
        stages in one program.  The view does not own the threads: close
        the lanes it came from."""
        view = Lanes.__new__(Lanes)
        view.n, view._pools = self.n, self._pools
        view._base = [sum(replicas[:s]) for s in range(len(replicas))]
        return view

    def close(self) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True)


class RemoteLanes(Lanes):
    """The lanes of a pipeline over ranks, on its controller: every op body
    there only posts its commands and returns a `RemoteWatch` (the work
    runs on the ranks' own lanes), so it runs at once on the scheduler
    thread and its future comes back done.  With nothing to dispatch, the
    engine polls every op's watch again (``polled``) instead of waiting for
    the oldest: a stalled op on one rank must not hold up the reports of
    the others."""

    polled = True

    def __init__(self):
        self.n = 1

    def submit(self, stage: int, rep: int, fn, *args):
        fut: Future = Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def relayout(self, replicas: list[int]) -> "Lanes":
        return self

    def close(self) -> None:
        pass


class Engine(Driver):
    """Wall-clock driver: non-blocking scheduler over a list of `Program`s.

    ``overlap=True`` hands dispatched ops to worker threads and retires
    them on completion; ``overlap=False`` is the serial A/B baseline
    (dispatch, block, advance).  ``replica_queue`` caps in-flight ops per
    stage replica (1 = strict serial worker, 2 = short device queue).
    """

    # how long a no-progress sweep waits on worker futures before
    # re-polling the device-completion watch sets (seconds)
    POLL_S = 5e-4

    def __init__(self, programs: list, *, overlap: bool = True,
                 workers: int = 8, replica_queue: int = 2,
                 tracer=None, fifos: dict | None = None,
                 lanes: Lanes | None = None, injector=None,
                 on_tick: Callable | None = None, tick_every: int = 64,
                 static_report=None):
        """``tracer``: optional `trace.Tracer` — op spans, wait spans, and
        per-stage stall/starve accounting (off = zero-cost path).
        ``fifos``: {label: Fifo} for the deadlock report's occupancy
        snapshot (independent of tracing).  ``lanes``: the worker threads
        of an overlapped run, kept by the caller across runs; None makes
        ``workers`` lanes for the run and closes them after it.
        ``injector``: optional `failures.ReplicaFaultPlan` consulted
        before every dispatch — a firing ``crash`` marks the op's replica
        dead and triggers failover, a ``stall`` wraps the op body in a
        host-side sleep.  ``on_tick(engine)``: optional health hook
        invoked every ``tick_every`` retirements from the scheduler
        thread (the `HealthController` attachment point).
        ``static_report``: the `core.verify.VerificationReport` this run
        was preflighted with (None = preflight skipped) — a runtime
        deadlock cross-references it so the report says whether the
        wedge matches a static finding or the plan was proven
        deadlock-free."""
        super().__init__(tracer)
        self.programs = list(programs)
        self.fifos = dict(fifos or {})
        self.static_report = static_report
        self.overlap = overlap
        self.workers = max(1, workers)
        self.replica_queue = max(1, replica_queue)
        self.lanes = lanes
        self.injector = injector
        self.on_tick = on_tick
        self.tick_every = max(1, tick_every)
        self._retired_n = 0
        self.result = EngineResult()
        self._busy = [[0] * max(1, p.n_replicas) for p in self.programs]
        self._inflight: dict = {}     # future -> Op (worker running)
        self._pending: list = []      # (Op, AsyncResult): device in flight
        for p in self.programs:
            self.result.stage_seconds[p.name] = 0.0
            self.result.stage_firings[p.name] = 0
            self.result.stage_done_s[p.name] = []
            self.result.stage_dispatch_s[p.name] = 0.0

    def _retire(self, op: Op, result) -> None:
        prog = self.programs[op.stage]
        t_done = prog.retire(op, result, self)
        for fifo, n in op.releases:
            fifo.release(n)
        self._busy[op.stage][op.rep] -= 1
        res = self.result
        if op.is_firing:
            res.stage_done_s[prog.name].append(t_done - self.t0)
        res.stage_seconds[prog.name] += t_done - op.t_dispatch
        res.stage_firings[prog.name] += 1
        res.op_trace.append((prog.name, op.kind, op.seq, op.rep,
                             op.t_dispatch - self.t0, t_done - self.t0))
        if self.tracer is not None:
            self.tracer.op_retire(prog.name, op.rep, op.kind, op.seq,
                                  op.chunk, op.t_dispatch - self.t0,
                                  t_done - self.t0)
        self._retired_n += 1
        if self.on_tick is not None \
                and self._retired_n % self.tick_every == 0:
            self.on_tick(self)

    def _settle(self, op: Op, result, t_done: float) -> None:
        """Retire a completed op, unwrapping an `AsyncResult` by appending
        the observed completion timestamp to its payload."""
        if isinstance(result, AsyncResult):
            result = result.payload + (t_done,)
        self._retire(op, result)

    def _abort(self, op: Op) -> None:
        """An op's body raised: free its channel credits and busy slot so
        the failure surfaces as the exception, not as a leaked-slot
        deadlock in some later run."""
        for fifo, n in op.releases:
            fifo.release(n)
        self._busy[op.stage][op.rep] -= 1

    def diagnostic_bundle(self) -> dict:
        """The deadlock report's forensics as structured data — what a
        `PipelineFailure` carries out of the run: every registered
        fifo's occupancy, each stuck program's wait reason and schedule
        position, reorder-buffer depth, failover history, trace tail."""
        bundle: dict = {
            "fifo_occupancy": {
                label: {"len": len(f), "capacity": f.capacity,
                        "inflight_slots": f.inflight_slots}
                for label, f in sorted(self.fifos.items())},
            "waiting": {p.name: self.wait_reason_of(p)
                        for p in self.programs if p.pending()},
            "schedule": [p.describe() for p in self.programs],
            "reorder_occupancy": self.reorder_occupancy(),
            "failovers": list(self.result.failovers),
            "static_preflight": (self.static_report.summary()
                                 if self.static_report is not None
                                 else {"ran": False}),
        }
        if self.tracer is not None:
            bundle["trace_tail"] = [
                f"{e.track}:{e.kind} {e.name}{e.seq if e.seq >= 0 else ''}"
                f"@{e.t:.4g}" for e in self.tracer.tail(n=12)]
        return bundle

    def _replica_fault(self, s: int, rep: int, kind: str, lost0=()) -> None:
        """Whole-replica abort + failover: replica ``rep`` of stage ``s``
        died.  Drain its ops — wait each body still on its lane home,
        discard its output, release every credit it held — and hand the
        lost ops, sorted by seq, each carrying its ``recover`` payload,
        to the program's ``fail_replica`` hook, which remaps routing and
        queues the replay.  A drained op's kernels may still be queued
        on the replica's stream: the hook orders what it drops or
        rebuilds after them.  A program without the hook, or whose last
        replica died, escalates to `PipelineFailure` with the diagnostic
        bundle attached — a structured failure, never a wedged reorder
        buffer."""
        prog = self.programs[s]
        t_fault = time.perf_counter() - self.t0
        lost = list(lost0)
        for f in [f for f, o in self._inflight.items()
                  if o.stage == s and o.rep == rep]:
            op = self._inflight.pop(f)
            try:
                f.result()          # wait the body home; discard its output
            except BaseException:
                pass
            self._abort(op)
            lost.append(op)
        for op, ar in [(o, a) for o, a in self._pending
                       if o.stage == s and o.rep == rep]:
            self._pending.remove((op, ar))
            self._abort(op)
            lost.append(op)
        lost.sort(key=lambda o: o.seq)
        drain = getattr(prog, "drain_lost", None)
        if drain is not None:       # over ranks: the lost ops' commands, home
            drain(lost)
        fail = getattr(prog, "fail_replica", None)
        try:
            if fail is None:
                raise PipelineFailure(
                    f"stage {prog.name}: replica r{rep} died ({kind}) and "
                    f"the program has no failover hook",
                    stage=prog.name, replica=rep, reason=kind)
            fail(rep, self, lost)
        except PipelineFailure as e:
            e.reason = e.reason or kind
            for key, val in self.diagnostic_bundle().items():
                e.diagnostics.setdefault(key, val)
            e.diagnostics.setdefault(
                "lost_ops", [(o.kind, o.seq) for o in lost])
            raise
        t_rec = time.perf_counter() - self.t0
        self.result.failovers.append({
            "stage": prog.name, "replica": rep, "kind": kind,
            "t_fault_s": t_fault, "recovery_s": t_rec - t_fault,
            "replayed_ops": len(lost)})
        if self.tracer is not None:
            self.tracer.failover(prog.name, rep, kind, t_fault, t_rec,
                                 len(lost))

    def _deadlock_detail(self) -> str:
        """Hang forensics appended to the deadlock error: what each party
        was *waiting on* — every registered fifo's occupancy (queued/cap
        plus in-flight slots) and, when traced, the last few events per
        stuck stage — not just the schedule position."""
        lines: list[str] = []
        if self.fifos:
            occ = []
            for label, f in sorted(self.fifos.items()):
                s = f"{label}={len(f)}/{f.capacity}"
                if f.inflight_slots:
                    s += f"(+{f.inflight_slots} in flight)"
                occ.append(s)
            lines.append("fifo occupancy: " + ", ".join(occ))
        elif self.tracer is not None and self.tracer.fifo_watch:
            lines.append("fifo occupancy: "
                         + ", ".join(self.tracer.fifo_snapshot()))
        for p in self.programs:
            if not p.pending():
                continue
            reason, edge = self.wait_reason_of(p)
            lines.append(f"{p.name} waiting: {reason}"
                         + (f" on {edge}" if edge else ""))
            if self.tracer is not None:
                tail = self.tracer.tail(p.name, n=4)
                if tail:
                    lines.append(f"last events {p.name}: " + "; ".join(
                        f"{e.kind} {e.name}{e.seq if e.seq >= 0 else ''}"
                        f"@{e.t:.4g}" for e in tail))
        lines.extend(self._static_crossref())
        return "".join("\n  " + ln for ln in lines)

    def _static_crossref(self) -> list[str]:
        """Tie the runtime wedge back to the static analysis: either the
        plan skipped preflight (say so — the wedge may be a statically
        catchable sizing bug), or a static finding already predicted a
        deadlock on some edge (name it), or the plan was verified
        deadlock-free (so suspect the executor, a fault injection, or an
        external stall, not the plan)."""
        rep = self.static_report
        if rep is None:
            return ["static preflight: not run for this drive — "
                    "rerun with preflight=True to check whether this "
                    "wedge is statically provable"]
        hits = rep.deadlock_findings()
        if hits:
            out = ["static preflight: runtime wedge matches "
                   f"{len(hits)} static finding(s):"]
            out += ["  " + f.describe() for f in hits[:4]]
            return out
        return ["static preflight: plan was verified deadlock-free "
                f"(checks: {', '.join(rep.checks)}) — suspect an "
                "executor bug, fault injection, or external stall, "
                "not the plan's channel sizing"]

    @staticmethod
    def _timed(fn, args):
        """Worker-side wrapper: run the op body and measure the host wall
        time it spent (the dispatch-overhead sample for ``stage_host_us``;
        under async bodies this is pure host work — the device part is in
        flight when the body returns)."""
        t0 = time.perf_counter()
        result = fn(*args)
        return result, time.perf_counter() - t0

    def run(self) -> EngineResult:
        from concurrent.futures import FIRST_COMPLETED, wait
        self.t0 = time.perf_counter()
        inflight = self._inflight           # future -> Op (worker running)
        pending = self._pending             # (Op, AsyncResult): body returned,
        #                                     device work still in flight
        lanes = self.lanes
        if self.overlap and lanes is None:
            lanes = Lanes([max(1, p.n_replicas) for p in self.programs],
                          self.workers)
        dispatch_s = self.result.stage_dispatch_s
        tr = self.tracer
        if tr is not None:
            tr.bind_wall(self.t0)
        # per-stage open blocked span: (t_blocked, (reason, edge)) — set
        # the first sweep a stage's next op defers, closed (one wait
        # event + stall/starve seconds) when the op finally dispatches
        wait_since: list = [None] * len(self.programs)
        try:
            while (any(p.pending() for p in self.programs)
                   or inflight or pending):
                progressed = False
                # downstream-first: consumers drain fifos before producers
                for s in reversed(range(len(self.programs))):
                    prog = self.programs[s]
                    op = prog.peek()
                    if op is None:
                        if tr is not None and wait_since[s] is None:
                            r = self.idle_reason_of(prog)
                            if r is not None:
                                wait_since[s] = (
                                    time.perf_counter() - self.t0, r)
                        continue
                    if self._busy[s][op.rep] >= self.replica_queue:
                        continue
                    if prog.ready(op) is None:
                        if tr is not None and wait_since[s] is None:
                            wait_since[s] = (time.perf_counter() - self.t0,
                                             self.wait_reason_of(prog))
                        continue
                    stall_s = 0.0
                    if self.injector is not None:
                        spec = self.injector.check(prog.name, op.rep, op.seq)
                        if spec is not None and spec.kind == "crash":
                            # the op consumed nothing yet: failover remaps
                            # its routing and the next sweep re-peeks it
                            # onto a surviving replica
                            self._replica_fault(s, op.rep, spec.kind)
                            progressed = True
                            continue
                        elif spec is not None:
                            stall_s = spec.stall_s
                    if stall_s > 0.0 and hasattr(prog, "stall_s"):
                        # over ranks: the command carries it, and the
                        # op's own lane sleeps on its rank
                        prog.stall_s, stall_s = stall_s, 0.0
                    fn, args = prog.dispatch(op, self)
                    if stall_s > 0.0:
                        fn = _stalled(fn, stall_s)
                    op.t_dispatch = time.perf_counter()
                    self._busy[s][op.rep] += 1
                    progressed = True
                    if tr is not None:
                        td = op.t_dispatch - self.t0
                        if wait_since[s] is not None:
                            t_w, (reason, edge) = wait_since[s]
                            wait_since[s] = None
                            tr.wait(prog.name, reason, edge, t_w, td)
                            d = self.result.stage_wait_s.setdefault(
                                prog.name, {})
                            d[reason] = d.get(reason, 0.0) + (td - t_w)
                        tr.op_dispatch(prog.name, op.rep, op.kind,
                                       op.seq, op.chunk, td)
                    if not self.overlap:
                        # serial A/B baseline: dispatch, await, advance
                        try:
                            result, host_s = self._timed(fn, args)
                        except ReplicaFault:
                            self._abort(op)     # the op itself is lost too:
                            self._replica_fault(s, op.rep, "crash",
                                                lost0=(op,))
                            progressed = True
                            continue
                        except BaseException:
                            self._abort(op)
                            raise
                        dispatch_s[prog.name] += host_s
                        if isinstance(result, AsyncResult):
                            try:        # a device error surfaces here —
                                result.block()   # free credits like the
                            except ReplicaFault:     # old in-body sync did
                                self._abort(op)
                                self._replica_fault(s, op.rep, "crash",
                                                    lost0=(op,))
                                progressed = True
                                continue
                            except BaseException:
                                self._abort(op)
                                raise
                        self._settle(op, result, time.perf_counter())
                    else:
                        inflight[lanes.submit(s, op.rep, self._timed,
                                              fn, args)] = op
                        self.result.max_inflight = max(
                            self.result.max_inflight,
                            len(inflight) + len(pending))
                # drain worker futures: a body either completed its op
                # synchronously (host compute) or handed back an
                # AsyncResult whose device work we watch below
                for f in [f for f in inflight if f.done()]:
                    if f not in inflight:
                        continue        # drained by a failover this sweep
                    op = inflight.pop(f)
                    try:
                        result, host_s = f.result()
                    except ReplicaFault:
                        self._abort(op)
                        self._replica_fault(op.stage, op.rep, "crash",
                                            lost0=(op,))
                        progressed = True
                        continue
                    except BaseException:
                        self._abort(op)
                        raise
                    dispatch_s[self.programs[op.stage].name] += host_s
                    if isinstance(result, AsyncResult):
                        pending.append((op, result))
                    else:
                        self._settle(op, result, time.perf_counter())
                        progressed = True
                # retire device completions (completion futures, no host
                # sync): ready watch sets observed this sweep
                if pending:
                    now = time.perf_counter()
                    still = []
                    for op, ar in pending:
                        if ar.is_ready():
                            self._settle(op, ar, now)
                            progressed = True
                        else:
                            still.append((op, ar))
                    pending[:] = still
                if not progressed:
                    if inflight:
                        # with device work pending, wait bounded (a watch
                        # set may become ready before any worker future);
                        # with none, block until a worker finishes — no
                        # busy-poll stealing host CPU from the op bodies
                        wait(list(inflight),
                             timeout=self.POLL_S if pending else None,
                             return_when=FIRST_COMPLETED)
                    elif pending and getattr(lanes, "polled", False):
                        # over ranks each op's end is a report to come,
                        # the oldest not always the first: poll them all
                        # again rather than wait for the oldest
                        time.sleep(self.POLL_S)
                    elif pending:
                        # nothing dispatchable, no workers running: block
                        # on the oldest in-flight device op for an
                        # accurate completion timestamp
                        op, ar = pending.pop(0)
                        try:
                            ar.block()
                        except ReplicaFault:
                            self._abort(op)
                            self._replica_fault(op.stage, op.rep, "crash",
                                                lost0=(op,))
                            continue
                        except BaseException:
                            self._abort(op)
                            raise
                        self._settle(op, ar, time.perf_counter())
                    else:
                        state = "; ".join(p.describe()
                                          for p in self.programs)
                        raise RuntimeError(
                            f"pipeline deadlock: no program can dispatch "
                            f"and nothing is in flight — "
                            f"schedule/backpressure bug ({state})"
                            + self._deadlock_detail())
        finally:
            if lanes is not None and lanes is not self.lanes:
                lanes.close()
        self.result.wall_s = time.perf_counter() - self.t0
        return self.result


# ===========================================================================
# virtual-clock driver: discrete-event loop
# ===========================================================================
@dataclass
class EventLoopStats:
    fire_times: dict[str, list[float]] = field(default_factory=dict)
    fired: dict[str, int] = field(default_factory=dict)
    busy_cycles: dict[str, float] = field(default_factory=dict)
    cycles: float = 0.0
    total_fired: int = 0
    hit_cycle_cap: bool = False
    wait_cycles: dict[str, dict[str, float]] = field(default_factory=dict)
    # stage -> {reason: cycles blocked} — the virtual-clock twin of
    # `EngineResult.stage_wait_s`; populated only under a tracer
    failovers: list = field(default_factory=list)
    # survived replica faults, as in `EngineResult.failovers` (virtual
    # clock: recovery is instantaneous and nothing is in flight, so the
    # entries carry t_fault_cycles and replayed_ops only)
    skipped_faults: list = field(default_factory=list)
    # stall specs the virtual clock cannot honor (no host time to burn)


class EventLoop(Driver):
    """Virtual-clock driver of the same `Program` protocol.

    Deterministic: among fireable programs the earliest (t, insertion
    seq) fires.  A popped candidate is re-checked (it may have been
    blocked by an earlier firing) and either fires, re-queues at its new
    ready time, or is dropped — a wake from a later retirement re-queues
    it.  Programs call ``driver.wake(names...)`` in ``retire`` to name
    whose readiness may have changed, read ``driver.now`` for the firing
    time, and report ``driver.note_busy`` cycles for the utilisation
    stats."""

    virtual = True

    def __init__(self, programs: dict[str, Program], tracer=None,
                 injector=None):
        """``injector``: optional `failures.ReplicaFaultPlan` — same
        dispatch-time consultation as the wall-clock engine, so a chaos
        drill fires at the identical op coordinate on the simulator.
        Crash faults fail over synchronously (the virtual clock has no
        in-flight ops to drain); stall faults are recorded in
        ``stats.skipped_faults`` — there is no host time to burn."""
        super().__init__(tracer)
        self.programs = dict(programs)
        self.injector = injector
        self.now = 0.0
        self._wake: set[str] = set()

    def wake(self, *names: str) -> None:
        self._wake.update(names)

    def note_busy(self, name: str, amount: float) -> None:
        self.stats.busy_cycles[name] += amount

    def _replica_fault(self, name: str, rep: int, kind: str) -> None:
        """Virtual-clock failover: nothing is ever in flight (dispatch
        and retire are one synchronous step), so a fault only remaps
        routing — the about-to-fire op re-peeks onto a survivor."""
        prog = self.programs[name]
        fail = getattr(prog, "fail_replica", None)
        try:
            if fail is None:
                raise PipelineFailure(
                    f"stage {name}: replica r{rep} died ({kind}) and "
                    f"the program has no failover hook",
                    stage=name, replica=rep, reason=kind)
            fail(rep, self, [])
        except PipelineFailure as e:
            e.reason = e.reason or kind
            e.diagnostics.setdefault(
                "schedule", [p.describe() for p in self.programs.values()])
            e.diagnostics.setdefault("reorder_occupancy",
                                     self.reorder_occupancy())
            e.diagnostics.setdefault("failovers",
                                     list(self.stats.failovers))
            raise
        self.stats.failovers.append({
            "stage": name, "replica": rep, "kind": kind,
            "t_fault_cycles": self.now, "replayed_ops": 0})
        if self.tracer is not None:
            self.tracer.failover(name, rep, kind, self.now, self.now, 0)

    def run(self, *, max_firings: int = 1_000_000,
            max_cycles: float = 1e12) -> EventLoopStats:
        programs = self.programs
        self.stats = stats = EventLoopStats()
        tr = self.tracer
        if tr is not None:
            tr.bind_virtual(self)
        # open blocked spans, as in the wall-clock engine: set on the
        # heap-pop re-check (a *real* deferral, same count_stall
        # semantics as FifoStats), closed at the next fire
        wait_since: dict[str, tuple] = {}
        for n in programs:
            stats.fire_times[n] = []
            stats.fired[n] = 0
            stats.busy_cycles[n] = 0.0

        seq = 0
        heap: list[tuple[float, int, str]] = []

        def push_candidate(name: str) -> None:
            nonlocal seq
            prog = programs[name]
            op = prog.peek()
            if op is None:
                if tr is not None and name not in wait_since:
                    r = self.idle_reason_of(prog)
                    if r is not None:
                        wait_since[name] = (self.now, r)
                return
            t = prog.ready(op)
            if t is not None:
                heapq.heappush(heap, (t, seq, name))
                seq += 1
            elif tr is not None and name not in wait_since:
                # blocked at wake time: open its wait span now — a later
                # wake (or pop re-check) requeues it and the span closes
                # at its next fire
                wait_since[name] = (self.now, self.wait_reason_of(prog))

        for n in programs:
            push_candidate(n)

        while heap and stats.total_fired < max_firings:
            now, _, name = heapq.heappop(heap)
            if now > max_cycles:
                stats.hit_cycle_cap = True
                break
            prog = programs[name]
            op = prog.peek()
            if op is None:
                continue        # completed since queueing
            t = prog.ready(op, count_stall=True)
            if t is None:
                if tr is not None and name not in wait_since:
                    wait_since[name] = (now, self.wait_reason_of(prog))
                continue        # became blocked; a wake requeues it
            if t > now:
                heapq.heappush(heap, (t, seq, name))
                seq += 1
                continue
            self.now = now
            self._wake = set()
            if self.injector is not None:
                spec = self.injector.check(name, op.rep, op.seq)
                if spec is not None and spec.kind == "crash":
                    self._replica_fault(name, op.rep, spec.kind)
                    for c in self._wake | {name}:
                        if c in programs:
                            push_candidate(c)
                    continue
                elif spec is not None:
                    stats.skipped_faults.append((name, op.rep, spec.kind))
            fn, args = prog.dispatch(op, self)
            op.t_dispatch = now
            if tr is not None:
                ws = wait_since.pop(name, None)
                if ws is not None:
                    t_w, (reason, edge) = ws
                    tr.wait(name, reason, edge, t_w, now)
                    d = stats.wait_cycles.setdefault(name, {})
                    d[reason] = d.get(reason, 0.0) + (now - t_w)
                tr.op_dispatch(name, op.rep, op.kind, op.seq, op.chunk, now)
            result = fn(*args)
            done = prog.retire(op, result, self)
            if tr is not None:
                tr.op_retire(name, op.rep, op.kind, op.seq, op.chunk,
                             now, done)
            for fifo, n_rel in op.releases:
                fifo.release(n_rel)
            stats.fired[name] += 1
            stats.fire_times[name].append(now)
            stats.total_fired += 1
            stats.cycles = max(stats.cycles, done)
            for c in self._wake | {name}:
                if c in programs:
                    push_candidate(c)
        return stats


def run_event_loop(programs: dict[str, Program], *,
                   max_firings: int = 1_000_000,
                   max_cycles: float = 1e12,
                   tracer=None, injector=None) -> EventLoopStats:
    """Drive `Program`s to quiescence under a virtual clock (the
    functional entry point over `EventLoop`)."""
    return EventLoop(programs, tracer, injector).run(max_firings=max_firings,
                                                     max_cycles=max_cycles)
