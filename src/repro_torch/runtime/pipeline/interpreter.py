"""Host streaming executor: run a planned STG as a real pipeline.

Where `core/simulate.py` *simulates* (unbounded FIFOs, one global event
loop, no notion of hardware), this module *executes*: the Selection is
materialised into replicas + fork/join routing (`core/transform.py`), every
worker is pinned to a device slice (`placement.py`), inter-stage buffers
are bounded double-buffered FIFOs with backpressure (`channels.py`), and
devices that host more than one worker are time-shared through per-device
busy clocks.  Node functions run for real (numpy), so sink streams are the
actual program output — bitwise comparable against the KPN simulator — and
firing timestamps give *measured* steady-state inverse throughput per
stage, comparable against `core/throughput.analyze`.

The event loop itself is the graph-generic executor core's virtual-clock
driver (`engine.run_event_loop`): this module only defines the per-node
*program* (`_HostNode`, an `engine.Program` — the same protocol the
wall-clock `Engine` drives) — KPN firing rules, FORK/JOIN routing state,
multirate token blocks, source streams, and per-device busy clocks.  The
loop owns the heap, candidate re-queueing, wake-set propagation, and the
firing/cycle caps, shared with the wall-clock engine the decode
pipeline runs on.

Firing rule (deterministic, KPN + backpressure):
  a worker may fire at time t when
    * every required input port holds a full rate-block visible by t
      (JOIN: only the round-robin-scheduled port),
    * every output FIFO that will receive tokens has space
      (FORK: only the scheduled port),
    * the worker is free (t >= worker II clock) and its devices are free.
  Among fireable workers the earliest (t, name) fires; outputs become
  visible at t + latency; worker and devices are busy for II cycles.

Copied from ``repro/runtime/pipeline/interpreter.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ...core.fork_join import LITERAL, ForkJoinModel
from ...core.stg import FORK, JOIN, STG, Selection
from ...core.transform import ReplicatedGraph, materialize
from .channels import ChannelSet
from .engine import Op, run_event_loop, steady_inverse
from .placement import Placement, StageSlice, place


@dataclass
class PipelineRun:
    """Result of one streaming execution."""
    outputs: dict[str, list] = field(default_factory=dict)     # sink worker -> tokens
    fire_times: dict[str, list[float]] = field(default_factory=dict)
    fired: dict[str, int] = field(default_factory=dict)
    cycles: float = 0.0
    placement: Placement | None = None
    channels: ChannelSet | None = None
    replica_map: dict[str, list[str]] = field(default_factory=dict)
    busy_cycles: dict[str, float] = field(default_factory=dict)
    wait_cycles: dict[str, dict[str, float]] = field(default_factory=dict)
    # worker -> {reason: cycles blocked} (traced runs only): credit =
    # output fifo full, starve = input empty — measure's stall/starve
    # columns under the virtual clock

    def inverse_throughput(self, worker: str, warmup_frac: float = 0.25) -> float:
        """Steady-state cycles per firing at one worker (drop pipeline fill)."""
        times = self.fire_times[worker]
        try:
            return steady_inverse(times, warmup_frac)
        except ValueError:
            raise ValueError(f"too few firings at {worker} ({len(times)})")

    def stage_inverse_throughput(self, stage: str,
                                 warmup_frac: float = 0.25) -> float:
        """Effective cycles per firing of a (possibly replicated) stage:
        merge all replicas' firings — round-robin replicas interleave, so
        the merged stream fires nr-times faster than one replica."""
        workers = self.replica_map.get(stage, [stage])
        merged = [t for w in workers for t in self.fire_times[w]]
        try:
            return steady_inverse(merged, warmup_frac)
        except ValueError:
            raise ValueError(f"too few firings at stage {stage}")

    def utilization(self, worker: str) -> float:
        times = self.fire_times[worker]
        if len(times) < 2:
            return 0.0
        span = times[-1] - times[0]
        return min(1.0, self.busy_cycles[worker] / span) if span > 0 else 1.0


def execute(stg: STG, sel, inputs: dict[str, list], *,
            devices=None, capacity_blocks: int = 2,
            fj: ForkJoinModel = LITERAL, max_firings: int = 1_000_000,
            max_cycles: float = 1e12, tracer=None) -> PipelineRun:
    """Materialise, place, and stream ``inputs`` through the pipeline.

    ``sel`` may be a Selection, a planner PlanResult, or a solver
    TradeoffResult — materialised through the package-level
    `as_selection` helper (the same rule the decode pipeline uses).
    ``tracer``: optional `trace.Tracer` — the virtual-clock run emits
    the same typed event stream as the wall-clock backends (op spans in
    cycles, credit/starve waits, fifo occupancy counters)."""
    from . import as_selection
    sel = as_selection(sel)
    rg: ReplicatedGraph = materialize(stg, sel, fj)
    pl = place(stg, sel, devices, replica_map=rg.replica_map)
    # Fork/join workers are routing fabric, not pool PEs: each gets its own
    # router slot so tree hops don't contend with compute time-sharing.
    for name in rg.fork_join_nodes:
        pl.slices[name] = StageSlice(stage=name, worker=name, replica=0,
                                     tp=1, devices=(("router", name),))
    return execute_materialized(rg, pl, inputs,
                                capacity_blocks=capacity_blocks,
                                max_firings=max_firings,
                                max_cycles=max_cycles, tracer=tracer)


class _HostNode:
    """One materialised worker as an `engine.Program` (virtual clock).

    Owns the node-specific halves of the firing rule — token/rate
    readiness, FORK/JOIN port scheduling, source streams, backpressure
    probes, and busy-clock updates — while `engine.run_event_loop` owns
    when anything runs.  ``dispatch`` consumes tokens at ``driver.now``
    and returns the node-function thunk; ``retire`` produces outputs at
    ``now + latency``, advances the node/device busy clocks, and wakes
    the neighbours whose readiness may have changed."""

    def __init__(self, idx: int, name: str, ctx: "_HostContext"):
        self.idx = idx
        self.name = name
        self.n_replicas = 1
        self.fired = 0
        self.ctx = ctx
        g = ctx.g
        self.node = g.nodes[name]
        self.impl = ctx.sel.impl_of(g, name)
        self.in_chs = g.in_channels(name)
        self.out_chs = g.out_channels(name)
        self.slice = ctx.pl.slices.get(name)
        self._wake_pending: set[str] = set()
        self.wait_reason = None   # (reason, fifo) of the last deferral

    def _required_out_ports(self) -> list[int]:
        if self.node.kind == FORK:
            return [self.ctx.state[self.name] or 0]
        return [ch.src_port for ch in self.out_chs]

    def pending(self) -> int:
        """KPN nodes have no op count — firings are decided by token
        arrival, and a finite stream *terminates by quiescence* (no node
        fireable, nothing in flight), not by draining a schedule.  So
        pending is "fireable right now": both drivers then stop exactly
        at quiescence (the event loop via an empty heap, the wall-clock
        engine via its pending-or-inflight loop, cleanly — quiescence is
        normal KPN termination, not a deadlock), and
        `execute_materialized`'s wedge guard is the truncation check
        that tells end-of-stream apart from an undersized buffer."""
        op = self.peek()
        return 1 if op is not None and self.ready(op) is not None else 0

    def peek(self) -> Op | None:
        return Op(stage=self.idx, kind="N", seq=self.fired, rep=0)

    def ready(self, op: Op, count_stall: bool = False) -> float | None:
        """Earliest fire time, or None if blocked on tokens/space.

        ``count_stall``: record a producer stall on the blocking fifo —
        set only on the heap-pop re-check, so FifoStats counts scheduled
        firings actually deferred, not readiness probes."""
        ctx, node, name = self.ctx, self.node, self.name
        t = ctx.node_free[name]
        if self.slice is not None:
            for d in self.slice.devices:
                t = max(t, ctx.dev_free[d])
        # inputs
        if not self.in_chs:   # source: finite stream
            n_need = node.out_rates[0]
            if name not in ctx.src_streams or \
                    ctx.src_pos[name] + n_need > len(ctx.src_streams[name]):
                self.wait_reason = ("source", None)    # end of stream
                return None
        elif node.kind == JOIN:
            k = ctx.state[name] or 0
            q = ctx.cs[self.in_chs[k].key()]
            rt = q.ready_time(node.in_rates[k])
            if rt is None:
                self.wait_reason = ("starve", q)
                return None
            t = max(t, rt)
        else:
            for ch in self.in_chs:
                q = ctx.cs[ch.key()]
                rt = q.ready_time(node.in_rates[ch.dst_port])
                if rt is None:
                    self.wait_reason = ("starve", q)
                    return None
                t = max(t, rt)
        # backpressure: every port fired into must have block space now
        need_ports = set(self._required_out_ports())
        for ch in self.out_chs:
            if ch.src_port in need_ports:
                q = ctx.cs[ch.key()]
                if not q.can_push(node.out_rates[ch.src_port]):
                    if count_stall:
                        q.note_stall()
                    self.wait_reason = ("credit", q)
                    return None
        return t

    def dispatch(self, op: Op, driver):
        ctx, node, name = self.ctx, self.node, self.name
        # -- consume (at dispatch time: frees producer space immediately) ----
        ins: list[list] = [[] for _ in range(max(1, node.n_in))]
        wake: set[str] = set()
        if self.in_chs:
            if node.kind == JOIN:
                k = ctx.state[name] or 0
                ch = self.in_chs[k]
                ins[k] = ctx.cs[ch.key()].pop(node.in_rates[k])
                wake.add(ch.src)
            else:
                for ch in self.in_chs:
                    ins[ch.dst_port] = ctx.cs[ch.key()].pop(
                        node.in_rates[ch.dst_port])
                    wake.add(ch.src)
        else:
            n_need = node.out_rates[0]
            p = ctx.src_pos[name]
            ins[0] = ctx.src_streams[name][p:p + n_need]
            ctx.src_pos[name] = p + n_need
        self._wake_pending = wake
        return self._compute, (ins,)

    def _compute(self, ins):
        node, name = self.node, self.name
        state = self.ctx.state[name]
        if node.fn is not None:
            outs, state = node.fn(ins, state)
        elif not self.in_chs:
            outs = [ins[0]]
        else:
            outs = ([list(ins[0]) for _ in range(node.n_out)]
                    if self.out_chs else [list(ins[0])])
        return outs, state

    def retire(self, op: Op, result, driver) -> float:
        ctx, node, name = self.ctx, self.node, self.name
        outs, ctx.state[name] = result
        now = driver.now
        wake = self._wake_pending
        self._wake_pending = set()
        # -- produce ---------------------------------------------------------
        done = now + (self.impl.latency or self.impl.ii)
        if self.out_chs:
            for ch in self.out_chs:
                toks = outs[ch.src_port]
                if toks:
                    ctx.cs[ch.key()].push(toks, done)
                wake.add(ch.dst)
        else:
            for port_out in outs:
                ctx.outputs[name].extend(port_out)
        ctx.node_free[name] = now + self.impl.ii
        if self.slice is not None:
            for d in self.slice.devices:
                ctx.dev_free[d] = now + self.impl.ii
                wake.update(ctx.dev_workers[d])
        self.fired += 1
        driver.note_busy(name, self.impl.ii)
        driver.wake(*wake)
        return done

    def describe(self) -> str:
        return f"{self.name}: {self.fired} fired"


@dataclass
class _HostContext:
    """State shared by all of one run's `_HostNode` programs."""
    g: STG
    sel: Selection
    pl: Placement
    cs: ChannelSet
    state: dict
    node_free: dict
    dev_free: dict
    dev_workers: dict
    src_streams: dict
    src_pos: dict
    outputs: dict


def execute_materialized(rg: ReplicatedGraph, pl: Placement,
                         inputs: dict[str, list], *,
                         capacity_blocks: int = 2,
                         max_firings: int = 1_000_000,
                         max_cycles: float = 1e12,
                         tracer=None) -> PipelineRun:
    g = rg.stg
    for n in inputs:
        if n not in g.nodes:
            raise ValueError(f"inputs key {n!r} is not a node of the "
                             f"materialised graph (sources: {g.sources()})")
        if g.in_channels(n):
            raise ValueError(f"inputs key {n!r} is not a source node")
    run = PipelineRun(placement=pl, replica_map=dict(rg.replica_map))
    cs = ChannelSet.for_graph(g, capacity_blocks=capacity_blocks)
    run.channels = cs
    if tracer is not None:
        for key, fifo in cs.fifos.items():
            src_n, sp, dst_n, dp = key
            tracer.watch_fifo(fifo, f"{src_n}.{sp}->{dst_n}.{dp}",
                              src=src_n, dst=dst_n)

    dev_free: dict = {}
    dev_workers: dict = {}
    for w, sl in pl.slices.items():
        for d in sl.devices:
            dev_free.setdefault(d, 0.0)
            dev_workers.setdefault(d, set()).add(w)
    ctx = _HostContext(
        g=g, sel=rg.selection, pl=pl, cs=cs,
        state={n: g.nodes[n].init_state for n in g.nodes},
        node_free={n: 0.0 for n in g.nodes},
        dev_free=dev_free, dev_workers=dev_workers,
        src_streams={n: list(toks) for n, toks in inputs.items()},
        src_pos={n: 0 for n in inputs},
        outputs={n: [] for n in g.nodes if not g.out_channels(n)})

    programs = {n: _HostNode(i, n, ctx) for i, n in enumerate(g.nodes)}
    stats = run_event_loop(programs, max_firings=max_firings,
                           max_cycles=max_cycles, tracer=tracer)
    run.outputs = ctx.outputs
    run.fire_times = stats.fire_times
    run.fired = stats.fired
    run.busy_cycles = stats.busy_cycles
    run.cycles = stats.cycles
    run.wait_cycles = stats.wait_cycles
    # wedge guard: the loop ending with a full source block unconsumed means
    # no node could ever fire again (undersized buffer / malformed graph) —
    # fail loudly rather than hand back a silently-truncated stream.  Not a
    # wedge: the caller's own max_firings / max_cycles caps stopped us.
    if stats.total_fired < max_firings and not stats.hit_cycle_cap:
        for n, stream in ctx.src_streams.items():
            left = len(stream) - ctx.src_pos[n]
            if left >= g.nodes[n].out_rates[0]:
                raise RuntimeError(
                    f"pipeline wedged: source {n} has {left} unconsumed "
                    f"tokens but no node can fire (fired={run.fired})")
    return run
