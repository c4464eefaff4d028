"""Static plan verification: prove a plan safe before anything runs.

Ported from ``repro/core/verify.py``.  The executors discover unsafe
plans at run time — `Engine._deadlock_detail` forensics after a wedge,
`Fifo` overflow raises.  The KPN/STG abstraction makes that analyzable
*up front*: this module takes a plan tuple — a bare (STG, Selection)
pair, a schedule's op order against its FIFO capacities, or a
`DecodePipeline` serve's stage chain, fusion plan, placement, channel
capacities and group shapes — and returns a structured report of
ERROR/WARN findings.

Three check families:

  * **bounded-FIFO deadlock analysis** — channels as credit-carrying
    edges.  A rate-changing edge (consumer pops ``block`` tokens per
    firing, producer pushes ``burst``) is live iff its capacity reaches
    the classic SDF bound ``block + burst - gcd(block, burst)``; an
    unconditional-push edge (the head→embed token feedback stream) must
    absorb its worst-case in-flight burst; every cycle must keep at least
    one free credit; and a schedule's exact op order is *simulated*
    against integer credits (`simulate_credit_schedule`) — exact for
    these graphs because every FIFO has a single producer and a single
    consumer stage, which makes the credit net a marked graph: enabled
    ops stay enabled until they fire, so greedy exploration decides
    deadlock-freedom, and a wedge names the wait-for cycle plus the
    minimum viable capacity that unblocks it.
  * **plan-consistency** — schedule shape vs the built stage count,
    `Schedule.validate()` invariants, fusion groups re-checked against
    `enumerate_fusions`' heavy-set rule / `validate_restructure`, replica
    counts vs placement slices.
  * **the cache contract** — the port updates cache slices in place and
    donates nothing, so where the JAX package proves cache-out ==
    cache-in avals (its donation contract), this proves that a block
    stage's decode leaves every cache tensor of its slice with the shape,
    dtype and storage it found: the stage's own decode code runs on
    ``meta`` tensors (no data, no device) through the plain route
    (``impl="ref"``).  Where a plain op cannot run on ``meta``, the check
    is not run and a WARN says so (`VerificationReport.checks` lacks
    ``cache-contract``).

`DecodePipeline.serve` calls `verify_decode_plan` as its ``preflight=``
hook (on by default) and raises `PlanVerificationError` on any ERROR;
the accepted report rides into the engine so a runtime deadlock can be
cross-referenced against the static analysis.

`LMPipeline.run` calls `verify_lm_plan` the same way: schedule
consistency, the credit simulation of the schedule's op order over the
run's activation and gradient FIFO capacities, placement consistency,
and (``deep=True``) the accumulate contract on ``meta`` tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

ERROR = "ERROR"
WARN = "WARN"


# ===========================================================================
# findings
# ===========================================================================
@dataclass(frozen=True)
class Finding:
    """One verification finding.  ``check`` is a dotted family name
    (``deadlock.*`` / ``channel.*`` / ``plan.*`` / ``cache.*`` /
    ``graph.*``);
    ``subject`` names the edge, cycle, stage, or group the
    finding is about; ``min_viable`` is the smallest capacity that fixes
    a sized finding (None when not a sizing issue)."""
    level: str
    check: str
    subject: str
    message: str
    min_viable: int | None = None

    def describe(self) -> str:
        cap = f" (min viable capacity {self.min_viable})" \
            if self.min_viable is not None else ""
        return f"[{self.level}] {self.check} @ {self.subject}: " \
               f"{self.message}{cap}"


class PlanVerificationError(RuntimeError):
    """A preflighted plan violates a static invariant.  ``report`` holds
    the full `VerificationReport`; the message names the first violated
    invariant so the failure reads like the analysis, not like the wedge
    it prevents."""

    def __init__(self, report: "VerificationReport", context: str = ""):
        self.report = report
        self.findings = report.errors()
        head = self.findings[0].describe() if self.findings \
            else "no findings"
        more = f" (+{len(self.findings) - 1} more error(s))" \
            if len(self.findings) > 1 else ""
        where = f"{context}: " if context else ""
        super().__init__(
            f"{where}plan fails static verification — {head}{more}\n"
            + report.render())


@dataclass
class VerificationReport:
    """Structured result of one static analysis pass."""
    plan: str = ""                      # one-line plan-tuple description
    findings: list[Finding] = field(default_factory=list)
    checks: list[str] = field(default_factory=list)   # families that ran

    def add(self, level: str, check: str, subject: str, message: str,
            min_viable: int | None = None) -> None:
        self.findings.append(Finding(level, check, subject, message,
                                     min_viable))

    def ran(self, check: str) -> None:
        if check not in self.checks:
            self.checks.append(check)

    def merge(self, other: "VerificationReport") -> None:
        self.findings.extend(other.findings)
        for c in other.checks:
            self.ran(c)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.level == ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.level == WARN]

    def ok(self) -> bool:
        return not self.errors()

    def deadlock_findings(self) -> list[Finding]:
        """Findings a runtime wedge could be the dynamic face of — what
        `Engine._deadlock_detail` cross-references."""
        return [f for f in self.findings
                if f.check.startswith(("deadlock.", "channel."))]

    def summary(self) -> dict:
        """Structured form for `Engine.diagnostic_bundle`."""
        return {"plan": self.plan, "checks": list(self.checks),
                "errors": [f.describe() for f in self.errors()],
                "warnings": [f.describe() for f in self.warnings()]}

    def render(self) -> str:
        lines = [f"static verification: {self.plan or 'plan'} — "
                 f"{len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s); "
                 f"checks: {', '.join(self.checks) or 'none'}"]
        lines += ["  " + f.describe() for f in self.findings]
        if not self.findings:
            lines.append("  no findings")
        return "\n".join(lines)

    def raise_if_errors(self, context: str = "") -> "VerificationReport":
        if not self.ok():
            raise PlanVerificationError(self, context)
        return self


# ===========================================================================
# credit-carrying edges (the pure analysis layer — no executor imports)
# ===========================================================================
@dataclass(frozen=True)
class EdgeSpec:
    """One channel as a credit-carrying edge.  ``block`` is the tokens
    the consumer pops per firing, ``burst`` the tokens the producer
    pushes per firing.  ``gated`` producers wait for free credits before
    dispatching (the executors' reserve-at-dispatch backpressure);
    ungated producers push unconditionally at retirement (the decode
    head's feedback stream), so their capacity must absorb the
    worst-case in-flight burst outright."""
    src: str
    dst: str
    capacity: int
    label: str = ""
    block: int = 1
    burst: int = 1
    gated: bool = True

    def name(self) -> str:
        return self.label or f"{self.src}->{self.dst}"


def channel_liveness_floor(block: int, burst: int) -> int:
    """Smallest capacity under which a gated producer/consumer pair on
    one bounded edge cannot wedge: the two-actor SDF bound
    ``block + burst - gcd(block, burst)``.  Below it, a rate-changing
    edge deadlocks with the producer short of free credits and the
    consumer short of tokens (e.g. block=3, burst=2, capacity=3: the
    producer parks 2, can't fit its next burst, the consumer never sees
    its 3rd token)."""
    return block + burst - math.gcd(block, burst)


def check_channel_capacities(edges: list[EdgeSpec],
                             report: VerificationReport) -> None:
    """Per-edge capacity analysis (the `channels.Fifo` sizing rules as
    provable requirements, incl. the ``min_capacity`` rate-change
    floors)."""
    report.ran("channel-capacity")
    for e in edges:
        floor = channel_liveness_floor(e.block, e.burst)
        if e.capacity < e.block:
            report.add(
                ERROR, "channel.consumer-starved", e.name(),
                f"capacity {e.capacity} < consumer block {e.block}: the "
                f"consumer can never accumulate one firing's input",
                min_viable=floor)
        elif e.capacity < e.burst:
            if e.gated:
                report.add(
                    ERROR, "channel.producer-blocked", e.name(),
                    f"capacity {e.capacity} < producer burst {e.burst}: "
                    f"the producer can never reserve one firing's output",
                    min_viable=floor)
            else:
                report.add(
                    ERROR, "channel.burst-overflow", e.name(),
                    f"capacity {e.capacity} < unconditional producer "
                    f"burst {e.burst}: the push overflows at runtime",
                    min_viable=e.burst)
        elif e.gated and e.capacity < floor:
            report.add(
                ERROR, "channel.rate-change-deadlock", e.name(),
                f"capacity {e.capacity} is under the rate-change "
                f"liveness floor {e.block}+{e.burst}-"
                f"gcd={floor}: producer (burst {e.burst}) and consumer "
                f"(block {e.block}) wedge with the buffer neither "
                f"drainable nor fillable", min_viable=floor)
        elif e.capacity < e.block + e.burst:
            report.add(
                WARN, "channel.single-buffered", e.name(),
                f"capacity {e.capacity} < block+burst "
                f"{e.block + e.burst}: producer and consumer serialize "
                f"(no double buffering)",
                min_viable=e.block + e.burst)


def _cycles_of(edges: list[EdgeSpec], limit: int = 64) -> list[list[EdgeSpec]]:
    """Enumerate simple cycles in the edge graph (DFS; the graphs here
    are stage chains plus a feedback edge or two, so this stays tiny —
    ``limit`` is a safety valve, not an expected path)."""
    by_src: dict[str, list[EdgeSpec]] = {}
    for e in edges:
        by_src.setdefault(e.src, []).append(e)
    cycles: list[list[EdgeSpec]] = []
    seen: set[tuple] = set()

    def walk(node: str, path: list[EdgeSpec], on_path: dict[str, int]):
        if len(cycles) >= limit:
            return
        for e in by_src.get(node, ()):
            if e.dst in on_path:
                cyc = path[on_path[e.dst]:] + [e]
                key = frozenset(c.name() for c in cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif len(path) < len(edges):
                walk(e.dst, path + [e], {**on_path, e.dst: len(path) + 1})

    for start in {e.src for e in edges}:
        walk(start, [], {start: 0})
    return cycles


def _cycle_name(cycle: list[EdgeSpec]) -> str:
    hops = [cycle[0].src]
    for e in cycle:
        hops.append(e.dst)
    return " -> ".join(hops)


def check_cycles(edges: list[EdgeSpec], tokens_in_flight: int,
                 report: VerificationReport) -> None:
    """Prove every dependency cycle carries enough initial credits for
    ``tokens_in_flight`` circulating tokens (the decode loop keeps one
    token per live serving group in flight around the
    embed→…→head→feedback cycle).

    Two requirements per cycle: each *ungated* edge must absorb the full
    in-flight complement at once (its producer pushes at retirement
    without a credit check — all live tokens can land on it before the
    consumer drains any), and the ring's total capacity must exceed the
    circulating tokens (a completely full ring has no free credit for
    any producer, and with reserve-at-dispatch semantics no stage can
    dispatch: deadlock)."""
    report.ran("cycle-credits")
    for cycle in _cycles_of(edges):
        cname = _cycle_name(cycle)
        for e in cycle:
            if not e.gated and e.capacity < tokens_in_flight:
                report.add(
                    ERROR, "deadlock.feedback-capacity",
                    f"{e.name()} in cycle [{cname}]",
                    f"unconditional-push edge holds {e.capacity} "
                    f"credit(s) but up to {tokens_in_flight} token(s) "
                    f"(one per live group) can be in flight on it at "
                    f"once — {tokens_in_flight - e.capacity} credit(s) "
                    f"short", min_viable=tokens_in_flight)
        total = sum(e.capacity for e in cycle)
        if total < tokens_in_flight + 1:
            report.add(
                ERROR, "deadlock.cycle-credits", cname,
                f"cycle capacity {total} cannot keep a free credit "
                f"ahead of {tokens_in_flight} circulating token(s): "
                f"once full, no stage on the cycle can dispatch",
                min_viable=tokens_in_flight + 1 - (total - cycle[0].capacity))


# ===========================================================================
# schedule-order credit simulation
# ===========================================================================
@dataclass(frozen=True)
class SimOp:
    """One scheduled op in credit terms: which edges it pops from and
    pushes to (edge index, token count)."""
    label: str
    pops: tuple = ()
    pushes: tuple = ()


@dataclass
class Wedge:
    """A credit simulation that stopped making progress: the per-stage
    positions, why each stuck stage is blocked, the wait-for cycle, and
    the minimum viable capacities that let the same op order complete."""
    positions: list[int]
    blockers: list[tuple]       # (stage, op label, reason, edge index)
    cycle: list[str]            # wait-for cycle through stages/edges
    min_viable: dict[int, int]  # edge index -> capacity that unblocks

    def describe(self, edge_names: list[str]) -> str:
        why = "; ".join(
            f"stage{s} at {lbl}: {reason} on {edge_names[ei]}"
            for s, lbl, reason, ei in self.blockers)
        fix = ", ".join(f"{edge_names[ei]}>={cap}"
                        for ei, cap in sorted(self.min_viable.items()))
        cyc = f" wait-for cycle: {' -> '.join(self.cycle)};" \
            if self.cycle else ""
        return f"{why};{cyc} minimum viable: {fix or 'n/a'}"


def simulate_credit_schedule(op_streams: list[list[SimOp]],
                             capacities: list[int]) -> Wedge | None:
    """Run the schedule's exact op order against integer channel credits.

    Exact, not heuristic: every edge has one producer stage and one
    consumer stage, so token counts only grow until the consumer itself
    pops and credits only shrink when the producer itself fires — an
    enabled op stays enabled until it fires (marked-graph persistence),
    which makes greedy exploration order-independent.  ``None`` means
    the schedule provably runs to completion under these capacities;
    a `Wedge` is a proven deadlock for this op order."""
    wedge = _simulate(op_streams, capacities)
    if wedge is None:
        return None
    wedge.min_viable = _min_viable(op_streams, capacities, wedge)
    return wedge


def _simulate(op_streams, capacities) -> Wedge | None:
    counts = [0] * len(capacities)
    pos = [0] * len(op_streams)
    remaining = sum(len(s) for s in op_streams)
    while remaining:
        progressed = False
        for s, stream in enumerate(op_streams):
            while pos[s] < len(stream):
                op = stream[pos[s]]
                if any(counts[ei] < n for ei, n in op.pops) or any(
                        capacities[ei] - counts[ei] < n
                        for ei, n in op.pushes):
                    break
                for ei, n in op.pops:
                    counts[ei] -= n
                for ei, n in op.pushes:
                    counts[ei] += n
                pos[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            return _wedge_info(op_streams, capacities, counts, pos)
    return None


def _wedge_info(op_streams, capacities, counts, pos) -> Wedge:
    blockers = []
    waits: dict[int, tuple[str, int]] = {}    # stage -> (reason, edge)
    producer_of: dict[int, int] = {}
    consumer_of: dict[int, int] = {}
    for s, stream in enumerate(op_streams):
        for op in stream:
            for ei, _ in op.pushes:
                producer_of[ei] = s
            for ei, _ in op.pops:
                consumer_of[ei] = s
    for s, stream in enumerate(op_streams):
        if pos[s] >= len(stream):
            continue
        op = stream[pos[s]]
        for ei, n in op.pops:
            if counts[ei] < n:
                blockers.append((s, op.label, "starved", ei))
                waits.setdefault(s, ("starved", ei))
        for ei, n in op.pushes:
            if capacities[ei] - counts[ei] < n:
                blockers.append((s, op.label, "no credits", ei))
                waits.setdefault(s, ("no credits", ei))
    # wait-for cycle: stage -> blocking edge -> the stage that could
    # unblock it (the producer of a starved edge, the consumer of a
    # full one); a cycle in that graph is the deadlock's shape
    cycle: list[str] = []
    if waits:
        start = min(waits)
        seen: dict[int, int] = {}
        chain: list[tuple[int, str, int]] = []
        s = start
        while s in waits and s not in seen:
            seen[s] = len(chain)
            reason, ei = waits[s]
            chain.append((s, reason, ei))
            s = producer_of.get(ei, s) if reason == "starved" \
                else consumer_of.get(ei, s)
        if s in seen:
            for st, reason, ei in chain[seen[s]:]:
                cycle.append(f"stage{st}")
                cycle.append(f"edge{ei}({reason})")
            cycle.append(f"stage{s}")
    return Wedge(positions=list(pos), blockers=blockers, cycle=cycle,
                 min_viable={})


def _min_viable(op_streams, capacities, wedge: Wedge,
                max_bumps: int = 256) -> dict[int, int]:
    caps = list(capacities)
    w = wedge
    for _ in range(max_bumps):
        full = [ei for _s, _l, reason, ei in w.blockers
                if reason == "no credits"]
        if not full:
            break
        for ei in full:
            caps[ei] += 1
        w = _simulate(op_streams, caps)
        if w is None:
            break
    return {ei: caps[ei] for ei in range(len(caps))
            if caps[ei] != capacities[ei]}


def schedule_sim_ops(schedule) -> tuple[list[list[SimOp]], list[str]]:
    """Lower a `runtime.pipeline.schedule.Schedule` to credit-sim op
    streams over its act/grd edges (the edge layout
    `schedule.schedule_programs` builds: ``act[i]`` between model stages
    i and i+1 forward, ``grd[i]`` backward)."""
    M = schedule.n_model_stages
    n_act = max(0, M - 1)
    edge_names = [f"act{i}" for i in range(n_act)]
    if schedule.trains:
        edge_names += [f"grd{i}" for i in range(n_act)]

    def act(i):
        return i

    def grd(i):
        return n_act + i

    streams: list[list[SimOp]] = []
    for s, ops in enumerate(schedule.stage_ops):
        stream = []
        for op in ops:
            ms = schedule.model_stage(s, op.chunk)
            if op.kind == "F":
                pops = ((act(ms - 1), 1),) if ms > 0 else ()
                pushes = ((act(ms), 1),) if ms < M - 1 else ()
            else:
                pops = ((grd(ms), 1),) if ms < M - 1 else ()
                pushes = ((grd(ms - 1), 1),) if ms > 0 else ()
            stream.append(SimOp(
                label=f"{op.kind}(mb={op.mb},chunk={op.chunk})",
                pops=pops, pushes=pushes))
        streams.append(stream)
    return streams, edge_names


def verify_schedule_credits(schedule, act_capacities, grd_capacities,
                            report: VerificationReport) -> None:
    """Prove the schedule's op order completes under the given per-edge
    FIFO capacities (ERROR with the wait-for cycle and minimum viable
    capacities otherwise)."""
    report.ran("schedule-credits")
    streams, edge_names = schedule_sim_ops(schedule)
    caps = list(act_capacities)
    if schedule.trains:
        caps += list(grd_capacities)
    if len(caps) != len(edge_names):
        report.add(ERROR, "plan.edge-count", schedule.name,
                   f"{len(caps)} capacities for {len(edge_names)} edges")
        return
    wedge = simulate_credit_schedule(streams, caps)
    if wedge is not None:
        report.add(
            ERROR, "deadlock.schedule-credits", schedule.name,
            f"op order wedges under the planned FIFO capacities — "
            f"{wedge.describe(edge_names)}",
            min_viable=min(wedge.min_viable.values())
            if wedge.min_viable else None)


def verify_schedule_consistency(schedule, *, n_stages_built: int,
                                n_micro: int, train: bool,
                                report: VerificationReport) -> None:
    """The shape/coverage contract a microbatch pipeline enforces on its
    schedule at run time, as static findings."""
    report.ran("schedule-consistency")
    if schedule.n_model_stages != n_stages_built:
        report.add(ERROR, "plan.schedule-shape", schedule.name,
                   f"covers {schedule.n_stages} x {schedule.n_chunks} = "
                   f"{schedule.n_model_stages} model stages; the pipeline "
                   f"built {n_stages_built}")
    if schedule.n_micro != n_micro:
        report.add(ERROR, "plan.schedule-micro", schedule.name,
                   f"schedules {schedule.n_micro} microbatches; the run "
                   f"has {n_micro}")
    if schedule.trains != train:
        what = "has no backward ops" if train else "schedules backward"
        report.add(ERROR, "plan.schedule-train", schedule.name,
                   f"{what} — mismatched with train={train}")
    try:
        schedule.validate()
    except ValueError as e:
        report.add(ERROR, "plan.schedule-invalid", schedule.name, str(e))


# ===========================================================================
# fusion legality
# ===========================================================================
def verify_fusion(names, groups, *, heavy=(),
                  report: VerificationReport) -> None:
    """Re-validate a fusion plan against the structural rules
    `core.restructure.enumerate_fusions` generates under: a contiguous
    partition of the stage chain with at most one *heavy* (state-owning)
    member per group — fusing two heavy stages would relocate resident
    pipeline state, which is the planner's ``periods_per_stage`` axis,
    not stage combining."""
    report.ran("fusion-legality")
    heavy = set(heavy)
    groups = [tuple(g) if not isinstance(g, str) else (g,) for g in groups]
    flat = [n for g in groups for n in g]
    if flat != list(names):
        report.add(ERROR, "plan.fusion-partition",
                   "+".join("|".join(g) for g in groups) or "<empty>",
                   f"not a contiguous partition of the stage chain "
                   f"{list(names)}")
        return
    for g in groups:
        heavies = [n for n in g if n in heavy]
        if len(heavies) > 1:
            report.add(
                ERROR, "plan.fusion-heavy", "+".join(g),
                f"groups {len(heavies)} state-owning stages {heavies}: "
                f"`enumerate_fusions` excludes multi-heavy groups (that "
                f"axis is periods_per_stage, not combining)")


def verify_graph_fusion(stg, sel, groups,
                        report: VerificationReport) -> None:
    """Graph-level fusion check: actually apply `restructure.combine` to
    each multi-member group and run `validate_restructure` — the rewrite
    either round-trips or the combine/validate error becomes a
    finding."""
    from . import restructure
    report.ran("fusion-restructure")
    for g in groups:
        g = (g,) if isinstance(g, str) else tuple(g)
        if len(g) < 2:
            continue
        try:
            rg = restructure.combine(stg, sel, list(g))
            fused = next(iter(rg.groups))
            restructure.validate_restructure(stg, rg,
                                             touched=set(g) | {fused})
        except (ValueError, KeyError) as e:
            report.add(ERROR, "plan.fusion-illegal", "+".join(g), str(e))


# ===========================================================================
# the cache contract
# ===========================================================================
def _cache_state(cache: dict) -> list:
    """(path, tensor identity, shape, dtype, stride, storage identity,
    offset) of every tensor of one stage's cache slice."""
    out = [("pos", cache["pos"])] + [
        (f"layers[{i}].{name}", t)
        for i, layer in enumerate(cache["layers"]) for name, t in layer.items()]
    return [(path, id(t), tuple(t.shape), t.dtype, t.stride(),
             t.untyped_storage()._cdata, t.storage_offset()) for path, t in out]


def _contract_violations(cfg, kinds: tuple, batch: int, prompt: int, cap: int,
                         dtype) -> list[tuple[str, str]]:
    """(tensor path, what changed) for every cache tensor a decode step of
    layers of ``kinds`` did not update in place, run on ``meta``; raises
    where a plain op cannot run there."""
    import torch

    from ..models import lm
    from ..runtime.pipeline.decode import _stage_fns
    layers = torch.nn.ModuleList(lm.DecoderLayer(cfg, kind, device="meta")
                                 for kind in kinds)
    params = {"layers": layers, "span": (0, len(kinds))}
    pre, dec = _stage_fns(cfg, False, True, False, "ref")
    with torch.no_grad():
        x = torch.zeros((batch, prompt, cfg.d_model), dtype=dtype, device="meta")
        _, cache = pre(params, x, cap)
        before = _cache_state(cache)
        dec(params, cache, torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                       device="meta"))
        after = _cache_state(cache)
    if len(before) != len(after):
        return [("", f"decode changed the cache's structure: {len(before)} "
                     f"tensors before, {len(after)} after")]
    out = []
    for b, a in zip(before, after):
        if b[1:] != a[1:]:
            what = [n for n, x, y in zip(("tensor", "shape", "dtype", "stride",
                                          "storage", "offset"), b[1:], a[1:]) if x != y]
            out.append((f".{b[0]}", f"decode did not update this cache tensor in "
                                    f"place: its {', '.join(what)} changed "
                                    f"({b[2]} {b[3]} -> {a[2]} {a[3]})"))
    return out


def verify_decode_cache_contract(cfg, span, *, batch: int, prompt: int, cap: int,
                                 dtype, stage: str, report: VerificationReport,
                                 memo: dict | None = None) -> None:
    """A block stage over periods ``span`` ((lo, hi) of ``block_pattern``)
    updates its cache slice in place: after a prefill at (``batch``,
    ``prompt``) into capacity ``cap``, one decode step must leave every
    tensor of the slice — the same objects — with the shape, dtype,
    strides and storage it found.  The stage's own prefill and decode
    (`decode._stage_fns`) run on ``meta`` tensors of fresh layers of the
    same config, through the plain route; nothing is computed.  ``memo``:
    a dict shared by the calls of one plan, so stages of the same layer
    kinds at the same shape run the check once."""
    L = len(cfg.block_pattern)
    kinds = tuple(cfg.block_pattern[i % L][0] for i in range(span[0] * L, span[1] * L))
    key = (kinds, batch, prompt, cap, dtype)
    memo = {} if memo is None else memo
    if key not in memo:
        try:
            memo[key] = _contract_violations(cfg, kinds, batch, prompt, cap, dtype)
        except (NotImplementedError, RuntimeError) as e:
            memo[key] = e
    found = memo[key]
    if isinstance(found, Exception):
        report.add(WARN, "cache.contract-not-run", stage,
                   f"the plain route cannot run on meta tensors here ({found}); "
                   f"the cache contract is unchecked")
        return
    report.ran("cache-contract")
    for path, message in found:
        report.add(ERROR, "cache.contract", stage + path, message)


# ===========================================================================
# placement / selection consistency
# ===========================================================================
def verify_placement(stg, sel, placement,
                     report: VerificationReport) -> None:
    """Replica counts vs placement slices: every graph node's planned
    replica count must be materialised as that many placement slices,
    tp>1 slices should own distinct devices (else the sub-mesh is
    invalid and the executor silently falls back), and oversubscription
    is surfaced."""
    report.ran("placement-consistency")
    for name in stg.topo_order():
        nr = sel.replicas(name)
        slices = placement.replicas_of(name)
        if nr < 1:
            report.add(ERROR, "plan.replicas", name,
                       f"selection asks for {nr} replicas")
        if len(slices) != nr:
            report.add(ERROR, "plan.replica-placement", name,
                       f"plan promises {nr} replica(s) but the placement "
                       f"carries {len(slices)} slice(s)")
        for sl in slices:
            if sl.tp > 1 and not sl.distinct:
                report.add(WARN, "plan.folded-slice",
                           f"{name}@r{sl.replica}",
                           f"tp{sl.tp} slice folds onto repeated devices "
                           f"{list(sl.devices)}: no sub-mesh, executor "
                           f"falls back to single-device placement")
    if placement.oversubscription > 1.0:
        report.add(WARN, "plan.oversubscribed", "placement",
                   f"plan wants {placement.demand} chip(s) on "
                   f"{placement.n_devices} device(s) "
                   f"(x{placement.oversubscription:.1f} time-shared)")


# ===========================================================================
# plan-level entry points
# ===========================================================================
def verify_graph(stg, sel=None, *, capacity_blocks: int = 2,
                 fusion_groups=None) -> VerificationReport:
    """Static analysis of a bare (STG, Selection) pair: graph structural
    validity, rate consistency, per-channel capacity under the
    `ChannelSet.for_graph` sizing, selection coverage, and (optionally)
    graph-level fusion legality."""
    report = VerificationReport(
        plan=f"graph<{len(stg.nodes)} nodes, {len(stg.channels)} "
             f"channels> @ capacity_blocks={capacity_blocks}")
    report.ran("graph-structure")
    try:
        stg.validate()
        stg.topo_order()
        q = stg.repetition_vector()
    except (ValueError, KeyError) as e:
        report.add(ERROR, "graph.invalid", "stg", str(e))
        return report
    if sel is not None:
        report.ran("selection-coverage")
        for name in stg.topo_order():
            try:
                sel.impl_of(stg, name)
            except (KeyError, ValueError) as e:
                report.add(ERROR, "plan.selection", name, str(e))
                continue
            if sel.replicas(name) < 1:
                report.add(ERROR, "plan.replicas", name,
                           f"{sel.replicas(name)} replicas")
    # channel capacities under the executor's actual sizing rule — build
    # the real ChannelSet so the analysis can never drift from the code
    from ..runtime.pipeline.channels import ChannelSet
    cs = ChannelSet.for_graph(stg, capacity_blocks=capacity_blocks)
    edges = []
    for ch in stg.channels:
        block = max(1, stg.nodes[ch.dst].in_rates[ch.dst_port])
        burst = max(1, stg.nodes[ch.src].out_rates[ch.src_port])
        edges.append(EdgeSpec(
            src=ch.src, dst=ch.dst, capacity=cs[ch.key()].capacity,
            label=f"{ch.src}->{ch.dst}", block=block, burst=burst))
    check_channel_capacities(edges, report)
    del q
    if fusion_groups and sel is not None:
        verify_graph_fusion(stg, sel, fusion_groups, report)
    return report


def verify_decode_plan(pipe, *, n_groups: int, capacity_blocks: int = 2,
                       feedback_capacity: int | None = None,
                       group_shapes=(), check_cache: bool = True
                       ) -> VerificationReport:
    """Static analysis of a `DecodePipeline` serve: the act-chain +
    head→embed feedback cycle's credits (fusion-deleted internal hops
    are already gone from ``stage_names``), fusion legality against the
    heavy-set rule, replica counts vs placement slices, and the cache
    contract for every block stage at every (batch, bucket, cap) group
    shape this serve will run.  Device-free: FIFO construction and
    ``meta`` tensors only."""
    names = list(pipe.stage_names)
    S = len(names)
    fb_cap = feedback_capacity if feedback_capacity is not None \
        else max(2, n_groups)
    report = VerificationReport(
        plan=f"decode plan: {S} stage(s) [{' -> '.join(names)}], "
             f"{n_groups} group(s), feedback capacity {fb_cap}")
    edges = [EdgeSpec(src=names[s], dst=names[s + 1],
                      capacity=pipe._edge_fifo(s, capacity_blocks).capacity,
                      label=f"act{s}")
             for s in range(S - 1)]
    # the continuous token stream: pushed unconditionally at head
    # retirement (`_ServeRun.on_head`), popped by embed decode dispatch
    edges.append(EdgeSpec(src=names[-1], dst=names[0], capacity=fb_cap,
                          label="feedback", gated=False))
    check_channel_capacities(edges, report)
    check_cycles(edges, n_groups, report)
    if pipe.fusion_plan:
        base = [m for g in pipe.fusion_plan for m in g]
        heavy = [m for m in base if m.startswith("blocks")]
        verify_fusion(base, pipe.fusion_plan, heavy=heavy, report=report)
    stg = getattr(pipe, "stg", None)
    sel = getattr(pipe, "sel", None)
    if stg is not None and sel is not None:
        verify_placement(stg, sel, pipe.placement, report)
    if check_cache:
        by_span = {desc.span: desc.name for desc in pipe.stage_descs}
        memo: dict = {}
        for span in sorted(sp for sp in by_span if sp is not None):
            for (batch, bucket, cap) in sorted(set(group_shapes)):
                verify_decode_cache_contract(
                    pipe.cfg, span, batch=batch, prompt=bucket, cap=cap,
                    dtype=pipe.params.embed.dtype,
                    stage=f"{by_span[span]}[{batch}x{bucket}->{cap}]", report=report,
                    memo=memo)
    return report


def _accumulate_violations(st) -> list[str]:
    """What breaks stage ``st``'s accumulate contract, run on ``meta``
    tensors shaped like its masters: the accumulator made from the first
    microbatch's gradients (bfloat16 for the working copies of
    `lm_pipe.working_params`, the master's dtype for the rest;
    `lm_pipe.first_acc`) must have each master's shape and dtype, and keep
    them and its storage through the stage's own fold program (``add_``
    in place)."""
    import torch

    from ..runtime.pipeline.lm_pipe import first_acc, working_params

    out = []
    masters = [(n, p) for n, p in st.module.named_parameters()]
    working = {id(p) for _, _, p in working_params(st.module)}
    pb = [torch.empty(p.shape, dtype=torch.bfloat16 if id(p) in working else p.dtype,
                      device="meta") for _, p in masters]
    acc = first_acc(pb, [p.dtype for _, p in masters])
    before = [(id(a), a.untyped_storage()._cdata) for a in acc]
    folded = st.acc.fn(acc, pb)
    for (name, p), b, a in zip(masters, before, folded):
        if (id(a), a.untyped_storage()._cdata) != b:
            out.append(f"{name}: the fold wrote a new tensor, not the accumulator")
        if a.shape != p.shape or a.dtype != p.dtype:
            out.append(f"{name}: accumulator {tuple(a.shape)} {a.dtype}, master "
                       f"{tuple(p.shape)} {p.dtype}")
    return out


def verify_lm_plan(pipe, *, schedule, n_micro: int, train: bool,
                   act_capacities=None, grd_capacities=None,
                   deep: bool = False) -> VerificationReport:
    """Static analysis of an `LMPipeline.run`: schedule consistency +
    `validate()` invariants, the op order simulated against the act/grd
    FIFO credits, replica/placement consistency, and (``deep=True``)
    the accumulate contract: each stage's accumulator keeps its master's
    shape and dtype, and its storage, through the fold, checked on
    ``meta`` tensors (no data, no device).  The JAX package's
    donated-accumulate aliasing check has no counterpart: an in-place
    ``add_`` donates nothing, so there is no donation to get wrong."""
    report = VerificationReport(
        plan=f"lm plan: {pipe.n_stages} stage(s), schedule "
             f"{schedule.name}, {n_micro} microbatch(es), train={train}")
    verify_schedule_consistency(schedule, n_stages_built=pipe.n_stages,
                                n_micro=n_micro, train=train,
                                report=report)
    if not report.ok():
        return report          # shape mismatch: the credit sim's edge
    #                            layout would be meaningless
    M = pipe.n_stages
    if act_capacities is None:
        act_capacities = [pipe._edge_fifo(pipe.stages[i],
                                          pipe.stages[i + 1]).capacity
                          for i in range(M - 1)]
    if grd_capacities is None:
        grd_capacities = [pipe._edge_fifo(pipe.stages[i + 1],
                                          pipe.stages[i]).capacity
                          for i in range(M - 1)] if train else []
    verify_schedule_credits(schedule, act_capacities, grd_capacities,
                            report)
    stg = getattr(pipe, "stg", None)
    sel = getattr(pipe, "sel", None)
    if stg is not None and sel is not None:
        verify_placement(stg, sel, pipe.placement, report)
    if deep and train:
        report.ran("accumulate")
        for st in pipe.stages:
            bad = _accumulate_violations(st)
            if bad:
                report.add(
                    ERROR, "accumulate.contract", st.name,
                    f"gradient accumulator leaves break the in-place fold: {bad[:3]}")
    return report


__all__ = [
    "ERROR", "WARN", "Finding", "PlanVerificationError",
    "VerificationReport", "EdgeSpec", "SimOp", "Wedge",
    "channel_liveness_floor", "check_channel_capacities", "check_cycles",
    "simulate_credit_schedule", "schedule_sim_ops",
    "verify_schedule_credits", "verify_schedule_consistency",
    "verify_fusion", "verify_graph_fusion", "verify_decode_cache_contract",
    "verify_placement", "verify_graph", "verify_decode_plan", "verify_lm_plan",
]
