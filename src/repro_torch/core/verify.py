"""Static plan verification of a decode serve: prove it safe before it runs.

Ported from the decode half of ``repro/core/verify.py``.  The executors
discover unsafe plans at run time — `Engine._deadlock_detail` forensics
after a wedge, `Fifo` overflow raises.  The KPN/STG abstraction makes
that analyzable *up front*: this module takes a `DecodePipeline` serve's
plan tuple — stage chain, fusion plan, placement, channel capacities,
group shapes — and returns a structured report of ERROR/WARN findings.

Three check families:

  * **bounded-FIFO deadlock analysis** — channels as credit-carrying
    edges.  A rate-changing edge (consumer pops ``block`` tokens per
    firing, producer pushes ``burst``) is live iff its capacity reaches
    the classic SDF bound ``block + burst - gcd(block, burst)``; an
    unconditional-push edge (the head→embed token feedback stream) must
    absorb its worst-case in-flight burst; every cycle must keep at least
    one free credit.
  * **plan-consistency** — fusion groups re-checked against
    `enumerate_fusions`' heavy-set rule, replica counts vs placement
    slices.
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

Not ported: the training half (schedule credit simulation, schedule
consistency, `verify_lm_plan`, the donated-accumulate check) and
`verify_graph` / `verify_graph_fusion` (``ROADMAP.md``).
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
    (``deadlock.*`` / ``channel.*`` / ``plan.*`` / ``cache.*``);
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
# the plan-level entry point
# ===========================================================================
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


__all__ = [
    "ERROR", "WARN", "Finding", "PlanVerificationError",
    "VerificationReport", "EdgeSpec", "channel_liveness_floor",
    "check_channel_capacities", "check_cycles", "verify_fusion",
    "verify_decode_cache_contract", "verify_placement", "verify_decode_plan",
]
