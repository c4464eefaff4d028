"""Intra-Node Optimizer (paper §II.A.1, Figs. 2-4).

A composite node's body is a DAG of *primitive operations*; each op kind has
an initiation interval (cycles a PE is busy per result: e.g. div = 8 on the
simple PE).  The optimizer enumerates implementations spanning the full
space/time range:

  * pipelining  — one PE per op; II = max op ii (Fig. 2: div stalls => II=8),
  * expansion   — replicate ops with ii > target round-robin (Fig. 3: 8
                  dividers => II=1),
  * clustering  — pack ops onto shared PEs; a cluster's II = sum of member
                  iis; node II = max cluster II (area savings, Fig. 4 right).

For a target II = t the greedy schedule packs topologically-sorted ops into
clusters with total ii <= t, and expands any single op with ii > t into
ceil(ii/t) round-robin copies.  area(t) = #clusters + total extra copies.
The resulting (II, area) frontier for the paper's N-body force node spans
II = 1 .. sum(ii) = 33 exactly as Fig. 4.

Copied from ``repro/core/intra_node.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .stg import Impl

# Default primitive-op inverse throughputs on the simple PE (paper Fig. 2:
# division takes 8 cycles; mul is multi-cycle; add/sub single-cycle).
DEFAULT_OP_II: dict[str, float] = {
    "add": 1, "sub": 1, "neg": 1, "abs": 1, "min": 1, "max": 1, "cmp": 1,
    "shift": 1, "and": 1, "or": 1, "xor": 1, "copy": 1, "sel": 1,
    "mul": 2, "mac": 2,
    "div": 8, "sqrt": 8, "rsqrt": 8, "exp": 8, "log": 8,
    "lut": 1, "table": 1,
}


@dataclass(frozen=True)
class PrimOp:
    name: str
    kind: str
    deps: tuple[str, ...] = ()
    ii: float | None = None  # override library ii

    def resolved_ii(self, lib: dict[str, float]) -> float:
        if self.ii is not None:
            return float(self.ii)
        if self.kind not in lib:
            raise KeyError(f"unknown primitive op kind {self.kind!r}")
        return float(lib[self.kind])


@dataclass
class CompositeBody:
    """The primitive-op DAG inside one composite node."""

    ops: tuple[PrimOp, ...]
    op_lib: dict[str, float] = field(default_factory=lambda: dict(DEFAULT_OP_II))

    def __post_init__(self):
        names = set()
        for op in self.ops:
            if op.name in names:
                raise ValueError(f"duplicate op {op.name}")
            names.add(op.name)
        for op in self.ops:
            for d in op.deps:
                if d not in names:
                    raise ValueError(f"op {op.name} depends on unknown {d}")

    def topo(self) -> list[PrimOp]:
        by_name = {o.name: o for o in self.ops}
        seen: dict[str, int] = {}
        order: list[PrimOp] = []

        def visit(o: PrimOp):
            state = seen.get(o.name, 0)
            if state == 1:
                raise ValueError("cycle in primitive DAG")
            if state == 2:
                return
            seen[o.name] = 1
            for d in o.deps:
                visit(by_name[d])
            seen[o.name] = 2
            order.append(o)

        for o in self.ops:
            visit(o)
        return order

    def total_ii(self) -> float:
        return sum(op.resolved_ii(self.op_lib) for op in self.ops)

    def max_ii(self) -> float:
        return max(op.resolved_ii(self.op_lib) for op in self.ops)

    def critical_latency(self) -> float:
        """Longest dependence path (sum of iis) — pipeline fill latency."""
        lat: dict[str, float] = {}
        for op in self.topo():
            lat[op.name] = op.resolved_ii(self.op_lib) + max(
                (lat[d] for d in op.deps), default=0.0)
        return max(lat.values()) if lat else 0.0


@dataclass
class ScheduledImpl:
    """An implementation + its schedule provenance."""

    impl: Impl
    clusters: list[list[str]]
    expansions: dict[str, int]  # op name -> copies (round-robin expansion)


def schedule_for_target(body: CompositeBody, target_ii: float) -> ScheduledImpl:
    """Greedy topological packing for a target II (see module docstring)."""
    if target_ii <= 0:
        raise ValueError("target_ii must be positive")
    clusters: list[list[str]] = []
    expansions: dict[str, int] = {}
    cur: list[str] = []
    cur_ii = 0.0
    area = 0.0
    for op in body.topo():
        ii = op.resolved_ii(body.op_lib)
        if ii > target_ii:
            # Expansion (Fig. 3): round-robin copies bring effective ii to target.
            copies = math.ceil(ii / target_ii - 1e-12)
            if cur:
                clusters.append(cur)
                cur, cur_ii = [], 0.0
            clusters.append([op.name])
            expansions[op.name] = copies
            area += copies
            continue
        if cur_ii + ii > target_ii + 1e-12:
            clusters.append(cur)
            cur, cur_ii = [], 0.0
        cur.append(op.name)
        cur_ii += ii
    if cur:
        clusters.append(cur)
    area += sum(1 for c in clusters if c[0] not in expansions)
    achieved = 0.0
    for c in clusters:
        if c[0] in expansions:
            op = next(o for o in body.ops if o.name == c[0])
            achieved = max(achieved, op.resolved_ii(body.op_lib) / expansions[c[0]])
        else:
            achieved = max(achieved, sum(
                next(o for o in body.ops if o.name == n).resolved_ii(body.op_lib) for n in c))
    impl = Impl(name=f"ii{achieved:g}_a{area:g}", area=area, ii=achieved,
                latency=body.critical_latency(),
                meta={"target_ii": target_ii})
    return ScheduledImpl(impl, clusters, expansions)


def enumerate_impls(body: CompositeBody, targets: list[float] | None = None) -> list[Impl]:
    """Enumerate the Pareto frontier of (II, area) implementations.

    Candidate targets default to every achievable II between 1 (full
    expansion) and sum of op iis (single PE)."""
    if targets is None:
        hi = int(math.ceil(body.total_ii()))
        targets = sorted({float(t) for t in range(1, hi + 1)})
    impls: list[Impl] = []
    for t in targets:
        s = schedule_for_target(body, t)
        impls.append(s.impl)
    # Pareto-filter on (ii, area); dedupe by (ii, area).
    impls.sort(key=lambda im: (im.ii, im.area))
    frontier: list[Impl] = []
    for im in impls:
        if frontier and im.ii == frontier[-1].ii:
            continue
        if not frontier or im.area < frontier[-1].area:
            frontier.append(im)
    # Re-name canonically v1..vk (fastest first) to mirror the paper's tables.
    out = []
    for i, im in enumerate(frontier):
        out.append(Impl(name=f"v{i+1}", area=im.area, ii=im.ii,
                        latency=im.latency, meta=im.meta))
    return out
