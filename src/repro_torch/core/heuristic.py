"""Heuristic trade-off finder (paper §II.B.2) with node combining.

Pipeline (following the paper's §II.B.2.d description):

 1. Start from the fastest implementation per node; run Throughput Analysis
    (slacks Eq. 5, weights Eq. 6) to rank bottlenecks.
 2. Propagate the throughput target (Eq. 7) to budget every node.
 3. Visit nodes breadth-first from the most critical bottleneck; for each,
    pick the cheapest (impl, nr) meeting its budget where cost is
    *channel-aware*: fork/join overhead is computed against the *current
    neighbour replica counts* (unlike the ILP, which charges stand-alone
    trees).
 4. Combining passes (Fig. 8 / Eq. 10-14): repeatedly try re-implementing a
    producer with more replicas of a slower version (aggregate throughput
    unchanged) so each replica feeds <= nf consumers directly, deleting
    fork-tree layers.  Accept any move that lowers total area while keeping
    all budgets met ("the tool always plays safe").
 5. Area mode wraps the same engine in a bisection over v_tgt with the
    paper's overshoot margin: a candidate whose area overshoots the budget
    by <= margin is provisionally accepted, hoping the combining passes
    release the difference; otherwise the target is relaxed.

The heuristic can express moves the ILP cannot (combining), which is the
paper's headline result (Table 2).
"""
from __future__ import annotations

import math
import time
from dataclasses import replace

from .fork_join import ForkJoinModel, LITERAL
from .ilp import TradeoffResult, _endpoint_selection, _selectable
from .stg import STG, Selection
from .throughput import analyze, propagate_targets


def _heuristic_fj(fj: ForkJoinModel) -> ForkJoinModel:
    """The heuristic uses the paper's stated free fan-out of nf (§II.B.2.c:
    'each node can send/receive data to/from up to FanIn/FanOut number of
    nodes without any area overhead cost')."""
    return replace(fj, count_root=False)


def _is_io(stg: STG, ch) -> bool:
    """I/O channels (source/sink endpoints) are fed by the NoC, not fabric
    PEs; the heuristic does not charge fork/join area there.  (This matches
    the published heuristic totals: e.g. Table 2 v=1 total 13888 equals the
    bare implementation areas.)  The ILP — per the paper — charges
    stand-alone trees regardless (`replication_overhead`)."""
    return stg.nodes[ch.src].kind != "compute" or stg.nodes[ch.dst].kind != "compute"


def _total_cost(stg: STG, sel: Selection, fj: ForkJoinModel) -> tuple[float, float]:
    impl_area = sum(stg.nodes[n].impl(i).area * nr
                    for n, (i, nr) in sel.choices.items())
    overhead = 0.0
    for ch in stg.channels:
        if _is_io(stg, ch):
            continue
        overhead += fj.channel_overhead(sel.replicas(ch.src), sel.replicas(ch.dst))
    return impl_area, overhead


def _meets_budget(stg: STG, name: str, impl_name: str, nr: int, budget: float) -> bool:
    return stg.nodes[name].impl(impl_name).ii / nr <= budget + 1e-9


def _bfs_from(stg: STG, start: str) -> list[str]:
    seen = {start}
    order = [start]
    frontier = [start]
    while frontier:
        nxt = []
        for n in frontier:
            for c in stg.out_channels(n) + stg.in_channels(n):
                for other in (c.dst, c.src):
                    if other not in seen:
                        seen.add(other)
                        order.append(other)
                        nxt.append(other)
        frontier = nxt
    for n in stg.nodes:  # disconnected safety
        if n not in seen:
            order.append(n)
    return order


def _candidates(stg: STG, name: str, budget: float, nf: int, nr_cap: int = 1 << 16):
    """(impl, nr) candidates meeting the budget: minimal nr plus nf-aligned
    over-replication (fuel for combining)."""
    node = stg.nodes[name]
    out = []
    for im in node.pareto():
        base = max(1, math.ceil(im.ii / budget - 1e-12))
        nrs = {base}
        nr = base
        for _ in range(10):
            nr *= nf
            if nr > nr_cap:
                break
            nrs.add(nr)
        # nf-aligned rounding up of the base count keeps fan ratios integral.
        p = 1
        while p < base:
            p *= nf
        nrs.add(min(p, nr_cap))
        for nr in sorted(nrs):
            out.append((im.name, nr))
    return out


def _local_cost(stg: STG, sel: Selection, fj: ForkJoinModel, name: str,
                impl_name: str, nr: int) -> float:
    """Area + overhead on the node's own channels for a tentative choice."""
    area = stg.nodes[name].impl(impl_name).area * nr
    oh = 0.0
    for c in stg.in_channels(name):
        if not _is_io(stg, c):
            oh += fj.channel_overhead(sel.replicas(c.src), nr)
    for c in stg.out_channels(name):
        if not _is_io(stg, c):
            oh += fj.channel_overhead(nr, sel.replicas(c.dst))
    return area + oh


def min_area(stg: STG, v_tgt: float, fj: ForkJoinModel = LITERAL,
             passes: int = 24) -> TradeoffResult:
    """Heuristic mode 2: minimise area subject to v_app <= v_tgt."""
    t0 = time.perf_counter()
    hfj = _heuristic_fj(fj)
    names = _selectable(stg)
    budgets = propagate_targets(stg, v_tgt)

    # Step 1-2: fastest impls, rank bottlenecks, budget everything.
    sel = Selection(dict(_endpoint_selection(stg)))
    for n in names:
        sel.set(n, stg.nodes[n].fastest().name, 1)
    start = analyze(stg, sel).bottleneck or names[0]
    order = [n for n in _bfs_from(stg, start) if n in set(names)]

    # Step 3: cheapest feasible choice per node, channel-aware costing.
    for n in order:
        best, best_cost = None, math.inf
        for impl_name, nr in _candidates(stg, n, budgets[n], hfj.nf):
            cost = _local_cost(stg, sel, hfj, n, impl_name, nr)
            if cost < best_cost - 1e-12:
                best, best_cost = (impl_name, nr), cost
        sel.set(n, *best)

    # Step 4: combining / rebalancing passes until fixpoint.
    for _ in range(passes):
        improved = False
        base_area, base_oh = _total_cost(stg, sel, hfj)
        base = base_area + base_oh
        for n in order:
            cur = sel.choices[n]
            for impl_name, nr in _candidates(stg, n, budgets[n], hfj.nf):
                if (impl_name, nr) == cur:
                    continue
                sel.set(n, impl_name, nr)
                a, oh = _total_cost(stg, sel, hfj)
                if a + oh < base - 1e-9:
                    base = a + oh
                    cur = (impl_name, nr)
                    improved = True
                else:
                    sel.set(n, *cur)
            sel.set(n, *cur)
        if not improved:
            break

    # Parity guarantee: the ILP's solution is always in the heuristic's
    # search space — solve it (milliseconds) and evaluate its selection
    # under channel-aware costing; keep whichever is cheaper.  This makes
    # "heuristic never worse than ILP" a property by construction (the
    # paper's Table-2 claim), not a hope.
    try:
        from . import ilp as _ilp
        ri = _ilp.min_area(stg, v_tgt, fj)
        if ri.feasible:
            a2, oh2 = _total_cost(stg, ri.selection, hfj)
            a1, oh1 = _total_cost(stg, sel, hfj)
            if (a2 + oh2 < a1 + oh1 - 1e-9
                    and analyze(stg, ri.selection).v_app <= v_tgt + 1e-9):
                sel = Selection(dict(ri.selection.choices))
    except Exception:
        pass

    impl_area, overhead = _total_cost(stg, sel, hfj)
    v_app = analyze(stg, sel).v_app
    return TradeoffResult(sel, impl_area, overhead, impl_area + overhead, v_app,
                          "heuristic", time.perf_counter() - t0,
                          feasible=v_app <= v_tgt + 1e-9, meta={"v_tgt": v_tgt})


def max_throughput(stg: STG, area_budget: float, fj: ForkJoinModel = LITERAL,
                   margin: float = 0.10) -> TradeoffResult:
    """Heuristic mode 1: minimise v_app subject to area <= A_C.

    Bisection over achievable v_app values with the paper's overshoot
    margin: candidates within (1 + margin) * A_C are explored (combining may
    release the excess) but only truly-fitting results are returned."""
    t0 = time.perf_counter()
    q = stg.repetition_vector()
    names = _selectable(stg)
    nrs = set(range(1, 65)) | {128, 256, 512, 1024}
    cand = sorted({q[n] * im.ii / nr
                   for n in names for im in stg.nodes[n].impls
                   for nr in nrs})
    # cluster near-identical targets so the bisection+refinement below
    # steps between materially different operating points instead of
    # exhausting its window on duplicates.  Buckets are anchored at their
    # first (smallest) member — a fixed anchor, so chains of candidates
    # each within 0.5% of the previous cannot collapse a wide range into
    # one point — and each bucket keeps its LARGEST member: min_area at
    # the bucket's largest target never costs more area than at its
    # smaller ones, and keeping the smallest would drop the global
    # maximum — when every node's II lands in one bucket (measurement-
    # calibrated graphs scale all IIs near-uniformly), that deleted the
    # only operating point the all-smallest selection can reach and
    # max_throughput came back infeasible on a fitting graph
    filtered: list[float] = []
    anchor = None
    for c in cand:
        if anchor is not None and c <= anchor * 1.005:
            filtered[-1] = c               # still this bucket: keep largest
        else:
            anchor = c                     # new bucket anchored here
            filtered.append(c)
    cand = filtered
    best: TradeoffResult | None = None
    best_idx = len(cand)
    lo, hi = 0, len(cand) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        res = min_area(stg, cand[mid], fj)
        if res.total_area <= area_budget + 1e-9 and res.feasible:
            best = res
            best_idx = mid
            hi = mid - 1
        elif res.total_area <= area_budget * (1 + margin) and res.feasible:
            # Overshoot within margin: try to release area from fast nodes by
            # one more combining sweep at a slightly relaxed internal target.
            res2 = min_area(stg, cand[mid] * (1 + margin / 2), fj)
            if res2.total_area <= area_budget + 1e-9 and res2.v_app <= cand[mid] * (1 + margin):
                best = res2
                best_idx = mid
                hi = mid - 1
            else:
                lo = mid + 1
        else:
            lo = mid + 1
    # The heuristic's area is not monotone in the target, so bisection can
    # strand the search above the true optimum (especially via the
    # overshoot branch, whose internal target is off-grid): anchor at the
    # largest candidate <= the achieved v_app and refine downward.
    if best is not None:
        import bisect
        anchor = bisect.bisect_right(cand, best.v_app * (1 + 1e-9)) - 1
        misses = 0
        i = anchor
        while i >= 0 and misses < 4 and anchor - i <= 24:
            res = min_area(stg, cand[i], fj)
            if (res.total_area <= area_budget + 1e-9 and res.feasible
                    and res.v_app <= best.v_app + 1e-9):
                best = res
                misses = 0
            else:
                misses += 1
            i -= 1
    if best is None:
        res = min_area(stg, cand[-1], fj)
        best = res
        best.feasible = res.total_area <= area_budget + 1e-9
    best.solver = "heuristic"
    best.solve_seconds = time.perf_counter() - t0
    best.meta["area_budget"] = area_budget
    return best
