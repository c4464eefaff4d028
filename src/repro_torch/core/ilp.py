"""ILP trade-off finder (paper §II.B.1, Eq. 3-4).

Variables: binary x_{j,i} selecting implementation i for node j, and replica
counts nr_{j,i}.  Because the minimum feasible replica count for a chosen
implementation is determined by the propagated throughput target
(nr* = ceil(II / target), Eq. 8), the MILP is formulated over per-node
*choices* c = (impl, nr) with precomputed cost

    cost(c) = nr * A(impl) + forkjoin.replication_overhead(nr)

exactly matching the paper's ILP behaviour: "ILP replicates the bottleneck
without any attention to its neighbouring nodes" — overhead is charged as
stand-alone fork+join trees (Eq. 9), and node combining/splitting is NOT
expressible (the paper's stated shortcoming, which our heuristic exploits).

Two problems:
  * min_area       — Eq. 4: minimise A_A s.t. v_A <= v_tgt.
  * max_throughput — Eq. 3: minimise v_A s.t. A_A <= A_C.

Both are solved with scipy's HiGHS MILP when available; a pure-Python exact
branch-and-bound fallback is provided so the tool has no hard scipy
dependency.  Solve wall-time is reported (the paper claims the heuristic is
faster — benchmarks/bench_solver_speed.py checks that claim).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from .fork_join import ForkJoinModel, LITERAL
from .stg import STG, Selection
from .throughput import analyze, propagate_targets

try:  # scipy is optional
    from scipy.optimize import Bounds, LinearConstraint, milp

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


@dataclass
class TradeoffResult:
    selection: Selection
    impl_area: float
    overhead_area: float
    total_area: float
    v_app: float
    solver: str
    solve_seconds: float
    feasible: bool = True
    meta: dict = field(default_factory=dict)

    def summary(self) -> str:
        rows = [f"  {n}: {i} x{nr}" for n, (i, nr) in sorted(self.selection.choices.items())]
        return (f"[{self.solver}] v_app={self.v_app:g} area={self.total_area:g} "
                f"(impl {self.impl_area:g} + overhead {self.overhead_area:g})\n" + "\n".join(rows))


def _selectable(stg: STG) -> list[str]:
    """Nodes the solver selects implementations for (sources/sinks with a
    single zero-area impl are pass-through endpoints)."""
    return [n for n in stg.topo_order() if stg.nodes[n].kind == "compute"]


def _endpoint_selection(stg: STG) -> dict[str, tuple[str, int]]:
    return {n: (stg.nodes[n].impls[0].name, 1)
            for n in stg.nodes if stg.nodes[n].kind != "compute"}


@dataclass(frozen=True)
class _Choice:
    impl: str
    nr: int
    area: float      # nr * A(impl)
    overhead: float  # stand-alone fork/join tree cost for nr replicas
    v_firing: float  # II / nr  (per-firing inverse throughput)

    @property
    def cost(self) -> float:
        return self.area + self.overhead


def _choices_for_target(stg: STG, name: str, firing_target: float,
                        fj: ForkJoinModel) -> list[_Choice]:
    """All (impl, minimal nr) choices meeting a per-firing target."""
    out = []
    for im in stg.nodes[name].impls:
        nr = max(1, math.ceil(im.ii / firing_target - 1e-12))
        out.append(_Choice(im.name, nr, nr * im.area,
                           fj.replication_overhead(nr), im.ii / nr))
    return out


def _choice_grid(stg: STG, name: str, q: int, nr_cap: int,
                 fj: ForkJoinModel) -> list[_Choice]:
    """Pareto grid of (impl, nr) choices for the area-constrained problem."""
    cands: list[_Choice] = []
    for im in stg.nodes[name].impls:
        nr = 1
        while nr <= nr_cap:
            cands.append(_Choice(im.name, nr, nr * im.area,
                                 fj.replication_overhead(nr), im.ii / nr))
            nr *= 2
        exact = max(1, min(nr_cap, math.ceil(im.ii)))
        for nr2 in {exact, max(1, exact // 2), min(nr_cap, exact * 2)}:
            cands.append(_Choice(im.name, nr2, nr2 * im.area,
                                 fj.replication_overhead(nr2), im.ii / nr2))
    # Pareto filter on (v_firing, cost).
    cands.sort(key=lambda c: (c.v_firing, c.cost))
    front: list[_Choice] = []
    for c in cands:
        if front and c.v_firing == front[-1].v_firing:
            continue
        if not front or c.cost < front[-1].cost:
            front.append(c)
    return front


def _solve_selection_milp(per_node: dict[str, list[_Choice]],
                          extra_area_budget: float | None = None,
                          node_q: dict[str, int] | None = None):
    """Assemble and solve the 0/1 selection MILP with HiGHS.

    min sum cost*x   s.t.  per node sum x = 1  [, sum area*x <= budget]
    When a budget is given, additionally minimises the max normalised
    inverse throughput t with big-M linking constraints (Eq. 3 mode).
    Returns (chosen index per node, objective, bool used_milp).
    """
    names = list(per_node)
    idx: list[tuple[str, int]] = [(n, i) for n in names for i in range(len(per_node[n]))]
    nvar = len(idx)
    throughput_mode = extra_area_budget is not None
    ncols = nvar + (1 if throughput_mode else 0)  # [+ t]

    c = np.zeros(ncols)
    if throughput_mode:
        c[-1] = 1.0  # minimise t = v_app
    else:
        for k, (n, i) in enumerate(idx):
            c[k] = per_node[n][i].cost

    A_rows, lbs, ubs = [], [], []
    for n in names:  # one-hot per node
        row = np.zeros(ncols)
        for k, (nn, i) in enumerate(idx):
            if nn == n:
                row[k] = 1.0
        A_rows.append(row); lbs.append(1.0); ubs.append(1.0)
    if throughput_mode:
        row = np.zeros(ncols)
        for k, (n, i) in enumerate(idx):
            row[k] = per_node[n][i].cost
        A_rows.append(row); lbs.append(-np.inf); ubs.append(float(extra_area_budget))
        for k, (n, i) in enumerate(idx):
            # t >= v_c * x (valid linearisation: v_c, t >= 0 and x binary)
            row = np.zeros(ncols)
            row[k] = per_node[n][i].v_firing * node_q[n]
            row[-1] = -1.0
            A_rows.append(row); lbs.append(-np.inf); ubs.append(0.0)

    if not _HAVE_SCIPY:
        return None
    integrality = np.ones(ncols)
    lo = np.zeros(ncols)
    hi = np.ones(ncols)
    if throughput_mode:
        integrality[-1] = 0
        hi[-1] = np.inf
    res = milp(c=c, constraints=LinearConstraint(np.array(A_rows), np.array(lbs), np.array(ubs)),
               integrality=integrality, bounds=Bounds(lo, hi))
    if not res.success:
        return ("infeasible", None)
    chosen = {}
    for k, (n, i) in enumerate(idx):
        if res.x[k] > 0.5:
            chosen[n] = i
    return (chosen, float(res.fun))


def min_area(stg: STG, v_tgt: float, fj: ForkJoinModel = LITERAL,
             solver: str = "auto") -> TradeoffResult:
    """Eq. 4: minimise area subject to application inverse throughput <= v_tgt."""
    t0 = time.perf_counter()
    targets = propagate_targets(stg, v_tgt)
    names = _selectable(stg)
    per_node = {n: _choices_for_target(stg, n, targets[n], fj) for n in names}

    used = "ilp-greedy"
    chosen: dict[str, int]
    if solver in ("auto", "milp") and _HAVE_SCIPY:
        out = _solve_selection_milp(per_node)
        if out is not None and out[0] != "infeasible":
            chosen, _ = out
            used = "ilp-highs"
        else:  # pragma: no cover
            chosen = {n: min(range(len(per_node[n])), key=lambda i: per_node[n][i].cost)
                      for n in names}
    else:
        # Exact fallback: the objective separates per node.
        chosen = {n: min(range(len(per_node[n])), key=lambda i: per_node[n][i].cost)
                  for n in names}

    sel = Selection(dict(_endpoint_selection(stg)))
    impl_area = overhead = 0.0
    for n in names:
        ch = per_node[n][chosen[n]]
        sel.set(n, ch.impl, ch.nr)
        impl_area += ch.area
        overhead += ch.overhead
    v_app = analyze(stg, sel).v_app
    return TradeoffResult(sel, impl_area, overhead, impl_area + overhead, v_app,
                          used, time.perf_counter() - t0,
                          feasible=v_app <= v_tgt + 1e-9,
                          meta={"v_tgt": v_tgt})


def max_throughput(stg: STG, area_budget: float, fj: ForkJoinModel = LITERAL,
                   solver: str = "auto") -> TradeoffResult:
    """Eq. 3: minimise application inverse throughput subject to area <= A_C."""
    t0 = time.perf_counter()
    q = stg.repetition_vector()
    names = _selectable(stg)
    min_impl_area = min(im.area for n in names for im in stg.nodes[n].impls)
    nr_cap = max(1, int(area_budget // max(min_impl_area, 1e-9)))
    per_node = {n: _choice_grid(stg, n, q[n], nr_cap, fj) for n in names}

    used = "ilp-bisect"
    chosen: dict[str, int] | None = None
    if solver == "milp" and _HAVE_SCIPY:
        out = _solve_selection_milp(per_node, extra_area_budget=area_budget, node_q=q)
        if out is not None and out[0] != "infeasible":
            chosen, _ = out
            used = "ilp-highs"
    if chosen is None:
        # Exact bisection over candidate v_app values (area(v) is monotone).
        cand = sorted({c.v_firing * q[n] for n in names for c in per_node[n]})

        def area_at(v: float) -> tuple[float, dict[str, int] | None]:
            total, pick = 0.0, {}
            for n in names:
                ok = [i for i, c in enumerate(per_node[n]) if c.v_firing * q[n] <= v + 1e-12]
                if not ok:
                    return math.inf, None
                i = min(ok, key=lambda i: per_node[n][i].cost)
                pick[n] = i
                total += per_node[n][i].cost
            return total, pick

        lo, hi = 0, len(cand) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            a, pick = area_at(cand[mid])
            if a <= area_budget:
                best = pick
                hi = mid - 1
            else:
                lo = mid + 1
        chosen = best

    if chosen is None:
        sel = Selection.smallest(stg)
        for n, (i, nr) in _endpoint_selection(stg).items():
            sel.set(n, i, nr)
        an = analyze(stg, sel)
        return TradeoffResult(sel, sel.impl_area(stg), 0.0, sel.impl_area(stg),
                              an.v_app, used, time.perf_counter() - t0, feasible=False,
                              meta={"area_budget": area_budget})

    sel = Selection(dict(_endpoint_selection(stg)))
    impl_area = overhead = 0.0
    for n in names:
        ch = per_node[n][chosen[n]]
        sel.set(n, ch.impl, ch.nr)
        impl_area += ch.area
        overhead += ch.overhead
    v_app = analyze(stg, sel).v_app
    return TradeoffResult(sel, impl_area, overhead, impl_area + overhead, v_app,
                          used, time.perf_counter() - t0,
                          feasible=impl_area + overhead <= area_budget + 1e-9,
                          meta={"area_budget": area_budget})
