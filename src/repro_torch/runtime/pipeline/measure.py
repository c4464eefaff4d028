"""Measurement layer: measured vs analytic throughput, and replan feedback.

Ported from ``repro/runtime/pipeline/measure.py``.  It closes the paper's
loop: the solver promises an application inverse throughput (Eq. 1/5/6
via `core/throughput.analyze`); the executors measure what the pipeline
actually sustains — per-stage streams of completion or firing times whose
steady-state gap is the stage's effective inverse throughput (ii/nr for
replicated stages).  `_build_report` lines the measured values up against
the analytic model; ``compare()`` adapts a virtual-clock interpreter run
(`interpreter.PipelineRun`) to it and ``compare_lm()`` a pipelined serve
(`decode.ServeRunResult`) or microbatch run (`lm_pipe.LMPipelineResult`).

``calibrate()`` scales each node's implementation library by its
measured/analytic ratio; ``measured_replan()`` re-runs the solver once on
the calibrated graph; and ``replan_to_fixed_point()`` iterates the whole
loop — plan -> run -> measure -> replan — to a fixed point with geometric
damping and an oscillation guard (a measured-slow stage gains replicas,
which changes what is measured, which changes the plan ...; undamped, the
solver can flip between two selections forever).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable

from ...core import heuristic, ilp
from ...core.fork_join import LITERAL, ForkJoinModel
from ...core.stg import SINK, SOURCE, STG, Node, Selection, scale_impls
from ...core.throughput import analyze
from .interpreter import PipelineRun


@dataclass
class StageMeasurement:
    stage: str
    analytic_v: float          # cycles/firing the model predicts (II / nr)
    measured_v: float          # cycles/firing the pipeline sustained
    replicas: int
    utilization: float
    host_v: float | None = None    # host dispatch overhead per firing (us,
    #                                wall-clock backends; None under the
    #                                virtual clock) — dispatch cost as its
    #                                own column, not folded into measured_v
    stall_v: float | None = None   # total time blocked on a full output
    #                                fifo (credit wait: downstream is the
    #                                bottleneck) — native unit (s wall /
    #                                cycles virtual); None when untraced
    starve_v: float | None = None  # total time blocked on an empty input
    #                                fifo (starve + reorder wait: upstream
    #                                is the bottleneck); None when untraced

    @property
    def ratio(self) -> float:
        return self.measured_v / self.analytic_v if self.analytic_v > 0 else 1.0


@dataclass
class PipelineReport:
    stages: dict[str, StageMeasurement] = field(default_factory=dict)
    v_app_analytic: float = 0.0    # cycles per graph iteration, model
    v_app_measured: float = 0.0    # cycles per graph iteration, executed
    bottleneck_analytic: str | None = None
    bottleneck_measured: str | None = None
    fifo_stalls: int = 0
    oversubscription: float = 1.0
    slo: dict | None = None        # serving-SLO percentiles (flat ms dict,
    #                                `metrics.serving_slo`) when the run
    #                                was a serve; None for batch runs

    @property
    def accuracy(self) -> float:
        """measured / analytic application inverse throughput (1.0 = the
        pipeline delivers exactly what the model promised)."""
        return (self.v_app_measured / self.v_app_analytic
                if self.v_app_analytic > 0 else float("nan"))

    def ratios(self) -> dict[str, float]:
        return {s.stage: s.ratio for s in self.stages.values()}

    def to_json(self) -> str:
        # per-stage metrics that never fired (host on the virtual clock,
        # stall/starve on untraced runs) are omitted, not emitted as null
        def stage_dict(m: StageMeasurement) -> dict:
            d = {"analytic_v": m.analytic_v, "measured_v": m.measured_v,
                 "ratio": m.ratio, "replicas": m.replicas,
                 "utilization": m.utilization, "host_us": m.host_v,
                 "stall": m.stall_v, "starve": m.starve_v}
            return {k: v for k, v in d.items() if v is not None}

        top = {
            "v_app_analytic": self.v_app_analytic,
            "v_app_measured": self.v_app_measured,
            "accuracy": self.accuracy,
            "bottleneck_analytic": self.bottleneck_analytic,
            "bottleneck_measured": self.bottleneck_measured,
            "fifo_stalls": self.fifo_stalls,
            "oversubscription": self.oversubscription,
            "stages": {n: stage_dict(m) for n, m in self.stages.items()},
        }
        if self.slo is not None:
            top["slo"] = self.slo
        return json.dumps(top, indent=2)

    def summary(self) -> str:
        def cols(m: StageMeasurement) -> str:
            # host always gets a column; `-` marks not-applicable (virtual
            # clock) so rows stay alignable.  stall/starve appear only on
            # traced runs — total blocked time in the run's native unit.
            out = (f", host {m.host_v:.0f}us/firing"
                   if m.host_v is not None else ", host -")
            if m.stall_v is not None:
                out += f", stall {m.stall_v:.3g}"
            if m.starve_v is not None:
                out += f", starve {m.starve_v:.3g}"
            return out

        rows = [f"  {m.stage}: model {m.analytic_v:.3g} vs measured "
                f"{m.measured_v:.3g} cyc/firing (x{m.ratio:.2f}), "
                f"util {m.utilization:.0%}" + cols(m)
                for m in sorted(self.stages.values(), key=lambda m: -m.ratio)]
        head = (f"pipeline: v_app measured {self.v_app_measured:.3g} vs model "
                f"{self.v_app_analytic:.3g} ({self.accuracy:.2f}x), "
                f"bottleneck {self.bottleneck_measured} "
                f"(model said {self.bottleneck_analytic}), "
                f"{self.fifo_stalls} fifo stalls")
        if self.slo is not None:
            head += ("\n  slo: " + ", ".join(
                f"{k}={v:.2f}" for k, v in self.slo.items()))
        return head + "\n" + "\n".join(rows)


# ===========================================================================
# one comparison core for every engine backend
# ===========================================================================
def _build_report(stg: STG, sel: Selection, *,
                  measured_of: Callable[[str], float | None],
                  firings_of: Callable[[str], int],
                  util_of: Callable[[str], float],
                  fifo_stalls: int, oversubscription: float,
                  skip_kinds: tuple = (),
                  host_of: Callable[[str], float | None] = lambda name: None,
                  stall_of: Callable[[str], float | None] = lambda name: None,
                  starve_of: Callable[[str], float | None] = lambda name: None,
                  err_noun: str = "firings",
                  err_hint: Callable[[dict], str] = lambda counts: "") \
        -> PipelineReport:
    """Line one executed run's measured per-stage inverse throughput up
    against the analytic model — the single comparison rule for every
    engine backend.  ``measured_of`` returns a stage's steady-state
    measured value or None (no steady state yet; the stage is skipped
    rather than calibrated on a degraded sample)."""
    a = analyze(stg, sel)
    q = stg.repetition_vector()
    rep = PipelineReport(
        v_app_analytic=a.v_app,
        bottleneck_analytic=a.bottleneck,
        fifo_stalls=fifo_stalls,
        oversubscription=oversubscription)
    worst_v, worst_stage = 0.0, None
    firings: dict[str, int] = {}
    for name in stg.nodes:
        if stg.nodes[name].kind in skip_kinds:
            continue
        firings[name] = firings_of(name)
        measured = measured_of(name)
        if measured is None:
            continue            # too few firings to call steady state
        nr = sel.replicas(name)
        impl = sel.impl_of(stg, name)
        rep.stages[name] = StageMeasurement(
            stage=name, analytic_v=impl.ii / nr, measured_v=measured,
            replicas=nr, utilization=util_of(name), host_v=host_of(name),
            stall_v=stall_of(name), starve_v=starve_of(name))
        # normalise to graph iterations for the app-level number
        v_iter = measured * q[name]
        if v_iter > worst_v:
            worst_v, worst_stage = v_iter, name
    if worst_stage is None:
        counts = ", ".join(f"{n}: {c}" for n, c in sorted(firings.items()))
        raise ValueError(
            f"no stage reached steady state (need >= 4 {err_noun} per "
            f"stage; got {counts}){err_hint(firings)}")
    rep.v_app_measured = worst_v
    rep.bottleneck_measured = worst_stage
    return rep


def compare(stg: STG, sel: Selection, run: PipelineRun,
            warmup_frac: float = 0.25) -> PipelineReport:
    """Per-stage measured-vs-analytic report for one interpreter run.

    ``stg``/``sel`` are the *logical* graph and selection the plan was made
    for; ``run`` is the executor's result on the materialised graph.
    """
    def measured_of(name: str) -> float | None:
        try:
            return run.stage_inverse_throughput(name, warmup_frac)
        except (ValueError, KeyError):
            return None

    def firings_of(name: str) -> int:
        workers = run.replica_map.get(name, [name])
        return sum(len(run.fire_times.get(w, ())) for w in workers)

    def util_of(name: str) -> float:
        workers = run.replica_map.get(name, [name])
        return (sum(run.utilization(w) for w in workers) / len(workers)
                if workers else 0.0)

    def hint(firings: dict) -> str:
        shortfall = max(4 - c for c in firings.values()) if firings else 4
        return (f" — stream at least {shortfall} more iteration(s) of "
                f"tokens before measuring")

    def wait_of(name: str, reasons: tuple) -> float | None:
        # traced runs only: sum the stage's replicas' blocked cycles
        if not run.wait_cycles:
            return None
        workers = run.replica_map.get(name, [name])
        return sum(run.wait_cycles.get(w, {}).get(r, 0.0)
                   for w in workers for r in reasons)

    return _build_report(
        stg, sel, measured_of=measured_of, firings_of=firings_of,
        util_of=util_of,
        stall_of=lambda n: wait_of(n, ("credit",)),
        starve_of=lambda n: wait_of(n, ("starve", "reorder")),
        fifo_stalls=run.channels.total_stalls() if run.channels else 0,
        oversubscription=(run.placement.oversubscription
                          if run.placement else 1.0),
        err_noun="firings", err_hint=hint)


def compare_lm(stg: STG, sel: Selection, res,
               stage_map: dict[str, str] | None = None) -> PipelineReport:
    """Per-stage measured-vs-analytic report for one pipelined run.

    ``res`` is a `decode.ServeRunResult` (a serve) or a
    `lm_pipe.LMPipelineResult` (a microbatch run); measured inverse throughput
    comes from each stage's completion-event stream (replicas dispatch
    concurrently under the overlapped executor, so a replicated stage
    reads its effective ii/nr).
    Analytic v is the plan's roofline ii/nr in µs — absolute magnitudes
    differ from host wall-clock by the hardware gap, but the *relative*
    per-stage ratios are exactly what
    ``planner.replan(measured_ratio=report.ratios())`` consumes.
    ``stage_map`` maps graph node -> executed stage name when a stage
    owns several graph nodes (`DecodePipeline.graph_stage_map`,
    `LMPipeline.graph_stage_map`);
    identity by default.
    """
    def exec_name(name: str) -> str:
        return (stage_map or {}).get(name, name)

    def measured_of(name: str) -> float | None:
        if firings_of(name) < 4:
            return None
        v = res.stage_inverse_us(exec_name(name))
        return None if v != v else v            # nan: never fired

    def firings_of(name: str) -> int:
        return len(res.stage_done_s.get(exec_name(name), ()))

    def util_of_nr(name: str) -> float:
        busy = res.stage_seconds.get(exec_name(name), 0.0)
        nr = sel.replicas(name)
        return min(1.0, busy / (res.wall_s * nr)) if res.wall_s > 0 else 0.0

    def host_of(name: str) -> float | None:
        # host dispatch us/firing off the engine's per-op accounting
        # (`EngineResult.stage_host_us`); nan -> None (stage never fired)
        v = res.stage_host_us(exec_name(name))
        return None if v != v else v

    def wait_of(name: str, reasons: tuple) -> float | None:
        # traced runs only (`res.stage_wait_s` fills under a Tracer):
        # seconds the stage's sweep slot sat blocked, by reason
        waits = getattr(res, "stage_wait_s", None)
        if not waits:
            return None
        d = waits.get(exec_name(name), {})
        return sum(d.get(r, 0.0) for r in reasons)

    rep = _build_report(
        stg, sel, measured_of=measured_of, firings_of=firings_of,
        util_of=util_of_nr, host_of=host_of,
        stall_of=lambda n: wait_of(n, ("credit",)),
        starve_of=lambda n: wait_of(n, ("starve", "reorder")),
        fifo_stalls=sum(s.producer_stalls for s in res.fifo_stats.values()),
        oversubscription=(res.placement.oversubscription
                          if res.placement else 1.0),
        skip_kinds=(SOURCE, SINK),
        err_noun="completions",
        err_hint=lambda _: " — serve more tokens before measuring")
    slo_fn = getattr(res, "slo", None)      # serve runs carry client SLOs
    if callable(slo_fn):
        rep.slo = slo_fn()
    return rep


def measured_bubble(run) -> float:
    """Measured pipeline-bubble fraction of one executed run: the idle
    share of the run's total stage-time budget,

        1 - sum(per-stage busy) / (n_stages * makespan)

    Works on either clock domain's result — an `engine.EngineResult` (or
    a backend result aliasing its fields: busy = ``stage_seconds``,
    makespan = ``wall_s``) or an `engine.EventLoopStats` (busy =
    ``busy_cycles``, makespan = ``cycles``) — and lines up against the
    analytic `schedule.fill_drain_bubble` / `schedule.interleaved_bubble`
    ceilings.  Wall-clock values on oversubscribed pools mix bubble with
    time-sharing; the virtual-clock domain (`schedule.simulate_schedule`)
    measures the schedule's own dynamics cleanly."""
    if hasattr(run, "busy_cycles"):               # EventLoopStats
        busy, span, n = (sum(run.busy_cycles.values()), run.cycles,
                         len(run.busy_cycles))
    else:                                         # EngineResult-shaped
        busy, span, n = (sum(run.stage_seconds.values()), run.wall_s,
                         len(run.stage_seconds))
    if span <= 0 or n == 0:
        return float("nan")
    return 1.0 - busy / (n * span)


def calibrate(stg: STG, ratios: dict[str, float],
              floor: float = 0.05) -> STG:
    """A copy of ``stg`` whose implementation IIs are scaled per node by the
    measured/analytic ratio — the graph the re-planner should solve."""
    g = STG()
    for name, node in stg.nodes.items():
        impls = scale_impls(node.impls, ratios.get(name, 1.0), floor)
        g.add_node(Node(name=name, impls=impls, in_rates=node.in_rates,
                        out_rates=node.out_rates, kind=node.kind,
                        fn=node.fn, init_state=node.init_state))
    for ch in stg.channels:
        g.add_channel(ch)
    return g


def measured_replan(stg: STG, report: PipelineReport, *,
                    v_tgt: float | None = None,
                    area_budget: float | None = None,
                    fj: ForkJoinModel = LITERAL, engine: str = "heuristic"):
    """Re-solve the trade-off on the measurement-calibrated graph.

    Exactly one of ``v_tgt`` (min-area mode) / ``area_budget``
    (max-throughput mode).  Returns the engine's TradeoffResult whose
    selection reflects *measured* stage behaviour — e.g. a stage that ran
    2x slower than modelled gets proportionally more replicas.
    """
    if (v_tgt is None) == (area_budget is None):
        raise ValueError("pass exactly one of v_tgt= / area_budget=")
    eng = {"ilp": ilp, "heuristic": heuristic}[engine]
    # sources/sinks fire at the app rate, not their (pseudo, ~0-II) impl
    # rate — their measured/analytic ratio is meaningless noise, drop it
    ratios = {n: r for n, r in report.ratios().items()
              if stg.nodes[n].kind not in (SOURCE, SINK)}
    g = calibrate(stg, ratios)
    if v_tgt is not None:
        return eng.min_area(g, v_tgt, fj)
    return eng.max_throughput(g, area_budget, fj)


# ===========================================================================
# measured-replan convergence loop
# ===========================================================================
@dataclass
class FixedPointStep:
    iteration: int
    selection: dict                 # node -> (impl, nr) at this step
    scale: dict[str, float]         # cumulative calibration applied
    measured: dict[str, float]      # ratios the run reported (vs original)
    residual: float                 # max |log(measured / scale)| this step
    total_area: float
    v_app: float


@dataclass
class FixedPointResult:
    result: object                  # the final engine TradeoffResult
    iterations: int
    converged: bool
    oscillated: bool                # a selection cycle was detected
    scale: dict[str, float]         # final per-node calibration
    history: list[FixedPointStep] = field(default_factory=list)

    @property
    def selection(self) -> Selection:
        return self.result.selection


def replan_to_fixed_point(stg: STG, run_fn, *,
                          v_tgt: float | None = None,
                          area_budget: float | None = None,
                          fj: ForkJoinModel = LITERAL,
                          engine: str = "heuristic",
                          max_iters: int = 10, damping: float = 0.5,
                          damping_floor: float = 0.1) -> FixedPointResult:
    """Iterate plan -> run -> measure -> replan to a fixed point.

    ``measured_replan`` is one feedback step; this is the loop.  Each
    iteration solves the trade-off on the ``scale``-calibrated graph,
    executes the chosen selection via ``run_fn(selection) ->
    dict[node, measured/analytic ratio]`` (or a `PipelineReport`, whose
    ``ratios()`` is used; ratios are vs the ORIGINAL graph's analytic
    model), and folds the measurement into the calibration with
    *geometric damping*:

        scale <- scale^(1-a) * measured^a        (a = ``damping``)

    ``damping=1`` is the undamped jump straight to the measured ratio —
    which oscillates whenever the measured ratio is itself a function of
    the selection (a stage measured slow at nr=1 gains a replica, then
    measures fast, loses it again, forever); damping keeps the memory of
    earlier measurements, so the calibration settles inside the band
    where the solver's choice is stable.  The **oscillation guard**
    detects a repeated non-consecutive selection, halves the damping, and
    continues; if the cycle persists at ``damping_floor`` the loop stops
    and returns the best (lowest measured bottleneck-v) selection seen,
    flagged ``oscillated=True`` — never an infinite loop.

    Converged when the solver returns the same selection twice in a row —
    the fixed point of the plan -> run -> replan map is a *plan* the
    re-solve reproduces (per-node log-residuals are recorded in
    ``history`` for anyone polishing the calibration further).
    """
    if (v_tgt is None) == (area_budget is None):
        raise ValueError("pass exactly one of v_tgt= / area_budget=")
    eng = {"ilp": ilp, "heuristic": heuristic}[engine]

    def solve(g):
        return (eng.min_area(g, v_tgt, fj) if v_tgt is not None
                else eng.max_throughput(g, area_budget, fj))

    scale = {n: 1.0 for n in stg.nodes}
    alpha = min(1.0, max(damping, 0.0))
    history: list[FixedPointStep] = []
    seen: dict[tuple, int] = {}            # selection key -> iteration
    prev_key = None
    best = None                            # (v_app, result, scale snapshot)
    res = None
    converged = oscillated = False

    for it in range(max_iters):
        res = solve(calibrate(stg, scale))
        key = tuple(sorted(res.selection.choices.items()))
        measured = run_fn(res.selection)
        if hasattr(measured, "ratios"):
            measured = measured.ratios()
        measured = {n: r for n, r in measured.items()
                    if stg.nodes[n].kind not in (SOURCE, SINK)}
        residual = max((abs(math.log(max(r, 1e-9) / scale[n]))
                        for n, r in measured.items()), default=0.0)
        history.append(FixedPointStep(
            iteration=it, selection=dict(res.selection.choices),
            scale=dict(scale), measured=dict(measured), residual=residual,
            total_area=res.total_area, v_app=res.v_app))
        if best is None or res.v_app < best[0]:
            best = (res.v_app, res, dict(scale))
        if key == prev_key:
            converged = True
            break
        if key in seen:
            # revisited an earlier selection (an adjacent repeat already
            # returned converged above): we are cycling.  Damp harder;
            # below the floor, stop with the best seen.
            oscillated = True
            alpha = alpha / 2
            if alpha < damping_floor:
                _, res, scale = best
                break
        seen[key] = it
        prev_key = key
        for n, r in measured.items():
            scale[n] = scale[n] ** (1 - alpha) * max(r, 1e-9) ** alpha
    return FixedPointResult(result=res, iterations=len(history),
                            converged=converged, oscillated=oscillated,
                            scale=scale, history=history)
