"""Measurement layer: measured vs analytic throughput, and replan feedback.

Ported from the wall-clock half of ``repro/runtime/pipeline/measure.py``.
It closes the paper's loop: the solver promises an application inverse
throughput (Eq. 1/5/6 via `core/throughput.analyze`); a pipelined serve
measures what the pipeline actually sustains — per-stage streams of
completion times whose steady-state gap is the stage's effective inverse
throughput (ii/nr for replicated stages).  `_build_report` lines the
measured values up against the analytic model and `compare_lm` adapts a
`decode.ServeRunResult` to it.

``calibrate()`` scales each node's implementation library by its
measured/analytic ratio, and ``measured_replan()`` re-runs the solver
once on the calibrated graph.  Not ported (``ROADMAP.md``): ``compare``
over the host interpreter's virtual-clock runs and the iterated
``replan_to_fixed_point``, which need ``interpreter.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable

from ...core import heuristic, ilp
from ...core.fork_join import LITERAL, ForkJoinModel
from ...core.stg import SINK, SOURCE, STG, Node, Selection, scale_impls
from ...core.throughput import analyze


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


def compare_lm(stg: STG, sel: Selection, res,
               stage_map: dict[str, str] | None = None) -> PipelineReport:
    """Per-stage measured-vs-analytic report for one pipelined serve.

    ``res`` is a `decode.ServeRunResult`; measured inverse throughput
    comes from each stage's completion-event stream (replicas dispatch
    concurrently under the overlapped executor, so a replicated stage
    reads its effective ii/nr).
    Analytic v is the plan's roofline ii/nr in µs — absolute magnitudes
    differ from host wall-clock by the hardware gap, but the *relative*
    per-stage ratios are exactly what
    ``planner.replan(measured_ratio=report.ratios())`` consumes.
    ``stage_map`` maps graph node -> executed stage name when a stage
    owns several graph nodes (`DecodePipeline.graph_stage_map`);
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

    over an `engine.EngineResult` (or a `ServeRunResult`): busy =
    ``stage_seconds``, makespan = ``wall_s``.  Wall-clock values on an
    oversubscribed pool (every slice on one card) mix bubble with
    time-sharing."""
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
