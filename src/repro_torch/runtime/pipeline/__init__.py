"""Spatial streaming executor: run planned STGs as real pipelines.

The port of ``repro/runtime/pipeline`` for serving:

  placement   — partition the device set into per-stage slices sized
                tp x replicas (on one card every slice is the card)
  channels    — bounded FIFOs with backpressure; capacity bounds in-flight
                work; `StreamChannel` adds open-ended token streams
                (decode feedback traffic)
  engine      — the executor core: the `Program` protocol (op streams
                with ready/dispatch/retire semantics) and its wall-clock
                asynchronous driver (`Engine`), owning FIFO credits,
                reorder buffers, replica busy budgets, completion timing
                and deadlock diagnostics; `DeviceWatch` is an op's CUDA
                event
  aot         — warm-up accounting: each stage program run once per
                shape before a timed serve, first calls inside it counted
  decode      — `DecodePipeline`: prefill/decode serving with per-stage
                KV/SSM-cache residency, a CUDA stream per (stage,
                replica) and a token feedback stream; replica failover
                with cache replay, migration, admission pause and
                `resume`
  health      — `HealthController`: straggler detection driving
                migration and re-plan advice
  measure     — measured vs analytic stage throughput of a serve
                (`compare_lm`) and the calibrated re-solve
                (`measured_replan`)
  trace, metrics — the typed event stream of a traced serve and the
                metrics read from it (`serving_slo`)

Not ported yet: the training backends (``interpreter``, ``schedule``,
``jax_pipe``) and what needs them (`measure.compare`,
`measure.replan_to_fixed_point`, the virtual-clock ``EventLoop``).
"""


def as_selection(plan):
    """The one plan -> executable-Selection materialisation rule.

    Accepts a `core.stg.Selection` (passed through), a solver
    ``TradeoffResult`` (its ``.selection``), or a planner ``PlanResult``
    (per-stage (impl, replicas) choices).
    """
    from ...core.stg import Selection
    if isinstance(plan, Selection):
        return plan
    if hasattr(plan, "selection"):          # TradeoffResult
        return plan.selection
    sel = Selection()
    for sp in plan.stages:                  # PlanResult
        sel.set(sp.name, sp.impl, sp.replicas)
    return sel


def selection_from_plan(plan):
    """PlanResult -> Selection over the lm_graph node names (the same
    rule as `as_selection`)."""
    return as_selection(plan)


from .aot import AotProgram, CompileStats  # noqa: E402
from .channels import Fifo, FifoStats, StreamChannel  # noqa: E402
from .engine import (AsyncResult, DeviceWatch, Driver, Engine,  # noqa: E402
                     EngineResult, Op, Program, StageProgram, steady_inverse)
from .decode import DecodePipeline, ResumeState, ServeRunResult  # noqa: E402
from .health import HealthController  # noqa: E402
from .measure import (PipelineReport, StageMeasurement, calibrate,  # noqa: E402
                      compare_lm, measured_bubble, measured_replan)
from .placement import Placement, StageSlice, place, tp_of  # noqa: E402
from .trace import FifoWatch, TraceEvent, Tracer  # noqa: E402
from .metrics import (BlameEntry, Counter, Gauge, Histogram,  # noqa: E402
                      MetricsRegistry, attribute_bottleneck,
                      registry_from_trace, serving_slo, stall_bottleneck)
from ..failures import (FailureInjector, PipelineFailure, ReplicaFault,  # noqa: E402
                        ReplicaFaultPlan, ReplicaFaultSpec)

__all__ = [
    "as_selection", "selection_from_plan",
    "AotProgram", "CompileStats",
    "Fifo", "FifoStats", "StreamChannel",
    "AsyncResult", "DeviceWatch", "Driver", "Engine", "EngineResult", "Op",
    "Program", "StageProgram", "steady_inverse",
    "DecodePipeline", "ResumeState", "ServeRunResult", "HealthController",
    "PipelineReport", "StageMeasurement", "calibrate", "compare_lm",
    "measured_bubble", "measured_replan",
    "Placement", "StageSlice", "place", "tp_of",
    "FifoWatch", "TraceEvent", "Tracer",
    "BlameEntry", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "attribute_bottleneck", "registry_from_trace", "serving_slo",
    "stall_bottleneck",
    "FailureInjector", "PipelineFailure", "ReplicaFault",
    "ReplicaFaultPlan", "ReplicaFaultSpec",
]
