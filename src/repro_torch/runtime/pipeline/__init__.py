"""Spatial streaming executor: run planned STGs as real pipelines.

The port of ``repro/runtime/pipeline`` for serving:

  placement   — partition the device set (or the ranks of a
                `launch.mesh.RankPool`) into per-stage slices sized
                tp x replicas (in one process every slice is its device)
  remote      — pipelines over ranks, a process a device: the
                controller's commands, the workers' reports, the tensors
                sent from rank to rank (`Controller`, `Worker`)
  channels    — bounded FIFOs with backpressure; capacity bounds in-flight
                work; `StreamChannel` adds open-ended token streams
                (decode feedback traffic)
  engine      — the executor core: ONE `Program` protocol (op streams
                with ready/dispatch/retire semantics) and two drivers of
                it — the wall-clock asynchronous scheduler (`Engine`) and
                the virtual-clock discrete-event loop (`run_event_loop`)
                — owning FIFO credits, reorder buffers, replica busy
                budgets, completion timing and deadlock diagnostics;
                `DeviceWatch` is an op's CUDA event
  schedule    — schedules as first-class plan objects (`Schedule` /
                `SchedOp`): `fill_drain`, `one_f_one_b`,
                `interleaved_1f1b(p, m, v)` with analytic bubble models,
                plus `simulate_schedule` — the schedule executed as data
                under the virtual-clock driver
  interpreter — `execute`: any functional STG (the paper's JPEG, n-body
                and StreamIt graphs) materialised, placed and streamed on
                the host under the virtual clock
  aot         — warm-up accounting: each stage program run once per
                shape before a timed serve, first calls inside it counted
  lm_pipe     — `LMPipeline`: the microbatch pipeline over the planner's
                LM stages (1F1B, interleaved 1F1B and fill-drain
                schedules, fused stages, replica round-robin, gradients
                folded in microbatch order), one CUDA stream a stage
                shared by its replicas and a lane thread per (stage,
                replica); the port of ``jax_pipe``
  decode      — `DecodePipeline`: prefill/decode serving with per-stage
                KV/SSM-cache residency, a CUDA stream per (stage,
                replica) and a token feedback stream; replica failover
                with cache replay, migration, admission pause and
                `resume`
  health      — `HealthController`: straggler detection driving
                migration and re-plan advice
  measure     — measured vs analytic stage throughput of an
                interpreter run (`compare`) or a serve (`compare_lm`),
                the calibrated re-solve (`measured_replan`) and its loop
                to a fixed point (`replan_to_fixed_point`)
  trace, metrics — the typed event stream of a traced serve and the
                metrics read from it (`serving_slo`)
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


from .aot import AotProgram, CompileStats  # noqa: E402
from .channels import ChannelSet, Fifo, FifoStats, StreamChannel  # noqa: E402
from .engine import (AsyncResult, DeviceWatch, Driver, Engine,  # noqa: E402
                     EngineResult, EventLoop, EventLoopStats, Op, Program,
                     StageProgram, run_event_loop, steady_inverse)
from .schedule import (SchedOp, Schedule, ScheduleProgram,  # noqa: E402
                       ScheduleRun, fill_drain, fill_drain_bubble,
                       interleaved_1f1b, interleaved_bubble,
                       max_live_activations, max_live_by_chunk, one_f_one_b,
                       schedule_programs, simulate_schedule)
from .interpreter import PipelineRun, execute, execute_materialized  # noqa: E402
from .lm_pipe import (LMPipeline, LMPipelineResult, LMStage,  # noqa: E402
                      build_lm_stages, selection_from_plan)
from .decode import DecodePipeline, ResumeState, ServeRunResult  # noqa: E402
from .health import HealthController  # noqa: E402
from .measure import (FixedPointResult, PipelineReport,  # noqa: E402
                      StageMeasurement, calibrate, compare, compare_lm,
                      measured_bubble, measured_replan, replan_to_fixed_point)
from .placement import Placement, StageSlice, place, tp_of  # noqa: E402
from .remote import Controller, RankFailure, Ref, Worker  # noqa: E402
from .trace import FifoWatch, TraceEvent, Tracer  # noqa: E402
from .metrics import (BlameEntry, Counter, Gauge, Histogram,  # noqa: E402
                      MetricsRegistry, attribute_bottleneck,
                      registry_from_trace, serving_slo, stall_bottleneck)
from ..straggler import StragglerReport, detect_replica_stragglers  # noqa: E402
from ..failures import (FailureInjector, PipelineFailure, ReplicaFault,  # noqa: E402
                        ReplicaFaultPlan, ReplicaFaultSpec)

__all__ = [
    "as_selection", "selection_from_plan",
    "AotProgram", "CompileStats",
    "ChannelSet", "Fifo", "FifoStats", "StreamChannel",
    "AsyncResult", "DeviceWatch", "Driver", "Engine", "EngineResult",
    "EventLoop", "EventLoopStats", "Op", "Program", "StageProgram",
    "run_event_loop", "steady_inverse",
    "SchedOp", "Schedule", "ScheduleProgram", "ScheduleRun",
    "fill_drain", "fill_drain_bubble", "interleaved_1f1b",
    "interleaved_bubble", "max_live_activations", "max_live_by_chunk",
    "one_f_one_b", "schedule_programs", "simulate_schedule",
    "PipelineRun", "execute", "execute_materialized",
    "LMPipeline", "LMPipelineResult", "LMStage", "build_lm_stages",
    "DecodePipeline", "ResumeState", "ServeRunResult", "HealthController",
    "FixedPointResult", "PipelineReport", "StageMeasurement", "calibrate",
    "compare", "compare_lm", "measured_bubble", "measured_replan",
    "replan_to_fixed_point",
    "Placement", "StageSlice", "place", "tp_of",
    "Controller", "RankFailure", "Ref", "Worker",
    "FifoWatch", "TraceEvent", "Tracer",
    "BlameEntry", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "attribute_bottleneck", "registry_from_trace", "serving_slo",
    "stall_bottleneck",
    "StragglerReport", "detect_replica_stragglers",
    "FailureInjector", "PipelineFailure", "ReplicaFault",
    "ReplicaFaultPlan", "ReplicaFaultSpec",
]
