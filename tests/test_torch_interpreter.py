"""The port's virtual-clock path against the JAX package, on the CPU.

The host interpreter (`runtime.pipeline.interpreter`), the schedules as
data (`runtime.pipeline.schedule`), the virtual-clock driver
(`engine.run_event_loop`), the interpreter half of the measurement layer
(`measure.compare`, `replan_to_fixed_point`) and the schedule and graph
half of the static verifier (`core.verify`) are plain Python, so the JAX
package is the oracle bit for bit:

  * `execute` gives bitwise-equal sink streams and identical firing
    times, firing counts, cycle and busy counts (and the sink streams
    equal `simulate.run_functional`'s and the references');
  * the schedules' op lists, live bounds and bubble models are equal, and
    `simulate_schedule` gives identical makespans, busy cycles and traces;
  * `verify_*` findings are equal (level, check, subject, message,
    minimum viable capacity);
  * the port's two drivers, the wall-clock `Engine` and
    `run_event_loop`, emit identical per-track event sequences for the
    same `ScheduleProgram`s, as ``tests/test_trace.py`` holds the JAX
    package's.

The cases are those of ``tests/test_pipeline.py`` (interpreter, schedule
and measure), ``test_schedule.py``, ``test_verify.py`` (schedules and
graphs) and ``test_trace.py``.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.fork_join as j_fork_join
import repro.core.heuristic as j_heuristic
import repro.core.restructure as j_restructure
import repro.core.simulate as j_simulate
import repro.core.stg as j_stg
import repro.core.verify as j_verify
import repro.graphs.jpeg as j_jpeg
import repro.graphs.nbody as j_nbody
import repro.graphs.streamit as j_streamit
import repro.runtime.pipeline.channels as j_channels
import repro.runtime.pipeline.engine as j_engine
import repro.runtime.pipeline.interpreter as j_interpreter
import repro.runtime.pipeline.measure as j_measure
import repro.runtime.pipeline.schedule as j_schedule
import repro.runtime.pipeline.trace as j_trace
from repro_torch.core import fork_join, heuristic, restructure, simulate, stg, verify
from repro_torch.core.throughput import analyze
from repro_torch.graphs import jpeg, nbody, streamit
from repro_torch.runtime.pipeline import (Engine, SchedOp, Schedule, as_selection, channels,
                                          compare, engine, execute, fill_drain,
                                          fill_drain_bubble, interleaved_1f1b,
                                          interleaved_bubble, interpreter, max_live_activations,
                                          max_live_by_chunk, measure, measured_bubble,
                                          measured_replan, one_f_one_b, replan_to_fixed_point,
                                          run_event_loop, schedule, schedule_programs,
                                          simulate_schedule, trace)
from test_torch_stg import same

JAX = SimpleNamespace(stg=j_stg, fj=j_fork_join, heuristic=j_heuristic, simulate=j_simulate,
                      restructure=j_restructure, verify=j_verify, jpeg=j_jpeg, nbody=j_nbody,
                      streamit=j_streamit, channels=j_channels, engine=j_engine,
                      interpreter=j_interpreter, measure=j_measure, schedule=j_schedule,
                      trace=j_trace)
PORT = SimpleNamespace(stg=stg, fj=fork_join, heuristic=heuristic, simulate=simulate,
                       restructure=restructure, verify=verify, jpeg=jpeg, nbody=nbody,
                       streamit=streamit, channels=channels, engine=engine,
                       interpreter=interpreter, measure=measure, schedule=schedule, trace=trace)

N_BLOCKS = 192


def both(fn):
    """``fn`` on the JAX package and on the port: (jax's, port's)."""
    return fn(JAX), fn(PORT)


def assert_same_run(got, want):
    """Two `PipelineRun`s: bitwise-equal streams, identical timing."""
    assert set(got.outputs) == set(want.outputs)
    for k in want.outputs:
        assert same(got.outputs[k], want.outputs[k]), k
    for field in ("fire_times", "fired", "cycles", "busy_cycles", "replica_map"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.channels.occupancy() == want.channels.occupancy()
    assert got.channels.total_stalls() == want.channels.total_stalls()


def findings(report) -> list:
    return [(f.level, f.check, f.subject, f.message, f.min_viable) for f in report.findings]


def _selection(P, g, which, v_tgt=8, fj=None):
    fj = fj or P.fj.JPEG_CALIBRATED
    if which == "fastest":
        return P.stg.Selection.fastest(g)
    if which == "smallest":
        return P.stg.Selection.smallest(g)
    return P.heuristic.min_area(g, v_tgt, fj).selection


# ===========================================================================
# the interpreter (tests/test_pipeline.py)
# ===========================================================================
@pytest.mark.parametrize("which", ["fastest", "smallest", "solver"])
def test_jpeg_streams_and_timing_equal_jax(which):
    def go(P):
        g = P.jpeg.build_stg()
        sel = _selection(P, g, which)
        blocks = P.jpeg.random_blocks(N_BLOCKS)
        run = P.interpreter.execute(g, sel, {"camera": blocks}, fj=P.fj.JPEG_CALIBRATED)
        ref = P.simulate.run_functional(g, sel, {"camera": blocks})["bitstream"]
        return g, sel, run, ref, P.jpeg.reference_pipeline(blocks)
    (_, _, want, _, _), (g, sel, got, ref, pipeline) = both(go)
    assert same(got.outputs["bitstream"], ref) and same(ref, pipeline)
    assert_same_run(got, want)
    rep = compare(g, sel, got)
    assert rep.v_app_measured == pytest.approx(analyze(g, sel).v_app, rel=0.15)
    assert rep.bottleneck_measured in rep.stages
    assert rep.stages[rep.bottleneck_measured].ratio == pytest.approx(1.0, rel=0.15)


@pytest.mark.parametrize("build,n_in", [("fft", 8), ("filterbank", 16), ("autocor", 16)])
def test_streamit_streams_and_throughput(build, n_in):
    def go(P):
        g = getattr(P.streamit, f"build_{build}")()
        rng = np.random.default_rng(3)
        blocks = [rng.normal(size=n_in) for _ in range(96)]
        out = {}
        for which in ("fastest", "smallest", "solver"):
            sel = _selection(P, g, which, v_tgt=4, fj=P.fj.LITERAL)
            out[which] = (sel, P.simulate.run_functional(g, sel, {"src": blocks})["out"],
                          P.interpreter.execute(g, sel, {"src": blocks}, fj=P.fj.LITERAL))
        return g, out
    (_, want), (g, got) = both(go)
    for which, (sel, ref, run) in got.items():
        assert same(run.outputs["out"], ref), which
        assert_same_run(run, want[which][2])
        rep = compare(g, sel, run)
        assert rep.v_app_measured == pytest.approx(analyze(g, sel).v_app, rel=0.15), which


def _chain(P, names, ii):
    g = P.stg.STG()
    g.add_node(P.stg.Node("src", impls=(P.stg.Impl("s", 0, 1e-9),), kind="source"))
    prev = "src"
    for n in names:
        g.add_node(P.stg.unit_rate_node(n, [P.stg.Impl("v1", 1, ii)],
                                        fn=lambda ins, st: ([[ins[0][0]]], st)))
        g.connect(prev, n)
        prev = n
    g.add_node(P.stg.Node("out", impls=(P.stg.Impl("t", 0, 1e-9),), kind="sink"))
    g.connect(prev, "out")
    return g


def test_replicated_chain_reaches_divided_throughput():
    def go(P):
        g = _chain(P, ["slow"], 8.0)
        sel = P.stg.Selection.fastest(g).set("slow", "v1", 4)
        return P.interpreter.execute(g, sel, {"src": list(range(256))}, fj=P.fj.LITERAL)
    want, got = both(go)
    assert got.outputs["out"] == list(range(256))
    assert got.stage_inverse_throughput("slow") == pytest.approx(2.0, rel=0.15)
    assert_same_run(got, want)


def test_oversubscription_slows_pipeline_honestly():
    def go(P):
        g = _chain(P, ["a", "b"], 4.0)
        sel = P.stg.Selection.fastest(g)
        return (P.interpreter.execute(g, sel, {"src": list(range(64))}, fj=P.fj.LITERAL),
                P.interpreter.execute(g, sel, {"src": list(range(64))}, devices=1,
                                      fj=P.fj.LITERAL))
    (w_spatial, w_folded), (spatial, folded) = both(go)
    assert spatial.inverse_throughput("out") == pytest.approx(4.0, rel=0.15)
    assert folded.inverse_throughput("out") == pytest.approx(8.0, rel=0.15)
    assert folded.placement.oversubscription > 1.0
    assert folded.placement.oversubscription == w_folded.placement.oversubscription
    assert_same_run(spatial, w_spatial)
    assert_same_run(folded, w_folded)


def test_multirate_producer_burst_fits_fifo():
    def go(P):
        g = P.stg.STG()
        g.add_node(P.stg.Node("src", impls=(P.stg.Impl("s", 0, 1e-9),), kind="source"))
        g.add_node(P.stg.Node("mid", impls=(P.stg.Impl("v1", 1, 3.0),), in_rates=(1,),
                              out_rates=(3,), fn=lambda ins, st: (
                                  [[ins[0][0], ins[0][0] + 1, ins[0][0] + 2]], st)))
        g.add_node(P.stg.Node("out", impls=(P.stg.Impl("t", 0, 1e-9),), kind="sink"))
        g.connect("src", "mid")
        g.connect("mid", "out")
        sel = P.stg.Selection.fastest(g)
        inputs = {"src": [10 * k for k in range(24)]}
        return (P.interpreter.execute(g, sel, inputs, fj=P.fj.LITERAL),
                P.simulate.run_functional(g, sel, inputs)["out"])
    (want, _), (got, ref) = both(go)
    assert got.outputs["out"] == ref
    assert got.fired["mid"] == 24
    assert_same_run(got, want)


def test_interpreter_traces_equal_jax():
    """A traced run emits the JAX package's typed event stream (op spans in
    cycles, waits, fifo occupancy) and the same per-stage wait cycles."""
    def go(P):
        g = P.jpeg.build_stg()
        sel = _selection(P, g, "solver")
        tr = P.trace.Tracer()
        run = P.interpreter.execute(g, sel, {"camera": P.jpeg.random_blocks(48)},
                                    fj=P.fj.JPEG_CALIBRATED, tracer=tr)
        return run, tr.track_sequences()
    (want, w_seq), (got, seq) = both(go)
    assert_same_run(got, want)
    assert got.wait_cycles == want.wait_cycles and got.wait_cycles
    assert seq == w_seq


# ===========================================================================
# measurement -> replanning feedback (tests/test_pipeline.py)
# ===========================================================================
def _report_record(rep) -> dict:
    return json.loads(rep.to_json())


def test_compare_and_measured_replan_equal_jax():
    def go(P):
        g = P.jpeg.build_stg()
        sel = _selection(P, g, "solver")
        run = P.interpreter.execute(g, sel, {"camera": P.jpeg.random_blocks(N_BLOCKS)},
                                    fj=P.fj.JPEG_CALIBRATED)
        rep = P.measure.compare(g, sel, run)
        record = json.loads(rep.to_json())
        rep.stages["dct"].measured_v *= 4          # dct measured 4x slower than modelled
        res = P.measure.measured_replan(g, rep, v_tgt=8, fj=P.fj.JPEG_CALIBRATED)
        base = P.heuristic.min_area(g, 8, P.fj.JPEG_CALIBRATED)
        return record, res, base
    (w_rec, w_res, _), (rec, res, base) = both(go)
    assert rec == w_rec
    assert 0.8 < rec["accuracy"] < 1.2
    assert res.feasible
    assert res.selection.choices == w_res.selection.choices
    assert res.total_area == w_res.total_area
    assert res.selection.choices["dct"] != base.selection.choices["dct"] or \
        res.total_area > base.total_area
    assert measured_replan is measure.measured_replan


def test_compare_error_names_underfired_stages():
    g = jpeg.build_stg()
    sel = stg.Selection.fastest(g)
    run = execute(g, sel, {"camera": jpeg.random_blocks(2)}, fj=fork_join.JPEG_CALIBRATED)
    with pytest.raises(ValueError, match=r"dct: 2") as ei:
        compare(g, sel, run)
    assert "need >= 4 firings" in str(ei.value)


def _fixed_point_graph(P):
    g = P.stg.STG()
    g.add_node(P.stg.Node("src", impls=(P.stg.Impl("s", 0, 1e-9),), kind="source"))
    g.add_node(P.stg.unit_rate_node("a", [P.stg.Impl("v1", 1, 3.0)]))
    g.add_node(P.stg.unit_rate_node("b", [P.stg.Impl("v1", 1, 1.0)]))
    g.add_node(P.stg.Node("out", impls=(P.stg.Impl("t", 0, 1e-9),), kind="sink"))
    g.connect("src", "a")
    g.connect("a", "b")
    g.connect("b", "out")
    return g


def _flappy_run_fn(sel):
    """Stage ``a`` measures slow single-replica and fast replicated: the
    undamped loop flips its replica count forever."""
    return {"a": 2.0 if sel.replicas("a") == 1 else 1.25, "b": 1.0}


def _history(res) -> list:
    return [(h.iteration, h.selection, h.scale, h.measured, h.residual, h.total_area,
             h.v_app) for h in res.history]


@pytest.mark.parametrize("damping", [1.0, 0.5])
def test_replan_to_fixed_point_equal_jax(damping):
    want, got = both(lambda P: P.measure.replan_to_fixed_point(
        _fixed_point_graph(P), _flappy_run_fn, v_tgt=3.9, fj=P.fj.LITERAL, damping=damping,
        max_iters=10))
    assert (got.iterations, got.converged, got.oscillated, got.scale) == \
        (want.iterations, want.converged, want.oscillated, want.scale)
    assert _history(got) == _history(want)
    if damping == 1.0:
        assert got.oscillated and got.iterations <= 10
        assert [h.selection["a"][1] for h in got.history[:3]] == [1, 2, 1]
    else:
        assert got.converged and not got.oscillated
        assert got.selection.choices["a"][1] == 2 and got.iterations <= 4
        assert got.history[-1].residual >= 0


def test_replan_to_fixed_point_validates_modes():
    with pytest.raises(ValueError, match="exactly one"):
        replan_to_fixed_point(_fixed_point_graph(PORT), _flappy_run_fn, fj=fork_join.LITERAL)


def test_as_selection_accepts_a_tradeoff_result():
    g = _fixed_point_graph(PORT)
    sel = stg.Selection.fastest(g)
    assert as_selection(sel) is sel
    res = heuristic.min_area(g, 8, fork_join.LITERAL)
    assert as_selection(res) is res.selection


# ===========================================================================
# schedules (tests/test_schedule.py, tests/test_pipeline.py)
# ===========================================================================
def _schedule_record(s) -> tuple:
    return (s.name, s.n_stages, s.n_micro, s.n_chunks, s.trains,
            [list(map(tuple, ops)) for ops in s.stage_ops], list(s.live_bounds))


@settings(max_examples=40, deadline=None)
@given(p=st.integers(1, 6), mult=st.integers(1, 4), v=st.integers(1, 4))
def test_interleaved_invariants_and_equal_to_jax(p, mult, v):
    m = p * mult
    want, sched = both(lambda P: P.schedule.interleaved_1f1b(p, m, v))
    assert _schedule_record(sched) == _schedule_record(want)
    cover = sorted([(kind, mb, c) for kind in ("F", "B") for mb in range(m)
                    for c in range(sched.n_chunks)])
    per_stage: dict[int, list] = {}
    for s, op in sched.flatten():
        per_stage.setdefault(s, []).append(tuple(op))
    assert set(per_stage) == set(range(sched.n_stages))
    for s, ops in enumerate(sched):
        seen_f = set()
        for op in ops:
            if op.kind == "F":
                seen_f.add((op.mb, op.chunk))
            else:
                assert (op.mb, op.chunk) in seen_f
        live = max_live_activations(ops)
        assert live <= sched.live_bounds[s]
        if v > 1 and m > p:
            assert sched.live_bounds[s] <= min(m * v, (p - s - 1) * 2 + (v - 1) * p + 1)
        by_chunk = max_live_by_chunk(ops)
        assert set(by_chunk) == set(range(sched.n_chunks))
        assert live <= sum(by_chunk.values())
        assert sorted(per_stage[s]) == cover


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (2, 3), (4, 8), (6, 4)])
def test_one_f_one_b_invariants(n_stages, n_micro):
    want, sched = both(lambda P: P.schedule.one_f_one_b(n_stages, n_micro))
    assert _schedule_record(sched) == _schedule_record(want)
    for s, ops in enumerate(sched):
        assert sorted((op.kind, op.mb) for op in ops) == sorted(
            [("F", m) for m in range(n_micro)] + [("B", m) for m in range(n_micro)])
        assert max_live_activations(ops) <= min(n_stages - s, n_micro)
        assert max_live_activations(ops) <= sched.live_bounds[s]
    assert [(op.kind, op.mb) for op in sched[-1][:2]] == [("F", 0), ("B", 0)]


def test_fill_drain_is_streaming_order():
    sched = fill_drain(3, 2)
    assert sched.stage_ops == [[SchedOp("F", 0), SchedOp("F", 1)]] * 3
    assert not sched.trains
    assert _schedule_record(sched) == _schedule_record(j_schedule.fill_drain(3, 2))


def test_interleaved_requires_micro_multiple_of_stages():
    with pytest.raises(ValueError, match="multiple of"):
        interleaved_1f1b(4, 6, 2)
    assert interleaved_1f1b(4, 6, 1).stage_ops == one_f_one_b(4, 6).stage_ops


def test_shape_validation_is_shared():
    for bad in (lambda: one_f_one_b(0, 4), lambda: fill_drain(4, 0),
                lambda: interleaved_1f1b(4, 4, 0), lambda: interleaved_bubble(0, 4, 1),
                lambda: fill_drain_bubble(0, 4)):
        with pytest.raises(ValueError, match="bad schedule shape"):
            bad()


def test_validate_rejects_corrupt_schedules():
    good = one_f_one_b(2, 2)
    bad = Schedule("bad", 2, 2, 1, [[SchedOp("B", 0), SchedOp("F", 0), SchedOp("F", 1),
                                     SchedOp("B", 1)], good.stage_ops[1]], good.live_bounds)
    with pytest.raises(ValueError, match="before its F"):
        bad.validate()
    bad2 = Schedule("bad2", 2, 2, 1, [good.stage_ops[0][:-1], good.stage_ops[1]],
                    good.live_bounds)
    with pytest.raises(ValueError, match="cover"):
        bad2.validate()
    with pytest.raises(ValueError, match="live"):
        Schedule("bad3", 2, 2, 1, good.stage_ops, [1, 1]).validate()


def test_max_live_by_chunk_matches_plain_accounting():
    ops = one_f_one_b(4, 8).stage_ops[0]
    assert max_live_by_chunk(ops) == {0: max_live_activations(ops)}
    by_chunk = max_live_by_chunk(interleaved_1f1b(2, 4, 2).stage_ops[0])
    assert set(by_chunk) == {0, 1} and all(v >= 1 for v in by_chunk.values())


def test_bubble_models_equal_jax():
    assert fill_drain_bubble(1, 8) == 0.0
    assert fill_drain_bubble(4, 12) == pytest.approx(3 / 15)
    assert interleaved_bubble(4, 8, 1) == pytest.approx(3 / 11)
    assert interleaved_bubble(4, 8, 2) == pytest.approx(3 / 19)
    assert interleaved_bubble(1, 8, 4) == 0.0
    for v in (2, 3, 4):
        assert interleaved_bubble(4, 8, v) < interleaved_bubble(4, 8, v - 1)
    for p, m, v in ((4, 8, 1), (4, 8, 2), (3, 9, 3), (1, 4, 1)):
        assert interleaved_bubble(p, m, v) == j_schedule.interleaved_bubble(p, m, v)
        assert fill_drain_bubble(p, m) == j_schedule.fill_drain_bubble(p, m)


def _sim_record(run) -> tuple:
    return (run.makespan, run.busy, run.trace, run.stats.fire_times, run.stats.fired,
            run.stats.busy_cycles, run.stats.cycles, run.stats.total_fired, run.bubble)


@pytest.mark.parametrize("make,f_cost", [
    (lambda S: S.one_f_one_b(4, 8), 2.0), (lambda S: S.interleaved_1f1b(4, 8, 2), 1.0),
    (lambda S: S.fill_drain(3, 4), 1.0),
    (lambda S: S.one_f_one_b(3, 6), lambda s, op: 3.0 if s == 1 else 1.0)])
def test_simulate_schedule_equal_jax(make, f_cost):
    want, got = both(lambda P: P.schedule.simulate_schedule(make(P.schedule), f_cost=f_cost))
    assert _sim_record(got) == _sim_record(want)


def test_simulated_bubbles_match_analytic_and_interleaved_wins():
    p, m, v = 4, 8, 2
    plain = simulate_schedule(one_f_one_b(p, m), f_cost=float(v))
    ilv = simulate_schedule(interleaved_1f1b(p, m, v))
    assert plain.bubble == pytest.approx(interleaved_bubble(p, m, 1))
    assert ilv.bubble == pytest.approx(interleaved_bubble(p, m, v))
    assert ilv.bubble < plain.bubble
    assert measured_bubble(plain.stats) == pytest.approx(plain.bubble)


def test_simulate_schedule_raises_on_wedged_schedules():
    bad = Schedule("wedge", 2, 2, 1, [[SchedOp("F", 0), SchedOp("F", 1)],
                                      [SchedOp("F", 1), SchedOp("F", 0)]], [2, 2])
    with pytest.raises((RuntimeError, AssertionError)):
        simulate_schedule(bad, capacity_blocks=1)


def _trace_precedence_ok(trace, sched):
    p = sched.n_stages
    done = {(kind, mb, chunk * p + s): t1 for s, kind, mb, chunk, t0, t1 in trace}
    for s, kind, mb, chunk, t0, t1 in trace:
        i = chunk * p + s
        if kind == "F" and i > 0:
            assert t0 >= done[("F", mb, i - 1)] - 1e-9
        if kind == "B" and i < sched.n_model_stages - 1:
            assert t0 >= done[("B", mb, i + 1)] - 1e-9
    return True


@pytest.mark.parametrize("make", [lambda: one_f_one_b(3, 4), lambda: interleaved_1f1b(2, 4, 2),
                                  lambda: fill_drain(3, 4)])
def test_both_drivers_run_the_same_program(make):
    sched = make()
    vprogs, vtrace = schedule_programs(sched)
    vstats = run_event_loop({p.name: p for p in vprogs})
    assert all(p.pending() == 0 for p in vprogs)
    wprogs, wtrace = schedule_programs(sched)
    Engine(wprogs, overlap=False).run()
    assert all(p.pending() == 0 for p in wprogs)
    for tr in (vtrace, wtrace):
        assert len(tr) == len(sched.flatten())
        per_stage: dict[int, list] = {}
        for s, kind, mb, chunk, _, _ in tr:
            per_stage.setdefault(s, []).append(SchedOp(kind, mb, chunk))
        assert per_stage == {s: list(ops) for s, ops in enumerate(sched.stage_ops)}
        assert _trace_precedence_ok(tr, sched)
    assert {p.name: vstats.fired[p.name] for p in vprogs} == {p.name: len(p.ops) for p in wprogs}


def test_wall_engine_deadlock_names_schedule_position():
    bad = Schedule("stuck", 2, 2, 1, [[SchedOp("F", 0), SchedOp("F", 1)], []], [2, 0])
    progs, _ = schedule_programs(bad, capacity_blocks=1)
    with pytest.raises(RuntimeError, match=r"deadlock.*stage0: op 1/2 next=F\(mb=1,chunk=0\)"):
        Engine(progs, overlap=False).run()


@settings(max_examples=15, deadline=None)
@given(p=st.integers(1, 4), mult=st.integers(1, 3), train=st.booleans())
def test_wall_and_virtual_drivers_emit_identical_sequences(p, mult, train):
    """The one-event-model contract on the port (``tests/test_trace.py``):
    the same programs under the wall clock (serial `Engine`) and the
    virtual clock give the same per-(stage, replica) op sequences, and
    every edge moves the same number of tokens; the virtual clock's
    sequences also equal the JAX package's."""
    m = p * mult

    def run_driver(P, wall: bool):
        sched = P.schedule.one_f_one_b(p, m) if train else P.schedule.fill_drain(p, m)
        programs, _ = P.schedule.schedule_programs(sched)
        tr = P.trace.Tracer()
        for i, f in enumerate(programs[0].acts):
            tr.watch_fifo(f, f"act{i}")
        for i, f in enumerate(programs[0].grds):
            tr.watch_fifo(f, f"grd{i}")
        if wall:
            P.engine.Engine(programs, overlap=False, tracer=tr).run()
        else:
            P.engine.run_event_loop({pr.name: pr for pr in programs}, tracer=tr)
        assert all(pr.pending() == 0 for pr in programs)
        ops, fifo_counts = {}, {}
        for track, seq in tr.track_sequences().items():
            if track in tr.fifo_watch:
                counts = fifo_counts.setdefault(track, {})
                for ev in seq:
                    counts[ev[0]] = counts.get(ev[0], 0) + 1
            else:
                ops[track] = seq
        return ops, fifo_counts

    assert run_driver(PORT, wall=True) == run_driver(PORT, wall=False)
    assert run_driver(PORT, wall=False) == run_driver(JAX, wall=False)


# ===========================================================================
# the static verifier's schedule and graph half (tests/test_verify.py)
# ===========================================================================
GRAPHS = ["jpeg.build_stg", "streamit.build_fft", "streamit.build_filterbank",
          "streamit.build_autocor", "nbody.build_stg"]


def _build(P, path):
    mod, fn = path.split(".")
    return getattr(getattr(P, mod), fn)()


@pytest.mark.parametrize("build", GRAPHS)
def test_committed_graphs_accepted_as_jax(build):
    def go(P):
        g = _build(P, build)
        return [P.verify.verify_graph(g, P.stg.Selection.fastest(g), capacity_blocks=cb)
                for cb in (1, 2)]
    want, got = both(go)
    for rep, w in zip(got, want):
        assert rep.ok(), rep.render()
        assert findings(rep) == findings(w) and rep.checks == w.checks and rep.plan == w.plan


def test_invalid_graph_is_a_finding_not_a_crash():
    def go(P):
        g = P.stg.STG()
        g.add_node(P.stg.Node(name="a", impls=(P.stg.Impl("x", 1, 1),), out_rates=(2, 1)))
        g.add_node(P.stg.Node(name="b", impls=(P.stg.Impl("x", 1, 1),), in_rates=(3, 1)))
        g.connect("a", "b", src_port=0, dst_port=0)
        g.connect("a", "b", src_port=1, dst_port=1)
        return P.verify.verify_graph(g, P.stg.Selection.fastest(g))
    want, got = both(go)
    assert any(f.check == "graph.invalid" for f in got.errors()), got.render()
    assert findings(got) == findings(want)


def test_rate_changing_channel_floored_at_liveness_bound():
    def go(P):
        g = P.stg.STG()
        g.add_node(P.stg.Node(name="camera", impls=(P.stg.Impl("cam", 1.0, 1),),
                              out_rates=(6,)))
        g.add_node(P.stg.Node(name="dct", impls=(P.stg.Impl("dct", 1.0, 1),), in_rates=(4,)))
        g.connect("camera", "dct")
        cs = P.channels.ChannelSet.for_graph(g, capacity_blocks=1)
        return cs[g.channels[0].key()].capacity, P.verify.verify_graph(
            g, P.stg.Selection.fastest(g), capacity_blocks=1)
    (w_cap, w_rep), (cap, rep) = both(go)
    assert cap == w_cap >= verify.channel_liveness_floor(4, 6)
    assert not [f for f in rep.errors() if f.check.startswith("channel.")], rep.render()
    assert findings(rep) == findings(w_rep)


_SCHEDULES = [("fill_drain", (2, 4)), ("fill_drain", (4, 8)), ("one_f_one_b", (2, 4)),
              ("one_f_one_b", (4, 8)), ("interleaved_1f1b", (2, 4, 2))]


@pytest.mark.parametrize("make", _SCHEDULES)
@pytest.mark.parametrize("cb", [1, 2, 3])
def test_schedule_credits_equal_jax_and_decide_completion(make, cb):
    """Findings equal the JAX package's, and the port's verdict decides
    the virtual clock: accepted schedules complete, rejected ones wedge."""
    def go(P):
        sched = getattr(P.schedule, make[0])(*make[1])
        caps = [cb] * (sched.n_model_stages - 1)
        rep = P.verify.VerificationReport()
        P.verify.verify_schedule_credits(sched, caps, caps if sched.trains else [], rep)
        return sched, rep
    (_, want), (sched, rep) = both(go)
    assert findings(rep) == findings(want)
    if rep.ok():
        assert simulate_schedule(sched, f_cost=1.0, capacity_blocks=cb).makespan > 0
    else:
        with pytest.raises(RuntimeError):
            simulate_schedule(sched, f_cost=1.0, capacity_blocks=cb)


def test_schedule_consistency_findings():
    def go(P):
        sched = P.schedule.fill_drain(4, 8)
        reps = []
        for n_built, n_micro, train in ((3, 8, False), (4, 6, True)):
            rep = P.verify.VerificationReport()
            P.verify.verify_schedule_consistency(sched, n_stages_built=n_built,
                                                 n_micro=n_micro, train=train, report=rep)
            reps.append(rep)
        return reps
    want, got = both(go)
    assert any(f.check == "plan.schedule-shape" for f in got[0].errors())
    assert {"plan.schedule-micro", "plan.schedule-train"} <= {f.check for f in got[1].errors()}
    assert [findings(r) for r in got] == [findings(r) for r in want]


def test_credit_wedge_names_cycle_and_fix():
    def go(P):
        ops = [[P.verify.SimOp("a0", pushes=((0, 2),))],
               [P.verify.SimOp("b0", pops=((0, 1),)), P.verify.SimOp("b1", pops=((0, 1),))]]
        return P.verify.simulate_credit_schedule(ops, [1]), \
            P.verify.simulate_credit_schedule(ops, [2])
    (want, _), (wedge, fixed) = both(go)
    assert {(r, ei) for _s, _l, r, ei in wedge.blockers} >= {("no credits", 0), ("starved", 0)}
    assert wedge.cycle and wedge.min_viable == {0: 2}
    text = wedge.describe(["e0"])
    assert "no credits" in text and "e0>=2" in text
    assert fixed is None
    assert (wedge.positions, wedge.blockers, wedge.cycle, wedge.min_viable) == \
        (want.positions, want.blockers, want.cycle, want.min_viable)
    assert text == want.describe(["e0"])


def test_schedule_sim_ops_equal_jax():
    for name, args in _SCHEDULES:
        want, got = both(lambda P: P.verify.schedule_sim_ops(
            getattr(P.schedule, name)(*args)))
        assert got[1] == want[1]
        assert [[(o.label, o.pops, o.pushes) for o in s] for s in got[0]] == \
            [[(o.label, o.pops, o.pushes) for o in s] for s in want[0]]


def test_graph_fusion_roundtrip_on_jpeg():
    def go(P):
        g = P.jpeg.build_stg()
        sel = P.stg.Selection.fastest(g)
        compute = [n for n in g.topo_order() if g.nodes[n].kind == "compute"]
        out = []
        for groups in P.restructure.enumerate_fusions(compute, max_group=3):
            rep = P.verify.VerificationReport()
            P.verify.verify_graph_fusion(g, sel, groups, rep)
            out.append((groups, rep))
        return out
    want, got = both(go)
    assert [g for g, _ in got] == [g for g, _ in want]
    for (_, rep), (_, w) in zip(got, want):
        assert rep.ok(), rep.render()
        assert findings(rep) == findings(w) and rep.checks == w.checks


def test_graph_fusion_finding_for_an_illegal_group():
    """A group that is not a chain segment comes back as the JAX package's
    ``plan.fusion-illegal`` finding."""
    def go(P):
        g = P.jpeg.build_stg()
        rep = P.verify.VerificationReport()
        P.verify.verify_graph_fusion(g, P.stg.Selection.fastest(g), [("color", "quant")], rep)
        return rep
    want, got = both(go)
    assert findings(got) == findings(want)
    assert [f.check for f in got.errors()] == [f.check for f in want.errors()]
