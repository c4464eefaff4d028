"""The port's self-healing serve on the CPU: failover, migration, pause and resume.

  * the engine: whatever replica of a replicated stage dies at whatever
    op, the run drains with every FIFO credit back, no reorder residue
    and every result in order; an op lost in flight is redone under its
    original sequence number; a fault with no survivor escalates to a
    structured `PipelineFailure` (synthetic programs, both engine modes);
  * `DecodePipeline` on ``tiny`` with two replicas forced on ``blocks00``
    (as the JAX package's failover tests do): a crash at a token and at
    an op, overlapped and serial, and a crash that loses an op in flight,
    each token-identical to the uninterrupted serve with no first call
    inside it; under the same fault spec with ``overlap=False`` the JAX
    `DecodePipeline(impl="ref")` on the same weights (float32) records the
    same failover (stage, replica, kind, replayed ops) and gives the same
    tokens, up to the first step whose top-2 margin is under ``TIE``;
  * a single-replica stage's crash escalates with the diagnostic bundle,
    and the same pipeline serves again afterwards;
  * a stalled replica drives the `HealthController`: flagged, its group
    migrated, re-plan advice that `planner.replan` takes;
  * an admission-paused serve resumes on the same pipeline and on one
    with other stage spans (caches handed off, or rebuilt by replay), and
    through `elastic.rescale_serving`;
  * the injectors re-arm and the straggler monitor re-warms (the JAX
    package's regressions, against the port's copies).
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.configs.tiny import CONFIG as jax_tiny
from repro.core import planner as jax_planner
from repro.graphs import lm_graph as jax_lm_graph
from repro.models import lm as jax_lm
from repro.runtime.failures import ReplicaFaultPlan as JaxReplicaFaultPlan
from repro.runtime.pipeline import DecodePipeline as JaxDecodePipeline
from repro.runtime.pipeline import as_selection as jax_as_selection
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner
from repro_torch.graphs import lm_graph
from repro_torch.runtime.elastic import rescale_serving
from repro_torch.runtime.failures import (FailureInjector, PipelineFailure, ReplicaFault,
                                          ReplicaFaultPlan, ReplicaFaultSpec,
                                          SimulatedNodeFailure)
from repro_torch.runtime.pipeline import (DecodePipeline, Engine, Fifo, HealthController,
                                          MetricsRegistry, Op, ResumeState, Tracer,
                                          as_selection, registry_from_trace)
from repro_torch.runtime.straggler import StragglerMonitor

JAX_TOL = 1e-4
TIE = 2e-4


# ===========================================================================
# synthetic replicated chain: src -> work(xR) -> sink, failover on work
# ===========================================================================
class _Src:
    n_replicas = 1

    def __init__(self, fin, m):
        self.name = "src"
        self.fin = fin
        self.m = m
        self.i = 0

    def pending(self):
        return self.m - self.i

    def peek(self):
        return None if self.i >= self.m else Op(stage=0, kind="S", seq=self.i, rep=0)

    def ready(self, op, count_stall=False):
        if self.fin.can_push(1):
            return 0.0
        self.wait_reason = ("credit", self.fin)
        return None

    def dispatch(self, op, driver):
        self.fin.reserve(1)
        self.i += 1
        return (lambda seq=op.seq: seq * 10), ()

    def retire(self, op, result, driver):
        t = time.perf_counter()
        driver.ordered_push(self.fin, op.seq, result, t)
        return t

    def describe(self):
        return f"src: {self.i}/{self.m}"


class _Work:
    """The replicated stage under test: routes op seq -> surviving
    replica, saves a ``recover`` payload at dispatch, and replays lost
    ops under their original seq (no new pop, no new reservation — the
    originals are outstanding)."""

    def __init__(self, fin, fout, m, n_replicas):
        self.name = "work"
        self.n_replicas = n_replicas
        self.fin = fin
        self.fout = fout
        self.m = m
        self.i = 0
        self.dead: set = set()
        self.redo: list = []          # (seq, payload), original seqs
        self.crash_at: int | None = None   # op body raises at this seq once
        self._crashed = False

    def rep_of(self, seq):
        alive = [r for r in range(self.n_replicas) if r not in self.dead]
        return alive[seq % len(alive)]

    def pending(self):
        return (self.m - self.i) + len(self.redo)

    def peek(self):
        if self.redo:
            return Op(stage=1, kind="W", seq=self.redo[0][0], rep=self.rep_of(self.redo[0][0]))
        if self.i >= self.m:
            return None
        return Op(stage=1, kind="W", seq=self.i, rep=self.rep_of(self.i))

    def ready(self, op, count_stall=False):
        if self.redo:
            return 0.0                # payload in hand, credit outstanding
        if not len(self.fin):
            self.wait_reason = ("starve", self.fin)
            return None
        if not self.fout.can_push(1):
            self.wait_reason = ("credit", self.fout)
            return None
        return 0.0

    def dispatch(self, op, driver):
        if self.redo and self.redo[0][0] == op.seq:
            _, payload = self.redo.pop(0)
        else:
            ((_seq, payload),) = self.fin.pop_hold(1)
            op.releases.append((self.fin, 1))
            self.fout.reserve(1)
            self.i += 1
        op.recover = (op.seq, payload)
        seq, rep = op.seq, op.rep

        def body():
            if self.crash_at == seq and not self._crashed:
                self._crashed = True
                raise ReplicaFault(f"injected body fault at op {seq}",
                                   stage=self.name, replica=rep)
            return payload * 2
        return body, ()

    def retire(self, op, result, driver):
        t = time.perf_counter()
        driver.ordered_push(self.fout, op.seq, result, t)
        return t

    def fail_replica(self, rep, driver, lost):
        self.dead.add(rep)
        if len(self.dead) >= self.n_replicas:
            raise PipelineFailure(f"stage {self.name}: no surviving replicas",
                                  stage=self.name, replica=rep)
        for op in lost:
            self.redo.append(op.recover)
        self.redo.sort()

    def describe(self):
        return f"work: {self.i}/{self.m} redo={len(self.redo)}"


class _Sink:
    n_replicas = 1

    def __init__(self, fout, m):
        self.name = "sink"
        self.fout = fout
        self.m = m
        self.i = 0
        self.out: list = []

    def pending(self):
        return self.m - self.i

    def peek(self):
        return None if self.i >= self.m else Op(stage=2, kind="K", seq=self.i, rep=0)

    def ready(self, op, count_stall=False):
        if len(self.fout):
            return 0.0
        self.wait_reason = ("starve", self.fout)
        return None

    def dispatch(self, op, driver):
        (pair,) = self.fout.pop(1)
        self.i += 1
        return (lambda p=pair: p), ()

    def retire(self, op, result, driver):
        self.out.append(result)
        return time.perf_counter()

    def describe(self):
        return f"sink: {self.i}/{self.m}"


def _chain(m, n_replicas, cap=2):
    fin = Fifo(block=1, capacity_blocks=cap)
    fout = Fifo(block=1, capacity_blocks=cap)
    return [_Src(fin, m), _Work(fin, fout, m, n_replicas), _Sink(fout, m)], fin, fout


def _assert_quiescent(engine, fin, fout, sink, m):
    assert sink.out == [(i, i * 20) for i in range(m)], sink.out
    assert fin.free == fin.capacity, f"fin leaked slots: free {fin.free}/{fin.capacity}"
    assert fout.free == fout.capacity, f"fout leaked slots: free {fout.free}/{fout.capacity}"
    assert engine.reorder_occupancy() == 0


# (ops, replicas, replica killed, its op count at the kill, fifo capacity);
# a trigger past the replica's dispatch count never fires, and the
# fault-free run must meet the same invariants
KILLS = [(2, 2, 0, 1, 1), (2, 2, 1, 1, 2), (5, 2, 0, 2, 1), (5, 2, 1, 3, 2),
         (8, 3, 2, 2, 3), (8, 3, 0, 1, 1), (10, 2, 1, 5, 2), (10, 3, 1, 4, 2),
         (10, 3, 2, 10, 3), (6, 2, 0, 4, 3)]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("m,n_rep,rep,at,cap", KILLS)
def test_kill_any_replica_any_op_quiesces(m, n_rep, rep, at, cap, overlap):
    programs, fin, fout = _chain(m, n_rep, cap)
    inj = ReplicaFaultPlan(faults=[ReplicaFaultSpec("work", rep, at)])
    eng = Engine(programs, overlap=overlap, workers=3, injector=inj)
    res = eng.run()
    _assert_quiescent(eng, fin, fout, programs[2], m)
    assert len(res.failovers) == inj.fired <= 1
    if inj.fired:
        assert programs[1].dead == {rep}


@pytest.mark.parametrize("overlap", [False, True])
def test_inflight_op_replays_under_original_seq(overlap):
    """A ReplicaFault raised from a dispatched op body: the engine aborts
    the whole replica, the lost op replays from its ``recover`` payload
    under the original seq, and the stream heals."""
    m = 8
    programs, fin, fout = _chain(m, 2)
    programs[1].crash_at = 3
    eng = Engine(programs, overlap=overlap, workers=4)
    res = eng.run()
    _assert_quiescent(eng, fin, fout, programs[2], m)
    assert len(res.failovers) == 1
    fo = res.failovers[0]
    assert (fo["stage"], fo["kind"]) == ("work", "crash")
    assert fo["replayed_ops"] >= 1 and fo["recovery_s"] >= 0.0
    assert programs[1].dead == {fo["replica"]}


@pytest.mark.parametrize("overlap", [False, True])
def test_no_survivors_escalates_structured(overlap):
    programs, *_ = _chain(4, 1)
    inj = ReplicaFaultPlan.parse("work:r0@op2=crash")
    with pytest.raises(PipelineFailure) as ei:
        Engine(programs, overlap=overlap, injector=inj).run()
    e = ei.value
    assert (e.stage, e.replica) == ("work", 0) and e.reason
    for key in ("schedule", "reorder_occupancy", "fifo_occupancy", "lost_ops",
                "static_preflight"):
        assert key in e.diagnostics
    assert "work" in e.describe()


def test_wall_clock_stall_burns_host_time():
    programs, fin, fout = _chain(4, 2)
    inj = ReplicaFaultPlan.parse("work:r0@op1=stall:0.05x2")
    eng = Engine(programs, overlap=False, injector=inj)
    t0 = time.perf_counter()
    eng.run()
    assert time.perf_counter() - t0 >= 0.1       # two stalled firings
    _assert_quiescent(eng, fin, fout, programs[2], 4)
    assert inj.fired == 2                        # repeat budget honored


def test_health_tick_runs_every_n_retirements():
    programs, *_ = _chain(6, 2)
    ticks = []
    Engine(programs, overlap=False, on_tick=lambda e: ticks.append(e._retired_n),
           tick_every=4).run()
    assert ticks == [4, 8, 12, 16]               # 18 retirements in all


# ===========================================================================
# decode serving: failover with token parity, against the JAX package too
# ===========================================================================
SHAPE = ("chaos_test", 64, 16, "decode")


def _force_two_on_first_period(stg, sel, n_period_layers):
    for n in stg.topo_order():
        if n.startswith("block") and int(n[5:]) < n_period_layers:
            sel.set(n, sel.choices[n][0], 2)
    return sel


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jcfg = dataclasses.replace(jax_tiny, compute_dtype="float32")
    return jcfg, jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, rng.integers(4, 20)).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def chaos_setup():
    """``tiny`` in float32 on the JAX package's weights, two replicas
    forced on the first period's blocks (stage ``blocks00`` has a
    survivor to fail over onto), and the uninterrupted serve."""
    _, tree = _jax_weights()
    cfg = dataclasses.replace(get_config("tiny"), compute_dtype="float32")
    shape = ShapeCfg(*SHAPE)
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    sel = _force_two_on_first_period(stg, as_selection(plan), len(cfg.block_pattern))
    params = bridge.from_jax(cfg, tree, device="cpu")
    pipe = DecodePipeline(cfg, stg, sel, device="cpu", params=params)
    assert len(pipe.stage_devices[pipe.stage_names.index("blocks00")]) == 2
    prompts = _prompts(cfg.vocab, 8, 0)
    ref = pipe.serve(prompts, 12, group_size=4)
    return cfg, shape, stg, plan, sel, params, pipe, prompts, ref


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("spec", ["blocks00:r1@tok6=crash", "blocks00:r0@op3=crash"])
def test_decode_failover_token_parity(chaos_setup, spec, overlap):
    *_, pipe, prompts, ref = chaos_setup
    inj = ReplicaFaultPlan.parse(spec)
    tr = Tracer()
    late = pipe.compile_stats.late
    res = pipe.serve(prompts, 12, group_size=4, injector=inj, tracer=tr, overlap=overlap)
    assert inj.fired == 1
    assert res.tokens == ref.tokens              # nothing was lost
    assert pipe.compile_stats.late == late == 0  # the moved group ran warm
    assert len(res.failovers) == 1
    fo = res.failovers[0]
    assert fo["stage"] == "blocks00" and fo["kind"] == "crash"
    assert fo["recovery_s"] >= 0.0
    assert tr.failovers and tr.failovers[0][0] == "blocks00"
    reg = registry_from_trace(tr)
    assert reg.counter("pipeline.failovers", stage="blocks00",
                       replica=str(fo["replica"])).value == 1
    assert reg.find("pipeline.recovery_s")


def test_decode_failover_redoes_an_op_lost_in_flight(chaos_setup):
    """Four groups, two on each ``blocks00`` replica: r1's second op (a
    prefill) stalls in its body, and r1 dies at its third dispatch while
    that op is still in flight.  The op is drained, redone on r0 under
    its sequence number, and the group whose prefill had retired gets its
    cache rebuilt by replay."""
    *_, pipe, _, _ = chaos_setup
    cfg = chaos_setup[0]
    prompts = _prompts(cfg.vocab, 16, 3)
    ref = pipe.serve(prompts, 8, group_size=4)
    inj = ReplicaFaultPlan.parse("blocks00:r1@op2=stall:1.0", "blocks00:r1@op3=crash")
    res = pipe.serve(prompts, 8, group_size=4, injector=inj)
    assert inj.fired == 2
    assert [f["replayed_ops"] for f in res.failovers] == [1]
    assert res.tokens == ref.tokens
    assert pipe.compile_stats.late == 0


@pytest.fixture(scope="module")
def jax_chaos():
    """The JAX `DecodePipeline(impl="ref")` on the same weights, plan and
    forced replicas, on one device."""
    jcfg, tree = _jax_weights()
    shape = JaxShapeCfg(*SHAPE)
    plan = jax_planner.plan(jcfg, shape, chips=8, max_tp=4)
    stg, _ = jax_lm_graph.build_stg(jcfg, shape, max_tp=4)
    sel = _force_two_on_first_period(stg, jax_as_selection(plan), len(jcfg.block_pattern))
    return JaxDecodePipeline(jcfg, stg, sel, params=jax.tree.map(jax.numpy.asarray, tree),
                             impl="ref", devices=jax.devices()[:1])


def _recording(pipe_sample, logits_of):
    def sample(logits, gid, temperature=None):
        if gid >= 0:                     # warm-up samples as gid -1
            logits_of.setdefault(gid, []).append(np.asarray(logits, np.float32)[:, -1])
        return pipe_sample(logits, gid, temperature)
    return sample


@pytest.mark.parametrize("spec", ["blocks00:r1@tok6=crash", "blocks00:r0@op3=crash"])
def test_decode_failover_matches_jax(chaos_setup, jax_chaos, spec):
    *_, sel, _, pipe, prompts, _ = chaos_setup
    assert dict(jax_chaos.sel.choices) == dict(sel.choices)
    want_logits, got_logits = {}, {}
    jsample, psample = jax_chaos._sample, pipe._sample
    jax_chaos._sample = _recording(jsample, want_logits)
    pipe._sample = _recording(psample, got_logits)
    try:
        want = jax_chaos.serve(prompts, 12, group_size=4, overlap=False,
                               injector=JaxReplicaFaultPlan.parse(spec))
        got = pipe.serve(prompts, 12, group_size=4, overlap=False,
                         injector=ReplicaFaultPlan.parse(spec))
    finally:
        jax_chaos._sample, pipe._sample = jsample, psample
    keys = ("stage", "replica", "kind", "replayed_ops")
    assert [{k: f[k] for k in keys} for f in got.failovers] == \
        [{k: f[k] for k in keys} for f in want.failovers]
    parted = {}
    for gid in want_logits:
        for step, (g, w) in enumerate(zip(got_logits[gid], want_logits[gid])):
            np.testing.assert_allclose(g, w, atol=JAX_TOL, rtol=0)
            top2 = np.sort(w, axis=-1)[:, -2:]
            flips = np.flatnonzero(g.argmax(-1) != w.argmax(-1))
            assert all(top2[i, 1] - top2[i, 0] < TIE for i in flips), (gid, step, flips)
            if len(flips):
                for i in range(len(g)):
                    parted[4 * gid + i] = step
                break
    for r, (g, w) in enumerate(zip(got.tokens, want.tokens)):
        n = parted.get(r, len(w))
        assert g[:n] == w[:n], (r, g, w)
        if r not in parted:
            assert g == w


def test_decode_single_replica_fault_escalates_and_the_pipeline_serves_again(chaos_setup):
    *_, pipe, prompts, ref = chaos_setup
    inj = ReplicaFaultPlan.parse("embed:r0@op2=crash")
    with pytest.raises(PipelineFailure) as ei:
        pipe.serve(prompts, 12, group_size=4, injector=inj)
    e = ei.value
    assert (e.stage, e.replica) == ("embed", 0)
    for key in ("fifo_occupancy", "waiting", "schedule", "reorder_occupancy", "lost_ops",
                "failovers", "static_preflight"):
        assert key in e.diagnostics, f"diagnostic bundle missing {key}"
    assert e.diagnostics["static_preflight"]["plan"].startswith("decode plan")
    assert pipe.serve(prompts, 12, group_size=4).tokens == ref.tokens


def test_stall_drives_health_controller_migration(chaos_setup):
    """A persistently stalled replica is flagged from live retire-latency
    histograms, its group migrates to the healthy peer, repeated strikes
    produce re-plan advice — and the tokens stay identical."""
    *_, pipe, prompts, _ = chaos_setup
    ref = pipe.serve(prompts, 16, group_size=4)
    tr = Tracer()
    inj = ReplicaFaultPlan.parse("blocks00:r0@op1=stall:0.03x999")
    # a tick at every retirement: a group moves only between its ops at
    # the stage, and a sparser tick may find it in flight there each time
    hc = HealthController(tracer=tr, threshold=1.5, min_samples=4, check_every=1,
                          replan_after=2)
    res = pipe.serve(prompts, 16, group_size=4, tracer=tr, injector=inj, health=hc)
    assert res.tokens == ref.tokens
    assert pipe.compile_stats.late == 0
    assert hc.ticks > 0
    assert hc.reports, "stalled replica never flagged"
    assert all(r.stage == "blocks00" and r.replica == 0 for r in hc.reports)
    assert hc.migrations >= 1, "no group migrated off the slow replica"
    assert hc.replan_advice is not None and hc.replan_advice["blocks00"] > 1.5


def test_health_replan_advice_feeds_planner(chaos_setup):
    """Pipeline stage names fan out to the graph nodes the stage owns
    (``graph_stage_map``), and the re-solve takes the ratios."""
    cfg, shape, _, plan, _, _, pipe, _, _ = chaos_setup
    owners = [n for n, s in pipe.graph_stage_map().items() if s == "blocks00"]
    assert owners == [f"block{i:02d}" for i in range(len(cfg.block_pattern))]
    new_plan, diff = planner.replan(cfg, shape, plan, new_chips=8, max_tp=4,
                                    measured_ratio={n: 3.0 for n in owners})
    assert new_plan.stages and "chips" in diff


# ===========================================================================
# admission pause -> (re-plan) -> resume
# ===========================================================================
@pytest.fixture(scope="module")
def pause_setup():
    cfg = get_config("tiny")
    shape = ShapeCfg("rescale_test", 64, 16, "decode")
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    pipe = DecodePipeline(cfg, stg, plan, device="cpu")
    prompts = _prompts(cfg.vocab, 8, 1)
    ref = pipe.serve(prompts, 12, group_size=4)
    return cfg, shape, plan, stg, pipe, prompts, ref


def _fresh_pause(pipe, prompts):
    """resume() runs the parked groups to completion on their caches in
    place, so every resuming test needs its own paused serve."""
    paused = pipe.serve(prompts, 12, group_size=4, pause_after_tokens=3)
    assert paused.paused and paused.resume_state is not None
    assert paused.resume_state.live_groups()
    return paused.resume_state


@pytest.mark.parametrize("overlap", [True, False])
def test_pause_resume_on_the_same_pipeline(pause_setup, overlap):
    """The spans match: the parked caches are adopted as they are."""
    *_, pipe, prompts, ref = pause_setup
    state = _fresh_pause(pipe, prompts)
    caches = {name: dict(v["caches"]) for name, v in state.stage_caches.items()}
    res = pipe.resume(state, overlap=overlap)
    assert res.tokens == ref.tokens and not res.paused
    assert pipe.compile_stats.late == 0
    assert all(caches.values())


@pytest.mark.parametrize("pps", [1, 2])
def test_pause_resume_token_parity_transfer_and_replay(pause_setup, pps):
    """pps=1: the successor's stage spans match the exporter's — caches
    are handed off.  pps=2: spans moved — caches are rebuilt by replay
    from prompt + fed-token history.  Both give the uninterrupted
    tokens."""
    cfg, _, plan, stg, pipe, prompts, ref = pause_setup
    state = _fresh_pause(pipe, prompts)
    succ = DecodePipeline(cfg, stg, plan, device="cpu", periods_per_stage=pps,
                          params=pipe.params)
    succ.check_pos = True
    res = succ.resume(state)
    assert res.tokens == ref.tokens and not res.paused
    assert succ.compile_stats.late == 0
    succ.close()


def test_rescale_serving_end_to_end(pause_setup):
    """Drain under admission pause, one solver call for a new chip budget,
    the successor adopts the state on the same weights, no request
    dropped."""
    cfg, shape, plan, stg, pipe, prompts, ref = pause_setup
    state = _fresh_pause(pipe, prompts)
    rs = rescale_serving(pipe, cfg, shape, plan, new_chips=6, stg=stg,
                         measured_ratio={"blocks00": 2.0}, periods_per_stage=2, max_tp=4)
    assert rs.plan.total_chips <= plan.total_chips
    assert "rescale" in rs.summary()
    assert rs.pipe.params is pipe.params
    res = rs.pipe.resume(state)
    assert res.tokens == ref.tokens
    assert rs.pipe.compile_stats.late == 0
    rs.pipe.close()


def test_plan_for_chips_is_the_planners_plan(pause_setup):
    from repro_torch.runtime.elastic import plan_for_chips
    cfg, shape, plan, *_ = pause_setup
    got = plan_for_chips(cfg, shape, 8)
    want = planner.plan(cfg, shape, chips=8)
    assert [(s.name, s.impl, s.replicas) for s in got.stages] == \
        [(s.name, s.impl, s.replicas) for s in want.stages]


def test_resume_requires_live_groups(pause_setup):
    *_, pipe, _, _ = pause_setup
    with pytest.raises(ValueError, match="no live groups"):
        pipe.resume(ResumeState(groups=[], group_of=[], eos_id=1))


# ===========================================================================
# injector re-arm + straggler warm-up regressions
# ===========================================================================
def test_failure_injector_rearms_across_incarnations():
    inj = FailureInjector(schedule={3: "crash"})
    with pytest.raises(SimulatedNodeFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                  # same incarnation: stays dead
    inj.reset()
    with pytest.raises(SimulatedNodeFailure):
        inj.maybe_fail(3)              # re-armed after the restart boundary
    assert [(i, s, k) for i, s, k in inj.log] == [(0, 3, "crash"), (1, 3, "crash")]
    assert inj.incarnation == 1
    assert inj.new_incarnation == inj.reset


def test_replica_fault_plan_rearms_and_recounts():
    p = ReplicaFaultPlan.parse("w:r0@op2=crash")
    assert p.check("w", 0, 100) is None          # 1st dispatch: below trigger
    assert p.check("w", 0, 101) is not None      # 2nd: fires
    assert p.check("w", 0, 102) is None          # crash budget spent
    assert p.fired == 1
    p.new_incarnation()
    assert p.check("w", 0, 200) is None
    assert p.check("w", 0, 201) is not None
    assert p.fired == 1
    assert [entry[0] for entry in p.log] == [0, 1]


def test_replica_fault_plan_parse_grammar():
    p = ReplicaFaultPlan.parse("blocks00:r1@tok64=crash", "embed:r0@op8=stall:0.05x16")
    a, b = p.faults
    assert (a.stage, a.replica, a.at, a.unit, a.kind) == ("blocks00", 1, 64, "tok", "crash")
    assert a.describe() == "blocks00:r1@tok64=crash"
    assert (b.unit, b.kind, b.repeat) == ("op", "stall:0.05", 16)
    assert b.stall_s == pytest.approx(0.05)
    for bad in ("nope", "s:r1@tok4=explode", "s:r1@foo4=crash", "s:rX@op4=crash",
                "s:r1@op4=stall:abc"):
        with pytest.raises(ValueError, match="bad fault spec"):
            ReplicaFaultPlan.parse(bad)


def test_straggler_monitor_warmup_resets_across_incarnations():
    mon = StragglerMonitor(window=16, threshold=2.0, warmup_steps=3)
    for i in range(6):
        mon.observe(i, 1.0)
    assert mon.observe(6, 10.0)                  # steady state: flagged
    mon.new_incarnation()
    for i in range(3):
        assert mon.observe(100 + i, 50.0) == []
    assert mon.observed == 3


def test_straggler_monitor_emits_counter():
    reg = MetricsRegistry()
    mon = StragglerMonitor(warmup_steps=1, threshold=2.0, registry=reg)
    mon.observe(0, 1.0)
    mon.observe(1, 1.0)
    assert mon.observe(2, 10.0)
    assert reg.counter("straggler.flagged", host="0").value == 1.0
    mon.observe(3, 10.0)
    assert reg.counter("straggler.flagged", host="0").value == 2.0


def test_straggler_monitor_median_consistent_within_observe():
    mon = StragglerMonitor(warmup_steps=1, threshold=2.0, window=8)
    mon.observe(0, 1.0)
    flagged = mon.observe(1, {0: 1.0, 1: 10.0})
    assert [(e.host, e.median) for e in flagged] == [(1, 1.0)]
    assert 10.0 not in mon._history              # straggler filtered out
    assert mon.median == 1.0
