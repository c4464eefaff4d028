"""The port's microbatch pipeline (`lm_pipe.LMPipeline`) on the CPU.

  * the JAX package's single-device `LMPipeline` tests on the port
    (``test_pipeline.py``, ``test_fusion.py``, ``test_failover.py``,
    ``test_donation.py``): serving bitwise equal to `reference()`, the
    sequential oracle, 1F1B, interleaved 1F1B, ``overlap=False`` and fused
    stages bitwise equal to one another, backpressure, the schedule and
    graph checks, `compare_lm` on a run, a replica fault escalating, and
    no first call inside a timed run;
  * each stage module against the JAX stage function it copies, in
    float32 (block stages hold the attention, SSD scan and norm kernels'
    plain versions, the head the norm's): outputs and every gradient leaf
    within 1e-4 of the largest entry (float32 sums in another order);
  * the port's pipeline against the JAX `LMPipeline` (its kernels on
    their ``"ref"`` oracles) from the same stage weights
    (`bridge.stages_from_jax`), for ``tiny``, ``tiny`` with 6 layers
    (interleaved 1F1B) and mamba2-370m ``reduced()`` with ``d_ff`` 0.
    Activations are bf16 in both packages (the embed stage casts to
    bf16), so the two round at other points; the tolerances, each stated
    where it is used, are about twice the spread seen.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.core.stg import Selection as JaxSelection
from repro.graphs import lm_graph as jax_lm_graph
from repro.kernels import ops as jax_ops
from repro.runtime.pipeline import LMPipeline as JaxLMPipeline
from repro.runtime.pipeline import interleaved_1f1b as jax_interleaved_1f1b
from repro.runtime.pipeline.jax_pipe import build_lm_stages as jax_build_lm_stages
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner
from repro_torch.core.stg import Selection
from repro_torch.core.verify import PlanVerificationError, verify_lm_plan
from repro_torch.graphs import lm_graph
from repro_torch.runtime.failures import PipelineFailure, ReplicaFaultPlan, ReplicaFaultSpec
from repro_torch.runtime.pipeline import (LMPipeline, LMPipelineResult, SchedOp, Schedule,
                                          Tracer,
                                          as_selection, build_lm_stages, compare_lm,
                                          fill_drain, interleaved_1f1b, one_f_one_b,
                                          selection_from_plan)

tiny = get_config("tiny")
SHAPE = ShapeCfg("pipe_test", 16, 8, "train")


def _loss(lg):
    return torch.sum(lg * lg) / lg.numel()


def _tokens(seed, n, batch=2, seq=16, vocab=tiny.vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (batch, seq)).astype(np.int32) for _ in range(n)]


def _leaves(tree, prefix=""):
    return bridge.flat_tree(tree, prefix)


def _assert_trees_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys(), what
    for k in la:
        assert torch.equal(la[k], lb[k]), f"{what} {k}"


def _assert_grads_equal(ga, gb):
    assert ga.keys() == gb.keys()
    for name in ga:
        _assert_trees_equal(ga[name], gb[name], name)


@pytest.fixture(scope="module")
def lm_setup():
    plan = planner.plan(tiny, SHAPE, chips=16, max_tp=4)
    stg, _ = lm_graph.build_stg(tiny, SHAPE, max_tp=4)
    pipe = LMPipeline(tiny, stg, selection_from_plan(plan), device="cpu")
    yield pipe, plan, stg, _tokens(0, 5)
    pipe.close()


@pytest.fixture(scope="module")
def lm6_setup():
    """A 6-layer tiny variant: embed + 6 blocks + head = 8 built stages,
    the smallest graph that interleaves over >= 4 physical stages."""
    tiny6 = dataclasses.replace(tiny, name="tiny6", n_layers=6)
    stg, _ = lm_graph.build_stg(tiny6, ShapeCfg("ilv_test", 16, 8, "train"), max_tp=4)
    pipe = LMPipeline(tiny6, stg, Selection.smallest(stg), device="cpu")
    yield pipe, _tokens(11, 8)
    pipe.close()


# ===========================================================================
# the JAX package's LMPipeline tests, on the port
# ===========================================================================
def test_lm_pipeline_runs_solver_selection_end_to_end(lm_setup):
    pipe, _, _, mbs = lm_setup
    assert pipe.n_stages == 6          # embed + 4 blocks + head
    res = pipe.run(mbs)
    ref = pipe.reference(mbs)
    assert all(o is not None for o in res.outputs)
    for a, b in zip(res.outputs, ref):
        assert torch.equal(a, b)
    assert res.tokens_per_s(toks_per_mb=32) > 0
    for st in pipe.stages:
        assert res.stage_firings[st.name] == len(mbs)


def test_lm_pipeline_1f1b_grads_match_autograd_and_the_oracle(lm_setup):
    """1F1B against one autograd pass over the whole model and every
    microbatch (float32 gradients of bf16 activations, summed in another
    order: within 1e-4 of each leaf's largest entry plus 1e-6), and
    bitwise against the sequential oracle (same ops, same fold order)."""
    pipe, _, _, mbs = lm_setup
    res = pipe.run(mbs, train=True, loss_fn=_loss)
    assert all(res.grads[st.name] is not None for st in pipe.stages)
    params = [p for st in pipe.stages for p in st.params]
    with torch.enable_grad():
        total = 0.0
        for mb in mbs:
            x = torch.from_numpy(mb).long()
            for st in pipe.stages:
                x = st.module(x)
            total = total + _loss(x)
        want = torch.autograd.grad(total, params)
    got = [g for st in pipe.stages for g in _leaves(res.grads[st.name]).values()]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-6)
    grads, losses = pipe.sequential(mbs, loss_fn=_loss)
    assert losses == res.losses
    _assert_grads_equal(res.grads, grads)


def test_lm_pipeline_rejects_grouping_that_drops_replicas(lm_setup):
    _, plan, stg, _ = lm_setup
    sel = selection_from_plan(plan)
    sel.set("block01", sel.choices["block01"][0],
            sel.choices["block01"][1] * 2)     # misalign within a group
    with pytest.raises(ValueError, match="drop replicas"):
        LMPipeline(tiny, stg, sel, layers_per_stage=2, device="cpu")


def test_lm_pipeline_overlap_off_matches_reference(lm_setup):
    """The serial A/B baseline (overlap=False) runs the same graph and
    must stay bitwise equal to the async default."""
    pipe, _, _, mbs = lm_setup
    res = pipe.run(mbs, overlap=False)
    for a, b in zip(res.outputs, pipe.reference(mbs)):
        assert torch.equal(a, b)


def test_tokens_per_s_short_run_excludes_fill():
    """< 3 completed microbatches: throughput anchors at the first
    completion instead of dividing by the full wall."""
    res = LMPipelineResult(outputs=[None, None], mb_done_s=[5.0, 5.5], wall_s=10.0)
    assert res.tokens_per_s(10) == pytest.approx(10 * 1 / 0.5)
    res1 = LMPipelineResult(outputs=[None], mb_done_s=[5.0], wall_s=10.0)
    assert res1.tokens_per_s(10) == pytest.approx(1.0)


def test_backpressure_bounds_inflight_under_async():
    """A slow consumer with capacity_blocks=1 must stall its producer and
    never trip the deadlock detector on a valid schedule."""
    stg, _ = lm_graph.build_stg(tiny, SHAPE, max_tp=4)
    pipe = LMPipeline(tiny, stg, Selection.smallest(stg), capacity_blocks=1,
                      replica_queue=1, device="cpu")
    mbs = _tokens(7, 12)
    slow_idx = pipe.n_stages - 2
    fwd = pipe.stages[slow_idx].fwd

    def slow(module, x):
        time.sleep(0.15)            # on the stage's lane thread
        return fwd(module, x)

    pipe.stages[slow_idx].fwd = slow
    ref = pipe.reference(mbs)
    tr = Tracer()
    res = pipe.run(mbs, tracer=tr)
    pipe.close()
    for a, b in zip(res.outputs, ref):
        assert torch.equal(a, b)
    assert res.fifo_stats[("act", slow_idx - 1)].producer_stalls > 0
    assert sum(res.stage_wait_s.get(pipe.stages[i].name, {}).get("credit", 0.0)
               for i in range(slow_idx)) > 0.0
    for stats in res.fifo_stats.values():
        assert stats.inflight_high_water <= 1 + 2
    assert res.max_inflight <= pipe.n_stages


def test_compare_lm_report_feeds_replan(lm_setup):
    """A microbatch run is a calibration source: completion-event ratios
    flow through the report into planner.replan(measured_ratio=...)."""
    pipe, plan, stg, mbs = lm_setup
    res = pipe.run(mbs)
    rep = compare_lm(stg, selection_from_plan(plan), res,
                     stage_map=pipe.graph_stage_map())
    assert rep.bottleneck_measured in rep.stages
    ratios = rep.ratios()
    assert ratios and all(r > 0 for r in ratios.values())
    new, diff = planner.replan(tiny, SHAPE, plan, new_chips=16, measured_ratio=ratios,
                               max_tp=4)
    assert new.feasible
    assert "throughput_ratio" in diff


def test_compare_lm_too_few_microbatches_names_counts(lm_setup):
    pipe, plan, stg, mbs = lm_setup
    res = pipe.run(mbs[:2])
    with pytest.raises(ValueError, match=r"embed: 2"):
        compare_lm(stg, selection_from_plan(plan), res)


def test_no_compiles_inside_timed_lm_run(lm_setup):
    pipe, _, _, mbs = lm_setup
    pipe.run(mbs, train=True, loss_fn=_loss)
    pipe.run(mbs)
    assert pipe.compile_stats.late == 0
    assert pipe.compile_stats.compiles > 0


def test_host_overhead_surfaces_in_report(lm_setup):
    pipe, plan, stg, mbs = lm_setup
    res = pipe.run(mbs * 2)
    for st in pipe.stages:
        assert res.stage_host_us(st.name) > 0
    rep = compare_lm(stg, selection_from_plan(plan), res)
    assert any(m.host_v is not None and m.host_v > 0 for m in rep.stages.values())
    assert "host" in rep.summary()
    # host overhead must be a component of, not exceed, total stage time
    for st in pipe.stages:
        assert res.stage_dispatch_s[st.name] <= res.stage_seconds[st.name] + 1e-6


def test_stages_share_the_module_tensors(lm_setup):
    """Every replica of a stage runs its one module: the weights live once
    however many replicas the plan asks for."""
    pipe, _, _, _ = lm_setup
    assert any(len(st.devices) > 1 for st in pipe.stages)
    ptrs = [p.data_ptr() for st in pipe.stages for p in st.params]
    assert len(ptrs) == len(set(ptrs))
    assert all(len(st.streams) == len(st.devices) for st in pipe.stages)


def test_interleaved_1f1b_grads_bitwise_equal(lm6_setup):
    """Interleaved 1F1B over 4 physical stages x 2 chunks gives grads
    bitwise equal to plain 1F1B, to overlap=False and to the sequential
    oracle (same ops, same fold order)."""
    pipe, mbs = lm6_setup
    assert pipe.n_stages == 8
    r_plain = pipe.run(mbs, train=True, loss_fn=_loss, schedule=one_f_one_b(8, len(mbs)))
    r_ilv = pipe.run(mbs, train=True, loss_fn=_loss,
                     schedule=interleaved_1f1b(4, len(mbs), 2))
    r_serial = pipe.run(mbs, train=True, loss_fn=_loss, overlap=False,
                        schedule=interleaved_1f1b(4, len(mbs), 2))
    assert len(r_ilv.stage_firings) == 4
    assert "embed+block03" in r_ilv.stage_firings
    assert r_ilv.stage_firings["embed+block03"] == 2 * 2 * len(mbs)
    g_seq, losses_seq = pipe.sequential(mbs, loss_fn=_loss)
    assert r_plain.losses == r_ilv.losses == r_serial.losses == losses_seq
    for r in (r_plain, r_ilv, r_serial):
        _assert_grads_equal(r.grads, g_seq)
    assert pipe.compile_stats.late == 0


def test_interleaved_default_schedule_at_construction(lm6_setup):
    """LMPipeline(schedule=...) sets the default `run` executes."""
    pipe, mbs = lm6_setup
    mbs = mbs[:4]
    stg, _ = lm_graph.build_stg(pipe.cfg, ShapeCfg("ilv_test", 16, 8, "train"), max_tp=4)
    pipe2 = LMPipeline(pipe.cfg, stg, Selection.smallest(stg), device="cpu",
                       schedule=interleaved_1f1b(4, 4, 2))
    assert isinstance(pipe2.schedule, Schedule)
    res = pipe2.run(mbs, train=True, loss_fn=_loss)
    assert set(res.stage_firings) == {"embed+block03", "block00+block04",
                                      "block01+block05", "block02+head"}
    ref = pipe2.run(mbs, train=True, loss_fn=_loss, schedule=one_f_one_b(8, 4))
    pipe2.close()
    _assert_grads_equal(res.grads, ref.grads)


def test_run_rejects_mismatched_schedules(lm6_setup):
    pipe, mbs = lm6_setup
    with pytest.raises(ValueError, match="model stages"):
        pipe.run(mbs, train=True, loss_fn=_loss, schedule=interleaved_1f1b(2, len(mbs), 2))
    with pytest.raises(ValueError, match="microbatches"):
        pipe.run(mbs[:4], train=True, loss_fn=_loss, schedule=one_f_one_b(8, len(mbs)))
    with pytest.raises(ValueError, match="no backward"):
        pipe.run(mbs, train=True, loss_fn=_loss, schedule=fill_drain(8, len(mbs)))
    with pytest.raises(ValueError, match="schedules backward"):
        pipe.run(mbs, schedule=one_f_one_b(8, len(mbs)))


def test_lm_pipeline_rejects_graphs_it_cannot_execute():
    """Enc-dec graphs emit encNN nodes no built decoder stage claims —
    construction must fail loudly instead of running less model than the
    plan placed."""
    cfg = dataclasses.replace(tiny, name="tiny-encdec", encdec=True, enc_layers=2)
    stg, _ = lm_graph.build_stg(cfg, ShapeCfg("encdec", 16, 8, "serve"), max_tp=2)
    with pytest.raises(ValueError, match="enc00"):
        LMPipeline(cfg, stg, Selection.smallest(stg), device="cpu")


def test_lm_stages_refuse_moe_and_a_device_pool():
    """A pool of devices is refused (MoE stages are ported since:
    ``tests/test_torch_moe.py`` runs them)."""
    stg, _ = lm_graph.build_stg(tiny, SHAPE, max_tp=4)
    with pytest.raises(NotImplementedError, match="one device"):
        LMPipeline(tiny, stg, Selection.smallest(stg), devices=["cpu", "meta"])


# -- fusion (test_fusion.py) ------------------------------------------------
def test_fused_lm_pipeline_bitwise_losses_and_grads():
    shape = ShapeCfg("fusion_train", 64, 16, "train")
    plan = planner.plan(tiny, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(tiny, shape, max_tp=4)
    sel = as_selection(plan)
    mbs = [np.random.default_rng(i).integers(2, tiny.vocab, (2, 16)).astype(np.int32)
           for i in range(4)]

    def loss(lg):
        return torch.mean(lg.float() ** 2)

    names, modules = build_lm_stages(tiny, device="cpu")
    pu = LMPipeline(tiny, stg, sel, device="cpu", params=modules)
    ru = pu.run(mbs, train=True, loss_fn=loss)
    fp = [("embed", "block00"), ("block01",), ("block02",), ("block03", "head")]
    pf = LMPipeline(tiny, stg, sel, fusion_plan=fp, device="cpu", params=modules)
    assert [s.name for s in pf.stages] == \
        ["embed+block00", "block01", "block02", "block03+head"]
    rf = pf.run(mbs, train=True, loss_fn=loss)
    pu.close()
    pf.close()
    assert ru.losses == rf.losses
    _assert_trees_equal(ru.grads["embed"], rf.grads["embed+block00"]["embed"])
    _assert_trees_equal(ru.grads["block00"], rf.grads["embed+block00"]["block00"])
    _assert_trees_equal(ru.grads["block01"], rf.grads["block01"])
    _assert_trees_equal(ru.grads["block03"], rf.grads["block03+head"]["block03"])
    _assert_trees_equal(ru.grads["head"], rf.grads["block03+head"]["head"])


def test_fused_lm_pipeline_serve_outputs_bitwise():
    shape = ShapeCfg("fusion_serve", 64, 16, "train")
    plan = planner.plan(tiny, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(tiny, shape, max_tp=4)
    sel = as_selection(plan)
    mbs = [np.random.default_rng(i).integers(2, tiny.vocab, (2, 16)).astype(np.int32)
           for i in range(3)]
    names, modules = build_lm_stages(tiny, device="cpu")
    pu = LMPipeline(tiny, stg, sel, device="cpu", params=modules)
    ru = pu.run(mbs)
    pf = LMPipeline(tiny, stg, sel, fusion_plan="auto", device="cpu", params=modules)
    rf = pf.run(mbs)
    pu.close()
    pf.close()
    assert pf.fusion_plan is not None
    assert pf.compile_stats.late == 0
    for a, b in zip(ru.outputs, rf.outputs):
        assert torch.equal(a, b)


# -- faults (test_failover.py) ----------------------------------------------
def test_lm_training_pipeline_fault_escalates_structured(lm_setup):
    """The training path has no failover hook by design: a replica fault
    surfaces as a structured PipelineFailure, never a hang; the pipeline
    runs again after it."""
    pipe, _, _, mbs = lm_setup
    target = pipe.stages[1].name
    inj = ReplicaFaultPlan(faults=[ReplicaFaultSpec(target, 0, at=2)])
    with pytest.raises(PipelineFailure) as ei:
        pipe.run(mbs[:3], injector=inj)
    e = ei.value
    assert e.stage == target and e.replica == 0
    assert "no failover hook" in str(e)
    assert "schedule" in e.diagnostics
    res = pipe.run(mbs)
    for a, b in zip(res.outputs, pipe.reference(mbs)):
        assert torch.equal(a, b)


# -- the accumulator (test_donation.py) -------------------------------------
def test_interleaved_grads_bitwise_stable_with_the_resident_accumulator():
    """Plain vs interleaved 1F1B agree bitwise with the in-place
    accumulator in the loop (per-built-stage fold order is schedule-
    independent), at two layers a stage."""
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("donate_ilv", 16, 8, "train"), max_tp=4)
    pipe = LMPipeline(tiny, stg, Selection.smallest(stg), layers_per_stage=2, device="cpu")
    mbs = _tokens(5, 4, batch=1)

    def loss(lg):
        return torch.mean(lg * lg)

    M = pipe.n_stages
    r_plain = pipe.run(mbs, train=True, loss_fn=loss, schedule=one_f_one_b(M, len(mbs)))
    r_ilv = pipe.run(mbs, train=True, loss_fn=loss,
                     schedule=interleaved_1f1b(M // 2, len(mbs), 2))
    pipe.close()
    _assert_grads_equal(r_plain.grads, r_ilv.grads)


def test_accumulator_is_the_first_microbatch_buffer_folded_in_place(lm_setup):
    """Each stage's gradients live in one buffer a stage: the fold writes
    the first microbatch's gradients in place (the same storage at the
    end), and the preflight's accumulate check passes on meta tensors."""
    pipe, _, _, mbs = lm_setup
    pipe.warm(mbs, train=True, loss_fn=_loss)     # the warm-up's fold is not the run's
    st = pipe.stages[1]
    seen = []
    fold = st.acc.fn

    def spy(acc, pb):
        seen.append([a.data_ptr() for a in acc])
        return fold(acc, pb)

    st.acc.fn = spy
    try:
        res = pipe.run(mbs, train=True, loss_fn=_loss)
    finally:
        st.acc.fn = fold
    assert len(seen) == len(mbs) - 1
    assert all(s == seen[0] for s in seen)
    assert [g.data_ptr() for g in _leaves(res.grads[st.name]).values()] == seen[0]
    report = verify_lm_plan(pipe, schedule=one_f_one_b(pipe.n_stages, len(mbs)),
                            n_micro=len(mbs), train=True, deep=True)
    assert report.ok(), report.render()
    assert "accumulate" in report.checks


# -- the preflight (core.verify.verify_lm_plan) -----------------------------
def test_default_run_passes_preflight(lm_setup):
    pipe, _, _, mbs = lm_setup
    pipe.run(mbs, train=True, loss_fn=_loss)
    rep = pipe.last_preflight
    assert rep.ok(), rep.render()
    for check in ("schedule-consistency", "schedule-credits", "placement-consistency"):
        assert check in rep.checks, rep.checks


def test_preflight_refuses_a_schedule_that_wedges_its_fifos(lm_setup):
    """An op order that needs more credits than the run's FIFOs hold is
    refused before anything runs: every stage but the head runs all its
    forwards before any backward, while the head alternates F and B into
    1-slot edges — its second backward waits for a gradient slot the
    stage below frees only after forwards the head has yet to take."""
    pipe, _, _, _ = lm_setup
    M, n = pipe.n_stages, 8
    ops = [[SchedOp("F", mb, 0) for mb in range(n)] + [SchedOp("B", mb, 0) for mb in range(n)]
           for _ in range(M - 1)]
    ops.append([SchedOp(k, mb, 0) for mb in range(n) for k in "FB"])
    sched = Schedule(name="wedge", n_stages=M, n_micro=n, n_chunks=1, stage_ops=ops)
    report = verify_lm_plan(pipe, schedule=sched, n_micro=n, train=True,
                            act_capacities=[1] * (M - 1), grd_capacities=[1] * (M - 1))
    assert not report.ok()
    assert report.deadlock_findings()
    with pytest.raises(PlanVerificationError):
        report.raise_if_errors("LMPipeline.run")
    assert verify_lm_plan(pipe, schedule=sched, n_micro=n, train=True,
                          act_capacities=[n] * (M - 1), grd_capacities=[n] * (M - 1)).ok()


# ===========================================================================
# the stage modules against the JAX stage functions, float32
# ===========================================================================
@pytest.fixture
def jax_ref_impl():
    """The JAX package's kernels on their oracles, restored afterwards."""
    saved = jax_ops._DEFAULT_IMPL
    jax_ops.set_default_impl("ref")
    yield
    jax_ops.set_default_impl(saved)


def _pair_configs(name, **kw):
    jcfg, cfg = jax_get_config(name), get_config(name)
    if name != "tiny":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("name,kw", [("tiny", {}), ("mamba2-370m", {"d_ff": 0}),
                                     ("mamba2-370m", {})])
def test_stage_modules_match_the_jax_stage_functions(jax_ref_impl, name, kw):
    """Each block stage (two layers) and the head, from the same weights
    (`bridge.stages_from_jax`), on the same float32 input: the output, the
    input's gradient and every parameter's gradient (``jax.vjp`` against
    ``torch.autograd.grad``) within 1e-4 of the largest entry — float32
    sums in another order.  A parameter the output does not reach (the
    MLP norm at d_ff 0) has zeros on both sides."""
    jcfg, cfg = _pair_configs(name, **kw)
    names, fwds, params = jax_build_lm_stages(jcfg, layers_per_stage=2, seed=1)
    modules = bridge.stages_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu",
                                     layers_per_stage=2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    for n in names[1:]:
        y, vjp = jax.vjp(fwds[n], params[n], jnp.asarray(x))
        y_bar = rng.normal(size=y.shape).astype(np.float32)
        p_bar, x_bar = vjp(jnp.asarray(y_bar))
        xt = torch.from_numpy(x).requires_grad_()
        yt = modules[n](xt)
        named = list(modules[n].named_parameters())
        gs = torch.autograd.grad(yt, [p for _, p in named] + [xt], torch.from_numpy(y_bar),
                                 allow_unused=True)
        want = _leaves(jax.tree.map(np.asarray, p_bar))
        pairs = [("y", np.asarray(y), yt.detach().numpy()),
                 ("x_bar", np.asarray(x_bar), gs[-1].numpy())]
        pairs += [(k, want[k], np.zeros_like(want[k]) if g is None else g.numpy())
                  for (k, _), g in zip(named, gs)]
        for k, a, b in pairs:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max() + 1e-7,
                                       err_msg=f"{n}.{k}")


def test_stages_from_jax_checks_keys_and_shapes():
    jcfg, cfg = _pair_configs("tiny")
    names, _, params = jax_build_lm_stages(jcfg, seed=0)
    tree = jax.tree.map(np.asarray, params)
    mods = bridge.stages_from_jax(cfg, tree, device="cpu")
    assert list(mods) == names
    assert all(p.dtype == torch.float32 for m in mods.values() for p in m.parameters())
    assert torch.equal(mods["head"].w_out, torch.from_numpy(np.array(tree["head"]["w_out"])))
    bad = dict(tree, head={"norm": tree["head"]["norm"]})
    with pytest.raises(ValueError, match="no counterpart"):
        bridge.stages_from_jax(cfg, bad, device="cpu")
    wrong = dict(tree, head=dict(tree["head"], norm=np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        bridge.stages_from_jax(cfg, wrong, device="cpu")


# ===========================================================================
# the port's pipeline against the JAX LMPipeline
# ===========================================================================
# (config, kwargs, microbatches, schedule: None or interleaved (p, v),
#  tolerances) — the tolerances are twice the spread seen, bf16 activations:
#  logits |port - JAX| <= LOGIT * max|JAX logits| (tiny: 1.4% seen, up to
#  ~1.5 bf16 steps at magnitude 4; mamba2-370m: its bf16 stack carries
#  single roundings further, 4.7% seen); each loss within LOSS relative;
#  each gradient leaf's ||port - JAX|| <= GRAD ||JAX|| (tiny 1.9%, mamba
#  5.9% seen)
PARITY = {
    "tiny": ("tiny", {}, 4, None, dict(LOGIT=3e-2, LOSS=2e-3, GRAD=5e-2)),
    "tiny6": ("tiny", {"n_layers": 6}, 8, (4, 2), dict(LOGIT=3e-2, LOSS=2e-3, GRAD=5e-2)),
    "mamba2-370m-reduced-d_ff0": ("mamba2-370m", {"d_ff": 0}, 4, None,
                                  dict(LOGIT=1e-1, LOSS=2e-3, GRAD=1.2e-1)),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_pipeline_matches_the_jax_pipeline(jax_ref_impl, case):
    name, kw, n_micro, ilv, tol = PARITY[case]
    jcfg, cfg = _pair_configs(name, **kw)
    jstg, _ = jax_lm_graph.build_stg(jcfg, JaxShapeCfg("parity", 16, 8, "train"), max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    jpipe = JaxLMPipeline(jcfg, jstg, JaxSelection.smallest(jstg))
    stage_params = {st.name: jax.tree.map(np.asarray, st.params[0]) for st in jpipe.stages}
    pipe = LMPipeline(cfg, stg, Selection.smallest(stg), device="cpu",
                      params=bridge.stages_from_jax(cfg, stage_params, device="cpu"))
    mbs = _tokens(3, n_micro, vocab=cfg.vocab)
    jr, pr = jpipe.run(mbs), pipe.run(mbs)
    for a, b in zip(jr.outputs, pr.outputs):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol["LOGIT"] * np.abs(a).max())
    jsched = None if ilv is None else jax_interleaved_1f1b(ilv[0], n_micro, ilv[1])
    sched = None if ilv is None else interleaved_1f1b(ilv[0], n_micro, ilv[1])
    jt = jpipe.run(mbs, train=True, loss_fn=lambda lg: jnp.mean(lg.astype(jnp.float32) ** 2),
                   schedule=jsched)
    pt = pipe.run(mbs, train=True, loss_fn=lambda lg: torch.mean(lg.float() ** 2),
                  schedule=sched)
    pipe.close()
    assert pt.losses.keys() == jt.losses.keys()
    for k in jt.losses:
        assert pt.losses[k] == pytest.approx(jt.losses[k], rel=tol["LOSS"])
    for n, tree in pt.grads.items():
        want = _leaves(jax.tree.map(np.asarray, jt.grads[n]))
        got = _leaves(tree)
        assert got.keys() == want.keys(), n
        for k, g in got.items():
            a = want[k].astype(np.float32)
            err = np.linalg.norm(g.numpy() - a)
            assert err <= tol["GRAD"] * np.linalg.norm(a) + 1e-12, \
                (n, k, err / max(np.linalg.norm(a), 1e-30))
