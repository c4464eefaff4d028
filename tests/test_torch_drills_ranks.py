"""The self-healing drills over ranks on the CPU, over gloo: failover,
migration, pause and resume, `rescale_serving` and the training pipeline's
fault escalation on a pool of 4 ranks (a process a rank, rank 0 the
controller), held to the uninterrupted serve over ranks, to the one-rank
port and to the JAX package.

One spawn of 4 ranks (`test_torch_distributed._spawn`, a module fixture)
runs every case below, every receive within ``POOL_TIMEOUT_S``; rank 0
returns what it measured.  The JAX oracles run in this process before the
spawn; the ranks import no JAX.

  (a) ``tiny`` in float32 on the JAX package's weights (each rank filling
      only its stages, `bridge.from_jax(keep=)`), planned as
      ``tests/test_failover.py`` plans it (chips 8, ``max_tp=4``, two
      replicas forced on ``blocks00``, on ranks 1 and 2): a crash at a
      token and at an op, overlapped and serial, each token-identical to
      the uninterrupted serve over ranks and to the one-rank port's, one
      failover in the result, the trace and ``pipeline.failovers``; serial,
      the failover (stage, replica, kind, replayed ops) is the one-rank
      port's and the JAX `DecodePipeline(impl="ref")`'s, and the tokens the
      JAX pipeline's up to a step whose top-2 margin is under ``TIE``;
  (b) an op lost in flight (stalled on its rank, its replica crashed at
      its next dispatch) is redone under its sequence number from the
      input its producer's rank kept;
  (c) the lone embed replica's crash escalates with the diagnostic bundle,
      and the same pool serves again; a command that raises on a rank while
      a failed run drains is raised (caused by the `PipelineFailure`), not
      dropped;
  (d) a stalled replica drives the `HealthController`: flagged, a group's
      slice migrated rank to rank, advice that `planner.replan` takes, the
      stall slept on the replica's rank;
  (e) a pause after 3 tokens resumed on the same pool (overlapped and
      serial: every slice adopted where it is) and on a successor at
      ``periods_per_stage=2`` (every slice replayed on its new owner's
      rank, the weights a rank lacks moved to it);
  (f) `rescale_serving` onto ranks 0-2 at 6 chips: parked slices moved to
      another rank on the same span, the successor's weights bitwise the
      whole model's, rank 3 left holding nothing;
  (g) a fused ``("embed", "blocks00")`` group's replica on another rank
      crashed;
  (e)-(g) in float32 on the JAX package's weights too, each held to the
      JAX `DecodePipeline(impl="ref")` doing the same pause and resume,
      `rescale_serving` and fused crash, under the ``TIE`` rule of (a)
      (the margins of the JAX pipeline's uninterrupted serve);
  (h) `LMPipeline` of ``tiny6`` over the 4 ranks: a crash on a
      single-replica block stage escalates, and the pool's next 1F1B run is
      bitwise a clean one; a stall sleeps on its stage's rank.
After every case each rank's store holds nothing, and after a pause only
the parked slices (`held_keys`).
"""
import dataclasses

import numpy as np
import pytest

from test_torch_distributed import _spawn

POOL_TIMEOUT_S = 30.0
SHAPE = ("chaos_test", 64, 16, "decode")
PAUSE_SHAPE = ("rescale_test", 64, 16, "decode")
FUSION_SHAPE = ("fusion_test", 64, 16, "decode")
FUSION = [("embed", "blocks00"), ("blocks01",), ("blocks02",), ("blocks03", "head")]
SPECS = ["blocks00:r1@tok6=crash", "blocks00:r0@op3=crash"]
TIE = 2e-4
FAILOVER_KEYS = ("stage", "replica", "kind", "replayed_ops")
STALL_S = 0.03


def _f32_tiny():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("tiny"), compute_dtype="float32")


def _tiny6():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("tiny"), name="tiny6", n_layers=6)


def _force_two_on_first_period(stg, sel, n_period_layers):
    for n in stg.topo_order():
        if n.startswith("block") and int(n[5:]) < n_period_layers:
            sel.set(n, sel.choices[n][0], 2)
    return sel


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, rng.integers(4, 20)).tolist() for _ in range(n)]


def _loss(lg):
    return (lg.float() ** 2).mean()


def _failovers(res) -> list:
    return [{k: f[k] for k in FAILOVER_KEYS} for f in res.failovers]


def _digests(pipe) -> dict:
    """{weight: sha256 of its bytes} of what this rank holds."""
    import hashlib

    import torch

    from repro_torch.runtime.pipeline.decode import _held_weights, _weight_tensors
    out = {}
    for name in _held_weights(pipe):
        h = hashlib.sha256()
        for t in _weight_tensors(pipe.params, name):
            h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
        out[name] = h.hexdigest()
    return out


def held_keys(pipe) -> dict:
    """What this rank holds for ``pipe`` (for ``call_ranks``): its worker's
    store keys and this process's parked keys, as strings."""
    from repro_torch.runtime.pipeline.remote import PARKED
    return {"store": sorted(map(repr, pipe.worker.store)),
            "parked": sorted(map(repr, PARKED))}


def _held(pipe) -> list:
    from repro_torch.runtime.pipeline.decode import _held_weights
    return _held_weights(pipe)


# -- the ranks' cases -----------------------------------------------------------
def _ranks4(rank, world, payload):
    import time

    from repro_torch.launch.mesh import rank_pool
    pool = rank_pool(device="cpu", timeout_s=POOL_TIMEOUT_S)
    out, seconds = {}, {}
    for name, case in (("chaos", lambda: _chaos(rank, pool, payload)),
                       ("pause", lambda: _pause(rank, pool, payload)),
                       ("fused", lambda: _fused(rank, pool, payload)),
                       ("lm", lambda: _lm(rank, pool))):
        t0 = time.perf_counter()
        out[name] = case()
        seconds[name] = time.perf_counter() - t0
    return dict(out, seconds=seconds)


def _chaos(rank, pool, payload):
    """(a)-(d) on one pipeline, then the one-rank port in rank 0."""
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.failures import PipelineFailure, ReplicaFaultPlan
    from repro_torch.runtime.pipeline import (DecodePipeline, HealthController, Tracer,
                                              as_selection, compare_lm, measured_replan,
                                              registry_from_trace)
    from repro_torch.runtime.pipeline.remote import RankFailure
    cfg, shape, tree = _f32_tiny(), ShapeCfg(*SHAPE), payload["tree"]
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    sel = _force_two_on_first_period(stg, as_selection(plan), len(cfg.block_pattern))
    pipe = DecodePipeline(cfg, stg, sel, devices=pool, params=lambda keep: bridge.from_jax(
        cfg, tree, device="cpu", keep=keep))
    held = _held(pipe)
    if rank != 0:
        pipe.work()
        return {"held": held}
    out = {"held": held, "ranks": pipe.stage_ranks, "names": pipe.stage_names, "stores": {}}

    def stores(label):
        out["stores"][label] = pipe.call_ranks(held_keys)

    prompts = _prompts(cfg.vocab, 8, 0)
    ref = pipe.serve(prompts, 12, group_size=4)
    out["ref"] = ref.tokens
    stores("ref")
    # (a)
    out["a"] = {}
    for spec in SPECS:
        for overlap in (True, False):
            inj, tr = ReplicaFaultPlan.parse(spec), Tracer()
            res = pipe.serve(prompts, 12, group_size=4, injector=inj, tracer=tr,
                             overlap=overlap)
            fo = res.failovers
            reg = registry_from_trace(tr)
            out["a"][spec, overlap] = {
                "fired": inj.fired, "tokens": res.tokens, "failovers": _failovers(res),
                "recovery_s": [f["recovery_s"] for f in fo],
                "traced": [f[0] for f in tr.failovers],
                "counted": reg.counter("pipeline.failovers", stage="blocks00",
                                       replica=str(fo[0]["replica"])).value if fo else 0,
                "late": pipe.compile_stats.late}
            stores(("a", spec, overlap))
    # (b)
    p16 = _prompts(cfg.vocab, 16, 3)
    ref16 = pipe.serve(p16, 8, group_size=4)
    inj = ReplicaFaultPlan.parse("blocks00:r1@op2=stall:1.0", "blocks00:r1@op3=crash")
    res = pipe.serve(p16, 8, group_size=4, injector=inj)
    out["b"] = {"fired": inj.fired, "replayed": [f["replayed_ops"] for f in res.failovers],
                "tokens_equal": res.tokens == ref16.tokens, "late": pipe.compile_stats.late,
                "sent": {r: c["bytes_sent"] for r, c in res.ranks.items()},
                "ref_sent": {r: c["bytes_sent"] for r, c in ref16.ranks.items()}}
    stores("b")
    # (c)
    try:
        pipe.serve(prompts, 12, group_size=4,
                   injector=ReplicaFaultPlan.parse("embed:r0@op2=crash"))
        raised = None
    except PipelineFailure as e:
        raised = {"stage": e.stage, "replica": e.replica, "keys": sorted(e.diagnostics),
                  "plan": e.diagnostics["static_preflight"].get("plan", "")}
    stores("c escalated")
    out["c"] = {"raised": raised,
                "again": pipe.serve(prompts, 12, group_size=4).tokens == ref.tokens}
    stores("c")
    # (d)
    ref_d = pipe.serve(prompts, 16, group_size=4)
    tr = Tracer()
    inj = ReplicaFaultPlan.parse(f"blocks00:r0@op1=stall:{STALL_S}x999")
    hc = HealthController(tracer=tr, threshold=1.5, min_samples=4, check_every=1,
                          replan_after=2)
    res = pipe.serve(prompts, 16, group_size=4, tracer=tr, injector=inj, health=hc)
    advice = hc.replan_advice or {}
    fanned = {n: advice[s] for n, s in pipe.graph_stage_map().items() if s in advice}
    new_plan, diff = planner.replan(cfg, shape, plan, new_chips=8, max_tp=4,
                                    measured_ratio=fanned)
    # the traced serve over ranks, read as the measurement-guided re-plan reads it
    report = compare_lm(stg, sel, res, stage_map=pipe.graph_stage_map())
    measured = measured_replan(stg, report, area_budget=plan.total_chips).selection
    out["d"] = {"tokens_equal": res.tokens == ref_d.tokens, "late": pipe.compile_stats.late,
                "stage_host_s": {f"{s}@{r}": v for (s, r), v in tr.rank_host_s.items()},
                "fired": inj.fired, "flagged": sorted({(r.stage, r.replica) for r in hc.reports}),
                "migrations": hc.migrations, "moved": res.migrations, "advice": advice,
                "fanned": fanned, "replanned": bool(new_plan.stages) and "chips" in diff,
                "ratios": report.ratios(), "measured_choices": len(measured.choices),
                "costs": res.ranks, "ref_costs": ref_d.ranks}
    stores("d")
    # a command that raises on its rank while a failed run drains
    def failing():
        pipe._ctl.post(1, {"do": "no such command", "what": "a bad command"})
        raise PipelineFailure("a simulated fault", stage="embed", replica=0)
    try:
        pipe._bracket(failing)
        out["drain_error"] = None
    except RankFailure as e:
        out["drain_error"] = {"rank": e.rank, "what": e.what,
                              "cause": type(e.__cause__).__name__}
    except PipelineFailure:
        out["drain_error"] = "dropped"
    stores("drain error")
    pipe.close()
    one = DecodePipeline(cfg, stg, sel, device="cpu",
                         params=bridge.from_jax(cfg, tree, device="cpu"))
    out["one"] = {"ref": one.serve(prompts, 12, group_size=4).tokens}
    for spec in SPECS:
        r1 = one.serve(prompts, 12, group_size=4, overlap=False,
                       injector=ReplicaFaultPlan.parse(spec))
        out["one"][spec] = {"tokens": r1.tokens, "failovers": _failovers(r1)}
    one.close()
    return out


def _pause(rank, pool, payload):
    """(e) and (f) on one pipeline, float32 on the JAX package's weights."""
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.elastic import rescale_serving
    from repro_torch.runtime.pipeline import DecodePipeline
    cfg, tree = _f32_tiny(), payload["tree"]
    shape = ShapeCfg(*PAUSE_SHAPE)
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    pipe = DecodePipeline(cfg, stg, plan, devices=pool, params=lambda keep: bridge.from_jax(
        cfg, tree, device="cpu", keep=keep))
    before = _held(pipe)
    if rank != 0:
        pipe.work()
        return {"before": before, "after": _held(pipe)}
    prompts = _prompts(cfg.vocab, 8, 1)
    ref = pipe.serve(prompts, 12, group_size=4)
    out = {"before": before, "ranks": pipe.stage_ranks, "spans": pipe.period_span,
           "ref": ref.tokens}

    def drill(res, succ=None):
        return {"tokens": res.tokens, "tokens_equal": res.tokens == ref.tokens,
                "paused": res.paused,
                "adopted": res.adopted, "late": pipe.compile_stats.late + (
                    succ.compile_stats.late if succ is not None else 0),
                "stores": pipe.call_ranks(held_keys)}

    def pause():
        paused = pipe.serve(prompts, 12, group_size=4, pause_after_tokens=3)
        slices = {n: {g: v[0] for g, v in e["slices"].items()}
                  for n, e in paused.resume_state.stage_caches.items()}
        return paused, {"paused": paused.paused, "slices": slices,
                        "live": len(paused.resume_state.live_groups()),
                        "stores": pipe.call_ranks(held_keys)}

    for overlap in (True, False):
        paused, rec = pause()
        out["same", overlap] = dict(drill(pipe.resume(paused.resume_state, overlap=overlap)),
                                    parked=rec)
    paused, rec = pause()
    rs = rescale_serving(pipe, cfg, shape, plan, new_chips=8, stg=stg, periods_per_stage=2,
                         max_tp=4)
    res = rs.pipe.resume(paused.resume_state)
    out["pps2"] = dict(drill(res, rs.pipe), parked=rec, stages=rs.pipe.stage_names,
                       ranks=rs.pipe.stage_ranks, weights_moved=rs.pipe.weights_moved,
                       succ_stores=rs.pipe.call_ranks(held_keys))
    rs.pipe.close()
    # (f)
    paused, rec = pause()
    rs = rescale_serving(pipe, cfg, shape, plan, new_chips=6, stg=stg,
                         measured_ratio={"blocks00": 2.0}, devices=[0, 1, 2], max_tp=4)
    res = rs.pipe.resume(paused.resume_state)
    out["f"] = dict(drill(res, rs.pipe), parked=rec, chips=rs.plan.total_chips,
                    old_chips=plan.total_chips, summary=rs.summary(),
                    ranks=rs.pipe.stage_ranks, spans=rs.pipe.period_span,
                    pool=list(rs.pipe.pool.ranks), weights_moved=rs.pipe.weights_moved,
                    weights_held=rs.pipe.weights_held, digests=rs.pipe.call_ranks(_digests),
                    old_held=pipe.call_ranks(_held), succ_stores=rs.pipe.call_ranks(held_keys))
    rs.pipe.close()
    pipe.close()
    whole = bridge.from_jax(cfg, tree, device="cpu")
    out["whole"] = _digests(type("P", (), {"cfg": cfg, "params": whole})())
    return out


def _fused(rank, pool, payload):
    """(g): ``("embed", "blocks00")`` fused, its replicas pooled from its
    members' slices (ranks 0 and 1), float32 on the JAX package's weights."""
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.failures import ReplicaFaultPlan
    from repro_torch.runtime.pipeline import DecodePipeline, Tracer
    tiny, tree = _f32_tiny(), payload["tree"]
    shape = ShapeCfg(*FUSION_SHAPE)
    plan = planner.plan(tiny, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(tiny, shape, max_tp=4)
    pipe = DecodePipeline(tiny, stg, plan, devices=pool, fusion_plan=FUSION, params=lambda keep:
                          bridge.from_jax(tiny, tree, device="cpu", keep=keep))
    if rank != 0:
        pipe.work()
        return {}
    prompts = _prompts(tiny.vocab, 8, 0)
    ref = pipe.serve(prompts, 12, group_size=4)
    inj, tr = ReplicaFaultPlan.parse("embed+blocks00:r1@tok6=crash"), Tracer()
    res = pipe.serve(prompts, 12, group_size=4, injector=inj, tracer=tr)
    out = {"ranks": pipe.stage_ranks[0], "names": pipe.stage_names, "fired": inj.fired,
           "tokens": res.tokens, "tokens_equal": res.tokens == ref.tokens,
           "failovers": _failovers(res),
           "traced": [f[0] for f in tr.failovers], "late": pipe.compile_stats.late,
           "stores": pipe.call_ranks(held_keys)}
    pipe.close()
    one = DecodePipeline(tiny, stg, plan, device="cpu",
                         params=bridge.from_jax(tiny, tree, device="cpu"))
    out["one_equal"] = one.serve(prompts, 12, group_size=4).tokens == ref.tokens
    one.close()
    return out


def _lm(rank, pool):
    """(h): `LMPipeline` of ``tiny6`` over the 4 ranks, a stage a layer."""
    import torch

    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.failures import (PipelineFailure, ReplicaFaultPlan,
                                              ReplicaFaultSpec)
    from repro_torch.runtime.pipeline import LMPipeline, Tracer
    cfg = _tiny6()
    stg, _ = lm_graph.build_stg(cfg, ShapeCfg("pipe_fault", 16, 8, "train"), max_tp=4)
    pipe = LMPipeline(cfg, stg, Selection.smallest(stg), devices=pool, seed=0)
    if rank != 0:
        pipe.work()
        return {}
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32) for _ in range(4)]
    clean = pipe.run(mbs, train=True, loss_fn=_loss)
    target = pipe.stages[1].name
    inj = ReplicaFaultPlan(faults=[ReplicaFaultSpec(target, 0, at=2)])
    try:
        pipe.run(mbs, train=True, loss_fn=_loss, injector=inj)
        raised = None
    except PipelineFailure as e:
        raised = {"stage": e.stage, "replica": e.replica, "message": str(e),
                  "keys": sorted(e.diagnostics)}
    escalated = pipe.call_ranks(held_keys)
    again = pipe.run(mbs, train=True, loss_fn=_loss)
    stall_stage, tr = pipe.stages[2], Tracer()
    inj = ReplicaFaultPlan.parse(f"{stall_stage.name}:r0@op1=stall:0.05x4")
    stalled = pipe.run(mbs, train=True, loss_fn=_loss, injector=inj, tracer=tr)

    def same(run):
        leaves = [n + "." + k for n, tree in clean.grads.items()
                  for k, g in bridge.flat_tree(tree).items()
                  if not torch.equal(g, bridge.flat_tree(run.grads[n])[k])]
        return run.losses == clean.losses and not leaves
    out = {"target": target, "raised": raised, "escalated": escalated,
           "again_bitwise": same(again), "stall_bitwise": same(stalled),
           "stall_fired": inj.fired, "stall_rank": stall_stage.ranks[0][0],
           "stall_stage": stall_stage.name,
           "stage_host_s": {f"{s}@{r}": v for (s, r), v in tr.rank_host_s.items()},
           "late": pipe.compile_stats.late, "stores": pipe.call_ranks(held_keys)}
    pipe.close()
    return out


# -- the spawn ------------------------------------------------------------------
def _recording(real, logits_of):
    def sample(logits, gid, temperature=None):
        if gid >= 0:                     # warm-up samples as gid -1
            logits_of.setdefault(gid, []).append(np.asarray(logits, np.float32)[:, -1])
        return real(logits, gid, temperature)
    return sample


def _jax_serve(jpipe, call) -> dict:
    """``call()`` (a serve or a resume of ``jpipe``, the JAX pipeline) with
    its sampler recorded: the tokens, the failovers, and each request's
    top-2 margin at each step (request ``4 * gid + i``: groups of 4)."""
    logits, real = {}, jpipe._sample
    jpipe._sample = _recording(real, logits)
    try:
        res = call()
    finally:
        jpipe._sample = real
    margins = {}
    for gid, steps in logits.items():
        top2 = [np.sort(s, axis=-1)[:, -2:] for s in steps]
        for i in range(len(steps[0])):
            margins[4 * gid + i] = [float(t[i, 1] - t[i, 0]) for t in top2]
    return {"tokens": res.tokens, "margins": margins,
            "failovers": [{k: f[k] for k in FAILOVER_KEYS} for f in res.failovers]}


def _jax_drills(jcfg, tree, dev) -> dict:
    """The JAX `DecodePipeline(impl="ref")` doing (e)-(g) on the same
    weights and requests: the uninterrupted serve (its margins), a pause
    resumed on the same pipeline, on a successor at
    ``periods_per_stage=2`` and on `rescale_serving`'s at 6 chips; the
    fused pipeline's uninterrupted serve and crash."""
    import jax

    from repro.configs.base import ShapeCfg as JaxShapeCfg
    from repro.core import planner as jax_planner
    from repro.graphs import lm_graph as jax_lm_graph
    from repro.runtime.elastic import rescale_serving as jax_rescale_serving
    from repro.runtime.failures import ReplicaFaultPlan as JaxReplicaFaultPlan
    from repro.runtime.pipeline import DecodePipeline as JaxDecodePipeline
    params = jax.tree.map(jax.numpy.asarray, tree)
    out = {}
    shape = JaxShapeCfg(*PAUSE_SHAPE)
    plan = jax_planner.plan(jcfg, shape, chips=8, max_tp=4)
    stg, _ = jax_lm_graph.build_stg(jcfg, shape, max_tp=4)
    jp = JaxDecodePipeline(jcfg, stg, plan, params=params, impl="ref", devices=dev)
    prompts = _prompts(jcfg.vocab, 8, 1)
    out["pause ref"] = _jax_serve(jp, lambda: jp.serve(prompts, 12, group_size=4))

    def pause():
        return jp.serve(prompts, 12, group_size=4, pause_after_tokens=3).resume_state

    state = pause()
    out["same"] = jp.resume(state).tokens
    for label, kw in (("pps2", {"new_chips": 8, "periods_per_stage": 2}),
                      ("f", {"new_chips": 6, "measured_ratio": {"blocks00": 2.0}})):
        state = pause()
        rs = jax_rescale_serving(jp, jcfg, shape, plan, stg=stg, devices=dev, **kw)
        out[label] = rs.pipe.resume(state).tokens
    shape = JaxShapeCfg(*FUSION_SHAPE)
    plan = jax_planner.plan(jcfg, shape, chips=8, max_tp=4)
    stg, _ = jax_lm_graph.build_stg(jcfg, shape, max_tp=4)
    fp = JaxDecodePipeline(jcfg, stg, plan, params=params, impl="ref", devices=dev,
                           fusion_plan=list(FUSION))
    prompts = _prompts(jcfg.vocab, 8, 0)
    out["fused ref"] = _jax_serve(fp, lambda: fp.serve(prompts, 12, group_size=4))
    out["fused"] = _jax_serve(fp, lambda: fp.serve(
        prompts, 12, group_size=4, injector=JaxReplicaFaultPlan.parse(
            "embed+blocks00:r1@tok6=crash")))
    return out


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The JAX oracles, then the 4 ranks: rank 0's results with the JAX
    package's under ``"jax"``, and the other ranks' under ``"others"``."""
    import jax

    from repro.configs.base import ShapeCfg as JaxShapeCfg
    from repro.configs.tiny import CONFIG as jax_tiny
    from repro.core import planner as jax_planner
    from repro.graphs import lm_graph as jax_lm_graph
    from repro.models import lm as jax_lm
    from repro.runtime.failures import ReplicaFaultPlan as JaxReplicaFaultPlan
    from repro.runtime.pipeline import DecodePipeline as JaxDecodePipeline
    from repro.runtime.pipeline import as_selection as jax_as_selection
    jcfg = dataclasses.replace(jax_tiny, compute_dtype="float32")
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    dev = jax.devices()[:1]
    shape = JaxShapeCfg(*SHAPE)
    plan = jax_planner.plan(jcfg, shape, chips=8, max_tp=4)
    stg, _ = jax_lm_graph.build_stg(jcfg, shape, max_tp=4)
    sel = _force_two_on_first_period(stg, jax_as_selection(plan), len(jcfg.block_pattern))
    jpipe = JaxDecodePipeline(jcfg, stg, sel, params=jax.tree.map(jax.numpy.asarray, tree),
                              impl="ref", devices=dev)
    prompts = _prompts(jcfg.vocab, 8, 0)
    jx = {spec: _jax_serve(jpipe, lambda: jpipe.serve(
        prompts, 12, group_size=4, overlap=False, injector=JaxReplicaFaultPlan.parse(spec)))
        for spec in SPECS}
    jx.update(_jax_drills(jcfg, tree, dev))
    ranks = _spawn(tmp_path_factory.mktemp("drills"), 4, _ranks4, {"tree": tree})
    return dict(ranks[0], jax=jx, others=ranks[1:])


def _tie_breaks(got: list, want: list, margins: dict) -> list:
    """The requests whose tokens differ from ``want``'s other than at a
    step where the JAX pipeline's top-2 margin is under ``TIE`` (a near
    tie either side may break), as (request, first differing step)."""
    bad = [] if len(got) == len(want) else [("requests", len(got))]
    for r, (g, w) in enumerate(zip(got, want)):
        diff = [t for t, (a, b) in enumerate(zip(g, w)) if a != b]
        if diff and not margins[r][diff[0]] < TIE:
            bad.append((r, diff[0]))
        elif not diff and len(g) != len(w):
            bad.append((r, min(len(g), len(w))))
    return bad


def _empty(stores: dict) -> bool:
    return all(not v["store"] and not v["parked"] for v in stores.values())


# -- (a) ----------------------------------------------------------------------------
def test_the_two_replicas_of_blocks00_are_on_two_ranks(drills):
    c = drills["chaos"]
    b0 = c["ranks"][c["names"].index("blocks00")]
    assert len(b0) == 2 and len(set(b0)) == 2
    assert c["ref"] == drills["chaos"]["one"]["ref"]
    for rank, other in enumerate([c] + drills["others"]):
        mine = {n for n, rs in zip(c["names"], c["ranks"]) if rank in rs}
        held = set(other["chaos"]["held"] if rank else c["held"])
        assert ({f"layers.{i}" for i in range(4)} & held) == {
            f"layers.{int(n[6:])}" for n in mine if n.startswith("blocks")}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("spec", SPECS)
def test_crash_over_ranks_keeps_the_tokens(drills, spec, overlap):
    c = drills["chaos"]
    a = c["a"][spec, overlap]
    assert a["fired"] == 1 and a["late"] == 0
    assert a["tokens"] == c["ref"] == c["one"]["ref"]
    assert len(a["failovers"]) == 1 and a["failovers"][0]["stage"] == "blocks00"
    assert a["failovers"][0]["kind"] == "crash" and a["recovery_s"][0] >= 0.0
    assert a["traced"] == ["blocks00"] and a["counted"] == 1
    assert _empty(c["stores"]["a", spec, overlap])


@pytest.mark.parametrize("spec", SPECS)
def test_serial_failover_is_the_one_rank_ports_and_the_jax_pipelines(drills, spec):
    c, jx = drills["chaos"], drills["jax"][spec]
    got = c["a"][spec, False]
    assert got["failovers"] == c["one"][spec]["failovers"] == jx["failovers"]
    assert got["tokens"] == c["one"][spec]["tokens"]
    assert not _tie_breaks(got["tokens"], jx["tokens"], jx["margins"])


# -- (b), (c) ---------------------------------------------------------------------
def test_an_op_lost_in_flight_is_redone_from_its_producers_rank(drills):
    c = drills["chaos"]
    b = c["b"]
    assert b["fired"] == 2 and b["replayed"] == [1]
    assert b["tokens_equal"] and b["late"] == 0
    embed_rank = c["ranks"][c["names"].index("embed")][0]
    # the redo's input and the replay's prefill went again from the embed's rank
    assert b["sent"][embed_rank] > b["ref_sent"][embed_rank]
    assert _empty(c["stores"]["b"])


def test_the_lone_embed_replicas_crash_escalates_and_the_pool_serves_again(drills):
    c = drills["chaos"]["c"]
    assert c["raised"] is not None
    assert (c["raised"]["stage"], c["raised"]["replica"]) == ("embed", 0)
    for key in ("fifo_occupancy", "waiting", "schedule", "reorder_occupancy", "lost_ops",
                "failovers", "static_preflight"):
        assert key in c["raised"]["keys"], key
    assert c["raised"]["plan"].startswith("decode plan")
    assert _empty(drills["chaos"]["stores"]["c escalated"])
    assert c["again"] and _empty(drills["chaos"]["stores"]["c"])


def test_a_ranks_error_while_a_failed_run_drains_is_raised(drills):
    """A command that raised on rank 1 while the controller waited a failed
    run's commands home is raised, caused by the `PipelineFailure`; every
    rank's store emptied all the same."""
    c = drills["chaos"]
    assert c["drain_error"] == {"rank": 1, "what": "a bad command",
                                "cause": "PipelineFailure"}
    assert _empty(c["stores"]["drain error"])


# -- (d) ----------------------------------------------------------------------------
def test_a_stall_over_ranks_drives_a_migration_rank_to_rank(drills):
    c = drills["chaos"]
    d = c["d"]
    assert d["tokens_equal"] and d["late"] == 0
    assert d["flagged"] == [("blocks00", 0)]
    assert d["migrations"] >= 1 and d["moved"]
    ranks = c["ranks"][c["names"].index("blocks00")]
    for m in d["moved"]:
        assert (m["from_rank"], m["to_rank"]) == (ranks[m["from"]], ranks[m["to"]])
    away = [m for m in d["moved"] if m["from_rank"] != m["to_rank"]]
    assert away and all(m["bytes"] > 0 for m in away)
    src = away[0]["from_rank"]
    moved = sum(m["bytes"] for m in away if m["from_rank"] == src)
    # the slices the source rank sent, counted in what it sent
    assert d["costs"][src]["bytes_sent"] >= d["costs"][src]["bytes_moved"] >= moved
    assert d["ref_costs"][src]["bytes_moved"] == 0
    assert d["advice"]["blocks00"] > 1.5 and d["replanned"]
    assert set(d["fanned"]) == {"block00"}
    ratios = d["ratios"]
    assert ratios and all(np.isfinite(v) and v > 0 for v in ratios.values()), ratios
    assert d["measured_choices"] > 0
    assert _empty(c["stores"]["d"])


def test_the_stall_sleeps_on_the_replicas_rank(drills):
    """Each stalled op's sleep is in its rank's host seconds for the stage
    (each rank's report of the op), and each rank's report says what it
    slept: the replica's rank all of it, the controller's rank none."""
    c = drills["chaos"]
    d = c["d"]
    r0_rank = c["ranks"][c["names"].index("blocks00")][0]
    slept = STALL_S * d["fired"]
    assert d["fired"] >= 2 and r0_rank != 0
    assert d["stage_host_s"][f"blocks00@{r0_rank}"] >= slept, d["stage_host_s"]
    assert d["costs"][0]["stall_s"] == 0.0
    assert d["costs"][r0_rank]["stall_s"] == pytest.approx(slept, rel=1e-12)
    assert sum(c["stall_s"] for c in d["costs"].values()) == pytest.approx(slept, rel=1e-12)


# -- (e), (f) -----------------------------------------------------------------------
@pytest.mark.parametrize("overlap", [True, False])
def test_pause_resume_on_the_same_pool(drills, overlap):
    e = drills["pause"]["same", overlap]
    parked = e["parked"]
    assert parked["paused"] and parked["live"]
    # paused: each rank holds its parked slices and nothing else
    for rank, held in parked["stores"].items():
        n = sum(1 for sl in parked["slices"].values() for r in sl.values() if r == rank)
        assert not held["store"] and len(held["parked"]) == n, (rank, held)
    assert e["tokens_equal"] and not e["paused"] and e["late"] == 0
    assert e["adopted"]["moved"] and not e["adopted"]["replayed"]
    assert all(m["from_rank"] == m["to_rank"] for m in e["adopted"]["moved"])
    assert _empty(e["stores"])
    jx = drills["jax"]
    assert not _tie_breaks(e["tokens"], jx["same"], jx["pause ref"]["margins"])
    assert not _tie_breaks(drills["pause"]["ref"], jx["pause ref"]["tokens"],
                           jx["pause ref"]["margins"])


def test_pause_resume_on_a_successor_with_other_spans_replays(drills):
    e = drills["pause"]["pps2"]
    assert e["stages"] == ["embed", "blocks00", "blocks01", "head"]
    assert e["tokens_equal"] and e["late"] == 0
    assert e["adopted"]["replayed"] and not e["adopted"]["moved"]
    assert e["weights_moved"], "a successor rank lacked no weight"
    assert _empty(e["stores"]) and _empty(e["succ_stores"])
    jx = drills["jax"]
    assert not _tie_breaks(e["tokens"], jx["pps2"], jx["pause ref"]["margins"])


def test_rescale_serving_onto_three_of_the_ranks(drills):
    p = drills["pause"]
    f = p["f"]
    assert f["pool"] == [0, 1, 2] and f["chips"] <= f["old_chips"] and "rescale" in f["summary"]
    assert {r for rs in f["ranks"] for r in rs} <= {0, 1, 2}
    assert f["tokens_equal"] and f["late"] == 0
    moved = [m for m in f["adopted"]["moved"] if m["from_rank"] != m["to_rank"]]
    assert moved and all(m["bytes"] > 0 for m in moved)
    if f["spans"] != p["spans"]:
        assert f["adopted"]["replayed"]
    assert f["weights_moved"]
    for rank, digests in f["digests"].items():
        assert digests and all(p["whole"][n] == h for n, h in digests.items()), rank
    assert f["old_held"][3] == [] and drills["others"][2]["pause"]["after"] == []
    assert _empty(f["stores"]) and _empty(f["succ_stores"])
    jx = drills["jax"]
    assert not _tie_breaks(f["tokens"], jx["f"], jx["pause ref"]["margins"])


# -- (g), (h) -----------------------------------------------------------------------
def test_a_fused_groups_failover_over_ranks(drills):
    g = drills["fused"]
    assert g["names"][0] == "embed+blocks00" and len(set(g["ranks"])) >= 2
    assert g["fired"] == 1 and g["tokens_equal"] and g["one_equal"] and g["late"] == 0
    assert len(g["failovers"]) == 1 and g["failovers"][0]["stage"] == "embed+blocks00"
    assert g["traced"] == ["embed+blocks00"]
    assert _empty(g["stores"])
    jx, ref = drills["jax"]["fused"], drills["jax"]["fused ref"]
    kept = FAILOVER_KEYS[:3]            # overlapped: the lost ops are timing's
    assert ([{k: f[k] for k in kept} for f in g["failovers"]]
            == [{k: f[k] for k in kept} for f in jx["failovers"]])
    assert not _tie_breaks(g["tokens"], jx["tokens"], ref["margins"])


def test_training_over_ranks_escalates_and_runs_again_bitwise(drills):
    h = drills["lm"]
    assert h["raised"] is not None
    assert (h["raised"]["stage"], h["raised"]["replica"]) == (h["target"], 0)
    assert "no failover hook" in h["raised"]["message"]
    assert {"schedule", "lost_ops", "fifo_occupancy"} <= set(h["raised"]["keys"])
    assert _empty(h["escalated"])
    assert h["again_bitwise"] and h["late"] == 0
    assert _empty(h["stores"])


def test_a_training_stall_sleeps_on_its_stages_rank(drills):
    h = drills["lm"]
    assert h["stall_fired"] == 4 and h["stall_bitwise"] and h["stall_rank"] != 0
    stage = h["stall_stage"]
    assert h["stage_host_s"][f"{stage}@{h['stall_rank']}"] >= 0.05 * 4, h["stage_host_s"]
    assert not any(k.startswith(f"{stage}@") and k != f"{stage}@{h['stall_rank']}"
                   for k in h["stage_host_s"])
