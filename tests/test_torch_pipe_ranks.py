"""The pipelines over ranks (`runtime.pipeline.remote`) on the CPU, over gloo:
a process a rank, each rank standing for one JAX device, as the JAX
package's 8-device tests run its single-controller pipelines.

One spawn of 4 ranks (`test_torch_distributed._spawn`, a module fixture)
runs every case below on a pool of the 4 ranks (every receive within
``POOL_TIMEOUT_S``); each rank returns what it measured, and the tests
read it.  The JAX oracles run in this process before the spawn; the ranks
import no JAX.

  (a) ``tiny`` at 6 layers, `Selection.smallest`: 8 stages spread over the
      4 ranks, the weights the JAX pipeline's (each rank fills only its
      stages, `bridge.stages_from_jax(stages=)`); 1F1B and
      ``interleaved_1f1b(4, 8, 2)`` (traced: each op's rank in the
      controller's trace) and serial (``overlap=False``) losses and
      gradients bitwise the one-rank port pipeline's (computed inside rank
      0), the fill-drain
      serve's logits bitwise its ``reference()``; against the JAX
      `LMPipeline` (kernels on their oracles) within the tolerances of
      ``tests/test_torch_lm_pipeline.py`` (``INTERLEAVED_PARITY_OK``'s
      counterpart);
  (b) a tp-2 ``block00`` on the JAX pipeline's weights for that plan: its
      parameters DTensors split over its two ranks, the outputs within
      ``atol=0.08, rtol=0.05`` of one rank and of the JAX `LMPipeline`'s
      (``TPSHARD_OK``), the losses within 2e-3 relative and each gradient
      leaf within 5e-2 of one rank's and of the JAX pipeline's norm (bf16
      activations summed over two shards in another order: up to 2.1% seen
      against one rank);
  (c) ``block01`` with 2 replicas on 2 ranks: gradients bitwise the
      one-rank oracle's, so the cross-rank fold keeps microbatch order;
      and ``embed`` fused with ``block00``, the group's replicas pooled over
      its members' ranks, each holding both members (a tp-sharded member
      is refused, as in the JAX package);
  (d) `DecodePipeline` over the 4 ranks, ``tiny``, 12 requests: tokens
      identical to the one-device `LMServer`'s, and to the JAX server's up
      to a step whose top-2 margin is under ``TIE`` (the rule of
      ``tests/test_torch_server.py``) (``DECODE_PARITY_OK``'s counterpart);
  (e) mamba2-370m ``reduced()`` over a pool of 2 of the ranks, weights
      from the seed: tokens identical to the one-device server's, and each
      rank holding only its stages' weights;
  (f) a worker that raises: rank 0 raises `RankFailure` within the time
      limit, naming the rank and the op;
  (g) a pool of several ranks with no process group raises.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from test_torch_distributed import _spawn

POOL_TIMEOUT_S = 30.0
TPSHARD = dict(atol=0.08, rtol=0.05)
# (a): the tolerances of tests/test_torch_lm_pipeline.py's tiny6 JAX parity
LOGIT, LOSS, GRAD = 3e-2, 2e-3, 5e-2
TP_LOSS, TP_GRAD = 2e-3, 5e-2


def _loss(lg):
    return torch.mean(lg.float() ** 2)


def _tiny6():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("tiny"), name="tiny6", n_layers=6)


def _f32(name):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg if name == "tiny" else cfg.reduced(),
                               compute_dtype="float32")


def _tokens(seed, n, vocab, batch=2, seq=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (batch, seq)).astype(np.int32) for _ in range(n)]


def _requests(vocab, n, seed, lo, hi, max_new):
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(2, vocab, rng.integers(lo, hi)).tolist(),
                    max_new=max_new) for i in range(n)]


def _equal_trees(a: dict, b: dict) -> list:
    """The leaves where two gradient trees differ bitwise ([] when none)."""
    from repro_torch import bridge
    la, lb = bridge.flat_tree(a), bridge.flat_tree(b)
    assert la.keys() == lb.keys()
    return [k for k in la if not torch.equal(la[k], lb[k])]


# -- the ranks' cases -----------------------------------------------------------
def _ranks4(rank, world, payload):
    from repro_torch.launch.mesh import rank_pool
    pool = rank_pool(device="cpu", timeout_s=POOL_TIMEOUT_S)
    pair = rank_pool([0, 1], device="cpu", timeout_s=POOL_TIMEOUT_S)
    return {"a": _schedules(rank, pool, payload), "b": _tp2(rank, pool, payload),
            "c": _replicated(rank, pool), "fused": _fused(rank, pool),
            "d": _decode(rank, pool, payload),
            "e": _mamba(rank, pair) if rank in pair.ranks else None,
            "f": _raising(rank, pool)}


def _schedules(rank, pool, payload):
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import (LMPipeline, Tracer, interleaved_1f1b,
                                              registry_from_trace)
    cfg = _tiny6()
    stg, _ = lm_graph.build_stg(cfg, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    sel, tree = Selection.smallest(stg), payload["stages"]
    pipe = LMPipeline(cfg, stg, sel, devices=pool, params=lambda names: bridge.stages_from_jax(
        cfg, tree, device="cpu", stages=names))
    held = sorted(pipe.modules)
    if rank != 0:
        pipe.work()
        return {"held": held}
    mbs, tracer = payload["mbs"], Tracer()
    runs = {"1f1b": pipe.run(mbs, train=True, loss_fn=_loss),
            "interleaved": pipe.run(mbs, train=True, loss_fn=_loss, tracer=tracer,
                                    schedule=interleaved_1f1b(4, 8, 2)),
            "serial": pipe.run(mbs, train=True, loss_fn=_loss, overlap=False)}
    serve = pipe.run(mbs)
    out = {"held": held, "ranks": [st.ranks for st in pipe.stages],
           "late": pipe.compile_stats.late, "checks": pipe.last_preflight.checks,
           "costs": runs["1f1b"].ranks, "streams": runs["1f1b"].streams_used,
           "traced_ranks": sorted(set(tracer.rank_of.values())),
           "rank_host_s": sorted(lab["rank"] for lab, _ in
                                 registry_from_trace(tracer).find("pipeline.rank_host_s"))}
    pipe.close()
    one = LMPipeline(cfg, stg, sel, device="cpu",
                     params=bridge.stages_from_jax(cfg, tree, device="cpu"))
    grads, losses = one.sequential(mbs, loss_fn=_loss)
    want = one.reference(mbs)
    one.close()
    out["differ"] = {k: (r.losses != losses, _equal_trees(r.grads, grads))
                     for k, r in runs.items()}
    out["serve_differ"] = [i for i, (a, b) in enumerate(zip(serve.outputs, want))
                           if not torch.equal(a, b)]
    out["losses"] = runs["1f1b"].losses
    out["grads"] = {n: bridge.flat_tree(t) for n, t in runs["1f1b"].grads.items()}
    out["outputs"] = [o.numpy() for o in serve.outputs]
    return out


def _tp2(rank, pool, payload):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import LMPipeline
    tiny = get_config("tiny")
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("parity", 16, 8, "serve"), max_tp=4)
    sel = Selection.smallest(stg).set("block00", "tp2", 1)
    try:                                       # as in the JAX package
        LMPipeline(tiny, stg, sel, devices=pool,
                   fusion_plan=[("embed", "block00"), ("block01",), ("block02",),
                                ("block03",), ("head",)])
        fuse_refused = None
    except ValueError as e:
        fuse_refused = str(e)
    tree = payload["tp2_stages"]
    pipe = LMPipeline(tiny, stg, sel, devices=pool, params=lambda names: bridge.stages_from_jax(
        tiny, tree, device="cpu", stages=names))
    b0 = next(st for st in pipe.stages if st.name == "block00")
    sharded = 0 if b0.module is None else sum(
        1 for p in b0.module.parameters()
        if hasattr(p, "placements") and any(pl.is_shard() for pl in p.placements)
        and p.device_mesh.size() == 2)
    if rank != 0:
        pipe.work()
        return {"sharded": sharded}
    mbs = payload["tp2_mbs"]
    served, trained = pipe.run(mbs).outputs, pipe.run(mbs, train=True, loss_fn=_loss)
    late = pipe.compile_stats.late
    pipe.close()
    one = LMPipeline(tiny, stg, sel, device="cpu",
                     params=bridge.stages_from_jax(tiny, tree, device="cpu"))
    served1, trained1 = one.run(mbs).outputs, one.run(mbs, train=True, loss_fn=_loss)
    one.close()
    rel = {}
    for n, tree in trained1.grads.items():
        got = bridge.flat_tree(trained.grads[n])
        for k, g in bridge.flat_tree(tree).items():
            rel[f"{n}.{k}"] = float((got[k] - g).norm() / g.norm().clamp_min(1e-30))
    return {"sharded": sharded, "slice": b0.ranks, "late": late, "fuse_refused": fuse_refused,
            "out": [o.float().numpy() for o in served],
            "out1": [o.float().numpy() for o in served1],
            "losses": trained.losses, "losses1": trained1.losses, "grad_rel": rel,
            "grads": {n: bridge.flat_tree(t) for n, t in trained.grads.items()}}


def _fused(rank, pool):
    """``embed`` fused with ``block00``: the group's replicas pool its two
    members' slices (ranks 0 and 1), each holding both members' weights."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import LMPipeline
    tiny = get_config("tiny")
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    sel = Selection.smallest(stg)
    plan = [("embed", "block00"), ("block01",), ("block02",), ("block03", "head")]
    pipe = LMPipeline(tiny, stg, sel, devices=pool, fusion_plan=plan)
    held = sorted(pipe.modules)
    if rank != 0:
        pipe.work()
        return {"held": held}
    mbs = _tokens(9, 4, tiny.vocab)
    run = pipe.run(mbs, train=True, loss_fn=_loss)
    slices = [st.ranks for st in pipe.stages]
    pipe.close()
    one = LMPipeline(tiny, stg, sel, device="cpu", fusion_plan=plan)
    grads, losses = one.sequential(mbs, loss_fn=_loss)
    one.close()
    return {"held": held, "slices": slices, "losses_differ": run.losses != losses,
            "differ": _equal_trees(run.grads, grads)}


def _replicated(rank, pool):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import LMPipeline
    tiny = get_config("tiny")
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    base = Selection.smallest(stg)
    sel = base.set("block01", base.choices["block01"][0], 2)
    pipe = LMPipeline(tiny, stg, sel, devices=pool)
    if rank != 0:
        pipe.work()
        return {}
    mbs = _tokens(7, 6, tiny.vocab)
    run = pipe.run(mbs, train=True, loss_fn=_loss)
    slices = next(st.ranks for st in pipe.stages if st.name == "block01")
    pipe.close()
    one = LMPipeline(tiny, stg, sel, device="cpu")
    grads, losses = one.sequential(mbs, loss_fn=_loss)
    one.close()
    return {"slices": slices, "losses_differ": run.losses != losses,
            "differ": _equal_trees(run.grads, grads)}


def _decode(rank, pool, payload):
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer
    cfg = _f32("tiny")
    shape = ShapeCfg("decode_par", 64, 16, "decode")
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    model = bridge.from_jax(cfg, payload["lm"], device="cpu")
    pipe = DecodePipeline(cfg, stg, plan, devices=pool, params=model)
    if rank != 0:
        pipe.work()
        return {}
    reqs = _requests(cfg.vocab, 12, 3, 4, 20, 10)
    srv = LMServer(cfg, max_batch=4, pipeline=pipe, device="cpu")
    got = srv.serve(reqs)
    out = {"ranks": pipe.stage_ranks, "late": pipe.compile_stats.late,
           "costs": srv.last_run.ranks, "checks": pipe.last_preflight.checks}
    pipe.close()
    want = LMServer(cfg, max_batch=4, params=model, device="cpu").serve(reqs)
    out.update(tokens=[c.tokens for c in got], want=[c.tokens for c in want])
    return out


def _mamba(rank, pool):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer
    cfg = _f32("mamba2-370m")
    shape = ShapeCfg("decode_test", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=4, max_tp=1)    # tp 1: the stages spread
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=1)
    pipe = DecodePipeline(cfg, stg, plan, devices=pool, seed=0)
    held = {"layers": [i for i, layer in enumerate(pipe.params.layers)
                       if next(layer.parameters()).device.type != "meta"],
            "embed": pipe.params.embed.device.type != "meta",
            "head": pipe.params.final_norm.device.type != "meta"}
    if rank != 0:
        pipe.work()
        return {"held": held}
    reqs = _requests(cfg.vocab, 8, 5, 3, 20, 6)
    got = LMServer(cfg, max_batch=4, pipeline=pipe, device="cpu").serve(reqs)
    ranks, late = pipe.stage_ranks, pipe.compile_stats.late
    pipe.close()
    want = LMServer(cfg, max_batch=4, seed=0, device="cpu").serve(reqs)
    return {"held": held, "ranks": ranks, "names": pipe.stage_names, "late": late,
            "tokens": [c.tokens for c in got], "want": [c.tokens for c in want]}


def _boom(*a, **kw):
    raise RuntimeError("a stage that fails on purpose")


def _raising(rank, pool):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.runtime.pipeline import LMPipeline, RankFailure
    tiny = get_config("tiny")
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    pipe = LMPipeline(tiny, stg, Selection.smallest(stg), devices=pool, warmup=False)
    if rank == 2:
        for st in pipe.stages:
            if st.module is not None:
                st.module.forward = _boom
    if rank != 0:
        pipe.work()
        return {}
    stage = next(st.name for st in pipe.stages if 2 in st.ranks[0])
    t0 = time.perf_counter()
    try:
        pipe.run(_tokens(1, 4, tiny.vocab), train=True, loss_fn=_loss)
        raised = None
    except RankFailure as e:
        raised = {"rank": e.rank, "what": e.what, "message": str(e)[:400]}
    seconds = time.perf_counter() - t0
    pipe.close()
    return {"raised": raised, "seconds": seconds, "stage": stage}


# -- the spawn ------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """The JAX oracles, then the 4 ranks: [rank 0's results, ...]."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeCfg as JaxShapeCfg
    from repro.core.stg import Selection as JaxSelection
    from repro.graphs import lm_graph as jax_lm_graph
    from repro.kernels import ops as jax_ops
    from repro.runtime.pipeline import LMPipeline as JaxLMPipeline
    from repro.runtime.server import LMServer as JaxServer
    from repro.runtime.server import Request as JaxRequest
    saved = jax_ops._DEFAULT_IMPL
    jax_ops.set_default_impl("ref")
    try:
        jcfg = dataclasses.replace(jax_get_config("tiny"), n_layers=6)
        jstg, _ = jax_lm_graph.build_stg(jcfg, JaxShapeCfg("parity", 16, 8, "train"), max_tp=4)
        jpipe = JaxLMPipeline(jcfg, jstg, JaxSelection.smallest(jstg))
        stages = {st.name: jax.tree.map(np.asarray, st.params[0]) for st in jpipe.stages}
        mbs = _tokens(5, 8, jcfg.vocab)
        jserve = [np.asarray(o, np.float32) for o in jpipe.run(mbs).outputs]
        jtrain = jpipe.run(mbs, train=True,
                           loss_fn=lambda lg: jnp.mean(lg.astype(jnp.float32) ** 2))
        jgrads = {n: jax.tree.map(np.asarray, t) for n, t in jtrain.grads.items()}
        # (b): the tp-2 plan on the one JAX device of this process, which
        # runs the slice's stage unsharded (the one-device math)
        bcfg = jax_get_config("tiny")
        bstg, _ = jax_lm_graph.build_stg(bcfg, JaxShapeCfg("parity", 16, 8, "serve"), max_tp=4)
        bpipe = JaxLMPipeline(bcfg, bstg, JaxSelection.smallest(bstg).set("block00", "tp2", 1))
        b_stages = {st.name: jax.tree.map(np.asarray, st.params[0]) for st in bpipe.stages}
        bmbs = _tokens(0, 5, bcfg.vocab)
        bserve = [np.asarray(o, np.float32) for o in bpipe.run(bmbs).outputs]
        btrain = bpipe.run(bmbs, train=True,
                           loss_fn=lambda lg: jnp.mean(lg.astype(jnp.float32) ** 2))
        bgrads = {n: jax.tree.map(np.asarray, t) for n, t in btrain.grads.items()}
        scfg = dataclasses.replace(jax_get_config("tiny"), compute_dtype="float32")
        jsrv = JaxServer(scfg, max_batch=4, seed=0, impl="ref")
        reqs = _requests(scfg.vocab, 12, 3, 4, 20, 10)
        jtokens = [c.tokens for c in jsrv.serve([JaxRequest(r.uid, r.prompt, r.max_new)
                                                 for r in reqs])]
        lm_tree = jax.tree.map(np.array, jsrv.params)
    finally:
        jax_ops.set_default_impl(saved)
    ranks = _spawn(tmp_path_factory.mktemp("ranks4"), 4, _ranks4,
                   {"stages": stages, "mbs": mbs, "lm": lm_tree, "tp2_stages": b_stages,
                    "tp2_mbs": bmbs})
    ranks[0]["jax"] = {"serve": jserve, "losses": dict(jtrain.losses), "grads": jgrads,
                       "tokens": jtokens, "lm": lm_tree, "requests": reqs,
                       "tp2": {"serve": bserve, "losses": dict(btrain.losses),
                               "grads": bgrads}}
    return ranks


# -- (a) ----------------------------------------------------------------------------
def test_stages_spread_over_the_ranks_each_holding_its_own(ranks4):
    a = ranks4[0]["a"]
    assert a["ranks"] == [[(r % 4,)] for r in range(8)]
    for rank, res in enumerate(ranks4):
        assert res["a"]["held"] == sorted(n for n, sl in zip(
            ["embed"] + [f"block{i:02d}" for i in range(6)] + ["head"], a["ranks"])
            if sl[0][0] == rank)
    assert a["late"] == 0 and "schedule-credits" in a["checks"]
    assert sorted(a["costs"]) == [0, 1, 2, 3]
    assert all(c["late"] == 0 and c["bytes_sent"] > 0 and c["host_s"] > 0
               for c in a["costs"].values())


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved", "serial"])
def test_training_over_ranks_is_bitwise_the_one_rank_pipeline(ranks4, schedule):
    losses_differ, leaves = ranks4[0]["a"]["differ"][schedule]
    assert not losses_differ and leaves == []


def test_serving_over_ranks_is_bitwise_the_reference(ranks4):
    assert ranks4[0]["a"]["serve_differ"] == []


def test_the_controllers_trace_names_the_rank_of_each_op(ranks4):
    a = ranks4[0]["a"]
    assert a["traced_ranks"] == [0, 1, 2, 3]
    assert sorted(set(a["rank_host_s"])) == ["0", "1", "2", "3"]


def test_pipeline_over_ranks_holds_to_the_jax_pipeline(ranks4):
    a, jx = ranks4[0]["a"], ranks4[0]["jax"]
    for got, want in zip(a["outputs"], jx["serve"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT * np.abs(want).max())
    assert a["losses"].keys() == jx["losses"].keys()
    for k, want in jx["losses"].items():
        assert a["losses"][k] == pytest.approx(want, rel=LOSS)
    from repro_torch import bridge
    for n, leaves in a["grads"].items():
        want = bridge.flat_tree(jx["grads"][n])
        assert leaves.keys() == want.keys(), n
        for k, g in leaves.items():
            w = want[k].astype(np.float32)
            assert np.linalg.norm(g.numpy() - w) <= GRAD * np.linalg.norm(w) + 1e-12, (n, k)


# -- (b) ----------------------------------------------------------------------------
def test_tp2_stage_shards_over_its_two_ranks(ranks4):
    b = ranks4[0]["b"]
    assert b["slice"] == [(1, 2)]
    assert ranks4[1]["b"]["sharded"] >= 4 and ranks4[2]["b"]["sharded"] >= 4
    assert ranks4[0]["b"]["sharded"] == ranks4[3]["b"]["sharded"] == 0


def test_tp2_stage_outputs_within_tpshard_of_one_rank(ranks4):
    b = ranks4[0]["b"]
    for got, want in zip(b["out"], b["out1"]):
        np.testing.assert_allclose(got, want, **TPSHARD)
    assert b["late"] == 0


def test_tp2_stage_training_within_tolerance_of_one_rank(ranks4):
    b = ranks4[0]["b"]
    for k, want in b["losses1"].items():
        assert b["losses"][k] == pytest.approx(want, rel=TP_LOSS)
    worst = max(b["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TP_GRAD, worst


def test_tp2_stage_outputs_within_tpshard_of_the_jax_pipeline(ranks4):
    b, jx = ranks4[0]["b"], ranks4[0]["jax"]["tp2"]
    assert len(b["out"]) == len(jx["serve"])
    for got, want in zip(b["out"], jx["serve"]):
        np.testing.assert_allclose(got, want, **TPSHARD)


def test_tp2_stage_training_holds_to_the_jax_pipeline(ranks4):
    from repro_torch import bridge
    b, jx = ranks4[0]["b"], ranks4[0]["jax"]["tp2"]
    assert b["losses"].keys() == jx["losses"].keys()
    for k, want in jx["losses"].items():
        assert b["losses"][k] == pytest.approx(want, rel=TP_LOSS)
    for n, leaves in b["grads"].items():
        want = bridge.flat_tree(jx["grads"][n])
        assert leaves.keys() == want.keys(), n
        for k, g in leaves.items():
            w = want[k].astype(np.float32)
            assert np.linalg.norm(g.numpy() - w) <= TP_GRAD * np.linalg.norm(w) + 1e-12, (n, k)


# -- (c) ----------------------------------------------------------------------------
def test_replicas_on_two_ranks_fold_in_microbatch_order(ranks4):
    c = ranks4[0]["c"]
    assert len(c["slices"]) == 2 and len({sl[0] for sl in c["slices"]}) == 2
    assert not c["losses_differ"] and c["differ"] == []


def test_a_fused_groups_replicas_pool_across_ranks(ranks4):
    f = ranks4[0]["fused"]
    assert f["slices"][0] == [(0,), (1,)]          # embed's slice, then block00's
    assert set(ranks4[0]["fused"]["held"]) >= {"embed", "block00"}
    assert set(ranks4[1]["fused"]["held"]) >= {"embed", "block00"}
    assert not f["losses_differ"] and f["differ"] == []


def test_a_tp_sharded_member_is_not_fused(ranks4):
    assert "cannot fuse tp-sharded stage block00" in ranks4[0]["b"]["fuse_refused"]


# -- (d) ----------------------------------------------------------------------------
def test_decode_pipeline_over_ranks_equals_the_one_device_server(ranks4):
    d = ranks4[0]["d"]
    assert len({r for ranks in d["ranks"] for r in ranks}) == 4
    assert d["tokens"] == d["want"]
    assert sum(len(t) for t in d["tokens"]) > 12
    assert d["late"] == 0 and {"channel-capacity", "cycle-credits"} <= set(d["checks"])
    assert all(c["bytes_sent"] > 0 for c in d["costs"].values())


def test_decode_pipeline_over_ranks_holds_to_the_jax_server(ranks4):
    from repro_torch import bridge
    from test_torch_server import TIE, _margins
    d, jx = ranks4[0]["d"], ranks4[0]["jax"]
    cfg = _f32("tiny")
    model = bridge.from_jax(cfg, jx["lm"], device="cpu")
    reqs = [(r.uid, r.prompt, r.max_new) for r in jx["requests"]]
    for lo in range(0, len(reqs), 4):                  # the servers' rounds
        margins = _margins(cfg, model, reqs[lo:lo + 4], jx["tokens"][lo:lo + 4])
        for i, (got, want) in enumerate(zip(d["tokens"][lo:lo + 4], jx["tokens"][lo:lo + 4])):
            diff = [t for t, (a, b) in enumerate(zip(got, want)) if a != b]
            if diff:
                assert margins[i][diff[0]] < TIE, (lo + i, diff[0])
            else:
                assert len(got) == len(want)


# -- (e) ----------------------------------------------------------------------------
def test_mamba_over_two_ranks_equals_the_one_device_server(ranks4):
    e = ranks4[0]["e"]
    assert {r for ranks in e["ranks"] for r in ranks} == {0, 1}
    assert e["tokens"] == e["want"] and e["late"] == 0
    L = 2                                     # reduced(): two layers, a stage each
    for rank in (0, 1):
        held = ranks4[rank]["e"]["held"]
        mine = [n for n, ranks in zip(e["names"], e["ranks"]) if rank in ranks]
        tied = "head" in mine and _f32("mamba2-370m").tie_embeddings   # the head reads it
        assert held["embed"] == ("embed" in mine or tied)
        assert held["head"] == ("head" in mine)
        assert held["layers"] == [i for i in range(L) if f"blocks{i:02d}" in mine]


# -- (f), (g) -------------------------------------------------------------------------
def test_a_worker_that_raises_fails_the_run_on_rank_0(ranks4):
    f = ranks4[0]["f"]
    assert f["raised"] is not None, "the run did not raise"
    assert f["raised"]["rank"] == 2 and f["stage"] in f["raised"]["what"]
    assert "rank 2" in f["raised"]["message"] and "fails on purpose" in f["raised"]["message"]
    assert "microbatch 0" in f["raised"]["what"]
    assert f["seconds"] < POOL_TIMEOUT_S


def test_a_pool_of_ranks_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.core.stg import Selection
    from repro_torch.graphs import lm_graph
    from repro_torch.launch.mesh import rank_pool
    from repro_torch.runtime.pipeline import DecodePipeline, LMPipeline
    assert not dist.is_initialized()
    tiny = get_config("tiny")
    stg, _ = lm_graph.build_stg(tiny, ShapeCfg("parity", 16, 8, "train"), max_tp=4)
    with pytest.raises(RuntimeError, match="process group"):
        LMPipeline(tiny, stg, Selection.smallest(stg), devices=[0, 1, 2, 3])
    shape = ShapeCfg("decode_par", 64, 16, "decode")
    dstg, _ = lm_graph.build_stg(tiny, shape, max_tp=4)
    with pytest.raises(RuntimeError, match="process group"):
        DecodePipeline(tiny, dstg, planner.plan(tiny, shape, chips=8, max_tp=4),
                       devices=[0, 1])
    with pytest.raises(RuntimeError, match="process group"):
        rank_pool(device="cpu")



@pytest.mark.parametrize("drawn_by", ["stages", "lm"])
def test_a_rank_draws_the_whole_model_and_keeps_its_own_stages(drawn_by):
    """Weights drawn from a seed over ranks (``keep=``): the kept stages are
    bitwise the whole model's draws, the others are not held."""
    from repro_torch.models import lm
    from repro_torch.runtime.pipeline import build_lm_stages
    cfg = _tiny6()
    if drawn_by == "stages":
        names, whole = build_lm_stages(cfg, seed=3, device="cpu")
        _, mine = build_lm_stages(cfg, seed=3, device="cpu", keep={"block02", "head"})
        assert list(mine) == ["block02", "head"] and len(names) == 8
        for n, module in mine.items():
            assert all(torch.equal(a, b) for a, b in zip(module.parameters(),
                                                        whole[n].parameters()))
        return
    gen = lambda: torch.Generator(device="cpu").manual_seed(3)   # noqa: E731
    whole = lm.init_params(cfg, device="cpu", generator=gen())
    mine = lm.init_params(cfg, device="cpu", generator=gen(),
                          keep={"layers.4", "final_norm", "head"}.__contains__)
    held = {n for n, p in mine.named_parameters() if p.device.type != "meta"}
    assert held and all(n.startswith(("layers.4.", "final_norm", "head")) for n in held)
    ref = dict(whole.named_parameters())
    assert all(torch.equal(p, ref[n]) for n, p in mine.named_parameters() if n in held)
    assert mine.embed.device.type == "meta" and next(mine.layers[0].parameters()).is_meta
