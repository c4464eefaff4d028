"""The port's planner against the JAX package's, on the same `Hardware`.

The port copies the graph, the throughput analysis, both solvers, the
router model, restructuring and the planner; only the default hardware
differs (the H100 in the port, a TPU in the JAX package).  So given a `Hardware` built from
the JAX ``HW_V5E``'s fields, both must build the same task graph and
choose the same plans: the same stage choices ``(impl, tp, replicas)``,
and ``v_firing_us``, ``total_chips`` and ``tokens_per_s`` within 1e-9
relative (the same float operations in the same order), with both
engines, on full configs (the planner prices shapes; it runs no model),
and the same fusion groups from ``plan_fusion`` and ``auto_fusion``.
"""
import dataclasses

import pytest

from repro.analysis.roofline import HW_V5E
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.core import planner as jax_planner
from repro.core import restructure as jax_restructure
from repro.graphs import lm_graph as jax_lm_graph
from repro_torch.analysis.roofline import HW_H100, Hardware
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner, restructure
from repro_torch.graphs import lm_graph

CONFIGS = ["tiny", "qwen2.5-3b", "h2o-danube-3-4b", "mamba2-370m"]
REL = 1e-9
# a decode shape and a budget of two chips a node plus slack, so the plans
# replicate and split (tp > 1) nodes instead of taking one chip each
SHAPE = dict(name="decode_test", seq_len=2048, global_batch=64, kind="decode")
MAX_TP = 8


def _close(a, b):
    return a == pytest.approx(b, rel=REL, abs=0.0)


@pytest.mark.parametrize("engine", ["heuristic", "ilp"])
@pytest.mark.parametrize("name", CONFIGS)
def test_plans_match_jax_planner(name, engine):
    hw = Hardware(**dataclasses.asdict(HW_V5E))
    cfg, jcfg = get_config(name), jax_get_config(name)
    shape, jshape = ShapeCfg(**SHAPE), JaxShapeCfg(**SHAPE)
    chips = 2 * cfg.n_layers + 8

    stg, info = lm_graph.build_stg(cfg, shape, hw=hw, max_tp=MAX_TP)
    jstg, jinfo = jax_lm_graph.build_stg(jcfg, jshape, hw=HW_V5E, max_tp=MAX_TP)
    assert stg.topo_order() == jstg.topo_order()
    for n in stg.topo_order():
        got = [(i.name, i.area, i.ii) for i in stg.nodes[n].impls]
        want = [(i.name, i.area, i.ii) for i in jstg.nodes[n].impls]
        assert [g[0] for g in got] == [w[0] for w in want]
        assert all(_close(g[1], w[1]) and _close(g[2], w[2]) for g, w in zip(got, want))
    assert {k: info[k] for k in ("toks_per_firing", "n_firings", "act_bytes")} == \
        {k: jinfo[k] for k in ("toks_per_firing", "n_firings", "act_bytes")}

    p = planner.plan(cfg, shape, chips=chips, engine=engine, hw=hw, max_tp=MAX_TP)
    jp = jax_planner.plan(jcfg, jshape, chips=chips, engine=engine, hw=HW_V5E, max_tp=MAX_TP)
    assert [(s.name, s.impl, s.tp, s.replicas) for s in p.stages] == \
        [(s.name, s.impl, s.tp, s.replicas) for s in jp.stages]
    assert (p.mode, p.engine, p.feasible) == (jp.mode, jp.engine, jp.feasible)
    for key in ("v_firing_us", "total_chips", "tokens_per_s", "impl_chips", "overhead_chips"):
        assert _close(getattr(p, key), getattr(jp, key)), key

    for pps, host_us in ((1, None), (4, {"embed": 30.0, "head": 30.0})):
        fuse = planner.plan_fusion(cfg, shape, p, periods_per_stage=pps, host_us=host_us,
                                   hw=hw, max_tp=MAX_TP)
        jfuse = jax_planner.plan_fusion(jcfg, jshape, jp, periods_per_stage=pps,
                                        host_us=host_us, hw=HW_V5E, max_tp=MAX_TP)
        assert fuse.groups == jfuse.groups
        assert _close(fuse.period_us, jfuse.period_us)

    # the scorer as `DecodePipeline(fusion_plan="auto")` calls it
    names = ["embed"] + [f"blocks{i:02d}" for i in range(4)] + ["head"]
    dev = {n: 10.0 * (i + 1) for i, n in enumerate(names)}
    reps = {n: 1 + i % 2 for i, n in enumerate(names)}
    kw = dict(dev_us=dev, heavy=names[1:-1], replicas=reps, dev_in_score=False)
    assert restructure.auto_fusion(names, **kw).groups == \
        jax_restructure.auto_fusion(names, **kw).groups


def test_port_prices_the_h100_by_default():
    cfg = get_config("qwen2.5-3b")
    shape = ShapeCfg(**SHAPE)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=MAX_TP)
    want, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=MAX_TP)
    assert [i.ii for i in stg.nodes["block00"].impls] == \
        [i.ii for i in want.nodes["block00"].impls]
    v5e, _ = lm_graph.build_stg(cfg, shape, hw=Hardware(**dataclasses.asdict(HW_V5E)),
                                max_tp=MAX_TP)
    assert stg.nodes["block00"].impls[0].ii < v5e.nodes["block00"].impls[0].ii
    p = planner.plan(get_config("tiny"), shape, chips=8, engine="ilp")
    assert p.engine == "ilp" and p.feasible
    assert planner.plan.__kwdefaults__["engine"] == "heuristic"
    assert planner.plan.__kwdefaults__["hw"] is HW_H100
