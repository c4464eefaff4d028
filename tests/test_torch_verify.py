"""The port's serve preflight (`core.verify`) and measurement (`measure`) on the CPU.

  * for the same plan and serve arguments, the port's
    `verify_decode_plan` findings (level, check, subject) equal the JAX
    package's, outside the cache-contract family (the JAX package checks
    donation avals there, the port its in-place contract): a sound plan,
    an undersized feedback stream (ERROR in both, the serve refused before
    any op), and fusion plans through `verify_fusion`;
  * the cache contract on ``meta`` tensors for dense and Mamba2 stages,
    a decode that rebinds a cache tensor caught, and a plain op that cannot
    run on ``meta`` reported as a check not run;
  * the engine's deadlock report cross-references the static report;
  * `compare_lm`, `calibrate` and `measured_replan` on a port serve give
    the JAX package's numbers and selection for the same run.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.analysis.roofline import HW_V5E
from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.configs.tiny import CONFIG as jax_tiny
from repro.core import planner as jax_planner
from repro.core import verify as jax_verify
from repro.graphs import lm_graph as jax_lm_graph
from repro.models import lm as jax_lm
from repro.runtime.pipeline import DecodePipeline as JaxDecodePipeline
from repro.runtime.pipeline import measure as jax_measure
from repro_torch import bridge
from repro_torch.analysis.roofline import Hardware
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner, verify
from repro_torch.graphs import lm_graph
from repro_torch.models import lm
from repro_torch.runtime.pipeline import (DecodePipeline, Engine, Tracer, calibrate,
                                          compare_lm, measured_bubble, measured_replan)

SHAPE = ("verify_decode", 64, 16, "decode")
REL = 1e-9          # the two planners' analytic values (`test_torch_planner`)


@functools.lru_cache(maxsize=None)
def _pipes(pps=1):
    """The same plan and weights in both packages (``tiny``, float32, the
    port's planner on the JAX package's hardware), the JAX pipeline on one
    device as the port's is."""
    jcfg = dataclasses.replace(jax_tiny, compute_dtype="float32")
    cfg = dataclasses.replace(get_config("tiny"), compute_dtype="float32")
    tree = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    jplan = jax_planner.plan(jcfg, JaxShapeCfg(*SHAPE), chips=8, max_tp=4)
    jstg, _ = jax_lm_graph.build_stg(jcfg, JaxShapeCfg(*SHAPE), max_tp=4)
    hw = Hardware(**dataclasses.asdict(HW_V5E))
    plan = planner.plan(cfg, ShapeCfg(*SHAPE), chips=8, max_tp=4, hw=hw)
    stg, _ = lm_graph.build_stg(cfg, ShapeCfg(*SHAPE), max_tp=4, hw=hw)
    jpipe = JaxDecodePipeline(jcfg, jstg, jplan, params=tree, devices=jax.devices()[:1],
                              periods_per_stage=pps, warmup=False)
    pipe = DecodePipeline(cfg, stg, plan, device="cpu", periods_per_stage=pps,
                          params=bridge.from_jax(cfg, jax.tree.map(np.array, tree),
                                                 device="cpu"))
    return jpipe, pipe, (jstg, jplan), (stg, plan)


def _outside_cache_family(report):
    return sorted((f.level, f.check, f.subject) for f in report.findings
                  if not f.check.startswith(("donation.", "cache.")))


def _prompts(vocab, n):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, rng.integers(4, 20)).tolist() for _ in range(n)]


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("n_groups,fb_cap", [(2, None), (4, None), (4, 1), (3, 2), (1, 1)])
def test_decode_plan_findings_match_jax(pps, n_groups, fb_cap):
    jpipe, pipe, *_ = _pipes(pps)
    shapes = [(4, 16, 28)] * n_groups
    kw = dict(n_groups=n_groups, capacity_blocks=2, feedback_capacity=fb_cap,
              group_shapes=shapes)
    want = jax_verify.verify_decode_plan(jpipe, **kw)
    got = verify.verify_decode_plan(pipe, **kw)
    assert _outside_cache_family(got) == _outside_cache_family(want)
    assert got.ok() == want.ok()
    assert [c for c in got.checks if c != "cache-contract"] == \
        [c for c in want.checks if c != "donation-cache-contract"]
    assert "cache-contract" in got.checks
    assert not [f for f in got.findings if f.check.startswith("cache.")]
    if fb_cap is not None and fb_cap < n_groups:
        bad = [f for f in got.errors() if f.check == "deadlock.feedback-capacity"]
        assert bad and bad[0].min_viable == n_groups


def test_undersized_feedback_refused_before_any_op():
    _, pipe, *_ = _pipes()
    prompts = _prompts(pipe.cfg.vocab, 16)
    dispatched = pipe.compile_stats.calls
    with pytest.raises(verify.PlanVerificationError) as ei:
        pipe.serve(prompts, 4, group_size=4, feedback_capacity=1)
    msg = str(ei.value)
    assert "feedback" in msg and "cycle" in msg and "embed" in msg and "head" in msg
    assert any(f.check == "deadlock.feedback-capacity" and f.min_viable == 4
               for f in ei.value.findings)
    assert pipe.compile_stats.calls == dispatched
    res = pipe.serve(prompts, 3, group_size=4, feedback_capacity=4)
    assert all(len(t) == 3 for t in res.tokens)


def test_default_serve_passes_preflight_and_the_escape_hatch_serves_the_same():
    _, pipe, *_ = _pipes()
    prompts = _prompts(pipe.cfg.vocab, 8)
    ref = pipe.serve(prompts, 3, group_size=4)
    assert pipe.last_preflight.ok(), pipe.last_preflight.render()
    assert "cache-contract" in pipe.last_preflight.checks
    assert pipe.serve(prompts, 3, group_size=4, preflight=False).tokens == ref.tokens


FUSIONS = [
    [("embed", "blocks00"), ("blocks01",), ("blocks02",), ("blocks03", "head")],
    [("embed", "blocks01"), ("blocks00",), ("blocks02",), ("blocks03", "head")],
    [("embed",), ("blocks00", "blocks01"), ("blocks02",), ("blocks03", "head")],
    [("embed", "blocks00", "blocks01", "blocks02", "blocks03", "head")],
]


@pytest.mark.parametrize("groups", FUSIONS)
def test_fusion_findings_match_jax(groups):
    names = ["embed", "blocks00", "blocks01", "blocks02", "blocks03", "head"]
    heavy = [n for n in names if n.startswith("blocks")]
    want, got = jax_verify.VerificationReport(), verify.VerificationReport()
    jax_verify.verify_fusion(names, groups, heavy=heavy, report=want)
    verify.verify_fusion(names, groups, heavy=heavy, report=got)
    assert [(f.level, f.check, f.subject) for f in got.findings] == \
        [(f.level, f.check, f.subject) for f in want.findings]
    assert got.ok() == (groups == FUSIONS[0])


@pytest.mark.parametrize("name", ["tiny", "mamba2-370m-smoke", "qwen2.5-3b", "mamba2-370m"])
def test_cache_contract_on_meta(name):
    """Dense and Mamba2 stages update their slices in place; on ``meta``
    the full widths cost nothing."""
    cfg = get_config(name)
    report = verify.VerificationReport()
    verify.verify_decode_cache_contract(cfg, (0, 2), batch=2, prompt=16, cap=24,
                                        dtype=torch.bfloat16, stage="blocks00",
                                        report=report)
    assert report.checks == ["cache-contract"] and report.ok(), report.render()
    assert not report.findings


def test_cache_contract_catches_a_rebound_cache_tensor(monkeypatch):
    real = lm.decode_blocks

    def rebinding(cfg, layers, caches, x, pos, **kw):
        caches[0]["k"] = caches[0]["k"].clone()      # not in place
        return real(cfg, layers, caches, x, pos, **kw)

    monkeypatch.setattr(lm, "decode_blocks", rebinding)
    report = verify.VerificationReport()
    verify.verify_decode_cache_contract(get_config("tiny"), (0, 1), batch=2, prompt=16,
                                        cap=24, dtype=torch.float32, stage="blocks00",
                                        report=report)
    bad = report.errors()
    assert [f.check for f in bad] == ["cache.contract"]
    assert bad[0].subject == "blocks00.layers[0].k" and "storage" in bad[0].message


def test_cache_contract_not_runnable_on_meta_is_reported(monkeypatch):
    def host_sync(cfg, layers, caches, x, pos, **kw):
        int(pos)                                      # no value on meta
        return x

    monkeypatch.setattr(lm, "decode_blocks", host_sync)
    report = verify.VerificationReport()
    verify.verify_decode_cache_contract(get_config("tiny"), (0, 1), batch=2, prompt=16,
                                        cap=24, dtype=torch.float32, stage="blocks00",
                                        report=report)
    assert "cache-contract" not in report.checks and report.ok()
    assert [f.check for f in report.warnings()] == ["cache.contract-not-run"]


def test_deadlock_detail_crossref():
    eng = Engine([], static_report=None)
    assert "preflight: not run" in eng._deadlock_detail()
    assert eng.diagnostic_bundle()["static_preflight"] == {"ran": False}
    clean = verify.VerificationReport(plan="p")
    clean.ran("cycle-credits")
    eng2 = Engine([], static_report=clean)
    assert "verified deadlock-free" in eng2._deadlock_detail()
    assert eng2.diagnostic_bundle()["static_preflight"]["plan"] == "p"
    dirty = verify.VerificationReport(plan="p")
    dirty.add(verify.ERROR, "deadlock.feedback-capacity", "feedback", "short", min_viable=4)
    d3 = Engine([], static_report=dirty)._deadlock_detail()
    assert "matches" in d3 and "feedback" in d3


# ===========================================================================
# measured vs analytic on a port serve
# ===========================================================================
@pytest.fixture(scope="module")
def traced_serve():
    _, pipe, (jstg, jplan), (stg, plan) = _pipes()
    tracer = Tracer()
    run = pipe.serve(_prompts(pipe.cfg.vocab, 8), 12, group_size=4, tracer=tracer)
    return pipe, run, (jstg, jplan), (stg, plan)


def test_compare_lm_on_a_serve_matches_jax(traced_serve):
    pipe, run, (jstg, jplan), (stg, plan) = traced_serve
    from repro.runtime.pipeline import as_selection as jax_as_selection
    from repro_torch.runtime.pipeline import as_selection
    stage_map = pipe.graph_stage_map()
    got = compare_lm(stg, as_selection(plan), run, stage_map=stage_map)
    want = jax_measure.compare_lm(jstg, jax_as_selection(jplan), run, stage_map=stage_map)
    assert got.ratios() == pytest.approx(want.ratios(), rel=REL) and got.ratios()
    assert got.v_app_measured == want.v_app_measured
    assert got.bottleneck_measured == want.bottleneck_measured
    assert got.accuracy == pytest.approx(want.accuracy, rel=REL)
    assert np.isfinite(got.accuracy)
    assert got.slo == want.slo and got.slo
    for name, m in got.stages.items():
        assert (m.stall_v, m.starve_v, m.host_v) == \
            (want.stages[name].stall_v, want.stages[name].starve_v, want.stages[name].host_v)
    assert got.to_json() and "pipeline" in got.summary()
    assert 0.0 <= measured_bubble(run) < 1.0


def test_measured_replan_on_a_serve_matches_jax(traced_serve):
    pipe, run, (jstg, jplan), (stg, plan) = traced_serve
    from repro.runtime.pipeline import as_selection as jax_as_selection
    from repro_torch.runtime.pipeline import as_selection
    stage_map = pipe.graph_stage_map()
    report = compare_lm(stg, as_selection(plan), run, stage_map=stage_map)
    jreport = jax_measure.compare_lm(jstg, jax_as_selection(jplan), run, stage_map=stage_map)
    for kw in (dict(area_budget=2 * plan.total_chips), dict(v_tgt=plan.v_firing_us)):
        got = measured_replan(stg, report, **kw)
        want = jax_measure.measured_replan(jstg, jreport, **kw)
        assert dict(got.selection.choices) == dict(want.selection.choices)
        assert got.total_area == pytest.approx(want.total_area, rel=REL)
    g = calibrate(stg, {"block00": 2.0})
    assert g.nodes["block00"].impls[0].ii == 2.0 * stg.nodes["block00"].impls[0].ii
    with pytest.raises(ValueError, match="exactly one"):
        measured_replan(stg, report)
