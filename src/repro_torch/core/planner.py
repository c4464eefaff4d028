"""Pod-scale parallelism planner = the paper's trade-off finder on LM STGs.

Copied from ``repro/core/planner.py`` with the same API; every entry
point prices the graph on `HW_H100` unless given another `Hardware`.

``plan()`` runs the paper's two optimisation modes over the LM task graph
built by `graphs.lm_graph`:

  * min_chips       (paper: min area s.t. v <= v_tgt)  — "hit this many
    tokens/s with as few chips as possible"
  * max_throughput  (paper: min v s.t. area <= A_C)    — "I have one pod
    (256 chips); make it as fast as possible"

Both engines run: the ILP (Eq. 3/4, stand-alone fork/join trees) and the
heuristic (bottleneck-driven + node combining).  On LM graphs the heuristic
exhibits the paper's headline behaviour — it aligns replica counts across
stage boundaries (combining) and deletes routing cost the ILP must pay.

``plan_fusion()`` scores stage fusion for a decode pipeline, and
``replan()`` is the elastic-scaling entry point: the same graph re-solved
for a new chip count.  ``to_execution()`` projects a plan onto one
("data", "model") mesh (what ``launch/train.py --use-planner`` and
`runtime.elastic.rescale` build as a ``DeviceMesh``), and
``folded_tokens_per_s()`` prices that folded layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..analysis.roofline import HW_H100, Hardware
from ..configs.base import ModelConfig, ShapeCfg
from ..graphs import lm_graph
from . import heuristic, ilp
from .ilp import TradeoffResult
from .throughput import analyze


@dataclass(frozen=True)
class StagePlan:
    name: str
    impl: str
    tp: int
    replicas: int

    @property
    def chips(self) -> int:
        return self.tp * self.replicas


@dataclass
class PlanResult:
    arch: str
    shape: str
    mode: str                    # min_chips | max_throughput
    engine: str                  # ilp | heuristic
    stages: list[StagePlan]
    total_chips: float           # incl. routing overhead chip-equivalents
    impl_chips: float
    overhead_chips: float
    v_firing_us: float
    tokens_per_s: float
    solve_seconds: float
    feasible: bool
    info: dict = field(default_factory=dict)

    def summary(self) -> str:
        head = (f"[{self.engine}/{self.mode}] {self.arch} x {self.shape}: "
                f"{self.total_chips:.0f} chips "
                f"({self.impl_chips:.0f} impl + {self.overhead_chips:.1f} routing), "
                f"v={self.v_firing_us:.1f}us/firing, "
                f"{self.tokens_per_s:,.0f} tok/s, "
                f"solve {self.solve_seconds*1e3:.0f}ms")
        groups: dict[tuple[str, int], list[str]] = {}
        for sp in self.stages:
            groups.setdefault((sp.impl, sp.replicas), []).append(sp.name)
        rows = [f"  {names[0]}..{names[-1]} ({len(names)}): {im} x{nr}"
                for (im, nr), names in groups.items()]
        return head + "\n" + "\n".join(rows)


def _stage_plans(res: TradeoffResult) -> list[StagePlan]:
    out = []
    for name, (impl_name, nr) in sorted(res.selection.choices.items()):
        tp = int(impl_name[2:]) if impl_name.startswith("tp") else 1
        out.append(StagePlan(name=name, impl=impl_name, tp=tp, replicas=nr))
    return out


def plan(cfg: ModelConfig, shape: ShapeCfg, *, chips: int | None = None,
         tokens_per_s: float | None = None, engine: str = "heuristic",
         hw: Hardware = HW_H100, max_tp: int = 256, nf: int = 4,
         mb_seqs: int | None = None, fj_iters: int = 2,
         ii_scale: dict[str, float] | None = None) -> PlanResult:
    """Solve one trade-off mode.  Exactly one of chips / tokens_per_s.

    ``ii_scale``: per-stage measured/analytic inverse-throughput ratios
    from an executed pipeline (runtime.pipeline.measure) — the solver then
    sizes the plan to measured stage behaviour."""
    if (chips is None) == (tokens_per_s is None):
        raise ValueError("pass exactly one of chips= / tokens_per_s=")
    stg, info = lm_graph.build_stg(cfg, shape, hw=hw, max_tp=max_tp,
                                   mb_seqs=mb_seqs, ii_scale=ii_scale)
    eng = {"ilp": ilp, "heuristic": heuristic}[engine]

    if tokens_per_s is not None:
        mode = "min_chips"
        v_tgt_us = info["toks_per_firing"] / tokens_per_s * 1e6
        fj = lm_graph.router_fork_join(info["act_bytes"], v_tgt_us, hw=hw, nf=nf)
        res = eng.min_area(stg, v_tgt_us, fj)
    else:
        mode = "max_throughput"
        # router pricing depends on the achieved rate — fixed-point iterate
        from .stg import Selection
        v_est = analyze(stg, Selection.fastest(stg)).v_app
        res = None
        for _ in range(max(1, fj_iters)):
            fj = lm_graph.router_fork_join(info["act_bytes"], v_est, hw=hw, nf=nf)
            res = eng.max_throughput(stg, float(chips), fj)
            if res.v_app <= 0 or abs(res.v_app - v_est) / res.v_app < 0.05:
                break
            v_est = res.v_app
    v = res.v_app
    return PlanResult(
        arch=cfg.name, shape=shape.name, mode=mode, engine=engine,
        stages=_stage_plans(res),
        total_chips=res.total_area, impl_chips=res.impl_area,
        overhead_chips=res.overhead_area,
        v_firing_us=v,
        tokens_per_s=(info["toks_per_firing"] / v * 1e6) if v > 0 else 0.0,
        solve_seconds=res.solve_seconds, feasible=res.feasible,
        info={"toks_per_firing": info["toks_per_firing"],
              "act_bytes": info["act_bytes"], "n_firings": info["n_firings"]})


def plan_both(cfg: ModelConfig, shape: ShapeCfg, **kw) -> dict[str, PlanResult]:
    """ILP vs heuristic on the same problem (the paper's Table-2 shape)."""
    return {e: plan(cfg, shape, engine=e, **kw) for e in ("ilp", "heuristic")}


# ===========================================================================
# stage fusion + elastic replanning
# ===========================================================================
def plan_fusion(cfg: ModelConfig, shape: ShapeCfg, plan_result: PlanResult, *,
                periods_per_stage: int = 1,
                host_us: dict[str, float] | None = None,
                hw: Hardware = HW_H100, max_tp: int = 256,
                mb_seqs: int | None = None, slack: float = 1.0):
    """Score candidate stage-fusion plans for a decode pipeline on the
    virtual clock and return the winner (a ``restructure.FusionScore``).

    The candidate space is the runtime stage chain exactly as
    ``DecodePipeline`` builds it from this plan: ``embed``, one
    ``blocksNN`` per ``periods_per_stage`` block periods, ``head``.
    Device time per stage is the analytic II of its graph nodes under the
    plan's selection, calibrated to microseconds against the plan's
    ``v_firing_us`` (the ``measured_ratio``-style analytic->measured
    bridge).  ``host_us`` is measured ``per_stage_host_us`` from an
    executed pipeline, folded in as a per-stage fixed dispatch cost; when
    absent every stage costs one dispatch unit, so the score minimizes
    dispatch count subject to the structural guards.  Span-bearing
    ``blocksNN`` stages are ``heavy`` — they never fuse with each other
    (that axis is ``periods_per_stage``), so fusion absorbs the stateless
    ``embed``/``head`` endpoints into their neighbours.

    The loop closes on hardware: serve with the winner, feed the measured
    ``per_stage_host_us`` (keyed by the fused names) back in, and the
    re-score confirms the fixed point (``replan_to_fixed_point``-style).
    """
    from . import restructure
    stg, _info = lm_graph.build_stg(cfg, shape, hw=hw, max_tp=max_tp,
                                    mb_seqs=mb_seqs)
    choices = {s.name: (s.impl, s.replicas) for s in plan_result.stages}
    blocks = sorted(n for n in stg.nodes if n.startswith("block"))
    pps = max(1, int(periods_per_stage))
    spans = [(a, min(a + pps, len(blocks))) for a in range(0, len(blocks), pps)]
    stage_names = (["embed"]
                   + [f"blocks{i:02d}" for i in range(len(spans))]
                   + ["head"])
    owners = {"embed": ["embed"], "head": ["head"]}
    for i, (a, b) in enumerate(spans):
        owners[f"blocks{i:02d}"] = blocks[a:b]
    # analytic node iter time -> microseconds via the plan's firing period
    iter_t = {n: stg.nodes[n].impl(choices[n][0]).ii / max(1, choices[n][1])
              for n in stg.nodes if n in choices}
    v_app = max(iter_t.values())
    us_per_unit = (plan_result.v_firing_us / v_app) if v_app > 0 else 0.0
    dev_us, replicas = {}, {}
    for sn in stage_names:
        dev_us[sn] = sum(stg.nodes[n].impl(choices[n][0]).ii
                         for n in owners[sn]) * us_per_unit
        replicas[sn] = min(choices[n][1] for n in owners[sn])
    heavy = [sn for sn in stage_names if sn.startswith("blocks")]
    return restructure.auto_fusion(stage_names, host_us=host_us,
                                   dev_us=dev_us, heavy=heavy,
                                   replicas=replicas, slack=slack,
                                   dev_in_score=host_us is not None)


# ===========================================================================
# execution projection + elastic replanning
# ===========================================================================
@dataclass(frozen=True)
class ExecutionPlan:
    """Homogeneous projection of a plan onto one mesh (what launch.*
    consumes)."""
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    dp: int
    tp: int
    grad_accum: int
    fsdp: bool
    notes: str = ""


def to_execution(p: PlanResult, *, cfg: ModelConfig | None = None,
                 chips: int = 256) -> ExecutionPlan:
    """Fold the spatial plan onto one fixed-size mesh.

    The paper maps the STG *spatially* (each stage owns its PEs: pipeline
    parallelism).  One SPMD program over a mesh instead *timeshares* all
    stages over it; the planner still decides the policy: the modal
    tensor-parallel degree of the block stages becomes the "model" axis,
    the rest of the chip budget the "data" axis.  Heterogeneous residue
    (stages preferring another layout) is reported in ``notes``.
    """
    blocks = [s for s in p.stages if s.name.startswith(("block", "enc"))]
    if not blocks:
        blocks = p.stages
    from collections import Counter
    tp, nr = Counter((s.tp, s.replicas) for s in blocks).most_common(1)[0][0]
    residue = [s.name for s in blocks if (s.tp, s.replicas) != (tp, nr)]
    hetero = ""
    if residue:
        hetero = (f"{len(residue)} stages prefer a different layout "
                  f"(e.g. {residue[:3]}); homogeneous projection keeps "
                  f"majority tp={tp}")
    tp = min(tp, chips)
    dp = max(1, chips // tp)
    accum = cfg.grad_accum if cfg is not None else 1
    big = cfg is not None and cfg.param_count() * 4 > 8e9
    return ExecutionPlan(
        mesh_shape=(dp, tp), mesh_axes=("data", "model"), dp=dp, tp=tp,
        grad_accum=accum, fsdp=big or dp * tp >= 64, notes=hetero)


def folded_tokens_per_s(cfg: ModelConfig, shape: ShapeCfg, *, chips: int,
                        tp: int, hw: Hardware = HW_H100,
                        mb_seqs: int | None = None) -> dict:
    """Analytic throughput of the folded (single-mesh, timeshared) layout:
    one microbatch per step over ALL chips, batch sharded dp = chips/tp,
    features/experts sharded tp.  Per-chip TP-collective bytes are
    ~ (tp-1) * toks_firing * d * b / chips per sync, so they GROW with tp
    at fixed chips.  Stages whose state does not fit even fully sharded
    are counted in ``fallbacks``."""
    stages, info = lm_graph.stage_costs(cfg, shape, mb_seqs=mb_seqs)
    dp = max(1, chips // tp)
    total_us = 0.0
    per_stage = {}
    fallbacks = 0
    train = info["train"]
    for st in stages:
        if st.state_bytes / chips > 0.75 * hw.hbm_bytes:
            fallbacks += 1      # does not fit even fully sharded
        compute_s = st.flops / (chips * hw.peak_flops)
        memory_s = st.hbm_bytes / (chips * hw.hbm_bw)
        if st.tp_collectives != "none" and tp > 1:
            n_sync = 4 if train else 2
            factor = 2 if st.tp_collectives == "megatron" else 1
            per_chip = n_sync * factor * (tp - 1) / tp \
                * st.act_out_bytes * tp / chips
            coll_s = per_chip / hw.link_bw
        else:
            coll_s = 0.0
        ii = max(compute_s, memory_s, coll_s) * 1e6
        total_us += ii
        per_stage[st.name] = ii
    tps = info["toks_per_firing"] / total_us * 1e6
    return {"tokens_per_s": tps, "firing_us": total_us, "dp": dp, "tp": tp,
            "per_stage_us": per_stage, "fallbacks": fallbacks}


def replan(cfg: ModelConfig, shape: ShapeCfg, old: PlanResult, *,
           new_chips: int, engine: str = "heuristic",
           measured_ratio: dict[str, float] | None = None,
           fusion_host_us: dict[str, float] | None = None,
           periods_per_stage: int = 1,
           **kw) -> tuple[PlanResult, dict]:
    """Elastic rescale: re-solve for a new chip budget; diff vs old plan.

    This is the paper's core motivation ("scaling a program to a larger or
    smaller processor array requires manually re-programming all objects
    and channels" — here it is one solver call).

    ``measured_ratio``: measured/analytic per-stage ratios from an executed
    pipeline (PipelineReport.ratios()); when given, the re-solve runs on
    the measurement-calibrated graph (measurement-guided re-planning).

    ``fusion_host_us``: measured ``per_stage_host_us`` from the running
    pool; when given, the re-plan also re-scores stage fusion for the new
    plan (``plan_fusion``) and reports the winning groups in
    ``diff["fusion_groups"]`` — so an elastic rescale carries the
    dispatch-deletion decision forward instead of silently unfusing."""
    new = plan(cfg, shape, chips=new_chips, engine=engine,
               ii_scale=measured_ratio, **kw)
    changed = []
    old_by = {s.name: s for s in old.stages}
    for s in new.stages:
        o = old_by.get(s.name)
        if o is not None and (o.tp, o.replicas) != (s.tp, s.replicas):
            changed.append((s.name, (o.tp, o.replicas), (s.tp, s.replicas)))
    diff = {
        "chips": (old.total_chips, new.total_chips),
        "tokens_per_s": (old.tokens_per_s, new.tokens_per_s),
        "stages_changed": changed,
        "throughput_ratio": (new.tokens_per_s / old.tokens_per_s
                             if old.tokens_per_s else float("inf")),
    }
    if fusion_host_us is not None:
        diff["fusion_groups"] = plan_fusion(
            cfg, shape, new, periods_per_stage=periods_per_stage,
            host_us=fusion_host_us).groups
    return new, diff
