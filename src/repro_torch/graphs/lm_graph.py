"""LM models as streaming task graphs — the paper's technique at pod scale.

Copied from ``repro/graphs/lm_graph.py``; the one change is the hardware
the costs are priced on: `HW_H100` by default, and the router model is
named `router_fork_join`.

The space/time scaling problem the paper solves for MPPA overlays is the
accelerator parallelism-planning problem in disguise:

    composite node        = model stage (embed / layer block / head)
    implementation P_m^s  = tensor-parallel degree tp (node *splitting*):
                            area = tp chips, II = modeled µs per firing
    replication nr        = data parallelism over firings (microbatches /
                            serving slots), round-robin — exactly the
                            paper's replica semantics
    fork/join tree        = resharding/routing between stage groups with
                            mismatched replica counts; a pass-through
                            "router PE" costs the chip-time needed to
                            forward one firing's activations at the target
                            rate (`router_fork_join` below), so Eq. 9/14 and
                            the combining optimisation apply verbatim
    area budget A_C       = number of chips (HBM capacity filters the
                            implementation library per node)

A *firing* is one microbatch (train/prefill: ``mb_seqs`` sequences of
``seq_len`` tokens) or one decode step for one serving slot (``SLOT``
sequences, one token each).  II(tp) is the analytic three-term roofline
max over compute, memory and chip-to-chip traffic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from ..analysis.roofline import HW_H100, Hardware
from ..configs.base import ModelConfig, ShapeCfg
from ..core.fork_join import ForkJoinModel
from ..core.stg import STG, Channel, Impl, Node, scale_impls

BF16 = 2
F32 = 4
DECODE_SLOT = 8          # sequences per serving-slot firing


# ===========================================================================
# per-stage analytic costs
# ===========================================================================
@dataclass(frozen=True)
class StageCost:
    """Per-firing costs of one stage (before parallelisation).

    flops:        fwd(+bwd) floating ops per firing
    param_bytes:  weight bytes read per firing (compute copy, bf16)
    state_bytes:  persistent per-chip state that must FIT (params + optimizer
                  + grads for train; params + kv-cache share for decode)
    hbm_bytes:    HBM traffic per firing (params + activations + cache)
    coll_per_tp:  f(tp) -> per-chip collective bytes per firing at degree tp
    act_out_bytes: activation bytes leaving the stage per firing (boundary /
                  fork-join routing size)
    """
    name: str
    flops: float
    param_bytes: float
    state_bytes: float
    hbm_bytes: float
    act_out_bytes: float
    tp_collectives: str = "megatron"   # megatron | moe | none


def _attn_cost(cfg: ModelConfig, toks: int, ctx: int, train: bool,
               decode_batch: int = 0) -> tuple[float, float, float]:
    """(flops_fwd, params, extra_hbm) for one attention sublayer."""
    a = cfg.attn
    d = cfg.d_model
    qkvo = d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim \
        + a.n_heads * a.head_dim * d
    proj = 2.0 * toks * qkvo
    eff_ctx = min(ctx, a.window) if a.window else ctx
    # causal prefill sees ~ctx/2 average; decode sees the full cache
    avg_ctx = eff_ctx if decode_batch else eff_ctx / 2
    score = 2.0 * toks * avg_ctx * a.n_heads * a.head_dim * 2
    extra = 0.0
    if decode_batch:   # KV-cache read dominates decode
        extra = decode_batch * eff_ctx * 2 * a.n_kv_heads * a.head_dim * BF16
    return proj + score, qkvo, extra


def _mamba_cost(cfg: ModelConfig, toks: int) -> tuple[float, float]:
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    H = m.n_ssm_heads(d)
    N = m.d_state
    params = d * 2 * di + d * (2 * m.n_groups * N + H) + m.d_conv * di + di * d
    flops = 2.0 * toks * params + 6.0 * toks * di * N   # proj + SSD state math
    return flops, params


def _mlp_cost(cfg: ModelConfig, toks: int) -> tuple[float, float]:
    if cfg.d_ff == 0:
        return 0.0, 0.0
    mult = 3 if cfg.act == "silu_glu" else 2
    params = mult * cfg.d_model * cfg.d_ff
    return 2.0 * toks * params, params


def _moe_cost(cfg: ModelConfig, toks: int) -> tuple[float, float, float]:
    """(flops, params_total, params_active) for one MoE sublayer."""
    e = cfg.moe
    mult = 3 if cfg.act == "silu_glu" else 2
    per_expert = mult * cfg.d_model * e.d_ff
    params = e.n_experts * per_expert + cfg.d_model * e.n_experts
    active = e.top_k * per_expert
    if e.shared_expert:
        params += per_expert
        active += per_expert
    flops = 2.0 * toks * active + 2.0 * toks * cfg.d_model * e.n_experts
    return flops, params, active


def stage_costs(cfg: ModelConfig, shape: ShapeCfg, *,
                mb_seqs: int | None = None) -> tuple[list[StageCost], dict]:
    """Decompose (cfg, shape) into per-firing stage costs."""
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    if decode:
        slot = min(DECODE_SLOT, shape.global_batch)
        toks = slot
        ctx = shape.seq_len
        n_firings = shape.global_batch // slot
    else:
        mb_seqs = mb_seqs or max(1, shape.global_batch // cfg.grad_accum)
        toks = mb_seqs * shape.seq_len
        ctx = shape.seq_len
        n_firings = cfg.grad_accum if train else shape.global_batch // mb_seqs

    fb = 3.0 if train else 1.0            # bwd = 2x fwd
    # optimizer bytes/param: AdamW fp32 m+v = 8; Adafactor factored ≈ 1
    opt = (8.0 if cfg.optimizer == "adamw" else 1.0) if train else 0.0
    grad = 4.0 if train else 0.0          # fp32 grad accumulator
    act_out = toks * cfg.d_model * BF16
    d = cfg.d_model

    stages: list[StageCost] = []

    def add(name, flops_fwd, params, extra_hbm=0.0, extra_state=0.0,
            coll="megatron"):
        pb = params * BF16
        stages.append(StageCost(
            name=name,
            flops=fb * flops_fwd,
            param_bytes=pb,
            state_bytes=params * (F32 + opt + grad) + extra_state,
            hbm_bytes=pb + fb * (extra_hbm + 2 * act_out)
            + (params * opt / max(1, n_firings)),
            act_out_bytes=act_out,
            tp_collectives=coll))

    # embed (lookup is bytes-bound; flops negligible)
    vp = cfg.padded_vocab
    add("embed", 2.0 * toks * d, vp * d, coll="none")

    enc_layers = cfg.enc_layers if cfg.encdec else 0
    for li, (mixer, mlp) in enumerate(
            cfg.block_pattern * (cfg.n_layers // len(cfg.block_pattern))):
        flops = 0.0
        params = 0.0
        extra_hbm = 0.0
        extra_state = 0.0
        coll = "megatron"
        if mixer == "attn":
            f, p, eh = _attn_cost(cfg, toks, ctx, train,
                                  decode_batch=toks if decode else 0)
            flops += f
            params += p
            extra_hbm += eh
            if decode or shape.kind == "prefill":
                a = cfg.attn
                eff = min(ctx, a.window) if a.window else ctx
                extra_state += (shape.global_batch * eff * 2 * a.n_kv_heads
                                * a.head_dim * BF16)
        else:
            f, p = _mamba_cost(cfg, toks)
            flops += f
            params += p
            if decode or shape.kind == "prefill":
                m = cfg.mamba
                extra_state += (shape.global_batch * m.n_ssm_heads(d)
                                * m.head_dim * m.d_state * F32)
        if mlp == "moe":
            f, p, _ = _moe_cost(cfg, toks)
            flops += f
            params += p
            coll = "moe"
        else:
            f, p = _mlp_cost(cfg, toks)
            flops += f
            params += p
        add(f"block{li:02d}", flops, params, extra_hbm, extra_state, coll)
    # encoder layers (enc-dec): modelled as extra dense blocks on the prefix
    for li in range(enc_layers):
        toks_e = (cfg.num_prefix or 128) * (mb_seqs or 1)
        f1, p1, _ = _attn_cost(cfg, toks_e, cfg.num_prefix or 128, train)
        f2, p2 = _mlp_cost(cfg, toks_e)
        add(f"enc{li:02d}", f1 + f2, p1 + p2)

    # head + loss (train) / sampling logits (serve)
    head_flops = 2.0 * toks * d * vp
    add("head", head_flops, vp * d, coll="none")

    info = {"toks_per_firing": toks, "n_firings": n_firings,
            "act_bytes": act_out, "train": train,
            "mb_seqs": None if decode else mb_seqs}
    return stages, info


# ===========================================================================
# implementation libraries:  II(tp) from the three-term roofline
# ===========================================================================
def impl_library(st: StageCost, *, hw: Hardware, train: bool,
                 max_tp: int = 256, seq_len: int = 1,
                 toks: int = 1) -> list[Impl]:
    """One Impl per feasible tensor-parallel degree."""
    out = []
    tp = 1
    while tp <= max_tp:
        # memory feasibility: persistent state must fit the tp chips
        # (leave ~25% HBM headroom for activations/temps)
        if st.state_bytes / tp <= 0.75 * hw.hbm_bytes:
            compute_s = st.flops / (tp * hw.peak_flops)
            memory_s = st.hbm_bytes / (tp * hw.hbm_bw)
            if st.tp_collectives == "megatron" and tp > 1:
                per_chip = (2 if not train else 4) * 2 * (tp - 1) / tp \
                    * st.act_out_bytes / tp
                coll_s = per_chip / hw.link_bw
            elif st.tp_collectives == "moe" and tp > 1:
                per_chip = (2 if not train else 4) * (tp - 1) / tp \
                    * st.act_out_bytes / tp
                coll_s = per_chip / hw.link_bw
            else:
                coll_s = 0.0
            ii_us = max(compute_s, memory_s, coll_s) * 1e6
            out.append(Impl(name=f"tp{tp}", area=float(tp), ii=ii_us,
                            meta={"compute_us": compute_s * 1e6,
                                  "memory_us": memory_s * 1e6,
                                  "coll_us": coll_s * 1e6,
                                  "tp": tp}))
        tp *= 2
    if not out:
        raise ValueError(f"stage {st.name}: no tp <= {max_tp} fits "
                         f"{st.state_bytes/1e9:.1f}GB of state")
    return out


def router_fork_join(act_bytes: float, v_tgt_us: float, *,
                     hw: Hardware = HW_H100, nf: int = 4) -> ForkJoinModel:
    """``tpu_fork_join`` of the JAX package, named for any card.

    The paper's router PE, priced in chips: forwarding one firing's
    activations takes act_bytes/link_bw; sustaining one firing per
    v_tgt_us therefore costs (act_us / v_tgt_us) chip-equivalents."""
    act_us = act_bytes / hw.link_bw * 1e6
    return ForkJoinModel(nf=nf, node_area=act_us / max(v_tgt_us, 1e-9),
                         count_root=False)


def build_stg(cfg: ModelConfig, shape: ShapeCfg, *, hw: Hardware = HW_H100,
              max_tp: int = 256, mb_seqs: int | None = None,
              ii_scale: dict[str, float] | None = None) -> tuple[STG, dict]:
    """The LM streaming task graph with per-node implementation libraries.

    ``ii_scale`` multiplies each named stage's implementation IIs — the
    measurement-feedback hook: runtime.pipeline reports measured/analytic
    ratios per stage, and replanning on the scaled graph sizes replica
    counts to *measured* behaviour instead of the roofline promise.
    """
    stages, info = stage_costs(cfg, shape, mb_seqs=mb_seqs)
    if ii_scale:
        unknown = set(ii_scale) - {st.name for st in stages}
        if unknown:
            raise ValueError(
                f"ii_scale names unknown stages {sorted(unknown)}; a typo'd "
                f"or regrouped key would silently skip calibration")
    g = STG()
    prev = None
    for st in stages:
        impls = impl_library(st, hw=hw, train=info["train"], max_tp=max_tp)
        if ii_scale and st.name in ii_scale:
            impls = scale_impls(impls, ii_scale[st.name])
        g.add_node(Node(name=st.name, impls=tuple(impls)))
        if prev is not None:
            g.connect(prev, st.name)
        prev = st.name
    info["stages"] = {st.name: st for st in stages}
    return g, info
