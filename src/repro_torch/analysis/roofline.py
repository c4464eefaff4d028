"""The card's published rates, a step's roofline, and the bytes a decode
stage must move.

Copied from ``repro/analysis/roofline.py``: `Hardware`, `CollectiveStats`,
`RooflineReport`, `decode_stage_bytes`, `measure_host_bandwidth` and
`fraction_of_roofline`, with the names and behaviour unchanged.
`analyze_step` is ``analyze_compiled`` without a compiled program: from a
step's global counts (`analysis.step_cost.count_step`) and, on a mesh of
``n_devices``, the collectives its eager meshed run issued
(`analysis.collectives.count_collectives`, the counterpart of
``parse_collectives`` and ``hlo.collect``), the three terms

    compute    = FLOPs      / (n_devices * peak FLOP/s)
    memory     = bytes      / (n_devices * HBM rate)
    collective = wire bytes / (n_devices * link rate)

the bottleneck, the model's FLOPs (6 N D to train, 2 N D otherwise), and
the bound on the step's time, tokens a second and MFU.  On one card, with
no collectives given, the collective term is 0.  The JAX package's TPU
table is not copied; the port's one entry is `HW_H100`.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float       # per chip, bf16
    hbm_bw: float           # bytes/s per chip
    link_bw: float          # bytes/s per chip-to-chip link
    hbm_bytes: float        # capacity per chip


# NVIDIA's published H100 SXM figures: dense bf16 tensor-core rate, HBM3
# rate and capacity.  link_bw is NVLink 4 in one direction: 18 links of
# 25 GB/s each way, 450 GB/s (the 900 GB/s of the data sheet counts both
# directions).  The planner prices a router by the time one firing's
# activations take to leave a chip, which moves them one way.
HW_H100 = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                   link_bw=450e9, hbm_bytes=80e9)


@dataclass
class CollectiveStats:
    op_bytes: dict[str, float] = field(default_factory=dict)   # shard bytes by kind
    wire_bytes: dict[str, float] = field(default_factory=dict)  # ring-cost traffic
    counts: dict[str, int] = field(default_factory=dict)

    def total_wire(self) -> float:
        return sum(self.wire_bytes.values())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float
    hlo_bytes: float
    wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    collectives: dict
    per_device_peak_memory: float | None = None
    step_time_bound_s: float = 0.0
    tokens_per_s: float = 0.0
    mfu: float = 0.0
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def model_flops(cfg, kind: str, tokens: float) -> float:
    """The model's FLOPs for ``tokens`` tokens: 6 N D to train, 2 N D to
    serve, N the active parameters (`ModelConfig.active_param_count`)."""
    return (6.0 if kind == "train" else 2.0) * cfg.active_param_count() * tokens


def analyze_step(*, arch: str, shape_name: str, kind: str, cfg, tokens: float,
                 step_flops: float, step_bytes: float, hw: Hardware = HW_H100,
                 n_devices: int = 1, mesh_name: str = "1",
                 collectives: CollectiveStats | None = None,
                 per_device_peak_memory: float | None = None) -> RooflineReport:
    """The roofline of one step on ``n_devices`` cards of ``hw`` from its
    whole-step counts (``step_flops`` / ``step_bytes``:
    `step_cost.count_step`) and its ``collectives``
    (`collectives.count_collectives`; None: none): compute = FLOPs / (n
    peak), memory = bytes / (n HBM rate), collective = wire bytes / (n
    link rate), the largest the bound on the step's time and the
    bottleneck.  ``per_device_peak_memory`` is the caller's bytes a
    device (the dry run's argument bytes: there is no compiled program
    to give temporaries), carried into the report."""
    coll = collectives or CollectiveStats()
    n = n_devices
    compute_s = step_flops / (n * hw.peak_flops)
    memory_s = step_bytes / (n * hw.hbm_bw)
    collective_s = coll.total_wire() / (n * hw.link_bw)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops(cfg, kind, tokens)
    if collectives is None:
        note = ("one card: no collectives (the JAX package parses them from its "
                "partitioned HLO, which the port has not); FLOPs and bytes from "
                "step_cost.count_step over the plain versions on the meta device")
    else:
        note = (f"{n} devices: collectives as the eager meshed step issued them "
                "(collectives.count_collectives); FLOPs and bytes from "
                "step_cost.count_step over the plain versions on the meta device")
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n, hlo_flops=step_flops,
        hlo_bytes=step_bytes, wire_bytes=coll.total_wire(), compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, bottleneck=bottleneck,
        model_flops=useful, useful_flops_ratio=(useful / step_flops) if step_flops else 0.0,
        collectives={"counts": coll.counts, "wire_bytes": coll.wire_bytes},
        per_device_peak_memory=per_device_peak_memory, step_time_bound_s=bound,
        tokens_per_s=(tokens / bound) if bound else 0.0,
        mfu=(useful / (n * hw.peak_flops)) / bound if bound else 0.0, note=note)


def _dtype_size(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(name, 4)


def decode_stage_bytes(cfg, batch: int, cache_len: int, *,
                       span: tuple[int, int] | None = None,
                       has_embed: bool = False,
                       has_head: bool = False) -> float:
    """Bytes a pipeline stage must move for ONE decode step.

    Each weight read once, the live KV prefix read once (k and v, at
    ``cache_len``), one ring slot written back, Mamba conv/ssm state read
    and written, plus the (B, D) activation in and out.  Embed adds the B
    gathered rows (the table is indexed, not streamed); head streams the
    (D, V) projection and writes the (B, V) logits.

    ``span``: (lo, hi) *period* range the stage owns (layers
    [lo*len(pattern), hi*len(pattern))); None = no block layers.
    ``cache_len``: live KV slots per attention layer (callers clamp to the
    ring capacity).  Returns float bytes; divide by the memory rate for
    the stage's step-time floor.
    """
    d = cfg.d_model
    pb = _dtype_size(cfg.param_dtype)
    ab = _dtype_size(cfg.compute_dtype)
    gated = cfg.act == "silu_glu"
    total = 0.0

    def ffn_bytes(d_ff):
        return ((3 if gated else 2) * d * d_ff) * pb

    layers = [] if span is None \
        else list(cfg.block_pattern) * (span[1] - span[0])
    for mixer, mlp in layers:
        total += d * 4                          # mixer norm (f32)
        if mixer == "attn":
            a = cfg.attn
            hd, h, kv = a.head_dim, a.n_heads, a.n_kv_heads
            total += d * (h + 2 * kv) * hd * pb + h * hd * d * pb
            if a.qkv_bias:
                total += (h + 2 * kv) * hd * pb
            # live prefix read (k + v) + one slot written (k + v)
            total += batch * cache_len * kv * hd * ab * 2
            total += batch * kv * hd * ab * 2
        else:
            m = cfg.mamba
            di = m.d_inner(d)
            H = m.n_ssm_heads(d)
            N = m.d_state
            total += (d * 2 * di + d * (2 * m.n_groups * N + H)
                      + m.d_conv * di + di * d) * pb
            total += (3 * H + di) * 4           # dt_bias/a_log/d_skip/gate_norm
            # conv history r+w (act dtype) and ssm state r+w (f32)
            total += 2 * batch * (m.d_conv - 1) * di * ab
            total += 2 * batch * H * m.head_dim * N * 4
        total += d * 4                          # mlp norm (f32)
        if mlp == "dense":
            if cfg.d_ff:
                total += ffn_bytes(cfg.d_ff)
        else:
            e = cfg.moe
            total += d * e.n_experts * 4        # router (f32)
            # at most top_k*batch distinct experts' weights stream per step
            total += min(e.top_k * batch, e.n_experts) * ffn_bytes(e.d_ff)
            if e.shared_expert:
                total += ffn_bytes(e.d_ff)
        total += 2 * batch * d * ab             # activation in/out
    if has_embed:
        total += batch * d * pb                 # gathered rows only
    if has_head:
        total += d * 4                          # final norm
        total += d * cfg.padded_vocab * pb + batch * cfg.padded_vocab * ab
    return total


def measure_host_bandwidth(mbytes: int = 256, repeats: int = 5) -> float:
    """Achievable host memory bandwidth (bytes/s), measured.

    One `numpy` buffer copy (read + write) over a buffer far larger than
    any cache level, best of ``repeats`` — the realistic peak for
    roofline fractions on the host, where the card's datasheet numbers
    do not apply.  Card runs should use the `Hardware` table instead.
    """
    import numpy as np
    n = mbytes * (1 << 20) // 8
    src = np.ones(n, np.float64)
    dst = np.empty_like(src)
    best = float("inf")
    np.copyto(dst, src)                  # warm: fault pages, warm TLBs
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2 * n * 8 / best


def fraction_of_roofline(step_bytes: float, measured_s: float,
                         bw: float) -> float:
    """measured step time vs its bytes/bw floor: 1.0 = at the roofline;
    > 1 means the bound is loose for this run (e.g. the working set sits
    in cache levels above DRAM, common for smoke-sized models)."""
    if measured_s <= 0 or bw <= 0:
        return float("nan")
    return (step_bytes / bw) / measured_s
