"""The card's published rates, and the bytes a decode stage must move.

Copied from ``repro/analysis/roofline.py``: `Hardware`,
`decode_stage_bytes` and `fraction_of_roofline`, with the names and
behaviour unchanged.  The JAX package's TPU table is not copied; the
port's one entry is `HW_H100`.
"""
from __future__ import annotations

from dataclasses import dataclass


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


def fraction_of_roofline(step_bytes: float, measured_s: float,
                         bw: float) -> float:
    """measured step time vs its bytes/bw floor: 1.0 = at the roofline;
    > 1 means the bound is loose for this run (e.g. the working set sits
    in cache levels above DRAM, common for smoke-sized models)."""
    if measured_s <= 0 or bw <= 0:
        return float("nan")
    return (step_bytes / bw) / measured_s
