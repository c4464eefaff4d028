"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4].  MoE on alternate layers (Maverick's interleaved
dense/MoE), shared expert always-on -> ~400B total / ~17B active.  The
vision "early fusion" frontend is a stub (patch embeddings as inputs) per
the assignment; text-only cells use no prefix."""
from .base import AttnCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab=202_048,
    block_pattern=(("attn", "dense"), ("attn", "moe")),
    attn=AttnCfg(n_heads=40, n_kv_heads=8, head_dim=128),
    moe=MoECfg(n_experts=128, top_k=1, d_ff=8192, shared_expert=True),
    act="silu_glu",
    optimizer="adafactor",
    grad_accum=16,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
