"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 on
every layer -> ~109B total / ~17B active [hf:meta-llama/Llama-4-Scout]."""
from .base import AttnCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab=202_048,
    block_pattern=(("attn", "moe"),),
    attn=AttnCfg(n_heads=40, n_kv_heads=8, head_dim=128),
    moe=MoECfg(n_experts=16, top_k=1, d_ff=8192, shared_expert=True),
    act="silu_glu",
    optimizer="adamw",
    grad_accum=8,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
