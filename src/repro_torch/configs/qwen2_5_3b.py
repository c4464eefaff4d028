"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 [hf:Qwen/Qwen2.5]."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab=151_936,
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=16, n_kv_heads=2, head_dim=128, qkv_bias=True),
    act="silu_glu",
    optimizer="adamw",
    grad_accum=4,
    source="hf:Qwen/Qwen2.5-0.5B",
)
