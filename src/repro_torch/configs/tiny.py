"""tiny — a ~10-20M-param dense config for runnable CPU examples/tests."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="tiny",
    family="dense",
    n_layers=4,
    d_model=256,
    d_ff=1024,
    vocab=4096,
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=8, n_kv_heads=4, head_dim=32),
    act="silu_glu",
    optimizer="adamw",
    grad_accum=1,
    remat="none",
    source="(local)",
)
