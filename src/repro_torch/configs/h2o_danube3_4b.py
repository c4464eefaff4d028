"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818].
SWA window 4096 makes long-context decode sub-quadratic (ring-buffer KV)."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab=32_000,
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=120, window=4096),
    act="silu_glu",
    optimizer="adamw",
    source="arXiv:2401.16818",
)
