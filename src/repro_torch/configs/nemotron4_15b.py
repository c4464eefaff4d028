"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP (non-gated).

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819]."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    d_ff=24576,
    vocab=256_000,
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=48, n_kv_heads=8, head_dim=128),
    act="sq_relu",
    optimizer="adamw",
    source="arXiv:2402.16819",
)
