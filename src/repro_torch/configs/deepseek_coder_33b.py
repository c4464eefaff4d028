"""deepseek-coder-33b [dense] — llama-arch GQA.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 [arXiv:2401.14196]."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab=32_256,
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=56, n_kv_heads=8, head_dim=128),
    act="silu_glu",
    optimizer="adamw",
    source="arXiv:2401.14196",
)
