"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887].  Period of 8 layers: 1 attention + 7 mamba; MoE on
alternate layers (4 MoE per period -> 36 MoE layers) which reproduces the
~398B total / ~94B active split.  Optimiser is Adafactor (400B-class AdamW
state does not fit a single 256-chip pod; see EXPERIMENTS.md §Dry-run)."""
from .base import AttnCfg, MambaCfg, ModelConfig, MoECfg

_P = (
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab=65_536,
    block_pattern=_P,
    attn=AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128),
    mamba=MambaCfg(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1),
    moe=MoECfg(n_experts=16, top_k=2, d_ff=24576),
    act="silu_glu",
    optimizer="adafactor",
    grad_accum=16,
    source="arXiv:2403.19887",
)
