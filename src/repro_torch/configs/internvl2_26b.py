"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2 backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821].
The ViT is a frontend stub per the assignment: ``input_specs()`` supplies
256 precomputed patch embeddings prepended to the token sequence."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab=92_553,                # padded to 92672
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=48, n_kv_heads=8, head_dim=128),
    act="silu_glu",
    frontend="vit_stub",
    num_prefix=256,
    optimizer="adamw",
    source="arXiv:2404.16821",
)
