"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
Mamba2 blocks have no separate MLP (d_ff=0): the block IS the mixer, so the
pattern uses a mamba mixer with no MLP sublayer (we encode that as a dense
MLP of width 0 being skipped — see models/lm.py)."""
from .base import MambaCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    d_ff=0,                      # attn-free SSD blocks carry no MLP
    vocab=50_280,                # GPT-NeoX tokenizer; padded to 50432
    block_pattern=(("mamba", "dense"),),
    mamba=MambaCfg(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1),
    act="silu_glu",
    optimizer="adamw",
    grad_accum=4,
    tie_embeddings=True,         # as in the released 370m checkpoint
    source="arXiv:2405.21060",
)
