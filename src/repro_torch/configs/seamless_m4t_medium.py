"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596].
12 encoder + 12 decoder layers; the speech frontend is a STUB supplying
1024 precomputed frame embeddings.  Decoder has a decode step (enc-dec, not
encoder-only), so decode shapes run; full attention => long_500k skipped."""
from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers; enc_layers mirrors it
    d_model=1024,
    d_ff=4096,
    vocab=256_206,               # padded to 256256
    block_pattern=(("attn", "dense"),),
    attn=AttnCfg(n_heads=16, n_kv_heads=16, head_dim=64),
    act="gelu",
    encdec=True,
    enc_layers=12,
    frontend="audio_stub",
    num_prefix=1024,             # encoder frame-embedding length
    optimizer="adamw",
    grad_accum=4,
    source="arXiv:2308.11596",
)
