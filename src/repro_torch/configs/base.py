"""Model/shape configuration system.

Every assigned architecture is a ``ModelConfig`` (src/repro/configs/<id>.py)
selectable via ``--arch``; shapes are the assigned (seq_len, global_batch)
grid.  ``reduced()`` returns a tiny same-family config for CPU smoke tests;
full configs are only ever lowered AOT (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


VOCAB_PAD = 256  # Megatron-style padding so vocab shards over 16-way TP


def pad_vocab(v: int, multiple: int = VOCAB_PAD) -> int:
    return -(-v // multiple) * multiple


@dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int | None = None       # sliding-window attention (SWA) width
    qkv_bias: bool = False
    rope_theta: float = 10_000.0


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    # block pattern: tuple of (mixer, mlp) pairs cycled over layers.
    #   mixer in {"attn", "mamba"}; mlp in {"dense", "moe"}
    block_pattern: tuple[tuple[str, str], ...] = (("attn", "dense"),)
    attn: AttnCfg | None = None
    mamba: MambaCfg | None = None
    moe: MoECfg | None = None
    act: str = "silu_glu"            # silu_glu | sq_relu | gelu
    norm_eps: float = 1e-5
    # encoder-decoder (audio family)
    encdec: bool = False
    enc_layers: int = 0
    # multimodal frontend stubs: prefix embeddings supplied as inputs
    frontend: str | None = None      # None | "vit_stub" | "audio_stub"
    num_prefix: int = 0              # patch/frame prefix length
    # numerics & training defaults
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor (for the 400B-class)
    grad_accum: int = 8
    remat: str = "full"              # full | dots | none
    tie_embeddings: bool = False
    # paper citation tag
    source: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, \
            f"{self.name}: pattern of {len(self.block_pattern)} must divide {self.n_layers}"
        for mixer, mlp in self.block_pattern:
            assert mixer in ("attn", "mamba") and mlp in ("dense", "moe")
            if mixer == "attn":
                assert self.attn is not None
            if mixer == "mamba":
                assert self.mamba is not None
            if mlp == "moe":
                assert self.moe is not None

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is admissible (SSM / hybrid / SWA)."""
        if all(mixer == "mamba" for mixer, _ in self.block_pattern):
            return True
        if any(mixer == "mamba" for mixer, _ in self.block_pattern):
            return True  # hybrid
        return self.attn is not None and self.attn.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f = self.d_model, self.d_ff
        total = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        for mixer, mlp in self.block_pattern:
            n = self.n_periods
            if mixer == "attn":
                a = self.attn
                qkv = d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
                o = a.n_heads * a.head_dim * d
                total += n * (qkv + o)
                if a.qkv_bias:
                    total += n * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
            else:
                m = self.mamba
                di = m.d_inner(d)
                h = m.n_ssm_heads(d)
                total += n * (d * 2 * di                       # xz in-proj
                              + d * (2 * m.n_groups * m.d_state + h)  # B, C, dt
                              + m.d_conv * di + di * d + 2 * h)       # conv, out, A/D
            if mlp == "dense":
                mult = 3 if self.act == "silu_glu" else 2
                total += n * mult * d * f
            else:
                e = self.moe
                mult = 3 if self.act == "silu_glu" else 2
                total += n * (e.n_experts * mult * d * e.d_ff + d * e.n_experts)
                if e.shared_expert:
                    total += n * mult * d * e.d_ff
            total += n * 2 * d  # norms
        if self.encdec:
            # decoder cross-attention + its norms (encoder counted above via
            # n_layers = enc; decoder layers counted separately by caller)
            pass
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE rooflines: 6*N_active*D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        mult = 3 if self.act == "silu_glu" else 2
        inactive = 0
        for mixer, mlp in self.block_pattern:
            if mlp == "moe":
                inactive += self.n_periods * (e.n_experts - e.top_k) * mult * d * e.d_ff
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_attn = None
        if self.attn is not None:
            small_attn = replace(self.attn, n_heads=4,
                                 n_kv_heads=max(1, min(self.attn.n_kv_heads, 2)),
                                 head_dim=16,
                                 window=64 if self.attn.window else None)
        small_mamba = None
        if self.mamba is not None:
            small_mamba = replace(self.mamba, d_state=16, head_dim=8)
        small_moe = None
        if self.moe is not None:
            small_moe = replace(self.moe, n_experts=4,
                                top_k=min(self.moe.top_k, 2), d_ff=64)
        return replace(
            self, name=self.name + "-smoke",
            n_layers=2 * len(self.block_pattern), d_model=64, d_ff=128,
            vocab=512, attn=small_attn, mamba=small_mamba, moe=small_moe,
            enc_layers=2 if self.encdec else 0,
            num_prefix=8 if self.frontend else 0,
            grad_accum=1, remat="none")


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """The assigned-cell applicability rule (skips noted in DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; long-context decode skipped"
    return True, ""
