"""Decoder-only LM: parameters, prompt pass and decode step.

Ported from ``repro/models/lm.py`` for decoders whose layers are
attention or Mamba2 mixers with a dense MLP (the dense configs and
mamba2-370m); no MoE, no encoder, no multimodal prefix.  The JAX package
stacks each parameter over layer periods of ``block_pattern`` and scans;
here layer ``p * len(pattern) + i`` is built from ``block_pattern[i]``,
the layers are an ``nn.ModuleList`` and the scan is a loop.

Serving keeps the cache on the device between steps:

  * `prefill` allocates the cache once per round, at its full capacity
    (prompt bucket + tokens still to come), and fills it in ring layout;
  * `decode_step` writes one slot per layer in place and bumps the
    position in place: it allocates no cache, and the position stays a
    device scalar, so a step makes no host sync;
  * positions past the capacity wrap (slot ``pos % C``), which only a
    sliding-window config reaches;
  * a Mamba layer's cache is its conv tail and its SSM state, both
    overwritten in place by each step.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import blocks
from .common import rmsnorm


def _check_supported(cfg: ModelConfig) -> None:
    if any(mlp != "dense" for _, mlp in cfg.block_pattern) or cfg.encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoders of attention and Mamba2 layers with "
            "dense MLPs; MoE, encoder-decoder and multimodal frontends are not ported")


class DecoderLayer(nn.Module):
    """One layer: the mixer (``attn`` or ``mamba``) then the MLP (``mlp``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, generator=None):
        super().__init__()
        self.kind = kind
        mixer = blocks.Attention if kind == "attn" else blocks.Mamba
        self.mixer = mixer(cfg, device=device, generator=generator)
        self.mlp = blocks.MLP(cfg, device=device, generator=generator)


class LM(nn.Module):
    """The parameters of `init_params`, under the JAX names: ``embed``
    (Vp, D), ``final_norm`` (D,), ``head`` (D, Vp) unless tied, and
    ``layers``.  With no generator the storage is left unset, for
    ``bridge.py`` to fill."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab
        make = blocks.weight_maker(cfg, device, generator)
        self.embed = make((vp, d), scale=0.02)
        self.final_norm = blocks.frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.head = None if cfg.tie_embeddings else make((d, vp))
        pattern = cfg.block_pattern
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, pattern[i % len(pattern)][0], device=device,
                         generator=generator)
            for i in range(cfg.n_layers))


def init_params(cfg: ModelConfig, *, device, generator: torch.Generator) -> LM:
    """Random weights on ``device``, drawn from ``generator``."""
    return LM(cfg, device=device, generator=generator)


def _head(cfg: ModelConfig, params: LM):
    return params.embed.T if cfg.tie_embeddings else params.head


def _embed_inputs(cfg: ModelConfig, params: LM, batch):
    """Token embeddings (B, S, D) in the compute dtype."""
    return params.embed[batch["tokens"]]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, dtype, device,
               span: tuple[int, int] | None = None):
    """``{"pos": () int32, "layers": [one cache a layer]}``, zeroed: {"k",
    "v"} for attention (a sliding-window config caps the capacity at its
    window), {"conv", "ssm"} for Mamba.  ``span``: the layers [lo, hi) to
    make caches for (a pipeline stage's); every layer by default."""
    cap = blocks.attn_cache_capacity(cfg, capacity)
    pattern = cfg.block_pattern
    lo, hi = span or (0, cfg.n_layers)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": [blocks.init_attn_cache(cfg, batch, cap, dtype, device)
                       if pattern[i % len(pattern)][0] == "attn"
                       else blocks.init_mamba_cache(cfg, batch, dtype, device)
                       for i in range(lo, hi)]}


def prefill_blocks(cfg: ModelConfig, layers, x, positions, caches, *, impl=None):
    """Prompt pass over ``layers``, filling each layer's cache in place:
    position p lands in slot p % C of an attention cache; a Mamba cache
    takes the conv tail and the final SSM state.  Returns the hidden
    states."""
    S = x.shape[1]
    for layer, c in zip(layers, caches):
        if layer.kind == "mamba":
            x, (conv, ssm) = layer.mixer(x, impl=impl)
            c["conv"].copy_(conv)
            c["ssm"].copy_(ssm)
        else:
            x, (k, v) = layer.mixer(x, positions, impl=impl, return_kv=True)
            cap = c["k"].shape[1]
            if S >= cap:       # ring layout: the last cap positions, rolled
                shift = (S - cap) % cap
                c["k"].copy_(torch.roll(k[:, -cap:], shift, dims=1))
                c["v"].copy_(torch.roll(v[:, -cap:], shift, dims=1))
            else:              # the slots past the prompt stay zero
                c["k"][:, :S].copy_(k)
                c["v"][:, :S].copy_(v)
        x = layer.mlp(x, impl=impl)
    return x


def prefill(cfg: ModelConfig, params: LM, batch, *, capacity: int | None = None,
            impl=None):
    """Prompt pass: last-token logits (B, 1, Vp) and a decode-ready cache.

    ``capacity``: cache length to allocate (prompt + tokens still to be
    generated); defaults to the prompt length."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, capacity or S, dtype=x.dtype, device=x.device)
    x = prefill_blocks(cfg, params.layers, x, positions, cache["layers"], impl=impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, impl)
    logits = x[:, -1:] @ _head(cfg, params)
    cache["pos"].fill_(S)
    return logits, cache


def decode_blocks(cfg: ModelConfig, layers, caches, x, pos, *, impl=None):
    """One decode step over ``layers``; each layer's cache is updated in
    place.  ``impl=None`` runs attention through `ops.attn_decode_step`
    (the chain of kernels on the card), ``"ref"`` through the op-by-op
    oracle body."""
    for layer, c in zip(layers, caches):
        if layer.kind == "mamba":
            x, _ = layer.mixer.decode(x, c, impl=impl)
        else:
            x, _ = layer.mixer.decode(x, c, pos, impl=impl)
        x = layer.mlp(x, impl=impl)
    return x


def decode_step(cfg: ModelConfig, params: LM, cache, tokens, *, impl=None):
    """One token for every sequence.  tokens: (B, 1) integer device tensor.
    Returns logits (B, 1, Vp) and ``cache``, updated in place: the ring
    slots and ``pos`` (+1)."""
    x = params.embed[tokens]
    pos = cache["pos"]
    x = decode_blocks(cfg, params.layers, cache["layers"], x, pos, impl=impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, impl)
    logits = x @ _head(cfg, params)
    pos.add_(1)
    return logits, cache


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable


def build_model(cfg: ModelConfig, impl: str | None = None) -> Model:
    _check_supported(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        prefill=functools.partial(prefill, cfg, impl=impl),
        decode_step=functools.partial(decode_step, cfg, impl=impl),
    )
