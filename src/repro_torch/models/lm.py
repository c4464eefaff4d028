"""Dense decoder-only LM: parameters, prompt pass and decode step.

Ported from ``repro/models/lm.py`` for the dense attention configs
(``block_pattern`` (("attn", "dense"),), no encoder, no multimodal
prefix).  The JAX package stacks each parameter over layer periods and
scans; here the layers are an ``nn.ModuleList`` and the scan is a loop.

Serving keeps the cache on the device between steps:

  * `prefill` allocates the cache once per round, at its full capacity
    (prompt bucket + tokens still to come), and fills it in ring layout;
  * `decode_step` writes one slot per layer in place and bumps the
    position in place: it allocates no cache, and the position stays a
    device scalar, so a step makes no host sync;
  * positions past the capacity wrap (slot ``pos % C``), which only a
    sliding-window config reaches.
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
    if (cfg.block_pattern != (("attn", "dense"),) or cfg.encdec or cfg.frontend
            or cfg.attn is None):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention decoders only")


class DecoderLayer(nn.Module):
    """One layer: attention sublayer (``mixer``) then MLP (``mlp``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.mixer = blocks.Attention(cfg, device=device, generator=generator)
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
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, *, device, generator: torch.Generator) -> LM:
    """Random weights on ``device``, drawn from ``generator``."""
    return LM(cfg, device=device, generator=generator)


def _head(cfg: ModelConfig, params: LM):
    return params.embed.T if cfg.tie_embeddings else params.head


def _embed_inputs(cfg: ModelConfig, params: LM, batch):
    """Token embeddings (B, S, D) in the compute dtype."""
    return params.embed[batch["tokens"]]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, dtype, device):
    """``{"pos": () int32, "layers": [{"k", "v"} per layer]}``, zeroed;
    a sliding-window config caps the capacity at its window."""
    cap = blocks.attn_cache_capacity(cfg, capacity)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": [blocks.init_attn_cache(cfg, batch, cap, dtype, device)
                       for _ in range(cfg.n_layers)]}


def prefill_blocks(cfg: ModelConfig, layers, x, positions, caches, *, impl=None):
    """Prompt pass over ``layers``, filling each layer's cache in place:
    position p lands in slot p % C.  Returns the hidden states."""
    S = x.shape[1]
    for layer, c in zip(layers, caches):
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
    place.  ``impl=None`` runs attention through the composed step and the
    kernels, ``"ref"`` through the op-by-op oracle body."""
    for layer, c in zip(layers, caches):
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
