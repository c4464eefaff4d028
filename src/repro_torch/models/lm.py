"""The LM: parameters, the full-sequence forward and loss (training), the
prompt pass and the decode step (serving).

Ported from ``repro/models/lm.py`` for stacks of attention or Mamba2
mixers, each followed by a dense or an MoE MLP: the decoders, the Mamba2
stack, the MoE decoders, the hybrid (attention and Mamba2 layers in one
pattern, an MoE after either), the encoder-decoder family (an encoder of
non-causal layers over ``batch["frames"]``, cross-attended by every
decoder layer) and the prefix frontend (``batch["prefix_embeds"]`` ahead
of the tokens).  The JAX package stacks each parameter over
layer periods of ``block_pattern`` and scans; here layer ``p *
len(pattern) + i`` is built from ``block_pattern[i]``, the layers are an
``nn.ModuleList`` and the scan is a loop.

Serving keeps the cache on the device between steps:

  * `prefill` allocates the cache once per round, at its full capacity
    (prompt bucket, prefix included, + tokens still to come), and fills it
    in ring layout;
  * `decode_step` writes one slot per layer in place and bumps the
    position in place: it allocates no cache, and the position stays a
    device scalar, so a step makes no host sync;
  * positions past the capacity wrap (slot ``pos % C``), which only a
    sliding-window config reaches;
  * a Mamba layer's cache is its conv tail and its SSM state, both
    overwritten in place by each step;
  * an encoder-decoder layer's cache is {"self": its own, "cross_k",
    "cross_v"}: the encoder output's K/V, written once by `prefill` and
    only read by decode; their length is kept as a device scalar,
    ``cache["cross_len"]``, for the decode attention kernel.

Training runs `loss_fn` → `forward` → `_run_stack` over float32 masters
(``init_params(..., param_dtype=torch.float32)``), each period of layers
under `_remat`'s policy, and `common.chunked_lm_loss`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from .. import sharding_ctx as sc
from ..configs.base import ModelConfig
from . import blocks
from .common import chunked_lm_loss, dtype_of, rmsnorm


class DecoderLayer(nn.Module):
    """One layer: the mixer (``attn`` or ``mamba``), with ``cross`` (a
    decoder layer of an encoder-decoder) the cross-attention, then the MLP
    (``mlp``: `blocks.MLP`, or `blocks.MoE` where ``mlp_kind`` is
    ``"moe"``), as JAX `_apply_period` orders them."""

    def __init__(self, cfg: ModelConfig, kind: str, mlp_kind: str = "dense", *, device,
                 generator=None, param_dtype=None, cross: bool = False):
        super().__init__()
        self.kind, self.moe = kind, mlp_kind == "moe"
        mixer = blocks.Attention if kind == "attn" else blocks.Mamba
        kw = dict(device=device, generator=generator, param_dtype=param_dtype)
        self.mixer = mixer(cfg, **kw)
        self.cross = blocks.CrossAttention(cfg, **kw) if cross else None
        self.mlp = (blocks.MoE if self.moe else blocks.MLP)(cfg, **kw)


class LM(nn.Module):
    """The parameters of `init_params`, under the JAX names: ``embed``
    (Vp, D), ``final_norm`` (D,), ``head`` (D, Vp) unless tied, ``layers``
    and, for an encoder-decoder, ``enc_layers`` and ``enc_norm`` (D,)
    (None otherwise).  With no generator the storage is left unset, for
    ``bridge.py`` to fill.  ``param_dtype``: None for serving (weights in
    the compute dtype, no gradients); a dtype for training (the masters
    the optimizer updates, with gradients).  ``keep``: None, or a test of
    the names ``"embed"``, ``"final_norm"``, ``"head"`` and ``"layers.<i>"``;
    what it leaves out is drawn all the same, so the rest are the whole
    model's draws, and goes to the ``meta`` device at once."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None,
                 param_dtype: torch.dtype | None = None, keep=None):
        super().__init__()
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab

        def kept(name, x):
            if x is None or keep is None or keep(name):
                return x
            if isinstance(x, nn.Module):
                return x.to("meta")
            return nn.Parameter(x.to("meta"), requires_grad=x.requires_grad)

        make = blocks.Maker(cfg, device, generator, param_dtype)
        self.embed = kept("embed", make.weight((vp, d), scale=0.02))
        self.final_norm = kept("final_norm", make.fill(1.0, (d,)))
        self.head = None if cfg.tie_embeddings else kept("head", make.weight((d, vp)))
        pattern = cfg.block_pattern
        kw = dict(device=device, generator=generator, param_dtype=param_dtype)
        self.layers = nn.ModuleList(
            kept(f"layers.{i}",
                 DecoderLayer(cfg, *pattern[i % len(pattern)], cross=cfg.encdec, **kw))
            for i in range(cfg.n_layers))
        self.enc_layers = self.enc_norm = None
        if cfg.encdec:
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, *pattern[i % len(pattern)], **kw)
                for i in range(cfg.enc_layers))
            self.enc_norm = make.fill(1.0, (d,))


def init_params(cfg: ModelConfig, *, device, generator: torch.Generator,
                param_dtype: torch.dtype | None = None, keep=None) -> LM:
    """Random weights on ``device``, drawn from ``generator``; trainable
    masters of ``param_dtype`` if one is given; only those ``keep`` passes
    held (`LM`)."""
    return LM(cfg, device=device, generator=generator, param_dtype=param_dtype, keep=keep)


def _head(cfg: ModelConfig, params: LM):
    return params.embed.T if cfg.tie_embeddings else params.head


def _embed_inputs(cfg: ModelConfig, params: LM, batch):
    """Token embeddings (B, S, D) in the compute dtype, after
    ``batch["prefix_embeds"]`` (B, P, D) where the config has the prefix
    frontend and the batch has them; and P (0 without)."""
    dt = dtype_of(cfg.compute_dtype)
    x = sc.act(sc.lookup(params.embed, batch["tokens"]).to(dt), "dp", "sp", None)
    if cfg.frontend != "vit_stub" or "prefix_embeds" not in batch:
        return x, 0
    pre = batch["prefix_embeds"].to(dt)
    return torch.cat([pre, x], dim=1), pre.shape[1]


# ===========================================================================
# training: the full-sequence forward and the loss
# ===========================================================================
# `_remat`'s "dots" policy: keep every matrix product's output, recompute
# the rest (``jax.checkpoint_policies.checkpoint_dots``)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``"none"``: ``fn`` as it is; ``"full"``: keep only its inputs and
    recompute the rest in the backward pass; ``"dots"``: keep its matrix
    products' outputs too."""
    if mode == "none":
        return fn
    if mode == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, context_fn=context)
    if mode == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"remat must be none, dots or full, got {mode!r}")


def _apply_period(layers, x, positions, enc_out, *, causal: bool = True, impl=None):
    for layer in layers:
        if layer.kind == "mamba":
            x, _ = layer.mixer(x, impl=impl)
        else:
            x = layer.mixer(x, positions, causal=causal, impl=impl)
        if layer.cross is not None:
            x = layer.cross(x, *layer.cross.kv(enc_out), impl=impl)
        x = layer.mlp(x, impl=impl)
    return x


def _run_stack(cfg: ModelConfig, layers, x, positions, *, causal: bool = True, enc_out=None,
               impl=None, remat: str | None = None):
    """Every period of ``block_pattern`` in turn, each under `_remat`;
    ``enc_out``: the encoder's output, for the layers' cross-attention."""
    n = len(cfg.block_pattern)
    periods = [layers[i:i + n] for i in range(0, len(layers), n)]
    body = _remat(functools.partial(_apply_period, causal=causal, impl=impl),
                  remat if remat is not None else cfg.remat)
    for period in periods:
        x = body(period, x, positions, enc_out)
    return x


def _encode(cfg: ModelConfig, params: LM, batch, *, impl=None, remat: str | None = None):
    """The encoder over ``batch["frames"]`` (B, Se, D): its layers, not
    causal, at positions ``arange(Se)``, then ``enc_norm``."""
    frames = sc.act(batch["frames"].to(dtype_of(cfg.compute_dtype)), "dp", "sp", None)
    positions = torch.arange(frames.shape[1], device=frames.device)
    enc = _run_stack(cfg, params.enc_layers, frames, positions, causal=False, impl=impl,
                     remat=remat)
    return rmsnorm(enc, params.enc_norm, cfg.norm_eps, impl)


def forward(cfg: ModelConfig, params: LM, batch, *, impl=None, remat: str | None = None):
    """Full-sequence forward: the final hidden states (B, P + S, D), after
    the final norm, and the prefix length P (`_embed_inputs`)."""
    enc_out = _encode(cfg, params, batch, impl=impl, remat=remat) if cfg.encdec else None
    x, n_prefix = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(cfg, params.layers, x, positions, enc_out=enc_out, impl=impl, remat=remat)
    return rmsnorm(x, params.final_norm, cfg.norm_eps, impl), n_prefix


def loss_fn(cfg: ModelConfig, params: LM, batch, *, impl=None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (masked by
    ``batch["mask"]`` where given), the prefix rows left out: (loss,
    {"loss": loss}); each period of layers under ``cfg.remat``."""
    x, n_prefix = forward(cfg, params, batch, impl=impl)
    loss = chunked_lm_loss(x[:, n_prefix:], _head(cfg, params), batch["labels"],
                           batch.get("mask"))
    return loss, {"loss": loss}


def logits_fn(cfg: ModelConfig, params: LM, batch, *, impl=None, last_only: bool = True):
    x, _ = forward(cfg, params, batch, impl=impl, remat="none")
    h = x[:, -1:] if last_only else x
    return h @ _head(cfg, params).to(x.dtype)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, dtype, device,
               span: tuple[int, int] | None = None, enc_len: int | None = None):
    """``{"pos": () int32, "layers": [one cache a layer]}``, zeroed: {"k",
    "v"} for attention (a sliding-window config caps the capacity at its
    window), {"conv", "ssm"} for Mamba.  An encoder-decoder's layer cache
    is {"self": that, "cross_k", "cross_v"} of (B, Se, KV, hd), Se =
    ``enc_len`` or ``cfg.num_prefix``, and ``"cross_len"`` holds Se as a
    () int32 device tensor.  ``span``: the layers [lo, hi) to make caches
    for (a pipeline stage's); every layer by default."""
    cap = blocks.attn_cache_capacity(cfg, capacity)
    pattern = cfg.block_pattern
    lo, hi = span or (0, cfg.n_layers)
    layers = [blocks.init_attn_cache(cfg, batch, cap, dtype, device)
              if pattern[i % len(pattern)][0] == "attn"
              else blocks.init_mamba_cache(cfg, batch, dtype, device)
              for i in range(lo, hi)]
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device), "layers": layers}
    if cfg.encdec:
        se = enc_len or cfg.num_prefix
        cross = (batch, se, cfg.attn.n_kv_heads, cfg.attn.head_dim)
        cache["layers"] = [{"self": c, "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
                           for c in layers]
        cache["cross_len"] = torch.full((), se, dtype=torch.int32, device=device)
    return cache


def _rolled(t, shift: int):
    """``torch.roll(t, shift, dims=1)`` as slices and a concatenation, which
    DTensor places in every torch version (2.11 has no strategy for roll)."""
    if not shift:
        return t
    n = t.shape[1]
    return torch.cat([t[:, n - shift:], t[:, :n - shift]], dim=1)


def prefill_blocks(cfg: ModelConfig, layers, x, positions, caches, *, enc_out=None,
                   impl=None):
    """Prompt pass over ``layers``, filling each layer's cache in place:
    position p lands in slot p % C of an attention cache; a Mamba cache
    takes the conv tail and the final SSM state; with ``enc_out`` (an
    encoder-decoder) each layer's cross-attention K/V, in the compute
    dtype.  Returns the hidden states."""
    S = x.shape[1]
    for layer, cc in zip(layers, caches):
        c = cc if layer.cross is None else cc["self"]
        if layer.kind == "mamba":
            x, (conv, ssm) = layer.mixer(x, impl=impl)
            c["conv"].copy_(conv)
            c["ssm"].copy_(sc.act(ssm, "dp", "tp", None, None))
        else:
            x, (k, v) = layer.mixer(x, positions, impl=impl, return_kv=True)
            k, v = sc.act(k, "dp", None, "tp", None), sc.act(v, "dp", None, "tp", None)
            cap = c["k"].shape[1]
            if S >= cap:       # ring layout: the last cap positions, rolled
                shift = (S - cap) % cap
                c["k"].copy_(_rolled(k[:, -cap:], shift))
                c["v"].copy_(_rolled(v[:, -cap:], shift))
            else:              # the slots past the prompt stay zero
                sc.write_prefix(c["k"], k)
                sc.write_prefix(c["v"], v)
        if layer.cross is not None:
            k, v = layer.cross.kv(enc_out)
            cc["cross_k"].copy_(k)
            cc["cross_v"].copy_(v)
            x = layer.cross(x, k, v, impl=impl)
        x = layer.mlp(x, impl=impl)
    return x


def prefill(cfg: ModelConfig, params: LM, batch, *, capacity: int | None = None,
            impl=None):
    """Prompt pass: last-token logits (B, 1, Vp) and a decode-ready cache.

    ``capacity``: cache length to allocate (prefix + prompt + tokens still
    to be generated); defaults to the prefix and prompt's length.  An
    encoder-decoder runs its encoder over ``batch["frames"]`` first, with
    no recomputation."""
    enc_out = _encode(cfg, params, batch, impl=impl, remat="none") if cfg.encdec else None
    x, _ = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    cache = sc.place_cache(cfg, init_cache(
        cfg, B, capacity or S, dtype=x.dtype, device=x.device,
        enc_len=enc_out.shape[1] if enc_out is not None else None))
    x = prefill_blocks(cfg, params.layers, x, positions, cache["layers"], enc_out=enc_out,
                       impl=impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, impl)
    logits = x[:, -1:] @ _head(cfg, params).to(x.dtype)
    cache["pos"].fill_(S)
    return logits, cache


def decode_blocks(cfg: ModelConfig, layers, caches, x, pos, *, cross_len=None, impl=None):
    """One decode step over ``layers``; each layer's cache is updated in
    place.  ``impl=None`` runs attention through `ops.attn_decode_step`
    (the chain of kernels on the card), ``"ref"`` through the op-by-op
    oracle body.  An encoder-decoder's layers attend to their cached
    cross K/V (``cross_len`` of them), which they do not write."""
    for layer, cc in zip(layers, caches):
        c = cc if layer.cross is None else cc["self"]
        if layer.kind == "mamba":
            x, _ = layer.mixer.decode(x, c, impl=impl)
        else:
            x, _ = layer.mixer.decode(x, c, pos, impl=impl)
        if layer.cross is not None:
            x = layer.cross.decode(x, cc["cross_k"], cc["cross_v"], cross_len, impl=impl)
        x = layer.mlp.decode(x, impl=impl) if layer.moe else layer.mlp(x, impl=impl)
    return x


def decode_step(cfg: ModelConfig, params: LM, cache, tokens, *, impl=None):
    """One token for every sequence.  tokens: (B, 1) integer device tensor.
    Returns logits (B, 1, Vp) and ``cache``, updated in place: the ring
    slots and ``pos`` (+1)."""
    x = sc.act(sc.lookup(params.embed, tokens).to(dtype_of(cfg.compute_dtype)), "dp", None, None)
    pos = cache["pos"]
    x = decode_blocks(cfg, params.layers, cache["layers"], x, pos,
                      cross_len=cache.get("cross_len"), impl=impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, impl)
    logits = x @ _head(cfg, params).to(x.dtype)
    pos.add_(1)
    return logits, cache


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable


def build_model(cfg: ModelConfig, impl: str | None = None) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(init_params, cfg),
        loss_fn=functools.partial(loss_fn, cfg, impl=impl),
        forward=functools.partial(logits_fn, cfg, impl=impl),
        prefill=functools.partial(prefill, cfg, impl=impl),
        decode_step=functools.partial(decode_step, cfg, impl=impl),
    )
