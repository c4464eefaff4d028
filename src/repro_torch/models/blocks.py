"""Transformer and Mamba2 blocks: attention, cross-attention, Mamba2 (SSD)
and MLP sublayers.

Ported from the dense-attention, cross-attention and Mamba2 parts of
``repro/models/blocks.py``.  Each sublayer is an ``nn.Module`` whose
parameters keep the JAX names and layouts (``wq`` is (D, H*hd) and the
projection is ``h @ wq``), so ``bridge.py`` maps a JAX pytree onto it
leaf for leaf:

  JAX                             port
  init_attn, _qkv, attn_forward   Attention.__init__, ._qkv, .forward
  attn_decode                     Attention.decode
  init_attn (``cross``),          CrossAttention.__init__, .kv, .forward
  cross_kv, cross_attn_forward
  cross_attn_decode               CrossAttention.decode
  init_mamba, _mamba_proj,        Mamba.__init__, ._proj, .forward
  mamba_forward
  mamba_decode                    Mamba.decode
  init_mlp, _init_ffn, _ffn,      MLP.__init__, ._ffn, .forward
  mlp_forward
  attn_cache_capacity,            the functions of the same names
  init_attn_cache, init_mamba_cache

Matrix weights, biases, the Mamba conv taps and the embedding are held in
``param_dtype``: for serving (``None``, the default) the compute dtype,
with no gradient, so the weights take half the memory and half the bytes
per decode step of float32 masters; for training the masters' dtype
(``cfg.param_dtype``, float32), with gradients.  Every module casts a
weight to the compute dtype where it uses it, as the JAX code does
(``.astype(x.dtype)``); ``Tensor.to`` of the same dtype returns the tensor
itself, so serving pays nothing for it.  Norm weights and the Mamba
``dt_bias``, ``a_log`` and ``d_skip`` are float32 either way, as the JAX
code uses them (``d_skip`` is cast at its use).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .common import activation, dense_init, dtype_of, rmsnorm, rope


class Maker:
    """Makes a module's parameters: in ``param_dtype`` (``None``: the compute
    dtype, no gradient; a dtype: trainable masters of it), random from
    ``generator`` or left unset for ``bridge.py`` to fill."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator | None,
                 param_dtype: torch.dtype | None = None):
        self.device, self.generator = device, generator
        self.dtype = param_dtype or dtype_of(cfg.compute_dtype)
        self.trainable = param_dtype is not None

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=self.trainable)

    def weight(self, shape, scale=None) -> nn.Parameter:
        if self.generator is None:
            return self._param(torch.empty(shape, dtype=self.dtype, device=self.device))
        return self._param(dense_init(shape, self.dtype, generator=self.generator,
                                      device=self.device, scale=scale))

    def fill(self, value: float, shape, dtype=None) -> nn.Parameter:
        """A constant: float32 (norms, the Mamba scalars) unless ``dtype``."""
        return self._param(torch.full(shape, value, dtype=dtype or torch.float32,
                                      device=self.device))


class Attention(nn.Module):
    """Pre-norm self-attention sublayer with residual (`init_attn`)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, param_dtype=None):
        super().__init__()
        make = Maker(cfg, device, generator, param_dtype)
        a = cfg.attn
        self.cfg = cfg
        d, hd = cfg.d_model, a.head_dim
        self.norm = make.fill(1.0, (d,))
        self.wq = make.weight((d, a.n_heads * hd))
        self.wk = make.weight((d, a.n_kv_heads * hd))
        self.wv = make.weight((d, a.n_kv_heads * hd))
        self.wo = make.weight((a.n_heads * hd, d))
        bias = (lambda n: make.fill(0.0, (n,), make.dtype)) if a.qkv_bias else (lambda n: None)
        self.bq = bias(a.n_heads * hd)
        self.bk = bias(a.n_kv_heads * hd)
        self.bv = bias(a.n_kv_heads * hd)

    def _qkv(self, x, positions):
        a = self.cfg.attn
        B, S, _ = x.shape
        dt = x.dtype
        q = x @ self.wq.to(dt)
        k = x @ self.wk.to(dt)
        v = x @ self.wv.to(dt)
        if self.bq is not None:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        q = rope(q.view(B, S, a.n_heads, a.head_dim), positions, a.rope_theta)
        k = rope(k.view(B, S, a.n_kv_heads, a.head_dim), positions, a.rope_theta)
        return q, k, v.view(B, S, a.n_kv_heads, a.head_dim)

    def forward(self, x, positions, *, causal=True, impl=None, return_kv=False):
        """`attn_forward`: x (B, S, D) at positions (S,) -> (B, S, D), and
        with ``return_kv`` the roped keys and the values (B, S, KV, hd).
        Not ``causal`` (the encoder) every position sees every other, and a
        window applies only to causal attention, as in the JAX code."""
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        q, k, v = self._qkv(h, positions)
        o = ops.attention(q, k, v, causal=causal,
                          window=self.cfg.attn.window if causal else None, impl=impl)
        B, S, _ = x.shape
        out = x + o.reshape(B, S, -1) @ self.wo.to(x.dtype)
        return (out, (k, v)) if return_kv else out

    def decode(self, x, cache, pos, *, impl=None):
        """`attn_decode`: one token.  x (B, 1, D); cache {k, v}: (B, C, KV,
        hd); pos: () int32 device tensor, the absolute position.  Writes
        ring slot ``pos % C`` of the cache in place and returns (out,
        cache).

        ``impl=None`` runs `kernels.ops.attn_decode_step`: on the card the
        chain of kernels that replaces `_fused_kernel`, on the CPU its
        plain version; ``"ref"`` runs the historical op-by-op body, the
        oracle."""
        a = self.cfg.attn
        if ops.check_impl(impl) != "ref":
            out = ops.attn_decode_step(
                x, cache["k"], cache["v"], pos, norm=self.norm, wq=self.wq,
                wk=self.wk, wv=self.wv, wo=self.wo, bq=self.bq, bk=self.bk,
                bv=self.bv, n_heads=a.n_heads, head_dim=a.head_dim,
                eps=self.cfg.norm_eps, rope_theta=a.rope_theta)
            return out, cache
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        positions = pos.reshape(1)
        q, k, v = self._qkv(h, positions)
        C = cache["k"].shape[1]
        slot = torch.remainder(positions, C).long()
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache_len = torch.clamp(pos + 1, max=C)
        o = ref.decode_attention_ref(q[:, 0], cache["k"], cache["v"], cache_len)
        return x + o.reshape(B, 1, -1) @ self.wo.to(x.dtype), cache


class CrossAttention(Attention):
    """Pre-norm cross-attention sublayer with residual: the leaves of
    `init_attn` (``cross``).  Its keys and values come from the encoder's
    output through `kv`, with no norm and no rope; its queries from its own
    norm of x, with no rope."""

    def _q(self, x):
        q = x @ self.wq.to(x.dtype)
        return q + self.bq.to(x.dtype) if self.bq is not None else q

    def kv(self, enc_out):
        """`cross_kv`: K and V (B, Se, KV, hd) of the encoder's output
        ``enc_out`` (B, Se, D)."""
        a = self.cfg.attn
        B, Se, _ = enc_out.shape
        dt = enc_out.dtype
        k = enc_out @ self.wk.to(dt)
        v = enc_out @ self.wv.to(dt)
        if self.bk is not None:
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        return k.view(B, Se, a.n_kv_heads, a.head_dim), v.view(B, Se, a.n_kv_heads, a.head_dim)

    def forward(self, x, k, v, *, impl=None):
        """`cross_attn_forward`: x (B, S, D) attends, not causal, to every
        one of the encoder's K/V (B, Se, KV, hd) -> (B, S, D)."""
        a = self.cfg.attn
        B, S, _ = x.shape
        q = self._q(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
        o = ops.attention(q.view(B, S, a.n_heads, a.head_dim), k, v, causal=False, impl=impl)
        return x + o.reshape(B, S, -1) @ self.wo.to(x.dtype)

    def decode(self, x, k, v, cache_len, *, impl=None):
        """`cross_attn_decode`: one token, x (B, 1, D), over the cached K/V
        (B, Se, KV, hd), which it only reads.  ``cache_len``: Se, on the card
        a () int32 device tensor (`ops.decode_attention`), made once a round
        by `lm.init_cache`."""
        a = self.cfg.attn
        B = x.shape[0]
        q = self._q(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
        o = ops.decode_attention(q.view(B, a.n_heads, a.head_dim), k, v, cache_len, impl=impl)
        return x + o.reshape(B, 1, -1) @ self.wo.to(x.dtype)


def attn_cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    w = cfg.attn.window if cfg.attn else None
    return min(seq_len, w) if w else seq_len


def init_attn_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device):
    a = cfg.attn
    shape = (batch, capacity, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Mamba(nn.Module):
    """Pre-norm Mamba2 (SSD) mixer with residual (`init_mamba`)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, param_dtype=None):
        super().__init__()
        make = Maker(cfg, device, generator, param_dtype)
        m = cfg.mamba
        self.cfg = cfg
        d = cfg.d_model
        di, H, N = m.d_inner(d), m.n_ssm_heads(d), m.d_state
        self.norm = make.fill(1.0, (d,))
        self.w_xz = make.weight((d, 2 * di))
        self.w_bcdt = make.weight((d, 2 * m.n_groups * N + H))
        self.conv_w = make.weight((m.d_conv, di), scale=0.5)
        self.dt_bias = make.fill(0.0, (H,))
        self.a_log = make.fill(0.0, (H,))          # A = -exp(a_log) = -1
        self.d_skip = make.fill(1.0, (H,))
        self.gate_norm = make.fill(1.0, (di,))
        self.w_out = make.weight((di, d))

    def _proj(self, h):
        """`_mamba_proj`: x_in, z (..., di); b, c (..., N); dt float32 (..., H)."""
        N = self.cfg.mamba.d_state
        x_in, z = torch.chunk(h @ self.w_xz.to(h.dtype), 2, dim=-1)
        bcdt = h @ self.w_bcdt.to(h.dtype)
        b, c, dt_raw = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        return x_in, z, b, c, dt

    def _gate_out(self, x, y, xh, z, impl):
        """Skip, gate, gate norm, output projection and residual.

        ``impl=None`` runs the first three as `kernels.ops.rmsnorm_gated`:
        on the card one kernel launch, on the CPU its plain version;
        ``"ref"`` runs the op-by-op body, the oracle."""
        if ops.check_impl(impl) == "ref":
            y = y + xh * self.d_skip[:, None].to(xh.dtype)
            y = y.reshape(*z.shape) * F.silu(z)
            y = rmsnorm(y, self.gate_norm, self.cfg.norm_eps, impl)
        else:
            y = ops.rmsnorm_gated(y, xh, self.d_skip, z, self.gate_norm, eps=self.cfg.norm_eps)
        return x + y @ self.w_out.to(x.dtype)

    def forward(self, x, *, impl=None):
        """The Mamba branch of `lm.prefill_blocks`: x (B, S, D) -> (out,
        (conv, ssm)), the conv tail (B, d_conv - 1, di): the last
        d_conv - 1 inputs of the causal conv, zeros before the sequence;
        and the final SSM state (B, H, P, N) float32."""
        m = self.cfg.mamba
        B, S, _ = x.shape
        H = m.n_ssm_heads(self.cfg.d_model)
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        x_in, z, b, c, dt = self._proj(h)
        # depthwise causal conv (d_conv taps) as shifted adds
        padded = F.pad(x_in, (0, 0, m.d_conv - 1, 0))
        conv = torch.zeros_like(x_in)
        w = self.conv_w.to(x_in.dtype)
        for k in range(m.d_conv):
            conv = conv + padded[:, k:k + S] * w[k]
        xh = F.silu(conv).reshape(B, S, H, m.head_dim)
        y, state = ops.ssd(xh, dt, -torch.exp(self.a_log), b, c, impl=impl)
        return self._gate_out(x, y, xh, z, impl), (padded[:, S:], state)

    def decode(self, x, cache, *, impl=None):
        """`mamba_decode`: one token.  x (B, 1, D); cache {conv (B, d_conv -
        1, di), ssm (B, H, P, N) float32}, both updated in place.  Returns
        (out, cache)."""
        m = self.cfg.mamba
        B = x.shape[0]
        H = m.n_ssm_heads(self.cfg.d_model)
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        x_in, z, b, c, dt = (t[:, 0] for t in self._proj(h))
        w, hist = self.conv_w.to(x_in.dtype), cache["conv"]
        conv = x_in * w[-1] + torch.einsum("bkd,kd->bd", hist.to(x_in.dtype), w[:-1])
        hist.copy_(torch.cat([hist[:, 1:], x_in[:, None].to(hist.dtype)], dim=1))
        xh = F.silu(conv).reshape(B, H, m.head_dim)
        y, ssm = ref.ssd_decode_step(cache["ssm"], xh, dt, -torch.exp(self.a_log), b, c)
        cache["ssm"].copy_(ssm)
        return self._gate_out(x[:, 0], y, xh, z, impl)[:, None], cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    m = cfg.mamba
    di, H = m.d_inner(cfg.d_model), m.n_ssm_heads(cfg.d_model)
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, m.head_dim, m.d_state), dtype=torch.float32,
                               device=device)}


class MLP(nn.Module):
    """Pre-norm feed-forward sublayer with residual (`init_mlp`).  With
    ``d_ff == 0`` (attention-free Mamba2 stacks) it holds only ``norm``
    and passes x through."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, param_dtype=None):
        super().__init__()
        make = Maker(cfg, device, generator, param_dtype)
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.norm = make.fill(1.0, (d,))
        if f == 0:
            return
        self.w_gate = make.weight((d, f)) if cfg.act == "silu_glu" else None
        self.w_up = make.weight((d, f))
        self.w_down = make.weight((f, d))

    def _ffn(self, h):
        dt = h.dtype
        if self.w_gate is not None:
            return (F.silu(h @ self.w_gate.to(dt)) * (h @ self.w_up.to(dt))) @ self.w_down.to(dt)
        return activation(self.cfg.act)(h @ self.w_up.to(dt)) @ self.w_down.to(dt)

    def forward(self, x, *, impl=None):
        """`mlp_forward`: x (B, S, D) -> (B, S, D)."""
        if self.cfg.d_ff == 0:
            return x
        return x + self._ffn(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
