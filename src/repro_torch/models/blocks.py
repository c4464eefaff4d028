"""Transformer and Mamba2 blocks: attention, Mamba2 (SSD) and MLP sublayers.

Ported from the dense-attention and Mamba2 parts of
``repro/models/blocks.py``.  Each sublayer is an ``nn.Module`` whose
parameters keep the JAX names and layouts (``wq`` is (D, H*hd) and the
projection is ``h @ wq``), so ``bridge.py`` maps a JAX pytree onto it
leaf for leaf:

  JAX                             port
  init_attn, _qkv, attn_forward   Attention.__init__, ._qkv, .forward
  attn_decode                     Attention.decode
  init_mamba, _mamba_proj,        Mamba.__init__, ._proj, .forward
  mamba_forward
  mamba_decode                    Mamba.decode
  init_mlp, _init_ffn, _ffn,      MLP.__init__, ._ffn, .forward
  mlp_forward
  attn_cache_capacity,            the functions of the same names
  init_attn_cache, init_mamba_cache

Matrix weights, biases, the Mamba conv taps and the embedding are held in
the compute dtype: the JAX code casts each of them to it at every use
(``.astype(x.dtype)``), so the values are the same and the weights take
half the memory and half the bytes per decode step.  Norm weights and
the Mamba ``dt_bias``, ``a_log`` and ``d_skip`` stay float32, as the JAX
code uses them (``d_skip`` is cast at its use).  Parameters take no
gradients: the port serves only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .common import activation, dense_init, dtype_of, rmsnorm, rope


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def weight_maker(cfg: ModelConfig, device, generator: torch.Generator | None):
    """Maker of matrix weights in the compute dtype: random from
    ``generator``, or left unset for ``bridge.py`` to fill."""
    dt = dtype_of(cfg.compute_dtype)

    def make(shape, scale=None):
        if generator is None:
            return frozen(torch.empty(shape, dtype=dt, device=device))
        return frozen(dense_init(shape, dt, generator=generator, device=device,
                                 scale=scale))
    return make


class Attention(nn.Module):
    """Pre-norm self-attention sublayer with residual (`init_attn`)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        a = cfg.attn
        self.cfg = cfg
        d, hd = cfg.d_model, a.head_dim
        w = weight_maker(cfg, device, generator)
        self.norm = frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.wq = w((d, a.n_heads * hd))
        self.wk = w((d, a.n_kv_heads * hd))
        self.wv = w((d, a.n_kv_heads * hd))
        self.wo = w((a.n_heads * hd, d))
        bias = (lambda n: frozen(torch.zeros(n, dtype=dtype_of(cfg.compute_dtype),
                                             device=device))) if a.qkv_bias \
            else (lambda n: None)
        self.bq = bias(a.n_heads * hd)
        self.bk = bias(a.n_kv_heads * hd)
        self.bv = bias(a.n_kv_heads * hd)

    def _qkv(self, x, positions):
        a = self.cfg.attn
        B, S, _ = x.shape
        q = x @ self.wq
        k = x @ self.wk
        v = x @ self.wv
        if self.bq is not None:
            q = q + self.bq
            k = k + self.bk
            v = v + self.bv
        q = rope(q.view(B, S, a.n_heads, a.head_dim), positions, a.rope_theta)
        k = rope(k.view(B, S, a.n_kv_heads, a.head_dim), positions, a.rope_theta)
        return q, k, v.view(B, S, a.n_kv_heads, a.head_dim)

    def forward(self, x, positions, *, impl=None, return_kv=False):
        """`attn_forward`, causal: x (B, S, D) at positions (S,) -> (B, S, D),
        and with ``return_kv`` the roped keys and the values (B, S, KV, hd)."""
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        q, k, v = self._qkv(h, positions)
        o = ops.attention(q, k, v, causal=True, window=self.cfg.attn.window, impl=impl)
        B, S, _ = x.shape
        out = x + o.reshape(B, S, -1) @ self.wo
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
        return x + o.reshape(B, 1, -1) @ self.wo, cache


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

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        m = cfg.mamba
        self.cfg = cfg
        d = cfg.d_model
        di, H, N = m.d_inner(d), m.n_ssm_heads(d), m.d_state
        w = weight_maker(cfg, device, generator)

        def f32(fill, n):
            return frozen(torch.full((n,), fill, dtype=torch.float32, device=device))
        self.norm = f32(1.0, d)
        self.w_xz = w((d, 2 * di))
        self.w_bcdt = w((d, 2 * m.n_groups * N + H))
        self.conv_w = w((m.d_conv, di), scale=0.5)
        self.dt_bias = f32(0.0, H)
        self.a_log = f32(0.0, H)                  # A = -exp(a_log) = -1
        self.d_skip = f32(1.0, H)
        self.gate_norm = f32(1.0, di)
        self.w_out = w((di, d))

    def _proj(self, h):
        """`_mamba_proj`: x_in, z (..., di); b, c (..., N); dt float32 (..., H)."""
        N = self.cfg.mamba.d_state
        x_in, z = torch.chunk(h @ self.w_xz, 2, dim=-1)
        bcdt = h @ self.w_bcdt
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
        return x + y @ self.w_out

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
        for k in range(m.d_conv):
            conv = conv + padded[:, k:k + S] * self.conv_w[k]
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
        w, hist = self.conv_w, cache["conv"]
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

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.norm = frozen(torch.ones(d, dtype=torch.float32, device=device))
        if f == 0:
            return
        w = weight_maker(cfg, device, generator)
        self.w_gate = w((d, f)) if cfg.act == "silu_glu" else None
        self.w_up = w((d, f))
        self.w_down = w((f, d))

    def _ffn(self, h):
        if self.w_gate is not None:
            return (F.silu(h @ self.w_gate) * (h @ self.w_up)) @ self.w_down
        return activation(self.cfg.act)(h @ self.w_up) @ self.w_down

    def forward(self, x, *, impl=None):
        """`mlp_forward`: x (B, S, D) -> (B, S, D)."""
        if self.cfg.d_ff == 0:
            return x
        return x + self._ffn(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
