"""Dense transformer blocks: attention and MLP sublayers.

Ported from the dense-attention half of ``repro/models/blocks.py``.  Each
sublayer is an ``nn.Module`` whose parameters keep the JAX names and
layouts (``wq`` is (D, H*hd) and the projection is ``h @ wq``), so
``bridge.py`` maps a JAX pytree onto it leaf for leaf:

  JAX                             port
  init_attn, _qkv, attn_forward   Attention.__init__, ._qkv, .forward
  attn_decode                     Attention.decode
  init_mlp, _init_ffn, _ffn,      MLP.__init__, ._ffn, .forward
  mlp_forward
  attn_cache_capacity,            the functions of the same names
  init_attn_cache

Matrix weights, biases and the embedding are held in the compute dtype:
the JAX code casts each of them to it at every use (``.astype(x.dtype)``),
so the values are the same and the weights take half the memory and half
the bytes per decode step.  Norm weights stay float32, as the kernels
read them.  Parameters take no gradients: this slice serves only.
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

        ``impl=None`` runs the composed step (`kernels.ops.attn_decode_step`:
        the norm and attention kernels around torch matmuls); ``"ref"``
        runs the historical op-by-op body, the oracle."""
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


class MLP(nn.Module):
    """Pre-norm feed-forward sublayer with residual (`init_mlp`)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        w = weight_maker(cfg, device, generator)
        self.norm = frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.w_gate = w((d, f)) if cfg.act == "silu_glu" else None
        self.w_up = w((d, f))
        self.w_down = w((f, d))

    def _ffn(self, h):
        if self.w_gate is not None:
            return (F.silu(h @ self.w_gate) * (h @ self.w_up)) @ self.w_down
        return activation(self.cfg.act)(h @ self.w_up) @ self.w_down

    def forward(self, x, *, impl=None):
        """`mlp_forward`: x (B, S, D) -> (B, S, D)."""
        return x + self._ffn(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
