"""Transformer and Mamba2 blocks: attention, cross-attention, Mamba2 (SSD),
MLP and MoE sublayers.

Ported from ``repro/models/blocks.py``.  Each sublayer is an ``nn.Module`` whose
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
  init_mlp, mlp_forward           MLP.__init__, .forward
  _init_ffn, _ffn                 FFN.__init__ (the experts' and the shared
                                  expert's weights), _ffn
  init_moe                        MoE.__init__
  _expert_ffn, moe_forward        MoE._expert_ffn, .forward
  _ffn2, _sorted_dispatch_local,  MoE._ffn2, ._sorted_dispatch_local,
  moe_forward_sorted              .forward_sorted (its ``shard_map``
                                  branch: ._sorted_sharded, a
                                  ``local_map`` with explicit collectives)
  moe_decode                      MoE.decode
  set_moe_impl                    set_moe_impl
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
code uses them (``d_skip`` is cast at its use), and so is the MoE's
router, which routes in float32.

The activation pins of the JAX code (``sc.act``) sit at the same places;
under an active `sharding_ctx` they redistribute DTensor activations, and
otherwise cost one ``None`` check.  The einsum MoE's pins of its
dispatched (B, E, C, D) tensor have no counterpart: the port dispatches
by index into an (E, B * C, D) buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding_ctx as sc
from ..configs.base import ModelConfig
from ..kernels import ops
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

    def weight(self, shape, scale=None, dtype=None) -> nn.Parameter:
        """A matrix in ``param_dtype`` unless ``dtype`` (the float32 router)."""
        dtype = dtype or self.dtype
        if self.generator is None:
            return self._param(torch.empty(shape, dtype=dtype, device=self.device))
        return self._param(dense_init(shape, dtype, generator=self.generator,
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
        q = sc.act(sc.heads(q, a.n_heads).view(B, S, a.n_heads, a.head_dim),
                   "dp", None, "tp", None)
        k = sc.act(sc.heads(k, a.n_kv_heads).view(B, S, a.n_kv_heads, a.head_dim),
                   "dp", None, "tp", None)
        v = sc.act(sc.heads(v, a.n_kv_heads).view(B, S, a.n_kv_heads, a.head_dim),
                   "dp", None, "tp", None)
        return rope(q, positions, a.rope_theta), rope(k, positions, a.rope_theta), v

    def forward(self, x, positions, *, causal=True, impl=None, return_kv=False):
        """`attn_forward`: x (B, S, D) at positions (S,) -> (B, S, D), and
        with ``return_kv`` the roped keys and the values (B, S, KV, hd).
        Not ``causal`` (the encoder) every position sees every other, and a
        window applies only to causal attention, as in the JAX code."""
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        q, k, v = self._qkv(h, positions)
        o = ops.attention(q, k, v, causal=causal,
                          window=self.cfg.attn.window if causal else None, impl=impl)
        out = sc.act(x + sc.merge_heads(o) @ self.wo.to(x.dtype), "dp", "sp", None)
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
            return sc.act(out, "dp", "sp", None), cache
        B = x.shape[0]
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        positions = pos.reshape(1)
        q, k, v = self._qkv(h, positions)
        C = cache["k"].shape[1]
        slot = torch.remainder(positions, C).long()
        sc.write_slot(cache["k"], slot, k.to(cache["k"].dtype))
        sc.write_slot(cache["v"], slot, v.to(cache["v"].dtype))
        cache_len = torch.clamp(pos + 1, max=C)
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], cache_len, impl="ref")
        return sc.act(x + o.reshape(B, 1, -1) @ self.wo.to(x.dtype), "dp", "sp", None), cache


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
        kv = a.n_kv_heads
        return (sc.heads(k, kv).view(B, Se, kv, a.head_dim),
                sc.heads(v, kv).view(B, Se, kv, a.head_dim))

    def forward(self, x, k, v, *, impl=None):
        """`cross_attn_forward`: x (B, S, D) attends, not causal, to every
        one of the encoder's K/V (B, Se, KV, hd) -> (B, S, D)."""
        a = self.cfg.attn
        B, S, _ = x.shape
        q = self._q(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
        q = sc.heads(q, a.n_heads).view(B, S, a.n_heads, a.head_dim)
        o = ops.attention(q, k, v, causal=False, impl=impl)
        return sc.act(x + sc.merge_heads(o) @ self.wo.to(x.dtype), "dp", "sp", None)

    def decode(self, x, k, v, cache_len, *, impl=None):
        """`cross_attn_decode`: one token, x (B, 1, D), over the cached K/V
        (B, Se, KV, hd), which it only reads.  ``cache_len``: Se, on the card
        a () int32 device tensor (`ops.decode_attention`), made once a round
        by `lm.init_cache`."""
        a = self.cfg.attn
        B = x.shape[0]
        q = self._q(rmsnorm(x, self.norm, self.cfg.norm_eps, impl))
        q = sc.heads(q, a.n_heads).view(B, a.n_heads, a.head_dim)
        o = ops.decode_attention(q, k, v, cache_len, impl=impl)
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
        x_in = sc.act(x_in, "dp", None, "tp")
        z = sc.act(z, "dp", None, "tp")
        bcdt = sc.act(h @ self.w_bcdt.to(h.dtype), "dp", "sp", None)
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
            y = sc.merge_heads(y) * F.silu(z)
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
        padded = sc.pad(x_in, (0, 0, m.d_conv - 1, 0))
        conv = torch.zeros_like(x_in)
        w = self.conv_w.to(x_in.dtype)
        for k in range(m.d_conv):
            conv = conv + padded[:, k:k + S] * w[k]
        xh = sc.act(sc.heads(F.silu(conv), H).reshape(B, S, H, m.head_dim),
                    "dp", None, "tp", None)
        y, state = ops.ssd(xh, dt, -torch.exp(self.a_log), b, c, impl=impl)
        out = sc.act(self._gate_out(x, y, xh, z, impl), "dp", "sp", None)
        return out, (padded[:, S:], state)

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
        xh = sc.heads(F.silu(conv), H).reshape(B, H, m.head_dim)
        y, ssm = ops.ssd_decode_step(cache["ssm"], xh, dt, -torch.exp(self.a_log), b, c)
        cache["ssm"].copy_(sc.act(ssm, "dp", "tp", None, None))
        return sc.act(self._gate_out(x[:, 0], y, xh, z, impl)[:, None], "dp", "sp", None), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    m = cfg.mamba
    di, H = m.d_inner(cfg.d_model), m.n_ssm_heads(cfg.d_model)
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, m.head_dim, m.d_state), dtype=torch.float32,
                               device=device)}


def _ffn(h, w_gate, w_up, w_down, act: str, mm=torch.matmul):
    """`_ffn`: the feed-forward of h (gated where ``w_gate`` is given), each
    weight cast to h's dtype at its use; ``mm`` the product (`torch.bmm`
    for the experts' (E, R, D) rows, as `_expert_ffn` and `_ffn2`, which
    pin nothing).  The dense form pins its hidden (B, S, F) over "tp"."""
    dt = h.dtype
    pin = (lambda t: sc.act(t, "dp", None, "tp")) if mm is torch.matmul else (lambda t: t)
    if w_gate is not None:
        return mm(pin(F.silu(mm(h, w_gate.to(dt)))) * pin(mm(h, w_up.to(dt))), w_down.to(dt))
    return mm(pin(activation(act)(mm(h, w_up.to(dt)))), w_down.to(dt))


class FFN(nn.Module):
    """The feed-forward weights of `_init_ffn`: ``w_gate`` (gated
    activations only) and ``w_up`` (..., D, F), ``w_down`` (..., F, D),
    with ``lead`` axes ahead (the experts')."""

    def __init__(self, cfg: ModelConfig, make: Maker, d_ff: int, lead: tuple = ()):
        super().__init__()
        d = cfg.d_model
        self.act = cfg.act
        self.w_gate = make.weight((*lead, d, d_ff)) if cfg.act == "silu_glu" else None
        self.w_up = make.weight((*lead, d, d_ff))
        self.w_down = make.weight((*lead, d_ff, d))

    def forward(self, h, mm=torch.matmul):
        return _ffn(h, self.w_gate, self.w_up, self.w_down, self.act, mm)


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

    def forward(self, x, *, impl=None):
        """`mlp_forward`: x (B, S, D) -> (B, S, D)."""
        if self.cfg.d_ff == 0:
            return x
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        return sc.act(x + _ffn(h, self.w_gate, self.w_up, self.w_down, self.cfg.act),
                      "dp", "sp", None)


MOE_IMPL = "einsum"     # "einsum" (GShard capacity dispatch) | "sorted"


def set_moe_impl(name: str) -> None:
    """`set_moe_impl`: which dispatch `MoE.forward` runs."""
    global MOE_IMPL
    if name not in ("einsum", "sorted"):
        raise ValueError(f"MoE dispatch must be einsum or sorted, got {name!r}")
    MOE_IMPL = name


class MoE(nn.Module):
    """Pre-norm top-k mixture-of-experts sublayer with residual (`init_moe`):
    ``norm`` (D,) and ``router`` (D, E) float32 whatever ``param_dtype``
    (the router's logits and softmax are float32, and a bf16 router would
    route other tokens); ``experts`` (E, D, F) / (E, F, D) and ``shared``
    (the dense FFN's layout, where the config has a shared expert) in
    ``param_dtype``.

    The dispatch builds no (B, S, E, C) one-hot: each round's kept tokens
    are copied into an (E, B * C, D) buffer, each expert's C slots of every
    row side by side, the experts run as one batched product a weight, and
    each token reads its slot's result back: every token touches one slot,
    so dispatch and combine are exact and only the products round.  A
    dropped token's index points at one row past the buffer, which
    dispatch adds into and combine reads as zeros."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, param_dtype=None):
        super().__init__()
        make = Maker(cfg, device, generator, param_dtype)
        e = cfg.moe
        self.cfg = cfg
        self.norm = make.fill(1.0, (cfg.d_model,))
        self.router = make.weight((cfg.d_model, e.n_experts), scale=0.02, dtype=torch.float32)
        self.experts = FFN(cfg, make, e.d_ff, (e.n_experts,))
        self.shared = FFN(cfg, make, e.d_ff) if e.shared_expert else None

    def capacity(self, seq: int) -> int:
        """Slots an expert a row (einsum) or in all (sorted), from the length."""
        e = self.cfg.moe
        return max(1, int(seq * e.capacity_factor * e.top_k / e.n_experts))

    def _probs(self, x, impl):
        h = rmsnorm(x, self.norm, self.cfg.norm_eps, impl)
        return h, torch.softmax(h.float() @ self.router, dim=-1)

    def _rounds(self, probs):
        """The einsum path's routing, round by round: [(expert, gate, slot,
        keep)], each (B, S).  Slots count a row's tokens an expert in
        sequence order, the occupancy carried over from earlier rounds; a
        slot at or past the capacity is dropped.  No host sync."""
        B, S, E = probs.shape
        cap = self.capacity(S)
        experts = torch.arange(E, device=probs.device)
        occupancy = torch.zeros((B, 1, E), dtype=torch.long, device=probs.device)
        remaining, rounds = probs, []
        for _ in range(self.cfg.moe.top_k):
            idx = remaining.argmax(dim=-1)                              # (B, S)
            gate = remaining.gather(-1, idx[..., None])[..., 0]
            onehot = (idx[..., None] == experts).long()                 # (B, S, E)
            pos = torch.cumsum(onehot, dim=1) - onehot + occupancy
            slot = pos.gather(-1, idx[..., None])[..., 0]
            keep = slot < cap
            occupancy = occupancy + (onehot * keep[..., None]).sum(dim=1, keepdim=True)
            remaining = remaining.scatter(-1, idx[..., None], 0.0)
            rounds.append((idx, gate, slot, keep))
        return rounds

    def routing(self, x, *, impl=None) -> dict:
        """What `forward` would route, for inspection: ``experts`` and
        ``kept`` (top_k, B, S) and the float32 router ``logits`` (B, S, E)."""
        h, probs = self._probs(x, impl)
        rounds = self._rounds(probs)
        return {"experts": torch.stack([r[0] for r in rounds]),
                "kept": torch.stack([r[3] for r in rounds]),
                "logits": h.float() @ self.router}

    def _expert_ffn(self, xe):
        """`_expert_ffn`: xe (E, R, D) -> (E, R, D), expert e's FFN on its rows."""
        return self.experts(xe, mm=torch.bmm)

    def _route(self, probs) -> tuple:
        """The einsum path's routing of ``probs`` (B, S, E), flat in round
        order: per round, each token's slot in that round's (E * B * C)
        dispatch buffer (B * S,) (one past the buffer where dropped) and
        its gate (B, S)."""
        B, S, E = probs.shape
        cap = self.capacity(S)
        rows = torch.arange(B, device=probs.device)[:, None] * cap
        out = []
        for idx, gate, slot, keep in self._rounds(probs):
            out += [torch.where(keep, idx * (B * cap) + rows + slot, E * B * cap).reshape(-1),
                    gate]
        return tuple(out)

    def _dispatch(self, h, flat):
        """One round's dispatch of h (B, S, D) to the slots ``flat`` gives
        (`_route`): the (E, B * C, D) buffer, each expert's C slots of
        every row side by side."""
        B, S, D = h.shape
        E = self.cfg.moe.n_experts
        cap = self.capacity(S)
        buf = h.new_zeros((E * B * cap + 1, D)).index_add(0, flat, h.reshape(-1, D))
        return buf[:-1].view(E, B * cap, D)

    @staticmethod
    def _combine(ye, flat, gate):
        """Each token's slot of the experts' output ye (E, B * C, D), zero
        where it was dropped, times its gate (B, S) -> (B, S, D)."""
        D = ye.shape[-1]
        ye = ye.reshape(-1, D)
        tok = torch.cat([ye, ye.new_zeros((1, D))]).index_select(0, flat)
        return tok.view(*gate.shape, D) * gate.to(ye.dtype)[..., None]

    def forward(self, x, *, impl=None):
        """`moe_forward` (GShard top-k with capacity): x (B, S, D) -> (B, S,
        D); `forward_sorted` under ``set_moe_impl("sorted")``.

        On a mesh (DTensor activations) each rank dispatches and combines
        its own rows (a row's capacity is its own, so the split is exact):
        the buffers are split over the batch's mesh dims along their B * C
        rows, and the experts' products run on them as DTensors."""
        if MOE_IMPL == "sorted":
            return self.forward_sorted(x, impl=impl)
        h, probs = self._probs(x, impl)
        route, dispatch, combine = self._route, self._dispatch, self._combine
        if ops._dtensor(h):
            from torch.distributed.tensor import Replicate, Shard
            from torch.distributed.tensor.experimental import local_map
            mesh = h.device_mesh
            rows = [p if p == Shard(0) else Replicate() for p in h.placements]
            slots = [Shard(1) if p == Shard(0) else Replicate() for p in rows]
            route = local_map(route, out_placements=(rows, rows) * self.cfg.moe.top_k,
                              in_placements=(rows,), device_mesh=mesh, redistribute_inputs=True)
            dispatch = local_map(dispatch, out_placements=slots, in_placements=(rows, rows),
                                 device_mesh=mesh, redistribute_inputs=True)
            combine = local_map(combine, out_placements=rows, in_placements=(slots, rows, rows),
                                device_mesh=mesh, redistribute_inputs=True)
        out = torch.zeros_like(h)
        routes = route(probs)
        for flat, gate in zip(routes[0::2], routes[1::2]):
            out = out + combine(self._expert_ffn(dispatch(h, flat)), flat, gate)
        if self.shared is not None:
            out = out + self.shared(h)
        return sc.act(x + out.to(x.dtype), "dp", "sp", None)

    def _ffn2(self, buf, experts=None):
        """`_ffn2`: the experts' FFN on an (E, C, D) buffer; ``experts``:
        local (w_gate, w_up, w_down) shards in place of the module's."""
        if experts is None:
            return self._expert_ffn(buf)
        return _ffn(buf, *experts, self.cfg.act, torch.bmm)

    def _sorted_dispatch_local(self, h2, probs, cap: int, *, experts=None, ep_group=None,
                               n_ep: int = 1, tp_group=None):
        """`_sorted_dispatch_local`: h2 (N, D) normed tokens, probs (N, E).
        Each round sorts the tokens by expert (stable), ranks them within it
        and keeps the first ``cap`` of all N; no occupancy is carried from
        round to round.  On one shard of a mesh, ``experts`` are the local
        weight shards (E / n_ep experts, F split over the model axis),
        ``ep_group`` carries the two all-to-alls (expert parallelism) and
        ``tp_group`` the within-expert sum."""
        N, D = h2.shape
        E = self.cfg.moe.n_experts
        out = torch.zeros_like(h2)
        remaining = probs
        for _ in range(self.cfg.moe.top_k):
            ids = remaining.argmax(dim=-1)                              # (N,)
            gate = remaining.gather(-1, ids[:, None])[:, 0]
            order = torch.argsort(ids, stable=True)
            ids_s = ids[order]
            counts = (ids[:, None] == torch.arange(E, device=ids.device)).sum(dim=0)
            starts = torch.cumsum(counts, 0) - counts
            slot = torch.arange(N, device=h2.device) - starts[ids_s]
            flat = torch.where(slot < cap, ids_s * cap + slot, E * cap)
            buf = h2.new_zeros((E * cap + 1, D)).index_add(0, flat, h2[order])
            buf = buf[:-1].view(E, cap, D)
            if ep_group is not None:      # (E, C, D) -> (E / n_ep, n_ep * C, D)
                buf = _all_to_all(buf, ep_group, n_ep).view(n_ep, E // n_ep, cap, D)
                buf = buf.transpose(0, 1).reshape(E // n_ep, n_ep * cap, D)
            if tp_group is not None:
                buf = _CopyToGroup.apply(buf, tp_group)
            ye = self._ffn2(buf, experts)
            if tp_group is not None:
                ye = _SumOverGroup.apply(ye, tp_group)                 # row-parallel F
            if ep_group is not None:      # back: (E / n_ep, n_ep * C, D) -> (E, C, D)
                ye = ye.view(E // n_ep, n_ep, cap, D).transpose(0, 1).contiguous()
                ye = _all_to_all(ye, ep_group, n_ep)
            ye = ye.reshape(-1, D)
            tok = torch.cat([ye, ye.new_zeros((1, D))]).index_select(0, flat)
            contrib = torch.zeros_like(h2).index_copy(0, order, tok)
            out = out + contrib * gate.to(h2.dtype)[:, None]
            remaining = remaining.scatter(-1, ids[:, None], 0.0)
        return out

    def _sorted_sharded(self, h, probs, ctx):
        """`moe_forward_sorted`'s ``shard_map`` branch: experts on "data",
        F on "model" (the ``ep_axis="data"`` layout); each shard dispatches
        its own tokens at a capacity from their count."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map

        from ..launch.sharding import P, to_placements
        e = self.cfg.moe
        mesh = ctx.mesh
        n_ep = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["data"]
        if e.n_experts % n_ep:
            raise ValueError(f"sorted MoE: {e.n_experts} experts must divide axis "
                             f"'data' ({n_ep})")
        if not isinstance(h, DTensor):
            raise ValueError("the sharded sorted MoE takes DTensor activations")
        tok = to_placements(P(ctx.dp, None, None), mesh)
        w_in = to_placements(P(("data",), None, "model"), mesh)
        w_out = to_placements(P(("data",), "model", None), mesh)
        names = [n for n in ("w_gate", "w_up", "w_down") if getattr(self.experts, n) is not None]
        weights = [getattr(self.experts, n) for n in names]
        w_pl = [w_out if n == "w_down" else w_in for n in names]
        ep_group, tp_group = mesh.get_group("data"), mesh.get_group("model")
        D, E = h.shape[-1], e.n_experts

        def body(hl, pl, *ws):
            n = hl.shape[0] * hl.shape[1]
            capl = max(1, int(n * e.capacity_factor * e.top_k / E))  # local tokens
            local = dict(zip(names, ws))
            experts = (local.get("w_gate"), local["w_up"], local["w_down"])
            out = self._sorted_dispatch_local(hl.reshape(n, D), pl.reshape(n, E), capl,
                                              experts=experts, ep_group=ep_group, n_ep=n_ep,
                                              tp_group=tp_group)
            return out.reshape(hl.shape)

        return local_map(body, out_placements=tok, in_placements=(tok, tok, *w_pl),
                         device_mesh=mesh, redistribute_inputs=True)(
            h, probs.float(), *weights)

    def forward_sorted(self, x, *, impl=None):
        """`moe_forward_sorted`: under an active sharding context over more
        than one device, the dispatch runs on each shard (`_sorted_sharded`);
        otherwise every B * S token is one group, the capacity still taken
        from S."""
        B, S, D = x.shape
        h, probs = self._probs(x, impl)
        ctx = sc.current()
        if ctx is None or ctx.n_devices() == 1:
            out = self._sorted_dispatch_local(h.reshape(B * S, D),
                                              probs.reshape(B * S, -1), self.capacity(S))
            out = out.view(B, S, D)
        else:
            out = self._sorted_sharded(h, probs, ctx)
        if self.shared is not None:
            out = out + self.shared(h).to(out.dtype)
        return sc.act(x + out.to(x.dtype), "dp", "sp", None)

    def decode(self, x, *, impl=None):
        """`moe_decode`: one token a row, x (B, 1, D), through `forward` at
        S = 1 (a row's one token takes slot 0 of each expert it picks, so
        none drops).  Every expert's slots are multiplied, as the einsum
        does: the step reads all E experts' weights whichever it hits.
        No host sync."""
        return self(x, impl=impl)


def _all_to_all(t, group, n: int):
    """Exchanges the n equal slices of t's dim 0 across ``group`` (slice j
    to its rank j; received slice i from rank i lands at i), with autograd
    (``lax.all_to_all``, tiled, on dim 0)."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd
    return all_to_all_single_autograd(t.contiguous(), None, None, group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` (the input of a
    product whose other operand is split over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """``lax.psum`` over ``group``; the gradient passes as it is (each rank
    holds the whole summed result)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None
