"""Grouped-query self-attention with rotary positions, pre-norm, residual.

The sublayer of a Llama-style decoder (deepseek-coder-33b, nemotron-4-15b):
``h = rmsnorm(x) * norm``; ``q = h @ wq``, ``k = h @ wk``, ``v = h @ wv``
split into heads; rotary embedding on q and k over non-interleaved halves
(the ``rotate_half`` layout); causal softmax attention where query head
``j`` reads key/value head ``j // (H / KV)``; ``x + o @ wo``.

Three things live here, each computed from shapes or plain ``torch``:
the leaves the benchmark draws, the float32 reference forward, and the
work a call needs (FLOPs and bytes: each weight read once, the cache read
up to its length, prompt tokens and not pads).
"""
from __future__ import annotations

import math

import torch

BF16 = 2          # bytes of a served weight, activation or cache element
F32 = 4


def dims(model: dict):
    a = model["attn"]
    return model["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"]


def leaves(model: dict) -> dict:
    """name -> (shape, init), as `perfbench.harness.weights` draws them."""
    d, h, kv, hd = dims(model)
    return {"norm": ((d,), "norm"),
            "wq": ((d, h * hd), "normal"), "wk": ((d, kv * hd), "normal"),
            "wv": ((d, kv * hd), "normal"), "wo": ((h * hd, d), "normal")}


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x (S, n, hd) float32 rotated at ``positions`` (S,): the first half of
    each head pairs with the second half."""
    d2 = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, d2, dtype=torch.float32, device=x.device) / d2)
    ang = positions[:, None].float() * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., 2 * d2:]], dim=-1)


def forward(model: dict, w: dict, x, mm=torch.matmul):
    """x (S, D) float32, a whole sequence from position 0 -> (S, D); ``mm``
    multiplies activations by a weight matrix."""
    d, h, kv, hd = dims(model)
    S = x.shape[0]
    hn = rmsnorm(x, w["norm"], model["norm_eps"])
    pos = torch.arange(S, device=x.device)
    theta = model["attn"]["rope_theta"]
    q = rope(mm(hn, w["wq"]).view(S, h, hd), pos, theta)
    k = rope(mm(hn, w["wk"]).view(S, kv, hd), pos, theta)
    v = mm(hn, w["wv"]).view(S, kv, hd)
    rep = h // kv
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    o = torch.empty(S, h, hd, dtype=x.dtype, device=x.device)
    for g in range(kv):                      # one key/value head and its queries
        qg = q[:, g * rep:(g + 1) * rep].transpose(0, 1)            # (rep, S, hd)
        s = (qg @ k[:, g].T) * hd ** -0.5                           # (rep, S, S)
        p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
        o[:, g * rep:(g + 1) * rep] = (p @ v[:, g]).transpose(0, 1)
    return x + mm(o.reshape(S, h * hd), w["wo"])


def _weight_bytes(model: dict) -> float:
    d, h, kv, hd = dims(model)
    return BF16 * (d * (h + 2 * kv) * hd + h * hd * d) + F32 * d


def _proj_flops(model: dict) -> float:
    d, h, kv, hd = dims(model)
    return 2.0 * (d * (h + 2 * kv) * hd + h * hd * d)


def decode_work(model: dict, lengths) -> tuple[float, float]:
    """One decode call over the live rows, whose caches hold ``lengths``
    positions each after this step's slot is written: (FLOPs, bytes).  The
    weights once, each row's cache read to its length, its new slot and
    its row of activations in and out."""
    d, h, kv, hd = dims(model)
    n, ctx = len(lengths), float(sum(lengths))
    flops = n * _proj_flops(model) + 4.0 * h * hd * ctx
    nbytes = (_weight_bytes(model) + BF16 * 2 * kv * hd * ctx
              + n * BF16 * (2 * kv * hd + 2 * d))
    return flops, nbytes


def prefill_work(model: dict, prompt_lens) -> tuple[float, float]:
    """One prefill call over real prompt tokens only: projections of each
    token, causal attention of each token over its own prompt's tokens up
    to itself; the weights once, activations in and out, keys and values
    written."""
    d, h, kv, hd = dims(model)
    tokens = float(sum(prompt_lens))
    pairs = float(sum(n * (n + 1) // 2 for n in prompt_lens))
    flops = tokens * _proj_flops(model) + 4.0 * h * hd * pairs
    nbytes = _weight_bytes(model) + tokens * BF16 * (2 * d + 2 * kv * hd)
    return flops, nbytes
