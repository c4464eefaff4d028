"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
plain version.

One query token per sequence attends over its resident (ring) KV cache,
GQA without repeating the KV heads: q (B, H, hd) is read as (B, KV, rep,
hd), group g owning query heads [g*rep, (g+1)*rep).  Slot ``idx`` takes
part when ``idx < cache_len`` and, with a window, ``idx >= cache_len -
window``.  Slot order does not matter (softmax attention is permutation
invariant over keys), so a wrapped ring needs only ``cache_len = C``.

The kernel replaces the Pallas TPU kernel `_decode_kernel`
(``repro/kernels/decode_attention.py``) and, unlike it, takes one length
per sequence as well as one for the batch.  ``decode_attention`` launches
it for CUDA tensors and runs the plain version for CPU tensors.

The kernel splits each (sequence, KV head)'s cache into ranges of slots
across blocks and merges the partial softmax states in the same launch
(flash-decoding); `split_plan` chooses the ranges on the host from the
shapes alone, so a step needs no host sync.  The partial states and the
merge counters live in a workspace kept per device, stream and shape:
calls that share one are ordered by their stream, and calls on two
streams (two pipeline stages, two replicas) never share one.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from . import build
from .ref import NEG_INF

__all__ = ["decode_attention", "decode_attention_plain"]

MAX_HEAD_DIM = 128   # a lane holds at most 4 of the head dim's values
MAX_REP = 8          # a warp a query head of the group
MIN_SPLIT = 32       # slots a split at least: one stage of the kernel
LONG_SPLIT = 256     # slots a split at most, unless MAX_SPLITS needs more
MAX_SPLITS = 64      # splits at most: the last block merges them one after another

_ARGS = [build.P, build.P, build.P, build.P, build.I, build.P, build.P, build.P, build.P,
         build.I, build.I, build.I, build.I, build.I, build.I, build.I, build.F, build.I,
         build.P]


class SplitPlan(NamedTuple):
    """Split s of a (sequence, KV head) takes the cache slots [s * length,
    min((s + 1) * length, C)) of a cache of capacity C."""
    length: int
    splits: int


def split_plan(batch: int, kv_heads: int, capacity: int, sm_count: int) -> SplitPlan:
    """The longest split (a power of two from MIN_SPLIT) that still leaves
    at least one block an SM, but no longer than LONG_SPLIT, since a block
    streams its stages one after another; longer only where that would take
    more than MAX_SPLITS, and one split where the cache is no longer than
    it.  At qwen2.5-3b's serving shapes (B 8, KV 2, C 544, 132 SMs): 64
    slots, 9 splits, 144 blocks."""
    length = MIN_SPLIT
    while length < capacity and (
            -(-capacity // length) > MAX_SPLITS
            or (length < LONG_SPLIT
                and batch * kv_heads * -(-capacity // (2 * length)) >= sm_count)):
        length *= 2
    return SplitPlan(length, -(-capacity // length))


def workspace_shapes(batch: int, kv_heads: int, rep: int, head_dim: int,
                     plan: SplitPlan) -> dict:
    """The kernel's buffers: the float32 partial sums and the running max
    and sum of every split and query head, and an int32 merge counter a
    (sequence, KV head)."""
    bg = batch * kv_heads
    return {"acc": (bg, plan.splits, rep, head_dim), "ml": (bg, plan.splits, rep, 2),
            "tickets": (bg,)}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_workspaces: dict = {}
_workspaces_lock = threading.Lock()


def _workspace(device: torch.device, stream: int, shapes: dict) -> dict:
    """The buffers for ``shapes`` on ``device`` for the launches of one
    ``stream`` (its handle), made once, on that stream: the counters start
    at 0 and the kernel leaves them at 0.  A workspace is only ever
    touched by its stream's launches, which run one after another."""
    key = (device, stream, tuple(shapes.values()))
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = {"acc": torch.empty(shapes["acc"], dtype=torch.float32, device=device),
                  "ml": torch.empty(shapes["ml"], dtype=torch.float32, device=device),
                  "tickets": torch.zeros(shapes["tickets"], dtype=torch.int32,
                                         device=device)}
            _workspaces[key] = ws
    return ws


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           window: int | None = None, scale: float | None = None):
    """The kernel's function in plain PyTorch, float32 inside.

    cache_len: an int or an integer tensor of shape () or (B,), >= 1."""
    b, h, d = q.shape
    _, c, kv, _ = k_cache.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, kv, rep, d) * scale
    s = torch.einsum("bgrd,bcgd->bgrc", qg, k_cache.float())
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    idx = torch.arange(c, device=q.device)[None, :]
    live = idx < clen                                     # (1 or B, C)
    if window is not None:
        live &= idx >= clen - window
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    o = torch.einsum("bgrc,bcgd->bgrd", torch.softmax(s, dim=-1), v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None, scale: float | None = None):
    """q (B, H, hd); caches (B, C, KV, hd); cache_len: the live slots, an
    int32 tensor of shape () or (B,) on the card (an int or any integer
    tensor on the CPU) -> (B, H, hd)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window, scale=scale)
    if not isinstance(cache_len, torch.Tensor):
        raise TypeError("decode_attention: cache_len must be a device int32 tensor on "
                        "the card, so that the step needs no host sync")
    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    build.check_cuda("decode_attention", q, k_cache, v_cache, cache_len)
    b, h, d = q.shape
    _, c, kv, _ = k_cache.shape
    if (q.dtype not in build.DTYPE_SUFFIX or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype or k_cache.shape != (b, c, kv, d)
            or v_cache.shape != k_cache.shape or h % kv or h // kv > MAX_REP
            or d > MAX_HEAD_DIM):
        raise ValueError(
            f"decode_attention: q (B,H,hd) and caches (B,C,KV,hd) of one dtype "
            f"(bf16/float32), H/KV a whole number <= {MAX_REP}, hd <= {MAX_HEAD_DIM}; "
            f"got q {q.dtype} {tuple(q.shape)}, k {k_cache.dtype} "
            f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if cache_len.dtype != torch.int32 or cache_len.shape not in ((), (b,)):
        raise ValueError("decode_attention: cache_len must be int32 of shape () or (B,), "
                         f"got {cache_len.dtype} {tuple(cache_len.shape)}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    plan = split_plan(b, kv, c, _sm_count(q.device.index))
    stream = build.stream(q.device)
    ws = _workspace(q.device, stream, workspace_shapes(b, kv, h // kv, d, plan))
    build.call(f"decode_attention_{build.DTYPE_SUFFIX[q.dtype]}", _ARGS,
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
               int(cache_len.dim() == 1), out.data_ptr(), ws["acc"].data_ptr(),
               ws["ml"].data_ptr(), ws["tickets"].data_ptr(), b, c, h, kv, d, plan.length,
               plan.splits, scale, window or 0, stream)
    build.count(decode_attention)
    return out


decode_attention.launches = 0   # kernel launches, for showing a run went through it
