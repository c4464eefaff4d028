"""Kernel dispatch: by the tensors' device, and by an explicit ``impl``.

  * ``impl=None`` (the default): the hand-written CUDA kernels.  Each
    wrapper launches its kernel for a CUDA tensor, and runs the kernel's
    plain version for a CPU tensor; nothing falls back from the card to
    the CPU.
  * ``impl="ref"``: the oracles of ``ref.py`` on either device (for the
    SSD scan, `ref.ssd_chunked`), and the op-by-op oracle body of
    `blocks.Attention.decode` and of `blocks.Mamba._gate_out` — an
    explicit request, used to hold the kernel route against the oracle.

Unlike ``repro.kernels.ops`` there is no platform guess and no
environment variable: the device of the data decides.

Training takes the same dispatch: on the card, `attention`, `rmsnorm`,
`ssd` and `rmsnorm_gated` are differentiable through their backward
kernels when an input requires grad (chosen by ``requires_grad``, not by
a knob); the decode kernels serve only and raise ``NotImplementedError``
on such inputs.  On the CPU the plain versions are differentiated by
autograd.

Under a mesh (inputs that are DTensors), each wrapper runs its kernel, or
on the CPU its plain version, on the local shards through ``local_map``,
along the dims where the op is independent: attention and decode
attention over batch and heads, the norms over rows (the normalised dim
whole), the SSD scan over batch and heads.  Inputs placed any other way
are redistributed to that layout first; a weight's gradient is partial
over the mesh dims that split its rows (`_row_grad`).  A mesh axis of
size 1 splits nothing (`_layout`).  The fused decode
chain contracts over heads in its out-projection and adds the residual
inside, so it runs on inputs replicated over the model axis (batch still
split over the data axes), which is what GSPMD does with a
``pallas_call`` it cannot partition; the caches it writes are gathered
for the call and written back to their layout where the model axis
splits them.  Plain tensors pass through unchanged.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .fused_decode import attn_decode_step as _attn_decode_step
from .rmsnorm import rmsnorm as _rmsnorm
from .rmsnorm import rmsnorm_gated as _rmsnorm_gated
from .ssd_scan import ssd_scan as _ssd_scan

IMPLS = (None, "ref")


def check_impl(impl: str | None) -> str | None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


# -- the mesh ----------------------------------------------------------------
def _dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, so the mesh path; a plain tensor costs one
    type check (and DTensor is not imported for it)."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _layout(mesh, batch: int, heads=(), head_dim: int | None = None) -> list:
    """Placements, one a mesh dim, of a tensor whose dim 0 is the batch
    (split over the data axes where ``batch`` divides them) and whose dim
    ``head_dim`` holds heads (split over "model" where every count in
    ``heads`` divides it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    ndp = 1
    for a in names:
        if a != "model":
            ndp *= sizes[a]
    out = []
    for a in names:
        if sizes[a] == 1:
            out.append(Replicate())
        elif a != "model":
            out.append(Shard(0) if batch % ndp == 0 else Replicate())
        elif head_dim is not None and heads and all(h % sizes[a] == 0 for h in heads):
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


def _local_map(fn, mesh, out_placements, in_placements, in_grad, *args):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _rows(x):
    """A row op's layout of x (..., D): rows split as x's leading dims
    already are, the last dim whole."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
            for p in x.placements]


def _row_grad(placements):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(p, Shard) else Replicate() for p in placements]


# -- the wrappers: a plain tensor takes the direct call; a DTensor runs the
# same wrapper on its local shards ---------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, kv_offset: int = 0,
              impl: str | None = None):
    """Multi-head (GQA) attention. q: (B,Sq,H,D), k/v: (B,Sk,KV,D)."""
    if _dtensor(q):
        fn = functools.partial(attention, causal=causal, window=window, scale=scale,
                               kv_offset=kv_offset, impl=impl)
        pl = _layout(q.device_mesh, q.shape[0], (q.shape[2], k.shape[2]), 2)
        return _local_map(fn, q.device_mesh, pl, (pl, pl, pl), (pl, pl, pl), q, k, v)
    if check_impl(impl) == "ref":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_offset=kv_offset)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                            kv_offset=kv_offset)


def ssd(x, dt, a, b, c, *, chunk: int = 128, impl: str | None = None):
    """Chunked SSD scan: (y (B,L,H,P), final_state (B,H,P,N)).  ``chunk``: the
    blocking of the oracle and of the plain version on the CPU; the CUDA
    kernel walks the sequence in chunks of its own (64 tokens)."""
    if _dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard
        batch, heads = Shard(0), Shard(2)
        px = _layout(x.device_mesh, x.shape[0], (x.shape[2],), 2)
        # a (H,) follows the heads; b, c (B, L, N) the batch, and are shared by
        # the heads, so their gradients are partial where the heads are split
        pa = [Shard(0) if p == heads else Replicate() for p in px]
        ga = [Shard(0) if p == heads else Partial() if p == batch else Replicate() for p in px]
        pb = [p if p == batch else Replicate() for p in px]
        gb = [batch if p == batch else Partial() if p == heads else Replicate() for p in px]
        state = [Shard(1) if p == heads else p for p in px]       # (B, H, P, N)
        fn = functools.partial(ssd, chunk=chunk, impl=impl)
        return _local_map(fn, x.device_mesh, (px, state), (px, px, pa, pb, pb),
                          (px, px, ga, gb, gb), x, dt, a, b, c)
    if check_impl(impl) == "ref":
        return ref.ssd_chunked(x, dt, a, b, c, chunk=chunk)
    return _ssd_scan(x, dt, a, b, c, chunk=chunk)


def ssd_decode_step(s, xt, dtt, a, bt, ct):
    """`ref.ssd_decode_step`, Mamba2's one-token state update (serving):
    every (sequence, head, column) of the state is independent, so under a
    mesh it runs on the local shards in the state's layout (s (B, H, P, N)
    split on any of its first three dims), the token's inputs laid out to
    match; DTensor's own einsum flattens a split dim, which some torch
    versions (2.11) refuse."""
    if not _dtensor(s):
        return ref.ssd_decode_step(s, xt, dtt, a, bt, ct)
    from torch.distributed.tensor import Replicate, Shard
    ps = [p if isinstance(p, Shard) and p.dim < 3 else Replicate() for p in s.placements]
    ph = [p if isinstance(p, Shard) and p.dim < 2 else Replicate() for p in ps]     # (B, H)
    pa = [Shard(0) if p == Shard(1) else Replicate() for p in ps]                 # (H,)
    pb = [p if p == Shard(0) else Replicate() for p in ps]                        # (B, N)
    return _local_map(ref.ssd_decode_step, s.device_mesh, (ps, ps), (ps, ps, ph, pa, pb, pb),
                      None, s, xt, dtt, a, bt, ct)


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str | None = None):
    if _dtensor(x):
        from torch.distributed.tensor import Replicate
        px = _rows(x)
        pw = [Replicate()] * x.device_mesh.ndim
        fn = functools.partial(rmsnorm, eps=eps, impl=impl)
        return _local_map(fn, x.device_mesh, px, (px, pw), (px, _row_grad(px)), x, w)
    if check_impl(impl) == "ref":
        return ref.rmsnorm_reference(x, w, eps=eps)
    return _rmsnorm(x, w, eps=eps)


def rmsnorm_gated(y, xh, d_skip, z, w, *, eps: float = 1e-5):
    """`rmsnorm.rmsnorm_gated`; under a mesh, rows of z (..., H*P) and of y,
    xh (..., H, P) split as z's leading dims are, the normalised dim whole."""
    if _dtensor(z):
        from torch.distributed.tensor import Replicate
        pz = _rows(z)
        pw = [Replicate()] * z.device_mesh.ndim
        gw = _row_grad(pz)
        fn = functools.partial(rmsnorm_gated, eps=eps)
        return _local_map(fn, z.device_mesh, pz, (pz, pz, pw, pz, pw), (pz, pz, gw, pz, gw),
                          y, xh, d_skip, z, w)
    return _rmsnorm_gated(y, xh, d_skip, z, w, eps=eps)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int | None = None,
                     scale: float | None = None, impl: str | None = None):
    """Single-token decode attention over a resident cache.  q (B, H, hd);
    caches (B, C, KV, hd); cache_len: the live slots, on the card a device
    int32 tensor of shape () or (B,)."""
    if _dtensor(q):
        from torch.distributed.tensor import Replicate
        mesh = q.device_mesh
        pq = _layout(mesh, q.shape[0], (q.shape[1], k_cache.shape[2]), 1)
        pc = _layout(mesh, q.shape[0], (q.shape[1], k_cache.shape[2]), 2)
        pl = [Replicate()] * mesh.ndim if _dtensor(cache_len) else None
        fn = functools.partial(decode_attention, window=window, scale=scale, impl=impl)
        return _local_map(fn, mesh, pq, (pq, pc, pc, pl), (pq, pc, pc, pl),
                          q, k_cache, v_cache, cache_len)
    if check_impl(impl) == "ref":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len, window=window,
                                        scale=scale)
    return _decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)


def attn_decode_step(x, k_cache, v_cache, pos, **kw):
    """`fused_decode.attn_decode_step`; under a mesh, with the batch split
    over the data axes and everything else whole (module docstring)."""
    if not _dtensor(x):
        return _attn_decode_step(x, k_cache, v_cache, pos, **kw)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    pb = _layout(mesh, x.shape[0])
    rep = [Replicate()] * mesh.ndim

    def local(t, placements):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements).to_local()

    weights = ("norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv")
    caches = [local(c, pb) for c in (k_cache, v_cache)]
    args = {k: local(v, rep) if k in weights else v for k, v in kw.items()}
    out = _attn_decode_step(local(x, pb), *caches, local(pos, rep), **args)
    for cache, new in zip((k_cache, v_cache), caches):
        if tuple(cache.placements) != tuple(pb):
            cache.to_local().copy_(DTensor.from_local(new, mesh, pb).redistribute(
                mesh, cache.placements).to_local())
    return DTensor.from_local(out, mesh, pb)
