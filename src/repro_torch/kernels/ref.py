"""Plain PyTorch oracles, ported from ``repro.kernels.ref``.

The simplest correct definition of each op the port's kernels compute:
attention materialises every logit and repeats the KV heads for GQA; the
Mamba2 SSD scan runs token by token (`ssd_reference`) or chunk by chunk
(`ssd_chunked`, the TPU kernel's algorithm).
``ops`` runs these under ``impl="ref"`` on either device; the tests hold
the kernels' plain versions against the JAX package's kernels with them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, kv_offset: int = 0):
    """Multi-head attention oracle.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H a multiple of KV (GQA).
    ``kv_offset``: absolute position of q[0] minus k[0] (decode: Sk-Sq).
    ``window``: sliding-window width (attend to the last `window` keys).
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         window: int | None = None, scale: float | None = None):
    """Single-token decode attention over a (possibly ring-buffered) cache.

    q: (B, H, D); caches: (B, C, KV, D); cache_len: the number of valid
    slots, an int or a () or (B,) integer tensor.  Once a ring buffer has
    wrapped, callers pass cache_len == capacity.
    """
    b, h, d = q.shape
    _, c, kv, _ = k_cache.shape
    rep = h // kv
    scale = scale if scale is not None else d ** -0.5
    kf = torch.repeat_interleave(k_cache.float(), rep, dim=2)
    vf = torch.repeat_interleave(v_cache.float(), rep, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float() * scale, kf)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    idx = torch.arange(c, device=q.device)[None, :]
    mask = idx < clen                                   # (1 or B, C)
    if window is not None:
        mask &= idx >= clen - window
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vf)
    return out.to(q.dtype)


def rmsnorm_reference(x, w, eps: float = 1e-5):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Mamba2 SSD (state-space duality), arXiv:2405.21060
# --------------------------------------------------------------------------
def ssd_reference(x, dt, a, b, c, *, d_skip=None, init_state=None):
    """Sequential (token-by-token) SSD recurrence, the gold oracle.

    x: (B, L, H, P) inputs (post-conv, post-activation); dt: (B, L, H)
    softplus-ed timestep; a: (H,) negative decay rate (A = -exp(a_log));
    b, c: (B, L, N) input and output projections (one group, shared by the
    heads); d_skip: (H,) optional skip weight.  Returns y (B, L, H, P) in
    x's dtype and the final state (B, H, P, N) in float32.
    """
    B, L, H, P = x.shape
    N = b.shape[-1]
    s = (init_state if init_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * a)[:, :, None, None]             # (B,H,1,1)
        dbx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], bf[:, t], xf[:, t])
        s = s * decay + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", s, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, H, P))
    if d_skip is not None:
        y = y + xf * d_skip[None, None, :, None]
    return y.to(x.dtype), s


def ssd_chunked(x, dt, a, b, c, *, chunk: int = 128, d_skip=None, init_state=None):
    """Chunked SSD: within a chunk a decay-masked quadratic form, across
    chunks a carried (P, N) float32 state.  The same function as
    `ssd_reference`, summed in another order."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    xf = xf.reshape(B, nc, chunk, H, P)
    dtf = dtf.reshape(B, nc, chunk, H)
    bf = bf.reshape(B, nc, chunk, N)
    cf = cf.reshape(B, nc, chunk, N)
    s = (init_state if init_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    i = torch.arange(chunk, device=x.device)
    causal = (i[:, None] >= i[None, :])[None, :, :, None]
    ys = []
    for k in range(nc):
        xc, dtc, bc, cc = xf[:, k], dtf[:, k], bf[:, k], cf[:, k]
        cs = torch.cumsum(dtc * a, dim=1)                       # (B,Q,H) inclusive
        # intra-chunk: y_i += sum_{j<=i} C_i.B_j * exp(cs_i - cs_j) * dt_j * x_j
        seg = cs[:, :, None, :] - cs[:, None, :, :]              # (B,Qi,Qj,H)
        decay = torch.where(causal, torch.exp(seg), 0.0)
        cb = torch.einsum("bin,bjn->bij", cc, bc)                # (B,Qi,Qj)
        w = cb[..., None] * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        # inter-chunk: y_i += C_i . (exp(cs_i) * S_prev)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cc, s, torch.exp(cs))
        # state: S = exp(sum la) * S + sum_j exp(cs_last - cs_j) dt_j B_j x_j
        tot = cs[:, -1, :]                                       # (B,H)
        rem = torch.exp(tot[:, None, :] - cs)                    # (B,Q,H)
        dbx = torch.einsum("bjh,bjn,bjhp->bhpn", rem * dtc, bc, xc)
        s = s * torch.exp(tot)[:, :, None, None] + dbx
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, P)[:, :L]
    if d_skip is not None:
        y = y + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype), s


def ssd_decode_step(s, xt, dtt, a, bt, ct, *, d_skip=None):
    """One-token SSD state update (serving): s (B, H, P, N) float32, xt
    (B, H, P), dtt (B, H), bt, ct (B, N) -> (y (B, H, P) in xt's dtype, s')."""
    decay = torch.exp(dtt.float() * a)[:, :, None, None]
    dbx = torch.einsum("bh,bn,bhp->bhpn", dtt.float(), bt.float(), xt.float())
    s = s * decay + dbx
    y = torch.einsum("bhpn,bn->bhp", s, ct.float())
    if d_skip is not None:
        y = y + xt.float() * d_skip[None, :, None]
    return y.to(xt.dtype), s
