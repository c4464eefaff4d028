"""Plain PyTorch oracles, ported from ``repro.kernels.ref``.

The simplest correct definition of each op the port's kernels compute:
attention materialises every logit and repeats the KV heads for GQA; the
Mamba2 SSD scan runs token by token (`ssd_reference`) or chunk by chunk
(`ssd_chunked`, the TPU kernel's algorithm).  Two backward functions,
`ssd_chunked_backward` and `rmsnorm_gated_backward`, are written step by
step as the card's backward kernels compute them; the tests hold them
against autograd and against ``jax.vjp`` of the JAX package's oracles.
``ops`` runs these under ``impl="ref"`` on either device; the tests hold
the kernels' plain versions against the JAX package's kernels with them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
        # seg <= 0 on and below the diagonal (a < 0); clamped above it, where
        # exp would overflow and autograd would carry 0 * inf = nan back
        decay = torch.where(causal, torch.exp(torch.clamp(seg, max=0.0)), 0.0)
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


def ssd_chunked_backward(x, dt, a, b, c, dy, d_state=None, *, chunk: int = 64):
    """The gradients (dx, ddt, da, db, dc) of ``ssd_chunked(x, dt, a, b, c)``
    for dy (y's shape) and d_state (the final state's gradient, or None for
    zero), by the card's chunked algorithm: each chunk's starting state S,
    passed from chunk to chunk, then a reverse sweep over the chunks
    carrying dS, the gradient of the state a chunk leaves.  With cs the chunk's inclusive
    cumsum of dt a, M_ij = (C_i.B_j) e^(cs_i - cs_j) (i >= j), G_ij =
    dy_i.x_j and rem_j = e^(cs_last - cs_j):

      dx_j  = dt_j (sum_i M_ij dy_i + rem_j dS B_j)
      db_j  = sum_h (sum_i e^(cs_i - cs_j) dt_j G_ij C_i + rem_j dt_j dS^T x_j)
      dc_i  = sum_h (sum_j e^(cs_i - cs_j) dt_j G_ij B_j + e^(cs_i) S^T dy_i)
      dS'   = e^(cs_last) dS + sum_i e^(cs_i) dy_i C_i^T  (into the chunk before)

    and d(cs) from every exponent, which reaches ddt and da through the
    cumsum as a suffix sum within the chunk.  Only differences of cs are
    exponentiated.  dx, db, dc in their inputs' dtypes; ddt, da float32."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    xf, dtf, bf, cf, dyf = x.float(), dt.float(), b.float(), c.float(), dy.float()
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf, cf = (F.pad(t, (0, 0, 0, pad)) for t in (bf, cf))
    xf, dyf = xf.reshape(B, nc, chunk, H, P), dyf.reshape(B, nc, chunk, H, P)
    dtf = dtf.reshape(B, nc, chunk, H)
    bf, cf = bf.reshape(B, nc, chunk, N), cf.reshape(B, nc, chunk, N)
    cs = torch.cumsum(dtf * a, dim=2)                          # (B,nc,Q,H) inclusive
    tot = cs[:, :, -1]                                          # (B,nc,H)
    i = torch.arange(chunk, device=x.device)
    causal = (i[:, None] >= i[None, :])[None, :, :, None]
    starts = []                                                 # S entering each chunk
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    for k in range(nc):
        starts.append(s)
        rem = torch.exp(tot[:, k, None, :] - cs[:, k]) * dtf[:, k]
        s = (s * torch.exp(tot[:, k])[:, :, None, None]
             + torch.einsum("bjh,bjn,bjhp->bhpn", rem, bf[:, k], xf[:, k]))
    ds = (d_state.float() if d_state is not None
          else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    dx, ddt, db, dc = (torch.empty_like(t) for t in (xf, dtf, bf, cf))
    da = torch.zeros_like(a, dtype=torch.float32)
    for k in reversed(range(nc)):
        xc, dyc, dtc, bc, cc, csk = xf[:, k], dyf[:, k], dtf[:, k], bf[:, k], cf[:, k], cs[:, k]
        S, tk = starts[k], tot[:, k]
        dec = torch.where(causal, torch.exp(torch.clamp(
            csk[:, :, None, :] - csk[:, None, :, :], max=0.0)), 0.0)          # (B,Qi,Qj,H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        m = cb[..., None] * dec
        w2 = dec * dtc[:, None] * torch.einsum("bihp,bjhp->bijh", dyc, xc)
        t = cb[..., None] * w2                                  # M_ij dt_j G_ij
        rem = torch.exp(tk[:, None, :] - csk)                   # (B,Q,H)
        ecs = torch.exp(csk)
        intra = torch.einsum("bijh,bihp->bjhp", m, dyc)
        inter = torch.einsum("bhpn,bjn->bjhp", ds, bc)
        dx[:, k] = dtc[..., None] * (intra + rem[..., None] * inter)
        a2 = (xc * inter).sum(-1)
        u = dtc * rem * a2                                      # d(cs_j) of the state's rem_j
        dys = torch.einsum("bihp,bhpn->bihn", dyc, S)
        db[:, k] = (torch.einsum("bijh,bin->bjn", w2, cc)
                    + torch.einsum("bjh,bjhp,bhpn->bjn", rem * dtc, xc, ds))
        dc[:, k] = torch.einsum("bijh,bjn->bin", w2, bc) + torch.einsum("bih,bihn->bin", ecs, dys)
        dcs = t.sum(2) - t.sum(1) + ecs * torch.einsum("bihn,bin->bih", dys, cc) - u
        dcs[:, -1] += torch.exp(tk) * (ds * S).sum((-1, -2)) + u.sum(1)
        suffix = torch.flip(torch.cumsum(torch.flip(dcs, [1]), 1), [1])
        ddt[:, k] = (xc * intra).sum(-1) + rem * a2 + a * suffix
        da += (dtc * suffix).sum((0, 1))
        ds = (ds * torch.exp(tk)[:, :, None, None]
              + torch.einsum("bih,bihp,bin->bhpn", ecs, dyc, cc))
    dx = dx.reshape(B, nc * chunk, H, P)[:, :L].to(x.dtype)
    ddt = ddt.reshape(B, nc * chunk, H)[:, :L]
    db = db.reshape(B, nc * chunk, N)[:, :L].to(b.dtype)
    dc = dc.reshape(B, nc * chunk, N)[:, :L].to(c.dtype)
    return dx, ddt, da, db, dc


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


def rmsnorm_gated_backward(y, xh, d_skip, z, w, g, *, eps: float = 1e-5):
    """The gradients (dy, dxh, dd_skip, dz, dw) of Mamba2's gated norm
    rmsnorm((y + xh * d_skip) * silu(z), w) for its output gradient g, as
    the card's kernel computes them: the gate recomputed with the forward's
    roundings, the norm's backward in float32 rounded once to the input
    type, then the gate's chain rule with silu'(z) = s (1 + z (1 - s)), s =
    sigmoid(z), rounded where autograd of the op-by-op body rounds.  y, xh
    (..., H, P); z and g (..., H*P); d_skip (H,) and w (H*P,) float32.
    dd_skip and dw are float32 sums over the rows (and, for dd_skip, over
    each head's P columns)."""
    h, p = y.shape[-2:]
    ds = d_skip[:, None].to(xh.dtype)
    g1 = (y + xh * ds).reshape(z.shape)
    sz = F.silu(z)
    gate = g1 * sz
    gf, gw = gate.float(), g.float() * w
    r = torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + eps)
    dgate = (r * gw - gf * r ** 3 * torch.mean(gw * gf, dim=-1, keepdim=True)).to(gate.dtype)
    dw = (g.float() * gf * r).reshape(-1, h * p).sum(0)
    dg1 = (dgate * sz).reshape(y.shape)
    sig = torch.sigmoid(z.float())
    dz = ((dgate * g1).float() * sig * (1 + z.float() * (1 - sig))).to(z.dtype)
    dd_skip = (dg1.float() * xh.float()).reshape(-1, h, p).sum((0, 2))
    return dg1, dg1 * ds, dd_skip, dz, dw
