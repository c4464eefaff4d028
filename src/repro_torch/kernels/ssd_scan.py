"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
plain version.

Layouts are the JAX wrapper's: x (B, L, H, P); dt (B, L, H); a (H,); b, c
(B, L, N), one group shared by the heads.  ``ssd_scan`` returns y (B, L,
H, P) in x's dtype and the final state (B, H, P, N) in float32.

The kernel replaces the Pallas TPU kernel `_ssd_kernel`
(``repro/kernels/ssd_scan.py``).  It reads x, dt, b and c in place
through their strides (the JAX wrapper's transposes are a TPU layout
choice), so the slices of the Mamba projection go in without a copy.
``ssd_scan`` launches it for CUDA tensors and runs the plain version,
``ref.ssd_chunked``, for CPU tensors.  ``chunk`` is the plain version's
blocking; the kernel walks the sequence in chunks of its own (64 tokens,
see the source), and any chunk length gives the same scan.  In bf16 the
kernel runs its chunk products on the tensor cores, one block of 4 warps
per (head, sequence), two blocks an SM (`blocks_per_sm` asks CUDA).

On the card, ``ssd_scan`` is differentiable when an input requires grad:
`_SsdScan` runs the forward kernel, then the backward kernels of the same
source (`ssd_scan_backward`) for the output gradients; a final state that
the loss does not use (a training loss never does) gets no gradient and
costs nothing.  Its plain version is `ref.ssd_chunked_backward`.
"""
from __future__ import annotations

import ctypes
import torch

from . import build
from .ref import ssd_chunked, ssd_chunked_backward

__all__ = ["blocks_per_sm", "bwd_scratch_shapes", "ssd_scan", "ssd_scan_backward",
           "ssd_scan_plain"]

MAX_HEAD_DIM = 64    # P: zero-padded to 64, 16 rows a warp (bf16); 4 columns a thread (float32)
MAX_STATE = 128      # N: zero-padded to 128 (bf16); 8 state columns a thread (float32)

_ARGS = [build.P] * 7 + [build.I] * 5 + [build.L] * 10 + [build.P]
_BWD_ARGS = [build.P] * 15 + [build.I] * 5 + [build.L] * 10 + [build.I, build.P]
CHUNK = 64           # the kernels' own chunk of tokens
SLOT = MAX_HEAD_DIM * MAX_STATE   # floats of a state in the backward's scratch (zero-padded)
# the backward's launches (csrc/ssd_scan.cu): the states, the chunks, da
STATES_PASS, CHUNK_PASS, DA_PASS = 1, 2, 4
ALL_PASSES = STATES_PASS | CHUNK_PASS | DA_PASS


def bwd_scratch_shapes(batch: int, length: int, heads: int) -> dict:
    """The backward's float32 buffers: the state entering and the state
    gradient leaving every chunk (a slot each: 64 rows of 128 floats, zero
    past P and N), and the chunks' shares of da."""
    chunks = -(-length // CHUNK)
    return {"starts": (batch, heads, chunks, SLOT), "dstates": (batch, heads, chunks, SLOT),
            "da_part": (batch, chunks, heads)}


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128):
    """The kernel's function in plain PyTorch: the chunked scan."""
    return ssd_chunked(x, dt, a, b, c, chunk=chunk)


def _check(name: str, x, dt, a, b, c) -> None:
    B, L, H, P = x.shape
    N = b.shape[-1]
    devices = {t.device for t in (x, dt, a, b, c)}
    if len(devices) != 1:
        raise ValueError(f"{name}: every tensor must be on one CUDA device, got {devices}")
    if (x.dtype not in build.DTYPE_SUFFIX or b.dtype != x.dtype or c.dtype != x.dtype
            or a.dtype != torch.float32 or dt.shape != (B, L, H) or a.shape != (H,)
            or b.shape != (B, L, N) or c.shape != (B, L, N) or not 1 <= P <= MAX_HEAD_DIM
            or not 1 <= N <= MAX_STATE):
        raise ValueError(
            f"{name}: x (B,L,H,P) and b, c (B,L,N) of one dtype (bf16/float32), dt "
            f"(B,L,H), a (H,) float32, P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got x "
            f"{x.dtype} {tuple(x.shape)}, dt {tuple(dt.shape)}, a {a.dtype} "
            f"{tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}, c {tuple(c.shape)}")
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1 or not a.is_contiguous():
        raise ValueError(f"{name}: the last axis of x, b and c, and a, must be contiguous")


def _strides(x, dt, b, c) -> tuple:
    return (x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1))


def _forward(x, dt, a, b, c):
    _check("ssd_scan", x, dt, a, b, c)
    B, L, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    build.call(f"ssd_scan_{build.DTYPE_SUFFIX[x.dtype]}", _ARGS,
               x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
               y.data_ptr(), state.data_ptr(), B, L, H, P, N, *_strides(x, dt, b, c),
               build.stream(x.device))
    build.count(ssd_scan)
    return y, state


def ssd_scan_backward(x, dt, a, b, c, dy, d_state=None, *, passes: int = ALL_PASSES):
    """dx, ddt, da, db, dc of ``ssd_scan(x, dt, a, b, c)`` for dy (y's
    shape) and d_state (the final state's gradient; None: zero).  dx, db,
    dc in x's dtype and ddt, da float32, all contiguous.  CUDA tensors: the
    backward kernels (three launches, see the source; ``passes`` launches
    only some, to time them apart); CPU tensors: the plain version,
    `ref.ssd_chunked_backward`."""
    if x.device.type == "cpu":
        return ssd_chunked_backward(x, dt, a, b, c, dy, d_state, chunk=CHUNK)
    dt = dt.float()
    _check("ssd_scan_backward", x, dt, a, b, c)
    B, L, H, P = x.shape
    N = b.shape[-1]
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or (d_state is not None and (d_state.shape != (B, H, P, N)
                                         or d_state.dtype != torch.float32
                                         or d_state.device != x.device))):
        raise ValueError(f"ssd_scan_backward: dy as x {x.dtype} {tuple(x.shape)} and d_state "
                         f"float32 {(B, H, P, N)} or None; got dy {dy.dtype} "
                         f"{tuple(dy.shape)}, d_state "
                         f"{None if d_state is None else (d_state.dtype, tuple(d_state.shape))}")
    dy = dy.contiguous()
    d_state = None if d_state is None else d_state.contiguous()
    dev = x.device
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    da = torch.zeros((H,), dtype=torch.float32, device=dev)
    db = torch.empty((B, L, N), dtype=x.dtype, device=dev)
    dc = torch.empty((B, L, N), dtype=x.dtype, device=dev)
    if B * L == 0:
        return dx, ddt, da, db, dc
    shapes = bwd_scratch_shapes(B, L, H)
    starts = torch.empty(shapes["starts"], dtype=torch.float32, device=dev)
    dstates = torch.empty_like(starts)
    da_part = torch.empty(shapes["da_part"], dtype=torch.float32, device=dev)
    build.call(f"ssd_scan_bwd_{build.DTYPE_SUFFIX[x.dtype]}", _BWD_ARGS,
               x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
               dy.data_ptr(), None if d_state is None else d_state.data_ptr(),
               starts.data_ptr(), dstates.data_ptr(), da_part.data_ptr(), dx.data_ptr(),
               ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
               B, L, H, P, N, *_strides(x, dt, b, c), passes,
               build.stream(dev))
    build.count(ssd_scan_backward)
    return dx, ddt, da, db, dc


class _SsdScan(torch.autograd.Function):
    """The forward kernel and the backward kernels."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.set_materialize_grads(False)     # an unused final state: no gradient, no zeros
        ctx.save_for_backward(x, dt, a, b, c)
        return _forward(x, dt, a, b, c)

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, a, b, c = ctx.saved_tensors
        return ssd_scan_backward(x, dt, a, b, c, torch.zeros_like(x) if dy is None else dy,
                                 d_state)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x (B, L, H, P); dt (B, L, H); a (H,) float32; b, c (B, L, N) ->
    y (B, L, H, P) in x's dtype, final state (B, H, P, N) float32.  On the
    card, differentiable through the backward kernels when an input
    requires grad; otherwise one forward launch."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    dt = dt.float()          # bf16 timesteps are widened, as the plain version does
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        return _SsdScan.apply(x, dt, a, b, c)
    return _forward(x, dt, a, b, c)


ssd_scan.launches = 0            # forward kernel launches, for showing a run went through it
ssd_scan_backward.launches = 0   # backward calls (three kernels each)


def blocks_per_sm(dtype: torch.dtype, P: int = MAX_HEAD_DIM, N: int = MAX_STATE) -> int:
    """Blocks of the kernel that fit one SM of the current card at these
    widths, by CUDA's occupancy calculator (card only)."""
    out = ctypes.c_int(0)
    build.call(f"ssd_scan_{build.DTYPE_SUFFIX[dtype]}_blocks_per_sm",
               [build.I, build.I, build.P], P, N, ctypes.addressof(out))
    return out.value
