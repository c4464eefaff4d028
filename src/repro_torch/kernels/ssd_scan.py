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
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_chunked

__all__ = ["blocks_per_sm", "ssd_scan", "ssd_scan_plain"]

MAX_HEAD_DIM = 64    # P: zero-padded to 64, 16 rows a warp (bf16); 4 columns a thread (float32)
MAX_STATE = 128      # N: zero-padded to 128 (bf16); 8 state columns a thread (float32)

_ARGS = [build.P] * 7 + [build.I] * 5 + [build.L] * 10 + [build.P]


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128):
    """The kernel's function in plain PyTorch: the chunked scan."""
    return ssd_chunked(x, dt, a, b, c, chunk=chunk)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x (B, L, H, P); dt (B, L, H); a (H,) float32; b, c (B, L, N) ->
    y (B, L, H, P) in x's dtype, final state (B, H, P, N) float32."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    build.refuse_grad("ssd_scan", x, dt, a, b, c)
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    dt = dt.float()          # bf16 timesteps are widened, as the plain version does
    devices = {t.device for t in (x, dt, a, b, c)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan: every tensor must be on one CUDA device, got {devices}")
    if (x.dtype not in build.DTYPE_SUFFIX or b.dtype != x.dtype or c.dtype != x.dtype
            or a.dtype != torch.float32 or dt.shape != (B, L, H) or a.shape != (H,)
            or b.shape != (B, L, N) or c.shape != (B, L, N) or not 1 <= P <= MAX_HEAD_DIM
            or not 1 <= N <= MAX_STATE):
        raise ValueError(
            f"ssd_scan: x (B,L,H,P) and b, c (B,L,N) of one dtype (bf16/float32), dt "
            f"(B,L,H), a (H,) float32, P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got x "
            f"{x.dtype} {tuple(x.shape)}, dt {tuple(dt.shape)}, a {a.dtype} "
            f"{tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}, c {tuple(c.shape)}")
    if x.stride(3) != 1 or b.stride(2) != 1 or c.stride(2) != 1 or not a.is_contiguous():
        raise ValueError("ssd_scan: the last axis of x, b and c, and a, must be contiguous")
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    build.call(f"ssd_scan_{build.DTYPE_SUFFIX[x.dtype]}", _ARGS,
               x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
               y.data_ptr(), state.data_ptr(), B, L, H, P, N,
               x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
               dt.stride(2), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
               build.stream(x.device))
    build.count(ssd_scan)
    return y, state


ssd_scan.launches = 0   # kernel launches, for showing a run went through it


def blocks_per_sm(dtype: torch.dtype, P: int = MAX_HEAD_DIM, N: int = MAX_STATE) -> int:
    """Blocks of the kernel that fit one SM of the current card at these
    widths, by CUDA's occupancy calculator (card only)."""
    out = ctypes.c_int(0)
    build.call(f"ssd_scan_{build.DTYPE_SUFFIX[dtype]}_blocks_per_sm",
               [build.I, build.I, build.P], P, N, ctypes.addressof(out))
    return out.value
