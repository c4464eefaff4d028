"""Row RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

The kernel replaces the Pallas TPU kernel `_rmsnorm_kernel`
(``repro/kernels/rmsnorm.py``); the source says what bounds it on the
H100 and how it is laid out.  ``rmsnorm`` launches it for a CUDA tensor
and runs the plain version for a CPU tensor.
"""
from __future__ import annotations

import torch

from . import build
from .ref import rmsnorm_reference as rmsnorm_plain  # the kernel's plain version

__all__ = ["rmsnorm", "rmsnorm_plain"]

_ARGS = [build.P, build.P, build.P, build.I, build.I, build.F, build.P]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) bf16 or float32, w: (D,) float32 -> x's shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    build.check_cuda("rmsnorm", x, w)
    d = x.shape[-1]
    if x.dtype not in build.DTYPE_SUFFIX or w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(f"rmsnorm: x bf16/float32 (..., {d}) and w float32 ({d},), "
                         f"got {x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    build.call(f"rmsnorm_{build.DTYPE_SUFFIX[x.dtype]}", _ARGS, x.data_ptr(), w.data_ptr(),
               out.data_ptr(), rows, d, eps, build.stream(x.device))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0   # kernel launches, for showing a run went through it
