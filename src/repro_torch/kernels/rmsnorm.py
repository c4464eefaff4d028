"""Row RMSNorm and Mamba2's gated form: the CUDA kernels ``csrc/rmsnorm.cu``
and their plain versions.

The kernels replace the Pallas TPU kernel `_rmsnorm_kernel`
(``repro/kernels/rmsnorm.py``); the gated form also takes in the
elementwise ops that the JAX package runs before it in a Mamba2 block.  The
source says what bounds them on the H100 and how they are laid out;
`norm_plan` chooses the launch on the host from the shapes and the card's
properties.  ``rmsnorm`` and ``rmsnorm_gated`` launch a kernel for CUDA
tensors and run the plain version for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .ref import rmsnorm_reference as rmsnorm_plain  # the kernel's plain version

__all__ = ["rmsnorm", "rmsnorm_gated", "rmsnorm_gated_plain", "rmsnorm_plain", "norm_plan"]

THREADS = 256      # a block of the row kernel at most (its launch bounds)
REGISTERS = 128    # a thread at most: the launch bounds keep two such blocks an SM
MAX_UNITS = {False: 4, True: 2}   # 16-byte pieces of a row a lane holds: plain, gated

_ARGS = [build.P, build.P, build.P, build.I, build.I, build.F] + [build.I] * 4 + [build.P]
_GATED_ARGS = ([build.P] * 4 + [build.L, build.I, build.P, build.P, build.I, build.I, build.F]
               + [build.I] * 4 + [build.P])


class Card(NamedTuple):
    """What `norm_plan` needs of a card: its SMs and what one SM holds."""
    sms: int
    threads: int      # an SM at most
    registers: int    # an SM


class NormPlan(NamedTuple):
    """A launch: ``warps`` warps a row (0: the wide kernel, a block a row),
    each lane holding ``units`` 16-byte pieces of it; ``groups`` rows a
    block at once; ``blocks`` blocks, which walk the rows grid-stride."""
    warps: int
    units: int
    groups: int
    blocks: int


WIDE = NormPlan(0, 0, 0, 0)


def norm_plan(rows: int, d: int, elem_bytes: int, *, gated: bool, aligned: bool,
              card: Card) -> NormPlan:
    """The fewest warps a row (a power of two, at most a block's 8) whose
    lanes hold the row in at most ``MAX_UNITS`` pieces each, and twice as
    many (where a block holds them) when there are fewer rows than SMs, so
    that more warps share each row's chain of work; rows that are not whole
    16-byte pieces at aligned addresses, or too wide, go to the wide kernel.
    A block takes 8 warps' worth of rows at once, or fewer where there are
    too few rows to give every SM a row group; there are at most as many
    blocks as fit the card at once (by threads, and by the registers the
    launch bounds allow), so each block walks several rows where there are
    many.  At qwen2.5-3b's prefill (4096 rows of 2048 bf16 on 132 SMs): 2
    warps a row, 4 pieces a lane, 4 rows a block, 264 blocks; at a decode
    step (8 rows): 8 blocks of one row of 4 warps."""
    vec = 16 // elem_bytes
    if not aligned or d % vec:
        return WIDE
    pieces = d // vec
    warps = 1
    while -(-pieces // (32 * warps)) > MAX_UNITS[gated]:
        warps *= 2
    if warps > THREADS // 32:
        return WIDE
    if rows < card.sms and warps < THREADS // 32:
        warps *= 2
    units = 1 << (-(-pieces // (32 * warps)) - 1).bit_length()
    groups = max(1, min(THREADS // 32 // warps, rows // card.sms))
    threads = 32 * warps * groups
    fit = min(card.threads // threads, card.registers // (REGISTERS * threads))
    return NormPlan(warps, units, groups, min(-(-rows // groups), card.sms * max(1, fit)))


@functools.lru_cache(maxsize=None)
def card_of(index: int) -> Card:
    p = torch.cuda.get_device_properties(index)
    return Card(p.multi_processor_count, p.max_threads_per_multi_processor,
                p.regs_per_multiprocessor)


def _aligned(*ptrs: int) -> bool:
    return all(p % 16 == 0 for p in ptrs)


def _plan(x: torch.Tensor, rows: int, d: int, gated: bool, aligned: bool) -> NormPlan:
    return norm_plan(rows, d, x.element_size(), gated=gated, aligned=aligned,
                     card=card_of(x.device.index))


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
    plan = _plan(x, rows, d, False, _aligned(x.data_ptr(), w.data_ptr(), out.data_ptr()))
    build.call(f"rmsnorm_{build.DTYPE_SUFFIX[x.dtype]}", _ARGS, x.data_ptr(), w.data_ptr(),
               out.data_ptr(), rows, d, eps, *plan, build.stream(x.device))
    build.count(rmsnorm)
    return out


rmsnorm.launches = 0   # kernel launches, for showing a run went through it


def rmsnorm_gated_plain(y, xh, d_skip, z, w, *, eps: float = 1e-5):
    """The gated kernel's function in plain PyTorch: the op-by-op body of the
    Mamba2 block, then `rmsnorm_plain`."""
    g = y + xh * d_skip[:, None].to(xh.dtype)
    g = g.reshape(z.shape) * F.silu(z)
    return rmsnorm_plain(g, w, eps=eps)


def _row_stride(t: torch.Tensor) -> int | None:
    """Elements between neighbouring rows of ``t`` read as (-1, last dim),
    or None where its last dim is not contiguous or its rows are not evenly
    spaced."""
    if t.stride(-1) != 1:
        return None
    stride = expected = None
    for size, st in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if expected is None:
            stride = st
        elif st != expected:
            return None
        expected = st * size
    return t.shape[-1] if stride is None else stride


def rmsnorm_gated(y, xh, d_skip, z, w, *, eps: float = 1e-5):
    """rmsnorm((y + xh * d_skip) * silu(z), w) in one launch, rounded to the
    input type where the op-by-op body rounds.  y, xh (..., H, P)
    contiguous and z (..., H*P) of one dtype (bf16/float32), z's rows evenly
    spaced (a column slice of the in-projection is taken as it is); d_skip
    (H,) and w (H*P,) float32 -> z's shape and dtype, contiguous."""
    if y.device.type == "cpu":
        return rmsnorm_gated_plain(y, xh, d_skip, z, w, eps=eps)
    build.check_cuda("rmsnorm_gated", y, xh, d_skip, w)
    if z.device != y.device:
        raise ValueError(f"rmsnorm_gated: z on {z.device}, the rest on {y.device}")
    *lead, h, p = y.shape
    d = h * p
    zs = _row_stride(z)
    if (y.dtype not in build.DTYPE_SUFFIX or xh.dtype != y.dtype or z.dtype != y.dtype
            or xh.shape != y.shape or tuple(z.shape) != (*lead, d) or d_skip.shape != (h,)
            or d_skip.dtype != torch.float32 or w.shape != (d,) or w.dtype != torch.float32
            or zs is None):
        raise ValueError(
            f"rmsnorm_gated: y, xh (..., H, P) and z (..., H*P) of one dtype (bf16/float32), "
            f"z's rows evenly spaced, d_skip (H,) and w (H*P,) float32; got y {y.dtype} "
            f"{tuple(y.shape)}, xh {xh.dtype} {tuple(xh.shape)}, z {z.dtype} "
            f"{tuple(z.shape)} strides {z.stride()}, d_skip {d_skip.dtype} "
            f"{tuple(d_skip.shape)}, w {w.dtype} {tuple(w.shape)}")
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    rows = out.numel() // d if d else 0
    if rows == 0:
        return out
    aligned = _aligned(y.data_ptr(), xh.data_ptr(), z.data_ptr(), w.data_ptr(),
                       out.data_ptr(), zs * z.element_size())
    plan = _plan(y, rows, d, True, aligned)
    build.call(f"rmsnorm_gated_{build.DTYPE_SUFFIX[y.dtype]}", _GATED_ARGS, y.data_ptr(),
               xh.data_ptr(), d_skip.data_ptr(), z.data_ptr(), zs, p, w.data_ptr(),
               out.data_ptr(), rows, d, eps, *plan, build.stream(y.device))
    build.count(rmsnorm_gated)
    return out


rmsnorm_gated.launches = 0   # kernel launches, for showing a run went through it


def launch_floor(plan: NormPlan) -> None:
    """Launches an empty kernel on the grid of the row kernel's ``plan``
    (card only): the floor a norm's time is held against."""
    build.call("rmsnorm_launch_floor", [build.I, build.I, build.P], plan.blocks,
               32 * plan.warps * plan.groups,
               build.stream(torch.device("cuda", torch.cuda.current_device())))
