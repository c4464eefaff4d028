"""Row RMSNorm and Mamba2's gated form: the CUDA kernels ``csrc/rmsnorm.cu``
and their plain versions.

The kernels replace the Pallas TPU kernel `_rmsnorm_kernel`
(``repro/kernels/rmsnorm.py``); the gated form also takes in the
elementwise ops that the JAX package runs before it in a Mamba2 block.  The
source says what bounds them on the H100 and how they are laid out;
`norm_plan` chooses the launch on the host from the shapes and the card's
properties: the row kernel, the cluster kernel (aligned rows past 8 warps,
`cluster_plan`) or the wide kernel.  ``rmsnorm`` and ``rmsnorm_gated``
launch a kernel for CUDA tensors and run the plain version for CPU
tensors.

On the card, ``rmsnorm`` is differentiable when ``x`` or ``w`` requires
grad: `_RmsNorm` runs the forward kernel and the backward kernel
(`rmsnorm_backward`, in the same source), which holds rows in the
forward's register layout (`norm_bwd_plan`).  So is ``rmsnorm_gated``:
`_RmsNormGated` runs its forward kernel and its backward kernel
(`rmsnorm_gated_backward`), on `norm_bwd_plan`'s layout for four inputs a
piece; its plain version is `ref.rmsnorm_gated_backward`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .ref import rmsnorm_gated_backward as rmsnorm_gated_backward_plain
from .ref import rmsnorm_reference as rmsnorm_plain  # the kernel's plain version

__all__ = ["rmsnorm", "rmsnorm_backward", "rmsnorm_gated", "rmsnorm_gated_backward",
           "rmsnorm_gated_plain", "rmsnorm_plain", "cluster_plan", "norm_bwd_plan", "norm_plan",
           "tail_heads"]

THREADS = 256      # a block of the row kernel at most (its launch bounds)
REGISTERS = 128    # a thread at most: the launch bounds keep two such blocks an SM
# 16-byte pieces of a row a lane holds: one input a piece (the forward), or
# more (the gated form: three; the backward: x and g); the gated backward,
# four inputs a piece, holds one
MAX_UNITS = {False: 4, True: 2}
GATED_BWD_UNITS = 1

MAX_CTAS = 8       # CTAs of a cluster that hold one row, at most: the portable cluster
CLUSTER_SLOTS = 64  # the cluster kernel's warps a row, at most (its slots for their sums)
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.F] + [build.I] * 5 + [build.P]
_BWD_ARGS = [build.P] * 6 + [build.I, build.I, build.F] + [build.I] * 5 + [build.P]
MAX_BWD_WIDTH = 50_000   # the wide backward keeps a float32 partial of dw a column in shared memory
FOLD_FLOATS = 8 * 32 * 2 * 8   # the backward's row groups' dw shares in shared memory, at most
_GATED_ARGS = ([build.P] * 4 + [build.L, build.I, build.P, build.P, build.I, build.I, build.F]
               + [build.I] * 5 + [build.P])
_GATED_BWD_ARGS = ([build.P] * 4 + [build.L, build.I] + [build.P] * 9
                   + [build.I, build.I, build.F] + [build.I] * 8 + [build.P])
MAX_GATED_BWD_WIDTH = 25_000   # its wide kernel keeps two float32 partials a column in shared memory
# its launches: the rows, then the tail (dw and d_skip's gradient from the
# partial rows)
GATED_ROWS_PASS, GATED_TAIL_PASS = 1, 2
GATED_ALL_PASSES = GATED_ROWS_PASS | GATED_TAIL_PASS


class Card(NamedTuple):
    """What `norm_plan` needs of a card: its SMs and what one SM holds."""
    sms: int
    threads: int      # an SM at most
    registers: int    # an SM


class NormPlan(NamedTuple):
    """A launch: ``warps`` warps a row (0: the wide kernel, a block a row),
    each lane holding ``units`` 16-byte pieces of it; ``groups`` rows a
    block at once; ``blocks`` blocks, which walk the rows grid-stride.
    ``warps`` > 8 or ``ctas`` > 1: a cluster kernel (the forward's or a
    backward's), a row held by ``ctas`` CTAs of ``warps`` warps each (a
    thread-block cluster, or one CTA of 16 warps), ``blocks / ctas``
    clusters at most (the kernel takes as many as the card holds at
    once)."""
    warps: int
    units: int
    groups: int
    blocks: int
    ctas: int = 1

    @property
    def cluster(self) -> bool:
        """The plan of a cluster kernel."""
        return self.warps > THREADS // 32 or self.ctas > 1


WIDE = NormPlan(0, 0, 0, 0)


def norm_plan(rows: int, d: int, elem_bytes: int, *, gated: bool, aligned: bool,
              card: Card, backward: bool = False) -> NormPlan:
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
    step (8 rows): 8 blocks of one row of 4 warps.  ``backward``: two
    inputs a piece, as the gated form's three; both: four, one piece a lane.
    A row past 8 warps goes to `cluster_plan` (jamba's gated forward, 4096
    rows of 16384 bf16: 2 CTAs of 16 warps a row, two pieces a lane)."""
    vec = 16 // elem_bytes
    if not aligned or d % vec:
        return WIDE
    pieces = d // vec
    limit = GATED_BWD_UNITS if gated and backward else MAX_UNITS[gated or backward]
    warps = 1
    while -(-pieces // (32 * warps)) > limit:
        warps *= 2
    if warps > THREADS // 32:
        return cluster_plan(rows, pieces, limit, card, most16=2 if gated and not backward else 1)
    if rows < card.sms and warps < THREADS // 32:
        warps *= 2
    units = 1 << (-(-pieces // (32 * warps)) - 1).bit_length()
    groups = max(1, min(THREADS // 32 // warps, rows // card.sms))
    threads = 32 * warps * groups
    fit = min(card.threads // threads, card.registers // (REGISTERS * threads))
    return NormPlan(warps, units, groups, min(-(-rows // groups), card.sms * max(1, fit)))


def cluster_plan(rows: int, pieces: int, limit: int, card: Card,
                 warps: int | None = None, *, most16: int = 1) -> NormPlan:
    """A row of ``pieces`` 16-byte pieces (of each input) past 8 warps, at
    most ``limit`` pieces a lane, for the cluster kernel (the forward's or a
    backward's): the fewest CTAs of 16 warps (one an SM), at most
    ``most16``, where they hold the row and there are at least as many rows
    as SMs, so that the row's warps add their sums on few SMs (the plain
    gradient to 8192 bf16 columns on one: 73-83% of its bound against
    60-75% on two CTAs of 8; the gated forward, ``most16`` 2, at jamba's
    4096 rows of 16384 bf16 on two: 4% faster than on four CTAs of 8, where
    the plain forward at (4096, 32768) bf16 ran 2% slower on two than on
    four of 8, PERF.md); else the fewest CTAs of 8 warps (two an SM) that
    hold it in a thread-block cluster, twice as many when there are fewer
    rows than SMs, so that more SMs share the rows, or the wide kernel
    where `MAX_CTAS` do not hold it (jamba's gated gradient, 16384 bf16
    with one piece a lane: 8 CTAs).  ``warps`` forces CTAs of 8 or 16
    warps.  As many clusters as fit the card at once (by threads, and by
    the registers the launch bounds allow) or as there are rows, fewer;
    the kernel launches fewer where the card holds fewer
    (`clusters_launched`)."""
    if warps is None:
        sixteen = most16 * 2 * THREADS * limit        # the pieces those CTAs of 16 warps hold
        warps = 2 * THREADS // 32 if rows >= card.sms and pieces <= sixteen else THREADS // 32
    lanes = 32 * warps
    most = min(MAX_CTAS, CLUSTER_SLOTS // warps)
    ctas = -(-pieces // (lanes * limit))
    if ctas > most:
        return WIDE
    if rows < card.sms:
        ctas = min(most, 2 * ctas)
    units = 1 << (-(-pieces // (lanes * ctas)) - 1).bit_length()
    fit = min(card.threads // lanes, card.registers // (REGISTERS * lanes))
    clusters = max(1, min(rows, card.sms * max(1, fit) // ctas))
    return NormPlan(warps, units, 1, clusters * ctas, ctas)


def clusters_launched(plan: NormPlan, elem_bytes: int, *, gated: bool, backward: bool) -> int:
    """The clusters that the forward's or a backward's cluster kernel
    launches on ``plan`` (card only): the plan's, or as many as the current
    card holds at once where that is fewer."""
    fit = build.library().rmsnorm_cluster_fit(int(backward), int(gated), int(elem_bytes == 2),
                                              plan.units, plan.ctas, 32 * plan.warps)
    if fit < 0:
        raise RuntimeError(f"rmsnorm_cluster_fit: CUDA error {-fit} for {plan}")
    return min(plan.blocks // plan.ctas, fit)


def norm_bwd_plan(rows: int, d: int, elem_bytes: int, *, aligned: bool, card: Card,
                  gated: bool = False) -> NormPlan:
    """The backward's launch, which writes one partial row of dw a block:
    `norm_plan`'s for two inputs a piece (x and the output's gradient) at
    qwen2.5-3b's training rows (8192 of 2048 bf16 on 132 SMs: 4 warps a
    row, 2 pieces a lane, 2 rows a block, 264 blocks), or, ``gated``, for
    four (y, xh, z and the gradient; mamba2-370m's 8192 rows of 2048 bf16:
    8 warps a row, one piece a lane, a row a block, 264 blocks); rows past
    8 warps take `cluster_plan`'s (jamba's gated 4096 rows of 16384 bf16:
    8 CTAs of 8 warps a row, 33 clusters at most; the plain gradient's
    8192 rows of 5120-8192 bf16: a CTA of 16 warps a row, 132); rows that
    go to the wide kernel take a block a row, at most two blocks an SM at
    once."""
    plan = norm_plan(rows, d, elem_bytes, gated=gated, aligned=aligned, card=card,
                     backward=True)
    return plan if plan.warps else NormPlan(0, 0, 0, min(rows, 2 * card.sms))


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


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    build.check_cuda(name, x, w)
    d = x.shape[-1]
    if x.dtype not in build.DTYPE_SUFFIX or w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(f"{name}: x bf16/float32 (..., {d}) and w float32 ({d},), "
                         f"got {x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    _check("rmsnorm", x, w)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    plan = _plan(x, rows, d, False, _aligned(x.data_ptr(), w.data_ptr(), out.data_ptr()))
    build.call(f"rmsnorm_{build.DTYPE_SUFFIX[x.dtype]}", _ARGS, x.data_ptr(), w.data_ptr(),
               out.data_ptr(), rows, d, eps, *plan, build.stream(x.device))
    build.count(rmsnorm)
    _count_route(plan, rmsnorm_cluster, rmsnorm_wide)
    return out


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """dx (x's shape and dtype) and dw (float32) of ``rmsnorm(x, w)`` for the
    output gradient ``g``, on CUDA tensors: the backward kernel on
    `norm_bwd_plan`'s launch (the row kernel, the cluster kernel or the
    wide kernel), then the fixed-order sum of its partial rows of dw, one a
    block or a cluster (no atomics)."""
    _check("rmsnorm_backward", x, w)
    build.check_cuda("rmsnorm_backward", x, g)
    d = x.shape[-1]
    if g.shape != x.shape or g.dtype != x.dtype or d > MAX_BWD_WIDTH:
        raise ValueError(f"rmsnorm_backward: g as x {x.dtype} {tuple(x.shape)}, width <= "
                         f"{MAX_BWD_WIDTH}; got g {g.dtype} {tuple(g.shape)}")
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    plan = norm_bwd_plan(rows, d, x.element_size(),
                         aligned=_aligned(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                                          dx.data_ptr()),
                         card=card_of(x.device.index))
    part = torch.empty((plan.blocks // plan.ctas, d), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    build.call(f"rmsnorm_bwd_{build.DTYPE_SUFFIX[x.dtype]}", _BWD_ARGS, x.data_ptr(),
               w.data_ptr(), g.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows,
               d, eps, *plan, build.stream(x.device))
    build.count(rmsnorm_backward)
    if plan.cluster:
        build.count(rmsnorm_bwd_cluster)
    return dx, dw


class _RmsNorm(torch.autograd.Function):
    """The forward kernel and the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, w, g.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) bf16 or float32, w: (D,) float32 -> x's shape and dtype.
    On the card, differentiable through the backward kernel when x or w
    requires grad; otherwise one forward launch."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RmsNorm.apply(x, w, eps)
    return _forward(x, w, eps)


rmsnorm.launches = 0            # forward kernel launches
rmsnorm_backward.launches = 0   # backward calls (two kernels each)


class _Launches:
    """The launch count (`build.count`) of a kernel that a wrapper reaches
    on some plans only, kept beside the wrapper's own."""
    launches = 0


# rmsnorm_bwd_cluster_kernel's and rmsnorm_gated_bwd_cluster_kernel's launches
rmsnorm_bwd_cluster = _Launches()
rmsnorm_gated_bwd_cluster = _Launches()
# the forwards' launches of rmsnorm_cluster_kernel and of rmsnorm_wide_kernel
rmsnorm_cluster = _Launches()
rmsnorm_gated_cluster = _Launches()
rmsnorm_wide = _Launches()
rmsnorm_gated_wide = _Launches()


def _count_route(plan: NormPlan, cluster: _Launches, wide: _Launches) -> None:
    """Counts a forward's launch of the cluster kernel or the wide kernel."""
    if plan.cluster:
        build.count(cluster)
    elif not plan.warps:
        build.count(wide)


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


def _gated_check(name: str, y, xh, d_skip, z, w) -> int:
    """Raises unless the gated form takes these inputs; returns z's row stride."""
    build.check_cuda(name, y, xh, d_skip, w)
    if z.device != y.device:
        raise ValueError(f"{name}: z on {z.device}, the rest on {y.device}")
    *lead, h, p = y.shape
    d = h * p
    zs = _row_stride(z)
    if (y.dtype not in build.DTYPE_SUFFIX or xh.dtype != y.dtype or z.dtype != y.dtype
            or xh.shape != y.shape or tuple(z.shape) != (*lead, d) or d_skip.shape != (h,)
            or d_skip.dtype != torch.float32 or w.shape != (d,) or w.dtype != torch.float32
            or zs is None):
        raise ValueError(
            f"{name}: y, xh (..., H, P) and z (..., H*P) of one dtype (bf16/float32), "
            f"z's rows evenly spaced, d_skip (H,) and w (H*P,) float32; got y {y.dtype} "
            f"{tuple(y.shape)}, xh {xh.dtype} {tuple(xh.shape)}, z {z.dtype} "
            f"{tuple(z.shape)} strides {z.stride()}, d_skip {d_skip.dtype} "
            f"{tuple(d_skip.shape)}, w {w.dtype} {tuple(w.shape)}")
    return zs


def _gated_forward(y, xh, d_skip, z, w, eps):
    zs = _gated_check("rmsnorm_gated", y, xh, d_skip, z, w)
    p = y.shape[-1]
    d = w.shape[0]
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
    _count_route(plan, rmsnorm_gated_cluster, rmsnorm_gated_wide)
    return out


def tail_heads(p: int) -> int:
    """Heads a block of the gated backward's tail takes: enough for 32
    columns (a warp's), at least one."""
    return max(1, 32 // p)


def rmsnorm_gated_backward(y, xh, d_skip, z, w, g, *, eps: float = 1e-5,
                           passes: int = GATED_ALL_PASSES):
    """dy, dxh (y's shape and dtype), dd_skip (H,) float32, dz (z's shape,
    contiguous) and dw (H*P,) float32 of ``rmsnorm_gated(y, xh, d_skip, z,
    w)`` for the output gradient ``g`` (z's shape and dtype).  CUDA
    tensors: the backward kernel on `norm_bwd_plan`'s gated launch (the
    row kernel, the cluster kernel or the wide kernel), then one launch of
    the fixed-order sums of its partial rows (one a block or a cluster) of
    dw and of d_skip's gradient a column, and of d_skip's over each head's
    columns (no atomics; ``passes`` launches only one of the two, to time
    them apart); CPU tensors: the plain version."""
    if y.device.type == "cpu":
        return rmsnorm_gated_backward_plain(y, xh, d_skip, z, w, g, eps=eps)
    zs = _gated_check("rmsnorm_gated_backward", y, xh, d_skip, z, w)
    build.check_cuda("rmsnorm_gated_backward", y, g)
    h, p = y.shape[-2:]
    d = h * p
    if g.shape != z.shape or g.dtype != z.dtype or d > MAX_GATED_BWD_WIDTH:
        raise ValueError(f"rmsnorm_gated_backward: g as z {z.dtype} {tuple(z.shape)}, width <= "
                         f"{MAX_GATED_BWD_WIDTH}; got g {g.dtype} {tuple(g.shape)}")
    dy, dxh = torch.empty_like(y), torch.empty_like(xh)
    dz = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    rows = dz.numel() // d if d else 0
    if rows == 0:
        return dy, dxh, torch.zeros_like(d_skip), dz, torch.zeros_like(w)
    aligned = _aligned(y.data_ptr(), xh.data_ptr(), z.data_ptr(), w.data_ptr(), g.data_ptr(),
                       dy.data_ptr(), dxh.data_ptr(), dz.data_ptr(), zs * z.element_size())
    plan = norm_bwd_plan(rows, d, y.element_size(), aligned=aligned,
                         card=card_of(y.device.index), gated=True)
    part = torch.empty((2, plan.blocks // plan.ctas, d), dtype=torch.float32, device=y.device)
    dd, dw = torch.empty_like(d_skip), torch.empty_like(w)
    build.call(f"rmsnorm_gated_bwd_{build.DTYPE_SUFFIX[y.dtype]}", _GATED_BWD_ARGS,
               y.data_ptr(), xh.data_ptr(), d_skip.data_ptr(), z.data_ptr(), zs, p,
               w.data_ptr(), g.data_ptr(), dy.data_ptr(), dxh.data_ptr(), dz.data_ptr(),
               part[0].data_ptr(), part[1].data_ptr(), dw.data_ptr(), dd.data_ptr(), rows, d,
               eps, h, tail_heads(p), *plan, passes, build.stream(y.device))
    build.count(rmsnorm_gated_backward)
    if plan.cluster and passes & GATED_ROWS_PASS:
        build.count(rmsnorm_gated_bwd_cluster)
    return dy, dxh, dd, dz, dw


class _RmsNormGated(torch.autograd.Function):
    """The gated forward kernel and its backward kernel."""

    @staticmethod
    def forward(ctx, y, xh, d_skip, z, w, eps):
        ctx.save_for_backward(y, xh, d_skip, z, w)
        ctx.eps = eps
        return _gated_forward(y, xh, d_skip, z, w, eps)

    @staticmethod
    def backward(ctx, g):
        return (*rmsnorm_gated_backward(*ctx.saved_tensors, g.contiguous(), eps=ctx.eps), None)


def rmsnorm_gated(y, xh, d_skip, z, w, *, eps: float = 1e-5):
    """rmsnorm((y + xh * d_skip) * silu(z), w) in one launch, rounded to the
    input type where the op-by-op body rounds.  y, xh (..., H, P)
    contiguous and z (..., H*P) of one dtype (bf16/float32), z's rows evenly
    spaced (a column slice of the in-projection is taken as it is); d_skip
    (H,) and w (H*P,) float32 -> z's shape and dtype, contiguous.  On the
    card, differentiable through the backward kernel when an input requires
    grad; otherwise one forward launch."""
    if y.device.type == "cpu":
        return rmsnorm_gated_plain(y, xh, d_skip, z, w, eps=eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, xh, d_skip, z, w)):
        return _RmsNormGated.apply(y, xh, d_skip, z, w, eps)
    return _gated_forward(y, xh, d_skip, z, w, eps)


rmsnorm_gated.launches = 0            # kernel launches, for showing a run went through it
rmsnorm_gated_backward.launches = 0   # backward calls (two kernels each)


def launch_floor(plan: NormPlan) -> None:
    """Launches an empty kernel on the grid of the row kernel's or the
    cluster kernel's ``plan`` (in clusters of ``plan.ctas`` CTAs; card
    only): the floor a norm's time is held against."""
    build.call("rmsnorm_launch_floor", [build.I, build.I, build.I, build.P], plan.blocks,
               32 * plan.warps * plan.groups, plan.ctas,
               build.stream(torch.device("cuda", torch.cuda.current_device())))
